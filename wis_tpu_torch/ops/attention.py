"""Multi-head attention helpers (port of ``wis_tpu/ops/attention.py``).

Shapes: (batch, heads, seq, head_dim). Scores are float32 (bf16 operands
upcast, the products are exact), softmax in float32, the context matmul
in the value dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def qkv_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, D) → (B, H, T, Dh)."""
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, Dh) → (B, T, D)."""
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scaled dot-product attention. q (B, H, Tq, Dh); k, v (B, H, Tk, Dh);
    mask broadcastable to (B, H, Tq, Tk), True = attend."""
    dh = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (dh ** -0.5)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)
