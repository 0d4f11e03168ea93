"""Packed-layout flash attention for the encoder: the hand-written CUDA
kernel (``csrc/flash_attention.cu``) and its plain PyTorch version.

Replaces the TPU kernel ``wis_tpu/ops/flash.py`` ``flash_attention_packed``.
q, k, v and the result keep the packed (B, T, D) layout, heads side by
side along D. The kernel is bound by the tensor cores' rate at the
encoder's shapes; ``csrc/flash_attention.cu`` says how its design feeds
them and keeps the T×T scores out of device memory.

``flash_attention_packed`` launches the kernel for CUDA tensors and
counts the launch in ``flash_attention_packed.launches``; it takes the
plain version only for tensors on the CPU.
"""

from __future__ import annotations

import torch

from wis_tpu_torch.ops import _build
from wis_tpu_torch.ops.attention import merge_heads, mha, qkv_heads


def flash_attention_packed_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int
) -> torch.Tensor:
    """Unmasked softmax(q·kᵀ/√Dh)·v on packed (B, T, D) tensors, through
    the head-major ``mha`` (f32 scores and softmax)."""
    return merge_heads(
        mha(qkv_heads(q, n_heads), qkv_heads(k, n_heads), qkv_heads(v, n_heads))
    )


def flash_attention_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int
) -> torch.Tensor:
    """Unmasked attention on packed (B, T, D) q/k/v; output packed
    (B, T, D). CUDA tensors run the kernel (bf16, contiguous, head_dim 64
    or 128); CPU tensors run ``flash_attention_packed_plain``."""
    if q.device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, n_heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_packed: unsupported device {q.device}")
    if q.dim() != 3:
        raise ValueError(f"flash_attention_packed: want (B, T, D), got {tuple(q.shape)}")
    b, t, d = q.shape
    if d % n_heads or d // n_heads not in (64, 128):
        raise ValueError(
            f"flash_attention_packed: D={d} over {n_heads} heads is not "
            "head_dim 64 or 128"
        )
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != torch.bfloat16 or x.device != q.device:
            raise ValueError(
                f"flash_attention_packed: {name} must be bf16 {tuple(q.shape)} "
                f"on {q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"flash_attention_packed: {name} must be contiguous")
    out = torch.empty_like(q)
    if b == 0 or t == 0:
        return out
    for x in (q, k, v, out):
        if x.data_ptr() % 16:
            raise ValueError("flash_attention_packed: pointers must be 16-byte aligned")
    lib = _build.kernels()
    with torch.cuda.device(q.device):
        rc = lib.wis_flash_attention_packed(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, d, n_heads, float((d // n_heads) ** -0.5),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(rc, "flash_attention_packed")
    flash_attention_packed.launches += 1
    return out


flash_attention_packed.launches = 0
