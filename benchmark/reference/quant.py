"""Weight and activation rounding, worked out again from the published
tensors, at the precision a configuration states and one step below it
(the control).

- ``int8``: symmetric, scale = max(|x|, 1e-8) / 127 over the reduced axis,
  round half to even, clip to ±127: the recipe the configuration states
  for the decoder's matmul weights (per output channel), the logits table
  (per row) and the cross-attention K/V (per audio position, with the
  scale rounded to bf16).
- ``int4``: the same with 7 levels, the control's step below int8.
- ``fp8``: float8 e4m3 with a per-channel scale of max(|x|) / 448, the
  control's step below bf16.
Each returns the dequantized float32 tensor.
"""

from __future__ import annotations

import torch


def symmetric(x: torch.Tensor, dim: int, levels: int, bf16_scale: bool = False) -> torch.Tensor:
    x32 = x.float()
    # the reciprocal's multiply, as the configuration's recipe computes it
    scale = torch.clamp_min(x32.abs().amax(dim=dim, keepdim=True), 1e-8) * torch.tensor(
        1.0 / levels, dtype=torch.float32)
    if bf16_scale:
        scale = scale.to(torch.bfloat16).float()
    return torch.clamp(torch.round(x32 / scale), -levels, levels) * scale


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().amax(dim=dim, keepdim=True), 1e-12) / 448.0
    return (x32 / scale).to(torch.float8_e4m3fn).float() * scale


#: the precision each kind of tensor is held in: as the configuration
#: states it ("served") and one step below ("control")
LEVELS = {"served": {"int8": 127, "bf16": None}, "control": {"int8": 7, "bf16": "fp8"}}


def weight(x: torch.Tensor, stated: str, mode: str, dim: int = -1) -> torch.Tensor:
    """A tensor the configuration holds at ``stated`` ("int8" or "bf16"),
    rounded as ``mode`` ("served" or "control") asks, as float32. ``dim``
    is the reduced axis: the input axis of a (out, in) weight."""
    rule = LEVELS[mode][stated]
    if rule is None:
        return x.float()
    if rule == "fp8":
        return fp8(x, dim)
    return symmetric(x, dim, rule)


def kv(x: torch.Tensor, dim: int, mode: str) -> torch.Tensor:
    """Per-position int8 K/V with a bf16 scale (int4 for the control)."""
    return symmetric(x, dim, LEVELS[mode]["int8"], bf16_scale=True)
