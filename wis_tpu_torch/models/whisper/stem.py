"""Encoder conv stem as matmuls (port of ``wis_tpu/models/whisper/stem.py``).

Both convs are im2col by reshape, no gathers:

- conv1 (stride 1, pad 1): concat of three shifted views —
  (B, 3000, 3·C_in) @ (3·C_in, D);
- conv2 (stride 2, pad 1): the stride-2 phases come from a reshape
  (B, 3000, D) → (B, 1500, 2, D); y[2t-1] is the odd phase shifted one
  row — (B, 1500, 3D) @ (3D, D).

Each matmul accumulates and returns f32 before the bias add (one rounding
to the working dtype, as the JAX package's ``preferred_element_type``),
then the tanh-form gelu (``ops/gelu.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wis_tpu_torch.ops.gelu import gelu
from wis_tpu_torch.ops.quant import matmul_f32


def conv_stem(enc: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, n_mels, 3000) → (B, 1500, D): conv1+gelu, conv2(s2)+gelu,
    positional add."""
    w1 = enc["conv1"]["w"]  # (3, C, D)
    w2 = enc["conv2"]["w"]  # (3, D, D)
    dtype = w1.dtype
    x = mel.transpose(-1, -2).to(dtype)  # (B, T, C)
    b, t, c = x.shape
    d = w1.shape[-1]

    # conv1, stride 1, pad 1: y[t] = Σ_k x[t+k-1] @ w1[k]
    xp = F.pad(x, (0, 0, 1, 1))
    z1 = torch.cat([xp[:, 0:t], xp[:, 1 : t + 1], xp[:, 2 : t + 2]], dim=-1)
    y = matmul_f32(z1, w1.reshape(3 * c, d))
    y = gelu((y + enc["conv1"]["b"].float()).to(dtype))

    # conv2, stride 2, pad 1: out[t] = y[2t-1]@w[0] + y[2t]@w[1] + y[2t+1]@w[2]
    r = y.reshape(b, t // 2, 2, d)
    even = r[:, :, 0]  # y[2t]
    odd = r[:, :, 1]  # y[2t+1]
    odd_prev = F.pad(odd[:, :-1], (0, 0, 1, 0))  # y[2t-1]
    z2 = torch.cat([odd_prev, even, odd], dim=-1)  # (B, T/2, 3D)
    y2 = matmul_f32(z2, w2.reshape(3 * d, d))
    y2 = gelu((y2 + enc["conv2"]["b"].float()).to(dtype))
    return y2 + enc["pos"].to(dtype)
