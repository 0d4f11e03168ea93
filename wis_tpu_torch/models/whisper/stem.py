"""Encoder conv stem as matmuls (port of ``wis_tpu/models/whisper/stem.py``).

Both convs are im2col by reshape, no gathers:

- conv1 (stride 1, pad 1): concat of three shifted views —
  (B, 3000, 3·C_in) @ (3·C_in, D);
- conv2 (stride 2, pad 1): the stride-2 phases come from a reshape
  (B, 3000, D) → (B, 1500, 2, D); y[2t-1] is the odd phase shifted one
  row — (B, 1500, 3D) @ (3D, D).

Each matmul accumulates and returns f32 before the bias add (one rounding
to the working dtype, as the JAX package's ``preferred_element_type``),
then the tanh-form gelu (``ops/gelu.py``); conv2 then adds the positions.
Each conv's bias, gelu and (conv2) positions run as one epilogue
(``ops/bias_act``: one kernel launch on the card).

Under tensor parallelism (``tp``) both convs are column-parallel: each
rank holds its share of the output channels (``parallel/mesh.py``
``whisper_param_specs``), and each conv's output is all-gathered along D
before the next step reads it (the positions added after the gather).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from wis_tpu_torch.ops.bias_act import bias_act
from wis_tpu_torch.ops.quant import matmul_f32
from wis_tpu_torch.parallel.axis import ModelAxis


def conv_stem(enc: dict, mel: torch.Tensor, tp: Optional[ModelAxis] = None) -> torch.Tensor:
    """mel (B, n_mels, 3000) → (B, 1500, D): conv1+gelu, conv2(s2)+gelu,
    positional add."""
    w1 = enc["conv1"]["w"]  # (3, C, D), or (3, C, D / tp.size)
    w2 = enc["conv2"]["w"]  # (3, D, D), or (3, D, D / tp.size)
    dtype = w1.dtype
    x = mel.transpose(-1, -2).to(dtype)  # (B, T, C)
    b, t, c = x.shape

    # conv1, stride 1, pad 1: y[t] = Σ_k x[t+k-1] @ w1[k]
    xp = F.pad(x, (0, 0, 1, 1))
    z1 = torch.cat([xp[:, 0:t], xp[:, 1 : t + 1], xp[:, 2 : t + 2]], dim=-1)
    y = matmul_f32(z1, w1.reshape(3 * c, w1.shape[-1]))
    y = bias_act(y, enc["conv1"]["b"], gelu=True, dtype=dtype)
    if tp is not None:
        y = tp.all_gather(y, dim=-1)
    d = y.shape[-1]

    # conv2, stride 2, pad 1: out[t] = y[2t-1]@w[0] + y[2t]@w[1] + y[2t+1]@w[2]
    r = y.reshape(b, t // 2, 2, d)
    even = r[:, :, 0]  # y[2t]
    odd = r[:, :, 1]  # y[2t+1]
    odd_prev = F.pad(odd[:, :-1], (0, 0, 1, 0))  # y[2t-1]
    z2 = torch.cat([odd_prev, even, odd], dim=-1)  # (B, T/2, 3D)
    y2 = matmul_f32(z2, w2.reshape(3 * d, w2.shape[-1]))
    pos = enc["pos"].to(dtype)
    if tp is None:
        return bias_act(y2, enc["conv2"]["b"], gelu=True, residual=pos, dtype=dtype)
    y2 = tp.all_gather(bias_act(y2, enc["conv2"]["b"], gelu=True, dtype=dtype), dim=-1)
    return y2 + pos
