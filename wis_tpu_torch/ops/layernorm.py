"""Encoder LayerNorm: the hand-written CUDA kernel (``csrc/layernorm.cu``)
and its plain PyTorch version.

Replaces the TPU kernel ``wis_tpu/ops/layernorm.py`` ``layer_norm_pallas``.
The kernel is bound by device-memory bytes (one read and one write per
element, no tensor-core work); ``csrc/layernorm.cu`` says how its design
keeps to that.

``layer_norm_cuda`` launches the kernel for a CUDA tensor and counts the
launch in ``layer_norm_cuda.launches``; it takes the plain version only
for a tensor on the CPU. ``layer_norm_plain`` is the f32-statistics
formula the JAX package uses (``models/whisper/model.py`` ``layer_norm``).
"""

from __future__ import annotations

import torch

from wis_tpu_torch.ops import _build
from wis_tpu_torch.ops.graphs import launched

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_plain(
    x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis: f32 mean and variance, output in
    x.dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * g.float() + b.float()).to(x.dtype)


def layer_norm_cuda(
    x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis of x (..., D); g, b (D,) f32. CUDA
    tensors run the kernel (f32 or bf16, D a multiple of 8, contiguous);
    CPU tensors run ``layer_norm_plain``."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, g, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_cuda: unsupported device {x.device}")
    d = x.shape[-1]
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"layer_norm_cuda: dtype {x.dtype} (want f32 or bf16)")
    if d % 8 != 0:
        raise ValueError(f"layer_norm_cuda: last axis {d} is not a multiple of 8")
    for name, t in (("g", g), ("b", b)):
        if t.shape != (d,) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(
                f"layer_norm_cuda: {name} must be f32 ({d},) on {x.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if not (x.is_contiguous() and g.is_contiguous() and b.is_contiguous()):
        raise ValueError("layer_norm_cuda: inputs must be contiguous")
    y = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return y
    for t in (x, g, b, y):
        if t.data_ptr() % 16:
            raise ValueError("layer_norm_cuda: pointers must be 16-byte aligned")
    lib = _build.kernels()
    with torch.cuda.device(x.device):
        rc = lib.wis_layer_norm(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), rows, d,
            float(eps), _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(rc, "layer_norm_cuda")
    launched(layer_norm_cuda)
    return y


layer_norm_cuda.launches = 0
