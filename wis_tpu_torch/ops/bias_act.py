"""The epilogue of a product in one pass: bias, then optional GELU, then
optional residual — the hand-written CUDA kernel (``csrc/bias_act.cu``)
and its plain PyTorch version.

    out = residual + act((f32(y) + f32(b)).to(dtype))

``act`` is the identity or ``ops/gelu.gelu`` (the JAX package's polynomial
with exact tails), whose result rounds to ``dtype`` before the residual
add. It replaces no TPU kernel: on the TPU, XLA fused this chain into the
products it follows. The kernel is bound by device-memory bytes: it reads
y and the residual once and writes the output once, where the plain chain
makes about twenty passes over f32 temporaries; ``csrc/bias_act.cu`` says
how its design keeps to that, and that its arithmetic is the plain chain's,
op for op.

``bias_act`` launches the kernel for a CUDA tensor and counts the launch in
``bias_act.launches`` (through ``ops/graphs.launched``, so a replayed
graph counts too); it takes the plain version only for a tensor on the
CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from wis_tpu_torch.ops import _build
from wis_tpu_torch.ops.gelu import gelu as gelu_poly
from wis_tpu_torch.ops.graphs import launched
from wis_tpu_torch.ops.quant import _sm_count

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def bias_act_plain(y: torch.Tensor, b: torch.Tensor, *, gelu: bool = False,
                   residual: Optional[torch.Tensor] = None,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The chain in plain PyTorch: y (..., N) plus the bias b (N,) in f32,
    rounded to ``dtype`` (default y's), then ``gelu`` if asked, then
    ``residual +`` it (the residual in ``dtype``, broadcast over y's
    leading axes)."""
    out = (y.float() + b.float()).to(dtype or y.dtype)
    if gelu:
        out = gelu_poly(out)
    if residual is not None:
        out = residual + out
    return out


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"bias_act: {msg}")


def _launch_args(y, b, residual, dtype) -> tuple:
    """What the kernel takes of these tensors (n, cols, residual elements),
    or a ValueError for what it does not: the output bf16 or f32, y the
    output's dtype or f32, b (N,) bf16 or f32, the residual in the output's
    dtype with y's trailing shape, N a multiple of 8, every tensor
    contiguous on y's device and 16-byte aligned."""
    _check(dtype in _DTYPE_CODES, f"output dtype {dtype} (want bf16 or f32)")
    _check(y.dtype in (dtype, torch.float32), f"product dtype {y.dtype} for a {dtype} output")
    _check(y.dim() >= 1, "the product has no last axis")
    cols = y.shape[-1]
    _check(cols % 8 == 0, f"last axis {cols} is not a multiple of 8")
    _check(b.shape == (cols,) and b.dtype in _DTYPE_CODES,
           f"bias must be ({cols},) bf16 or f32, got {b.dtype} {tuple(b.shape)}")
    tensors = [y, b]
    if residual is not None:
        _check(residual.dtype == dtype and residual.dim() <= y.dim()
               and residual.shape == y.shape[y.dim() - residual.dim():],
               f"residual must be {dtype} with y's trailing shape {tuple(y.shape)}, got "
               f"{residual.dtype} {tuple(residual.shape)}")
        tensors.append(residual)
    for t in tensors:
        _check(t.device == y.device, f"tensors on {t.device} and {y.device}")
        _check(t.is_contiguous(), "inputs must be contiguous")
        _check(t.data_ptr() % 16 == 0, "pointers must be 16-byte aligned")
    return y.numel(), cols, residual.numel() if residual is not None else 0


def bias_act(y: torch.Tensor, b: torch.Tensor, *, gelu: bool = False,
             residual: Optional[torch.Tensor] = None,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``bias_act_plain(y, b, gelu=gelu, residual=residual, dtype=dtype)``:
    CUDA tensors run ``csrc/bias_act.cu`` (see ``_launch_args`` for what it
    takes), CPU tensors the plain version."""
    if y.device.type == "cpu":
        return bias_act_plain(y, b, gelu=gelu, residual=residual, dtype=dtype)
    _check(y.device.type == "cuda", f"unsupported device {y.device}")
    dtype = dtype or y.dtype
    n, cols, res_n = _launch_args(y, b, residual, dtype)
    out = torch.empty(y.shape, dtype=dtype, device=y.device)
    if n == 0:
        return out
    lib = _build.kernels()
    with torch.cuda.device(y.device):
        rc = lib.wis_bias_act(
            y.data_ptr(), b.data_ptr(), residual.data_ptr() if residual is not None else None,
            out.data_ptr(), n, cols, res_n, int(gelu), _DTYPE_CODES[dtype],
            _DTYPE_CODES[y.dtype], _DTYPE_CODES[b.dtype], _sm_count(y.device.index),
            torch.cuda.current_stream(y.device).cuda_stream,
        )
    _build.check(rc, "bias_act")
    launched(bias_act)
    return out


bias_act.launches = 0
