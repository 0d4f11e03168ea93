"""Flash attention for the encoder, in the JAX package's two layouts: the
hand-written CUDA kernel (``csrc/flash_attention.cu``, one body for both)
and its plain PyTorch version.

Replaces the TPU kernels ``wis_tpu/ops/flash.py`` ``flash_attention_packed``
(q, k, v and the result packed (B, T, D), heads side by side along D) and
``flash_attention`` (head-major (B, H, T, Dh)). Both compute unmasked
softmax(q·kᵀ/√Dh)·v with f32 scores; keys at or past T never take part.
The kernel is bound by the tensor cores' rate at the encoder's shapes;
``csrc/flash_attention.cu`` says how its design feeds them and keeps the
T×T scores out of device memory: a TMA ring and ``wgmma`` for both
products, compiled at the head width rounded up to a multiple of 64, the
columns past the real width zero-filled by TMA. The same numbers give
bit-identical outputs in either layout.

``flash_attention_packed`` and ``flash_attention`` launch the kernel for
CUDA tensors and count the launch in their ``.launches``; they take the
plain versions only for tensors on the CPU.
"""

from __future__ import annotations

import torch

from wis_tpu_torch.ops import _build
from wis_tpu_torch.ops.attention import merge_heads, mha, qkv_heads
from wis_tpu_torch.ops.graphs import launched

#: widest head the kernel takes (the widest wgmma tile, 256 columns)
MAX_HEAD_DIM = 256


def flash_attention_packed_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int
) -> torch.Tensor:
    """Unmasked softmax(q·kᵀ/√Dh)·v on packed (B, T, D) tensors, through
    the head-major ``mha`` (f32 scores and softmax)."""
    return merge_heads(
        mha(qkv_heads(q, n_heads), qkv_heads(k, n_heads), qkv_heads(v, n_heads))
    )


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Unmasked softmax(q·kᵀ/√Dh)·v on head-major (B, H, T, Dh) tensors
    (``mha``: f32 scores and softmax, the context in v's dtype)."""
    return mha(q, k, v)


def _check_operands(name: str, q, k, v) -> None:
    for which, x in (("q", q), ("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != torch.bfloat16 or x.device != q.device:
            raise ValueError(
                f"{name}: {which} must be bf16 {tuple(q.shape)} on {q.device}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name}: {which} must be contiguous")


def _launch(name: str, fn, q, k, v, out, *dims) -> None:
    for x in (q, k, v, out):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: pointers must be 16-byte aligned")
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *dims,
            0,  # consumer warpgroups per block: the kernel's choice
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(rc, name)


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
    _check_operands("flash_attention_packed", q, k, v)
    out = torch.empty_like(q)
    if b == 0 or t == 0:
        return out
    _launch("flash_attention_packed", _build.kernels().wis_flash_attention_packed,
            q, k, v, out, b, t, d, n_heads, float((d // n_heads) ** -0.5))
    launched(flash_attention_packed)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unmasked attention on head-major (B, H, T, Dh) q/k/v; output
    head-major. CUDA tensors run the kernel (bf16, contiguous, Dh a
    multiple of 8 up to ``MAX_HEAD_DIM``); CPU tensors run
    ``flash_attention_plain``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"flash_attention: want (B, H, T, Dh), got {tuple(q.shape)}")
    b, h, t, dh = q.shape
    if dh % 8 or not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention: head_dim {dh} is not a multiple of 8 up to {MAX_HEAD_DIM}"
        )
    _check_operands("flash_attention", q, k, v)
    out = torch.empty_like(q)
    if b == 0 or h == 0 or t == 0:
        return out
    _launch("flash_attention", _build.kernels().wis_flash_attention,
            q, k, v, out, b, h, t, dh, float(dh ** -0.5))
    launched(flash_attention)
    return out


flash_attention_packed.launches = 0
flash_attention.launches = 0
