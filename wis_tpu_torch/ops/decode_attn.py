"""Beam self-attention with ancestry resolved at read time (port of
``wis_tpu/ops/decode_attn.py``).

Replaces the TPU kernel ``ancestry_attention``: one decode token's
self-attention for BK beam rows over unreordered physical cache rows,

    out[b, h, :] = softmax_s(q[b,h,:]·K[anc[b,s],h,:,s]·Dh^-0.5) · V[anc[b,s],h,:,s]

over s ≤ pos, scores and softmax in f32. ``anc (BK, T)`` names each row's
physical cache row per position; a negative entry reads a zero key and
value (the TPU kernel's one-hot selection). On the card it is the
hand-written CUDA of ``csrc/ancestry_attention.cu``: one block per (head,
time split, group of rows), the splits of a head one thread-block
cluster, every physical row's columns up to ``pos`` read once into shared
memory and selected there per logical row; the eager decoder's
self-attention (``models/whisper/model.py``) calls it on CUDA tensors.
The kernel takes head widths that are multiples of 8 up to
``MAX_HEAD_DIM``.

``ancestry_attention`` counts one launch per call in
``ancestry_attention.launches`` and takes the plain version,
``ancestry_attention_plain``, only for tensors on the CPU.
"""

from __future__ import annotations

import torch

from wis_tpu_torch.ops import _build
from wis_tpu_torch.ops.attention import NEG_INF
from wis_tpu_torch.ops.graphs import launched

#: widest head the kernel takes (a lane holds a quarter of a row's d values)
MAX_HEAD_DIM = 256


def global_rows(anc: torch.Tensor) -> torch.Tensor:
    """The decoder's (Bq, K, T) ancestry map, rows local to each group of K
    beams and -1 where nothing is written, → (Bq·K, T) int32 physical rows
    of the flat (Bq·K, ...) cache."""
    bq, k, t = anc.shape
    off = (torch.arange(bq, device=anc.device) * k)[:, None, None]
    return torch.where(anc >= 0, anc + off, -1).reshape(bq * k, t).to(torch.int32)


def ancestry_attention_plain(q, k_cache, v_cache, anc, pos: int) -> torch.Tensor:
    """The TPU oracle's formula with f32 weights: q (BK, H, Dh), k/v caches
    (BK, H, Dh, T), anc (BK, T) → (BK, H, Dh) in q's dtype."""
    bk, h, dh = q.shape
    t = k_cache.shape[-1]
    live = (anc >= 0)[:, None, None, :]
    idx = anc.long().clamp_min(0)[:, None, None, :].expand(bk, h, dh, t)
    k_sel = torch.gather(k_cache.float(), 0, idx) * live
    v_sel = torch.gather(v_cache.float(), 0, idx) * live
    scores = torch.einsum("bhd,bhdt->bht", q.float(), k_sel) * dh ** -0.5
    valid = torch.arange(t, device=q.device) <= pos
    w = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
    return torch.einsum("bht,bhdt->bhd", w, v_sel).to(q.dtype)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ancestry_attention: {msg}")


def ancestry_attention(q, k_cache, v_cache, anc, pos: int) -> torch.Tensor:
    """Arguments and result as ``ancestry_attention_plain``. CUDA tensors
    run ``csrc/ancestry_attention.cu`` (bf16 q and caches, int32 anc, Dh a
    multiple of 8 up to ``MAX_HEAD_DIM``); CPU tensors run the plain
    version."""
    if q.device.type == "cpu":
        return ancestry_attention_plain(q, k_cache, v_cache, anc, pos)
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    bk, h, dh = q.shape
    t = k_cache.shape[-1]
    _check(k_cache.shape == (bk, h, dh, t) and v_cache.shape == k_cache.shape,
           f"caches must be ({bk}, {h}, {dh}, T), got {tuple(k_cache.shape)} "
           f"{tuple(v_cache.shape)}")
    _check(q.dtype == k_cache.dtype == v_cache.dtype == torch.bfloat16,
           "q and the caches must be bf16")
    _check(anc.dtype == torch.int32 and anc.shape == (bk, t), f"anc must be int32 ({bk}, {t})")
    _check(dh % 8 == 0 and 0 < dh <= MAX_HEAD_DIM,
           f"head_dim {dh} is not a multiple of 8 up to {MAX_HEAD_DIM}")
    _check(0 <= pos < t, f"pos={pos} outside the cache's {t} columns")
    for x in (q, k_cache, v_cache, anc):
        _check(x.device == q.device, f"every tensor must be on {q.device}")
        _check(x.is_contiguous(), "every tensor must be contiguous")
    out = torch.empty_like(q)
    lib = _build.kernels()
    with torch.cuda.device(q.device):
        rc = lib.wis_ancestry_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), anc.data_ptr(),
            bk, h, dh, t, int(pos), dh ** -0.5, out.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(rc, "ancestry_attention")
    launched(ancestry_attention)
    return out


ancestry_attention.launches = 0
