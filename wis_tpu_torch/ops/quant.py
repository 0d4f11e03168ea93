"""Weight-only int8 quantization (port of ``wis_tpu/ops/quant.py:26-177``).

A weight leaf becomes ``{"q": int8 (..., K, N), "s": f32 (..., 1, N)}``
(per output channel) or, for the logits embedding, ``{"q": int8 (V, D),
"s": f32 (V, 1)}`` (per row). The quantizers are bit-for-bit the JAX
formulas: f32 absmax, ``max(absmax, 1e-8) / 127`` (as XLA computes it,
a multiply by the f32 reciprocal), round-half-even,
clip to ±127.

On the card, ``qmatmul`` sends an int8 leaf to ``int8_matmul``, the
hand-written W8A16 kernel of ``csrc/int8_matmul.cu`` that replaces the TPU
kernel ``wis_tpu/ops/quant_pallas.py`` ``int8_matmul``: x rounded to bf16
against the int8 weight made bf16 in the kernel, f32 accumulation, the f32
column scale applied once after the contraction, the output in x's dtype.
The gate is the JAX package's ``_use_pallas`` shape gate (a 2-D int8
weight, K and N multiples of 128) without its TPU opt-in; every Whisper
and XTTS product meets it, whatever the activations' float dtype. That is
the JAX package's ``WIS_PALLAS_QUANT`` numerics: the scale stays f32.
Elsewhere — the CPU, or a shape the gate refuses — ``qmatmul`` keeps the
JAX package's XLA-path numerics: the scale is cast to bf16 *before* the
multiply (``q.bf16 * s.bf16``, one bf16 rounding of the effective
weight), then the matmul accumulates in f32 and rounds to x's dtype.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Union

import torch

from wis_tpu_torch.ops import _build

QuantLeaf = Dict[str, torch.Tensor]
Weight = Union[torch.Tensor, QuantLeaf]


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def _quantize(w: torch.Tensor, dim: int) -> QuantLeaf:
    w32 = w.float()
    absmax = torch.amax(torch.abs(w32), dim=dim, keepdim=True)
    # XLA folds the division by the constant into a multiply by its f32
    # reciprocal; the port does the same to stay bit-equal
    scale = torch.clamp_min(absmax, 1e-8) * torch.tensor(1.0 / 127.0, dtype=torch.float32)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def quantize_weight(w: torch.Tensor) -> QuantLeaf:
    """Per-output-channel symmetric int8: scale (..., 1, N), so stacked
    (L, K, N) leaves quantize per (layer, output channel)."""
    return _quantize(w, dim=-2)


def quantize_rows(w: torch.Tensor) -> QuantLeaf:
    """Per-row symmetric int8 (scale over the last axis): the (V, D)
    logits embedding, each vocab row's scale applied after the dot."""
    return _quantize(w, dim=-1)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ b (K, N) with float32 output — the JAX package's
    ``preferred_element_type=float32`` on bf16 operands. On the card bf16
    operands go to a bf16 GEMM with an f32 result; elsewhere both upcast."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        y = torch.mm(a2, b, out_dtype=torch.float32)
    else:
        y = torch.mm(a2.float(), b.float())
    return y.reshape(*lead, b.shape[-1])


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The W8A16 product in plain PyTorch: ``(x @ q) * s`` in f32 with x
    rounded to bf16 first, the result in ``out_dtype`` (default x's
    dtype). x (M, K), q (K, N) int8, s (1, N) or (N,) f32."""
    y = x.to(torch.bfloat16).float() @ q.float()
    return (y * s.float().reshape(1, -1)).to(out_dtype or x.dtype)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"int8_matmul: {msg}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_counters: Dict[int, torch.Tensor] = {}


def _split_counters(device: torch.device, n: int) -> torch.Tensor:
    """The zeroed int32 counters a split product takes (one per column
    tile; each launch leaves them at 0), kept per device and grown as
    needed. Launches that share them must not overlap: the port issues
    its products on one stream."""
    have = _counters.get(device.index)
    if have is None or have.numel() < n:
        have = _counters[device.index] = torch.zeros(max(n, 64), dtype=torch.int32,
                                                     device=device)
    return have


def int8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y (M, N) = ``int8_matmul_plain(x, q, s, out_dtype)``: CUDA tensors
    run ``csrc/int8_matmul.cu`` (x of any float dtype, rounded to bf16 as
    the plain version does; K a multiple of 128 and N of 64), one launch
    per call (at most 64 rows, K split over the SMs, the splits summed in
    the same launch); CPU tensors run the plain version. The kernel stores
    bf16 for a bf16 ``out_dtype`` (default x's dtype) and f32 for any
    other, which is then cast."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, s, out_dtype)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    m, k = x.shape
    n = q.shape[-1]
    _check(x.is_floating_point(), f"x must be a float tensor, got {x.dtype}")
    _check(q.dtype == torch.int8 and q.shape == (k, n), f"q must be int8 ({k}, N), got "
           f"{q.dtype} {tuple(q.shape)}")
    _check(s.dtype == torch.float32 and s.numel() == n, f"s must be f32 with {n} scales")
    _check(k % 128 == 0 and n % 64 == 0, f"K={k} must be a multiple of 128, N={n} of 64")
    store = torch.bfloat16 if out_dtype == torch.bfloat16 else torch.float32
    y = torch.empty((m, n), dtype=store, device=x.device)
    if m == 0:
        return y.to(out_dtype)
    xb = x.to(torch.bfloat16)
    for t in (xb, q, s):
        _check(t.device == x.device, f"every tensor must be on {x.device}")
        _check(t.is_contiguous() and t.data_ptr() % 16 == 0, "tensors must be contiguous "
               "and 16-byte aligned")
    lib = _build.kernels()
    splits = lib.wis_int8_matmul_splits(m, k, n, _sm_count(x.device.index))
    part = torch.empty(splits * m * n if splits > 1 else 0, dtype=torch.float32,
                       device=x.device)
    sem = _split_counters(x.device, lib.wis_int8_matmul_counters(n))
    with torch.cuda.device(x.device):
        rc = lib.wis_int8_matmul(xb.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                                 part.data_ptr(), sem.data_ptr(), m, k, n, splits,
                                 int(store == torch.float32),
                                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "int8_matmul")
    int8_matmul.launches += 1
    return y.to(out_dtype)


int8_matmul.launches = 0


def _use_kernel(x: torch.Tensor, q: torch.Tensor) -> bool:
    """The JAX package's ``_use_pallas`` shape gate, on a CUDA tensor."""
    return x.is_cuda and q.dim() == 2 and q.shape[0] % 128 == 0 and q.shape[1] % 128 == 0


def qmatmul(x: torch.Tensor, w: Weight,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (..., K) @ w (K, N) with transparent int8 dequant; the output in
    ``out_dtype``, by default x's (f32: the sum before any rounding to
    x's dtype, as a row-parallel product's partials are reduced). On the
    card an int8 leaf that meets the gate runs the ``int8_matmul``
    kernel."""
    if is_quantized(w) and _use_kernel(x, w["q"]):
        y = int8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w["q"], w["s"], out_dtype)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    if is_quantized(w):
        # the scale rounds to bf16 before the multiply; the product (exact
        # in f32: 7 × 8 significant bits) rounds to bf16 only for a bf16
        # matmul — for f32 activations XLA keeps it f32 under jit
        s = w["s"].to(torch.bfloat16)
        w = w["q"].to(torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32) * s
    if out_dtype == torch.float32:
        return matmul_f32(x, w.to(x.dtype))
    return torch.matmul(x, w.to(x.dtype)).to(out_dtype or x.dtype)


#: whisper weight-leaf names eligible for int8 (matmul projections only)
_WHISPER_QUANT_KEYS = frozenset({"q_w", "k_w", "v_w", "o_w", "w1", "w2"})


def quantize_whisper_params(params: Dict) -> Dict:
    """Copy of a whisper param tree with the decoder's matmul weights
    quantized (the JAX package's production setting, its
    ``quantize_whisper_params`` defaults), plus a per-row int8 copy of
    ``tok_emb`` as ``tok_emb_q`` for the logits matmul; the original stays
    for embedding lookups."""

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for name, child in node.items():
                if (name in _WHISPER_QUANT_KEYS and isinstance(child, torch.Tensor)
                        and child.dim() >= 2):
                    out[name] = quantize_weight(child)
                else:
                    out[name] = walk(child)
            return out
        return node

    dec = walk(params["decoder"])
    dec["tok_emb_q"] = quantize_rows(dec["tok_emb"])
    return dict(params, decoder=dec)


#: XTTS GPT block matmul weights (models/xtts/gpt.py layout)
_GPT_QUANT_KEYS = ("q_w", "k_w", "v_w", "proj_w", "mlp_w1", "mlp_w2")


def quantize_gpt_params(params: Dict) -> Dict:
    """Copy of an XTTS GPT tree with the stacked block matmul weights
    quantized per output channel (the JAX package's production default);
    embeddings, LayerNorms and the audio-code head keep the working dtype."""
    blocks = dict(params["blocks"])
    for k in _GPT_QUANT_KEYS:
        blocks[k] = quantize_weight(blocks[k])
    return dict(params, blocks=blocks)
