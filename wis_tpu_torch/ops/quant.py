"""Weight-only int8 quantization (port of ``wis_tpu/ops/quant.py:26-177``).

A weight leaf becomes ``{"q": int8 (..., K, N), "s": f32 (..., 1, N)}``
(per output channel) or, for the logits embedding, ``{"q": int8 (V, D),
"s": f32 (V, 1)}`` (per row). The quantizers are bit-for-bit the JAX
formulas: f32 absmax, ``max(absmax, 1e-8) / 127`` (as XLA computes it,
a multiply by the f32 reciprocal), round-half-even,
clip to ±127.

``qmatmul`` keeps the JAX package's XLA-path numerics: the scale is cast
to bf16 *before* the multiply (``q.bf16 * s.bf16``, one bf16 rounding of
the effective weight in a bf16 matmul), then the matmul accumulates in f32
and rounds to x's dtype.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

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


def qmatmul(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """x (..., K) @ w (K, N) with transparent int8 dequant; output dtype
    follows x."""
    if is_quantized(w):
        # the scale rounds to bf16 before the multiply; the product (exact
        # in f32: 7 × 8 significant bits) rounds to bf16 only for a bf16
        # matmul — for f32 activations XLA keeps it f32 under jit
        s = w["s"].to(torch.bfloat16)
        w = w["q"].to(torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32) * s
    return torch.matmul(x, w.to(x.dtype))


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
