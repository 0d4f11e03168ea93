"""The decode step's head: final LayerNorm, logits, per-beam top-k and
logsumexp (port of ``wis_tpu/ops/fused_logits.py``).

Replaces the TPU kernel ``build_fused_logits_topk``. On the card the head
is the hand-written CUDA of ``csrc/fused_logits.cu``: one pass over the
(V, D) embedding, bf16 or per-row int8, that keeps every (BK, V) tensor
out of device memory and leaves only each vocabulary chunk's top-k and
logsumexp partials, then a small kernel that folds them into the final
top-k and ``lse``. It is bound by the embedding's bytes.

``fused_logits_topk`` launches the kernels for CUDA tensors and counts one
launch per head call in ``fused_logits_topk.launches``; it takes the plain
version, ``fused_logits_topk_plain``, only for tensors on the CPU.

Not ported yet: the timestamp grammar (``grammar=True``: the per-beam
``ts_state`` masks, the timestamp-region logsumexp and the second
candidate set), which waits for the port's timestamp decoding;
``build_fused_logits_topk(grammar=True)`` raises.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from wis_tpu_torch.models.whisper.config import WhisperConfig
from wis_tpu_torch.ops import _build
from wis_tpu_torch.ops.layernorm import layer_norm_plain

NEG = -1e30
#: the most candidates per row the kernels take (the TPU kernel's KPAD)
KPAD = 8
#: the most rows (BK) the kernels take
MAX_ROWS = 32

Emb = Union[torch.Tensor, dict]


def _stable_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last axis, ties to the lower index
    (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def fused_logits_topk_plain(x, ln_g, ln_b, emb: Emb, sup, *, k: int,
                            full_lse: bool = False):
    """The head in plain PyTorch: x (BK, D) f32; emb (V, D) bf16 or the
    per-row int8 leaf {"q": (V, D) int8, "s": (V, 1) f32}; sup (V,) f32.
    → (cand_val (BK, k) f32 suppressed logits, cand_tok (BK, k) int64,
    lse (BK, 1) f32), lse over the suppressed logits, or over the raw ones
    with full_lse."""
    xn = layer_norm_plain(x.float(), ln_g, ln_b).to(torch.bfloat16).float()
    if isinstance(emb, dict):
        dot = (xn @ emb["q"].float().T) * emb["s"].float().reshape(1, -1)
    else:
        dot = xn @ emb.float().T
    logits = dot + sup.float()
    src = dot if full_lse else logits
    m = src.amax(dim=-1, keepdim=True)
    lse = m + torch.log(torch.clamp_min(torch.exp(src - m).sum(dim=-1, keepdim=True), 1e-30))
    vals, tok = _stable_top_k(logits, k)
    return vals, tok, lse


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_logits_topk: {msg}")


def fused_logits_topk(x, ln_g, ln_b, emb: Emb, sup, *, k: int, full_lse: bool = False):
    """The head; arguments and result as ``fused_logits_topk_plain``. CUDA
    tensors run ``csrc/fused_logits.cu`` (BK ≤ 32, k ≤ 8, D a multiple of
    16); CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return fused_logits_topk_plain(x, ln_g, ln_b, emb, sup, k=k, full_lse=full_lse)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    dev = x.device
    bk, d = x.shape
    _check(x.dtype == torch.float32, f"x must be f32 (BK, D), got {x.dtype}")
    _check(1 <= bk <= MAX_ROWS and 1 <= k <= KPAD, f"BK={bk} must be 1..{MAX_ROWS}, k={k} 1..{KPAD}")
    _check(d % 16 == 0, f"D={d} is not a multiple of 16")
    emb_int8 = isinstance(emb, dict)
    if emb_int8:
        table, scales = emb["q"], emb["s"]
        v = table.shape[0]
        _check(table.dtype == torch.int8 and table.shape == (v, d),
               f"emb q must be int8 (V, {d}), got {table.dtype} {tuple(table.shape)}")
        _check(scales.dtype == torch.float32 and scales.numel() == v,
               f"emb s must be f32 ({v}, 1), got {scales.dtype} {tuple(scales.shape)}")
    else:
        table, scales = emb, None
        v = table.shape[0]
        _check(table.dtype == torch.bfloat16 and table.shape == (v, d),
               f"emb must be bf16 (V, {d}), got {table.dtype} {tuple(table.shape)}")
    _check(sup.dtype == torch.float32 and sup.shape == (v,),
           f"sup must be f32 ({v},), got {sup.dtype} {tuple(sup.shape)}")
    ln = torch.stack([ln_g, ln_b]).float()
    tensors = [x, table, sup, ln] + ([scales] if emb_int8 else [])
    for t in tensors:
        _check(t.device == dev, f"every tensor must be on {dev}")
        _check(t.is_contiguous(), "every tensor must be contiguous")
        _check(t.data_ptr() % 16 == 0, "pointers must be 16-byte aligned")

    lib = _build.kernels()
    ws = torch.empty(lib.wis_fused_logits_workspace_bytes(bk, v, k), dtype=torch.uint8, device=dev)
    vals = torch.empty((bk, k), dtype=torch.float32, device=dev)
    tok = torch.empty((bk, k), dtype=torch.int64, device=dev)
    lse = torch.empty((bk, 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.wis_fused_logits_topk(
            x.data_ptr(), ln.data_ptr(), table.data_ptr(),
            scales.data_ptr() if emb_int8 else None, sup.data_ptr(),
            bk, d, v, k, int(full_lse), int(emb_int8),
            ws.data_ptr(), vals.data_ptr(), tok.data_ptr(), lse.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "fused_logits_topk")
    fused_logits_topk.launches += 1
    return vals, tok, lse


fused_logits_topk.launches = 0


def build_fused_logits_topk(
    cfg: WhisperConfig,
    *,
    bk: int,
    k: int,
    grammar: bool = False,
    ts_base: int = 0,
    eot: int = 0,
    full_lse: bool = False,
    emb_int8: bool = False,
):
    """Return head(x (bk, D) f32, ln_g, ln_b (D,), emb, sup (V,) f32) →
    (cand_val (bk, k) f32, cand_tok (bk, k) int64, lse (bk, 1) f32), the JAX
    package's signature. emb_int8: ``emb`` is the per-row int8 leaf
    (``ops/quant.quantize_rows`` of tok_emb), each row's scale applied after
    the dot; else the bf16 (V, D) table. full_lse: the logsumexp runs over
    the logits before suppression; candidates always use the suppressed
    values. ``ts_base`` and ``eot`` serve only the grammar mode, which is
    not ported yet."""
    del ts_base, eot
    if grammar:
        raise NotImplementedError(
            "the fused head's timestamp-grammar mode is not ported to wis_tpu_torch yet"
        )
    if not 1 <= k <= KPAD:
        raise ValueError(f"k={k} outside 1..{KPAD}")

    def head(x, ln_g, ln_b, emb, sup):
        if isinstance(emb, dict) != emb_int8:
            raise ValueError(f"head built with emb_int8={emb_int8} got the other embedding")
        if x.shape != (bk, cfg.n_text_state):
            raise ValueError(f"x {tuple(x.shape)} is not ({bk}, {cfg.n_text_state})")
        return fused_logits_topk(x, ln_g, ln_b, emb, sup, k=k, full_lse=full_lse)

    return head
