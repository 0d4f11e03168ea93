"""The decode step's head: final LayerNorm, logits, per-beam top-k and
logsumexp (port of ``wis_tpu/ops/fused_logits.py``).

Replaces the TPU kernel ``build_fused_logits_topk``. On the card the head
is the hand-written CUDA of ``csrc/fused_logits.cu``, one launch: one
block per SM streams its range of the (V, D) embedding (bf16 or per-row
int8) through the tensor cores, keeps every (BK, V) tensor out of device
memory and leaves only its running top-k and logsumexp pair per row; the
last block to finish (a split counter of ``ops/quant``) folds them into
the final top-k and ``lse``. It is bound by the embedding's bytes.

Grammar mode (``grammar=True``) folds whisper's timestamp grammar in:
per-beam ``ts_state (BK, 4)`` int32 rows (need_ts, need_text, min_ts, pad)
mask the logits against global token ids, and the kernel also keeps the
timestamp region's logsumexp, the best text logit and a second top-k
restricted to timestamps; a row whose timestamp mass beats its best text
token takes the timestamp candidates (and, unless full_lse, the region's
logsumexp) — the TPU kernel's force rule.

``fused_logits_topk`` launches the kernels for CUDA tensors and counts one
launch per head call in ``fused_logits_topk.launches`` (and the grammar
mode's again in ``fused_logits_topk.grammar.launches``); it takes the plain
version, ``fused_logits_topk_plain``, only for tensors on the CPU.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from wis_tpu_torch.models.whisper.config import WhisperConfig
from wis_tpu_torch.ops import _build
from wis_tpu_torch.ops.graphs import launched
from wis_tpu_torch.ops.layernorm import layer_norm_plain
from wis_tpu_torch.ops.quant import _split_counters

NEG = -1e30
#: the most candidates per row the kernels take (the TPU kernel's KPAD)
KPAD = 8
#: the most rows (BK) the kernels take
MAX_ROWS = 32
#: the widest row the kernel's shared memory holds at MAX_ROWS rows
MAX_D = 1472

Emb = Union[torch.Tensor, dict]


def _stable_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last axis, ties to the lower index
    (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _lse(src: torch.Tensor) -> torch.Tensor:
    """m + log(max(Σ exp(src − m), 1e-30)) over the last axis; columns at
    NEG add exactly zero."""
    m = src.amax(dim=-1, keepdim=True)
    s = torch.where(src > NEG * 0.5, torch.exp(src - m), 0.0).sum(dim=-1, keepdim=True)
    return m + torch.log(torch.clamp_min(s, 1e-30))


def apply_grammar(logits, ts_state, ts_base: int, eot: int):
    """The timestamp grammar on (BK, V) logits, the JAX package's eager
    masks: need_ts bans ids below eot, need_text bans timestamps, ids in
    [ts_base, min_ts) are banned, and a row whose timestamp logsumexp beats
    its best text logit bans every non-timestamp id."""
    ids = torch.arange(logits.shape[-1], device=logits.device)
    is_ts = ids >= ts_base
    ts = ts_state.long()
    bad = (
        ((ts[:, 0:1] > 0) & (ids < eot))
        | ((ts[:, 1:2] > 0) & is_ts)
        | (is_ts & (ids < ts[:, 2:3]))
    )
    logits = torch.where(bad, NEG, logits)
    force = _lse(logits[:, ts_base:]) > logits[:, :ts_base].amax(dim=-1, keepdim=True)
    return torch.where(force & ~is_ts, NEG, logits)


def fused_logits_topk_plain(x, ln_g, ln_b, emb: Emb, sup, *, k: int,
                            full_lse: bool = False, ts_state=None, ts_base: int = 0,
                            eot: int = 0):
    """The head in plain PyTorch: x (BK, D) f32; emb (V, D) bf16 or the
    per-row int8 leaf {"q": (V, D) int8, "s": (V, 1) f32}; sup (V,) f32.
    → (cand_val (BK, k) f32 suppressed logits, cand_tok (BK, k) int64,
    lse (BK, 1) f32), lse over the suppressed logits, or over the raw ones
    with full_lse. With ``ts_state`` (BK, 4) the timestamp grammar
    (``apply_grammar``) masks the suppressed logits first."""
    xn = layer_norm_plain(x.float(), ln_g, ln_b).to(torch.bfloat16).float()
    if isinstance(emb, dict):
        dot = (xn @ emb["q"].float().T) * emb["s"].float().reshape(1, -1)
    else:
        dot = xn @ emb.float().T
    logits = dot + sup.float()
    if ts_state is not None:
        logits = apply_grammar(logits, ts_state, ts_base, eot)
    vals, tok = _stable_top_k(logits, k)
    return vals, tok, _lse(dot if full_lse else logits)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_logits_topk: {msg}")


def fused_logits_topk(x, ln_g, ln_b, emb: Emb, sup, *, k: int, full_lse: bool = False,
                      ts_state=None, ts_base: int = 0, eot: int = 0):
    """The head; arguments and result as ``fused_logits_topk_plain``. CUDA
    tensors run ``csrc/fused_logits.cu`` (BK ≤ 32, k ≤ 8, D a multiple of
    32 up to MAX_D); CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return fused_logits_topk_plain(x, ln_g, ln_b, emb, sup, k=k, full_lse=full_lse,
                                       ts_state=ts_state, ts_base=ts_base, eot=eot)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    dev = x.device
    bk, d = x.shape
    _check(x.dtype == torch.float32, f"x must be f32 (BK, D), got {x.dtype}")
    _check(1 <= bk <= MAX_ROWS and 1 <= k <= KPAD, f"BK={bk} must be 1..{MAX_ROWS}, k={k} 1..{KPAD}")
    _check(d % 32 == 0 and 32 <= d <= MAX_D, f"D={d} is not a multiple of 32 up to {MAX_D}")
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
    _check(k <= v, f"k={k} above V={v}")
    _check(sup.dtype == torch.float32 and sup.shape == (v,),
           f"sup must be f32 ({v},), got {sup.dtype} {tuple(sup.shape)}")
    ln = torch.stack([ln_g, ln_b]).float()
    tensors = [x, table, sup, ln] + ([scales] if emb_int8 else [])
    grammar = ts_state is not None
    if grammar:
        _check(ts_state.dtype == torch.int32 and ts_state.shape == (bk, 4),
               f"ts_state must be int32 ({bk}, 4), got {ts_state.dtype} {tuple(ts_state.shape)}")
        tensors.append(ts_state)
    for t in tensors:
        _check(t.device == dev, f"every tensor must be on {dev}")
        _check(t.is_contiguous(), "every tensor must be contiguous")
        _check(t.data_ptr() % 16 == 0, "pointers must be 16-byte aligned")

    lib = _build.kernels()
    ws = torch.empty(lib.wis_fused_logits_workspace_bytes(bk, v, k, int(grammar)),
                     dtype=torch.uint8, device=dev)
    vals = torch.empty((bk, k), dtype=torch.float32, device=dev)
    tok = torch.empty((bk, k), dtype=torch.int64, device=dev)
    lse = torch.empty((bk, 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.wis_fused_logits_topk(
            x.data_ptr(), ln.data_ptr(), table.data_ptr(),
            scales.data_ptr() if emb_int8 else None, sup.data_ptr(),
            ts_state.data_ptr() if grammar else None,
            bk, d, v, k, int(full_lse), int(emb_int8), int(ts_base), int(eot),
            ws.data_ptr(), vals.data_ptr(), tok.data_ptr(), lse.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream, _split_counters(dev, 1).data_ptr(),
        )
    _build.check(rc, "fused_logits_topk")
    launched(fused_logits_topk)
    if grammar:
        launched(fused_logits_topk.grammar)
    return vals, tok, lse


fused_logits_topk.launches = 0
#: the grammar mode's launches, counted again as an entry of their own
fused_logits_topk.grammar = type("fused_logits_topk(grammar)", (), {"launches": 0})


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
    """Return head(x (bk, D) f32, ln_g, ln_b (D,), emb, sup (V,) f32[,
    ts_state (bk, 4) int32]) → (cand_val (bk, k) f32, cand_tok (bk, k)
    int64, lse (bk, 1) f32), the JAX package's signature. emb_int8: ``emb``
    is the per-row int8 leaf (``ops/quant.quantize_rows`` of tok_emb), each
    row's scale applied after the dot; else the bf16 (V, D) table.
    full_lse: the logsumexp runs over the logits before suppression;
    candidates always use the suppressed values. grammar: the head takes
    ``ts_state`` and applies the timestamp grammar with the token-id
    constants ``ts_base`` and ``eot``."""
    if not 1 <= k <= KPAD:
        raise ValueError(f"k={k} outside 1..{KPAD}")

    def head(x, ln_g, ln_b, emb, sup, ts_state=None):
        if isinstance(emb, dict) != emb_int8:
            raise ValueError(f"head built with emb_int8={emb_int8} got the other embedding")
        if x.shape != (bk, cfg.n_text_state):
            raise ValueError(f"x {tuple(x.shape)} is not ({bk}, {cfg.n_text_state})")
        if (ts_state is not None) != grammar:
            raise ValueError(f"head built with grammar={grammar} takes ts_state "
                             f"{'(bk, 4)' if grammar else 'None'}")
        return fused_logits_topk(x, ln_g, ln_b, emb, sup, k=k, full_lse=full_lse,
                                 ts_state=ts_state, ts_base=ts_base, eot=eot)

    return head
