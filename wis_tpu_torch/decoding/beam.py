"""KV-cached greedy / beam-search decoding (port of
``wis_tpu/decoding/beam.py`` ``build_generate_xa``: the ancestry branch and
the fused branch).

Semantics are the JAX package's, step for step (its module docstring
describes them): per-beam top-(K+1) candidates, a global 2K pool, running
beams are the best K that did not finish, finished candidates within the
global top-K merge into a K-slot store scored
``sum_logprob / gen_len**length_penalty``, HF's ``early_stopping=False``
heuristic, suppress and begin-suppress masks, and ``renorm_suppressed`` in
both orders. Beams never permute the KV cache: the (B, K, T) ancestry map
names each logical beam's physical row per position (``model.py``).

The loop runs eagerly, one host check of the exit condition per token.
Under the caller's current timer (``utils/timing``) it records the spans
``asr.prefill`` (prefill, cache layout, cross-KV flattening and int8
columns: ``prefill_state``) and ``asr.decode`` (the loop), and in the loop
an ``asr.step`` (the host launching one step and its selection) and an
``asr.sync`` (the exit check, the host blocked on the device) with their
counts. The fused branch on a CUDA device, given the model's prefill slots,
replays the whole prefill from a captured graph (``decoding/prefill_slots``,
counted there); every other prefill runs eagerly and counts
``asr.prefill_eager``.
``fused=True`` runs each token through the fused decode step and the fused
head (``ops/fused_decode``, ``ops/fused_logits``) on the kernels' layouts,
as the JAX package's fused branch does.
``jax.lax.top_k`` breaks ties toward the lower index and ``torch.topk``
promises no order, so every top-k here is a stable descending sort.

``tp`` (this rank's ``parallel/axis.ModelAxis``, with ``params`` its
shard) runs the eager decoder tensor-parallel, as the JAX package's
GSPMD path runs its eager (``fused=False``) branch: the fused step keeps
whole heads of every layer in one launch, with no place for a per-layer
all-reduce, so ``fused=True`` with ``tp`` is refused. The logits reach
every rank with the same bits, so every rank takes the same host
decisions.

``with_timestamps=True`` applies whisper's timestamp grammar as the JAX
package does: the first token must be a timestamp of at most
``MAX_INITIAL_TS_INDEX`` steps (1 s), timestamps come in non-decreasing
begin/end pairs, text cannot follow an unpaired timestamp, and a row whose
timestamp mass beats its best text token must emit a timestamp. Each
running beam carries (prev_ts, prevprev_ts, max_ts); the eager branch masks
the logits (``ops.fused_logits.apply_grammar``), the fused branch hands the
same rules to the head as ``ts_state`` rows.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wis_tpu_torch.models.whisper.config import WhisperConfig
from wis_tpu_torch.models.whisper.model import DecoderCache, decode_step, prefill
from wis_tpu_torch.models.whisper.tokenizer import EOT, layout_for_vocab
from wis_tpu_torch.ops.attention import NEG_INF
from wis_tpu_torch.ops.fused_decode import build_fused_decode_step, quantize_xa_columns
from wis_tpu_torch.ops.fused_logits import apply_grammar, build_fused_logits_topk
from wis_tpu_torch.parallel.axis import ModelAxis
from wis_tpu_torch.utils.timing import count, span

#: HF beam search's "effectively -inf" gating constant
GATE = -1.0e9
#: the latest timestamp the first token may take: 50 steps of 20 ms
#: (openai's max_initial_timestamp of 1 s, the JAX package's default)
MAX_INITIAL_TS_INDEX = 50


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # (B, K, max_new) int64, EOT-padded
    lengths: torch.Tensor  # (B, K) int64 — emitted tokens incl. EOT
    scores: torch.Tensor  # (B, K) f32 — length-normalized logprob
    best: torch.Tensor  # (B,) int64 — argmax beam per sequence


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last axis, descending, ties to the lower index
    (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _suppress_mask(n_vocab: int, suppress: Tuple[int, ...]) -> np.ndarray:
    m = np.zeros((n_vocab,), dtype=np.float32)
    m[list(suppress)] = NEG_INF
    return m


class Prefill(NamedTuple):
    """The decode loop's start, as the prompt prefill leaves it."""

    first_lp: torch.Tensor  # (B, V) f32 — the first token's masked log-probabilities
    cache: DecoderCache  # each beam's copy of the prompt's K/V (fused: flat time-major)
    anc: torch.Tensor  # (B, K, T) int64 — the ancestry map over the prompt
    beam_rows: torch.Tensor  # (K,) int64
    xa: Optional[Tuple[torch.Tensor, ...]]  # fused: the kernel-layout cross-KV (k, v[, s])
    boff: Optional[torch.Tensor]  # fused: (B, 1, 1) each sequence's first beam row
    bk_rows: Optional[torch.Tensor]  # fused: (BK,)


def prefill_state(
    cfg: WhisperConfig,
    params: dict,
    prompt: torch.Tensor,  # (B, P) int64
    xa_kv: Tuple[torch.Tensor, torch.Tensor],
    begin_sup: torch.Tensor,  # (V,) f32 — the first token's suppress mask
    *,
    beams: int,
    cache_len: int,
    fused: bool,
    xa_int8: bool,
    renorm_suppressed: bool,
    tp: Optional[ModelAxis] = None,
) -> Prefill:
    """The prompt through the decoder on batch B (``model.prefill``), the
    first token's log-probabilities, each beam's cache and the ancestry
    map; fused, the kernels' layouts: caches (L, D, T·B·K) flat time-major
    and cross-KV (L, H, Dh, B·S_pad), int8 per column with ``xa_int8``
    (``build_generate_xa``). The same work at every call of one shape: on
    the card the fused program replays it from a graph
    (``decoding/prefill_slots``)."""
    K = beams
    B, prompt_len = prompt.shape
    device = xa_kv[0].device
    dtype = params["decoder"]["tok_emb"].dtype
    cache0 = DecoderCache.zeros(cfg, B, cache_len, dtype, device, tp)
    logits, cache0 = prefill(params, prompt, cache0, xa_kv, cfg, tp)
    first_raw = logits[:, -1]  # (B, V) f32
    first_masked = first_raw + begin_sup
    first_lse = torch.logsumexp(
        first_masked if renorm_suppressed else first_raw, dim=-1, keepdim=True
    )
    first_lp = first_masked - first_lse

    xa = boff = bk_rows = None
    if fused:
        H, L = cfg.n_text_head, cfg.n_text_layer
        Dh = cfg.n_text_state // H
        s_pad = ((cfg.n_audio_ctx + 127) // 128) * 128

        # flat time-major (L, D, T·B·K): column (t·B + b)·K + k, so each
        # position's BK rows are one contiguous block
        def flat_tmajor(c):  # (L, B, H, Dh, T)
            flat = c.reshape(L, B, H * Dh, cache_len).permute(0, 2, 3, 1)
            return flat.reshape(L, H * Dh, cache_len * B).repeat_interleave(K, dim=-1)

        cache = DecoderCache(flat_tmajor(cache0.k), flat_tmajor(cache0.v), cache0.pos)

        def flat_xa(x):  # (L, B, H, Dh, S) → (L, H, Dh, B·S_pad)
            t = F.pad(x.permute(0, 2, 3, 1, 4), (0, s_pad - cfg.n_audio_ctx))
            return t.reshape(L, H, Dh, B * s_pad)

        xa = (flat_xa(xa_kv[0]), flat_xa(xa_kv[1]))
        if xa_int8:
            xa = quantize_xa_columns(*xa)
        boff = (torch.arange(B, device=device) * K)[:, None, None]
        bk_rows = torch.arange(B * K, device=device)
    else:
        cache = DecoderCache(
            cache0.k.repeat_interleave(K, dim=1),
            cache0.v.repeat_interleave(K, dim=1),
            cache0.pos,
        )
    # ancestry: prompt positions live in each beam's own (replicated)
    # row; unwritten positions are -1 (masked)
    own_row = torch.arange(K, device=device)[None, :, None].expand(B, K, cache_len)
    anc = torch.where(
        torch.arange(cache_len, device=device)[None, None, :] < prompt_len,
        own_row,
        -1,
    )
    beam_rows = torch.arange(K, device=device)
    return Prefill(first_lp, cache, anc, beam_rows, xa, boff, bk_rows)


def build_generate_xa(
    cfg: WhisperConfig,
    *,
    beam_size: int,
    batch: int,
    max_new_tokens: int,
    prompt_len: int,
    suppress_tokens: Tuple[int, ...],
    begin_suppress_tokens: Tuple[int, ...],
    length_penalty: float = 1.0,
    with_timestamps: bool = False,
    fused: bool = False,
    xa_int8: bool = False,
    renorm_suppressed: bool = True,
    eot_id: Optional[int] = None,
    tp: Optional[ModelAxis] = None,
):
    """Return generate(params, xa_kv, prompt, token_cap, slots=None) →
    GenerateResult.

    xa_kv: cross-attention K/V for ``batch`` windows (``model.cross_kv``);
    prompt: (prompt_len,) shared or (batch, prompt_len) per sequence;
    token_cap: runtime cap ≤ max_new_tokens (int or 0-d tensor).
    renorm_suppressed=False normalizes over the full distribution before
    masking (HF order); eot_id overrides the EOT id. with_timestamps
    applies the timestamp grammar (module docstring).

    fused=True: generate(params, packed, xa_kv, prompt, token_cap,
    slots=None), with ``packed = ops.fused_decode.pack_decoder(params,
    cfg)``. Each token runs the fused step over the kernel layouts — caches
    (L, D, T·BK) flat time-major with T rounded up to a multiple of 128 (the
    prefill still runs the eager decoder and its cache is flattened once),
    cross-KV (L, H, Dh, B·S_pad) with each window zero-padded — and then the
    fused head, int8 when the tree carries ``tok_emb_q``. xa_int8 (fused
    only) quantizes the flattened cross-KV per column once before the loop
    (``quantize_xa_columns``). ``slots``, the model's prefill slots
    (``decoding/prefill_slots.PrefillSlots``, ``LoadedModel.prefill_slots``):
    on a CUDA device the prefill replays from the slot of
    ``generate.prefill_key``, shared by every program of the model with
    that key; elsewhere, and for the eager branch, it is ignored.

    tp: this rank's model axis; ``params`` and ``xa_kv`` are its shard
    (eager only: ``fused=True`` with ``tp`` raises)."""
    if fused and tp is not None:
        raise ValueError("the fused decode step runs on one device: tensor parallelism "
                         "(tp) takes the eager decoder (fused=False)")
    ts_base = layout_for_vocab(cfg.n_vocab).timestamp_base
    eot = EOT if eot_id is None else int(eot_id)
    K, B = beam_size, batch
    BK = B * K
    KC = 1 if K == 1 else K + 1  # per-beam candidates (K non-EOT + EOT)
    POOL = 2 * K
    cache_len = prompt_len + max_new_tokens
    if fused:
        # the kernels' flat (time, beam) axis, as in the JAX package
        cache_len = ((cache_len + 127) // 128) * 128
        step_fn = build_fused_decode_step(
            cfg, bk=BK, t_cache=cache_len, s_audio=cfg.n_audio_ctx,
            n_seq=B, xa_int8=xa_int8,
        )
        head_kw = dict(bk=BK, k=KC, grammar=with_timestamps, ts_base=ts_base, eot=eot,
                       full_lse=not renorm_suppressed)
        head_fn = build_fused_logits_topk(cfg, **head_kw)
        head_fn_q = build_fused_logits_topk(cfg, emb_int8=True, **head_kw)
    base_suppress = tuple(suppress_tokens)
    if with_timestamps:
        base_suppress += (layout_for_vocab(cfg.n_vocab).no_timestamps,)
    begin_extra = tuple(begin_suppress_tokens) + base_suppress
    if with_timestamps:
        # the first token is a timestamp, at most MAX_INITIAL_TS_INDEX in
        begin_extra += tuple(range(0, ts_base))
        begin_extra += tuple(range(ts_base + MAX_INITIAL_TS_INDEX + 1, cfg.n_vocab))
    sup_np = _suppress_mask(cfg.n_vocab, base_suppress)
    begin_np = _suppress_mask(cfg.n_vocab, begin_extra)
    #: device → (sup, begin_sup), made once per device
    masks = {}
    run_prefill = functools.partial(
        prefill_state, cfg, beams=K, cache_len=cache_len, fused=fused, xa_int8=xa_int8,
        renorm_suppressed=renorm_suppressed, tp=tp,
    )
    #: what the prefill's work depends on beyond the model: programs with
    #: one key share a prefill slot (``decoding/prefill_slots``)
    prefill_key = (B, K, prompt_len, cache_len, xa_int8, tuple(suppress_tokens),
                   tuple(begin_suppress_tokens), with_timestamps, renorm_suppressed)

    def _norm_len(n):
        """Length-penalty denominator: generated length incl. EOT."""
        n = torch.as_tensor(n, dtype=torch.float32)
        return n if length_penalty == 1.0 else n ** length_penalty

    def _generate(params, packed, xa_kv, prompt, token_cap, slots) -> GenerateResult:
        """``_run``, with the prefill slot of ``prefill_key`` on the card,
        holding the slots until the loop that reads its outputs has been
        launched."""
        if not (fused and slots is not None and xa_kv[0].device.type == "cuda"):
            return _run(params, packed, xa_kv, prompt, token_cap, None)
        with slots.lock:
            return _run(params, packed, xa_kv, prompt, token_cap, slots.get(prefill_key))

    def _run(params, packed, xa_kv, prompt, token_cap, slot) -> GenerateResult:
        device = xa_kv[0].device
        if device not in masks:
            masks[device] = (torch.from_numpy(sup_np).to(device),
                             torch.from_numpy(begin_np).to(device))
        sup, begin_sup = masks[device]
        cap_eff = max(min(max_new_tokens, int(token_cap)), 1)

        # ---- prefill on batch B ---- #
        with span("asr.prefill"):
            prompt = prompt.to(device=device, dtype=torch.long)
            prompt_b = prompt.expand(B, prompt_len) if prompt.dim() == 1 else prompt
            if slot is None:
                count("asr.prefill_eager")
                pre = run_prefill(params, prompt_b, xa_kv, begin_sup)
            else:
                pre = slot.run(functools.partial(run_prefill, params), prompt_b, xa_kv,
                               begin_sup)
        first_lp, cache, anc, beam_rows, xa_f, boff, bk_rows = pre

        def ts_rows(ts):
            """(prev_ts, prevprev_ts, max_ts) (B, K) → the head's ts_state
            (BK, 4) int32: need_ts (an open pair), need_text (a closed
            pair), the least legal timestamp id (equality with the last
            timestamp only while its pair is open), pad."""
            prev, prevprev, max_ts = ts
            open_pair = prev & ~prevprev
            min_ts = torch.where(open_pair, max_ts, max_ts + 1)
            return torch.stack(
                [open_pair.reshape(BK), (prev & prevprev).reshape(BK),
                 min_ts.reshape(BK), torch.zeros_like(min_ts.reshape(BK))],
                dim=1,
            ).to(torch.int32)

        def run_fused_step(tokens, cache, anc, ts):
            # sel from the PRE-update ancestry: the current position is
            # still -1 and selects nothing; the step's own K/V join through
            # the kernel's self column. Offsetting by b·K keeps each beam
            # inside its own sequence's rows.
            ganc = torch.where(anc >= 0, anc + boff, -1).reshape(BK, cache_len)
            sel = (ganc[..., None] == bk_rows).float().reshape(BK, cache_len * BK)
            dec = params["decoder"]
            x_emb = (
                dec["tok_emb"][tokens.reshape(BK)].float()
                + dec["pos"][cache.pos].float()[None]
            )
            x_out, kc, vc = step_fn(packed, x_emb, cache.k, cache.v, *xa_f, sel, cache.pos)
            anc = anc.clone()
            anc[:, :, cache.pos] = beam_rows
            if "tok_emb_q" in dec:
                head, emb = head_fn_q, dec["tok_emb_q"]
            else:
                head, emb = head_fn, dec["tok_emb"]
            cand_val, cand_tok, lse = head(
                x_out, dec["ln"]["g"], dec["ln"]["b"], emb, sup,
                *(() if ts is None else (ts_rows(ts),)),
            )
            return cand_val, cand_tok, lse, DecoderCache(kc, vc, cache.pos + 1), anc

        def run_step(tokens, cache, anc, ts):
            """Decoder step for the running beams' last tokens and, with
            timestamps, their grammar state → (cand_val (BK, KC), cand_tok
            (BK, KC), lse (BK, 1), cache, anc with the current position
            marked as each beam's own row)."""
            if fused:
                return run_fused_step(tokens, cache, anc, ts)
            anc = anc.clone()
            anc[:, :, cache.pos] = beam_rows
            logits, cache = decode_step(
                params, tokens.reshape(BK), cache, xa_kv, cfg, anc=anc, tp=tp
            )  # (BK, V) f32
            masked = logits + sup
            if ts is not None:
                masked = apply_grammar(masked, ts_rows(ts), ts_base, eot)
            cand_val, cand_tok = top_k(masked, KC)
            lse = torch.logsumexp(
                masked if renorm_suppressed else logits, dim=-1, keepdim=True
            )
            return cand_val, cand_tok, lse, cache, anc

        with span("asr.decode"):
            if K == 1:
                return _greedy(first_lp, cache, anc, run_step, cap_eff, device)
            return _beam(first_lp, cache, anc, run_step, cap_eff, device)

    if fused:
        def generate(params, packed, xa_kv, prompt, token_cap, slots=None) -> GenerateResult:
            return _generate(params, packed, xa_kv, prompt, token_cap, slots)
    else:
        def generate(params, xa_kv, prompt, token_cap, slots=None) -> GenerateResult:
            return _generate(params, None, xa_kv, prompt, token_cap, slots)
    generate.prefill_key = prefill_key

    # ------------------------------------------------------------------
    # Greedy (K == 1): argmax each step, stop at the first EOT
    # ------------------------------------------------------------------
    def _ts_init(tokens):
        """Grammar state after the first token: a lone leading timestamp
        counts as a closed pair (text must follow it)."""
        if not with_timestamps:
            return None
        return (tokens >= ts_base, torch.ones_like(tokens, dtype=torch.bool),
                torch.clamp_min(tokens, ts_base))

    def _greedy(first_lp, cache, anc, run_step, cap_eff, device):
        sum_lp, tokens = top_k(first_lp, 1)  # (B, 1)
        out = torch.full((B, 1, max_new_tokens), eot, dtype=torch.long, device=device)
        out[:, :, 0] = tokens
        finished = tokens == eot
        out_len = torch.ones((B, 1), dtype=torch.long, device=device)
        ts = _ts_init(tokens)
        t = 1
        while t < cap_eff and not _host_check(finished.all()):
            count("asr.step")
            with span("asr.step"):
                cand_val, cand_tok, lse, cache, anc = run_step(tokens, cache, anc, ts)
                lp = (cand_val - lse).reshape(B, 1)
                tok = torch.where(finished, eot, cand_tok.reshape(B, 1))
                out[:, :, t] = tok
                sum_lp = sum_lp + torch.where(finished, 0.0, lp)
                out_len = torch.where(finished, out_len, out_len + 1)
                if ts is not None:  # finished rows keep their state
                    prev, prevprev, max_ts = ts
                    tok_ts = tok >= ts_base
                    ts = (torch.where(finished, prev, tok_ts),
                          torch.where(finished, prevprev, prev),
                          torch.where(tok_ts & ~finished, torch.maximum(max_ts, tok), max_ts))
                finished = finished | (tok == eot)
                tokens = tok
                t += 1
        scores = sum_lp / _norm_len(out_len)
        best = torch.zeros((B,), dtype=torch.long, device=device)
        return GenerateResult(tokens=out, lengths=out_len, scores=scores, best=best)

    # ------------------------------------------------------------------
    # Beam search (K ≥ 2): HF-compatible hypothesis store. `_select`
    # applies one round of HF's candidate processing to a DESC-sorted
    # pool of P global candidates.
    # ------------------------------------------------------------------
    def _beam(first_lp, cache, anc, run_step, cap_eff, device):
        def _select(vals, toks, parents, cand_out, t, fin, unsat):
            P = vals.shape[1]
            hits = (toks == eot) | (t + 1 >= cap_eff)  # (B, P)

            # running beams: best K candidates that did NOT finish
            run_vals = vals + hits.float() * GATE
            new_lp, rsel = top_k(run_vals, K)
            new_tok = torch.gather(toks, 1, rsel)
            new_parent = torch.gather(parents, 1, rsel)
            new_out = torch.gather(
                cand_out, 1, rsel[..., None].expand(-1, -1, max_new_tokens)
            )

            # finished candidates: hits within the global top-K, gated off
            # once the early-stop heuristic is satisfied
            topmask = (torch.arange(P, device=device) < K)[None, :]
            f = vals / _norm_len(t + 1)
            f = f + (~(hits & topmask)).float() * GATE
            f = f + (~unsat).float()[:, None] * GATE
            m_scores = torch.cat([fin[1], f], dim=1)  # (B, K+P)
            m_out = torch.cat([fin[0], cand_out], dim=1)
            m_len = torch.cat([fin[2], torch.full_like(toks, t + 1)], dim=1)
            m_fin = torch.cat([fin[3], hits & topmask], dim=1)
            fin_scores, msel = top_k(m_scores, K)
            new_fin = (
                torch.gather(m_out, 1, msel[..., None].expand(-1, -1, max_new_tokens)),
                fin_scores,
                torch.gather(m_len, 1, msel),
                torch.gather(m_fin, 1, msel),
            )

            # early stop (HF early_stopping=False): every slot holds a real
            # hypothesis and the best running beam cannot beat the worst
            best_possible = new_lp[:, :1] / _norm_len(t + 1)  # (B, 1)
            worst = torch.where(
                new_fin[3], fin_scores.amin(dim=1, keepdim=True), GATE
            )  # (B, K)
            new_unsat = unsat & (best_possible > worst).any(dim=-1)
            return new_lp, new_tok, new_parent, new_out, new_fin, new_unsat

        fin = (
            torch.full((B, K, max_new_tokens), eot, dtype=torch.long, device=device),
            torch.full((B, K), GATE, dtype=torch.float32, device=device),
            torch.zeros((B, K), dtype=torch.long, device=device),
            torch.zeros((B, K), dtype=torch.bool, device=device),
        )

        # ---- init: candidates from the prefill distribution (a single
        # pseudo-beam, like HF's [0, -1e9, ...] score init) ---- #
        vals0, tok0 = top_k(first_lp, KC)  # (B, KC)
        cand_out0 = torch.full(
            (B, KC, max_new_tokens), eot, dtype=torch.long, device=device
        )
        cand_out0[:, :, 0] = tok0
        sum_lp, tokens, _, out, fin, unsat = _select(
            vals0,
            tok0,
            torch.zeros((B, KC), dtype=torch.long, device=device),
            cand_out0,
            0,
            fin,
            torch.ones((B,), dtype=torch.bool, device=device),
        )
        ts = _ts_init(tokens)
        t = 1
        while t < cap_eff and _host_check(unsat.any()):
            count("asr.step")
            with span("asr.step"):
                cand_val, cand_tok, lse, cache, anc = run_step(tokens, cache, anc, ts)
                cand_lp = (cand_val - lse).reshape(B, K, KC)
                total = sum_lp[..., None] + cand_lp  # (B, K, KC)
                vals, idx = top_k(total.reshape(B, K * KC), POOL)
                parent = idx // KC
                tok = torch.gather(cand_tok.reshape(B, K * KC), 1, idx)
                cand_out = torch.gather(
                    out, 1, parent[..., None].expand(-1, -1, max_new_tokens)
                )  # (B, POOL, max_new)
                cand_out[:, :, t] = tok
                sum_lp, tokens, new_parent, out, fin, unsat = _select(
                    vals, tok, parent, cand_out, t, fin, unsat
                )
                # re-parent: the ancestry map absorbs the permutation
                anc = torch.gather(anc, 1, new_parent[..., None].expand(-1, -1, cache_len))
                if ts is not None:
                    prev, prevprev, max_ts = (torch.gather(a, 1, new_parent) for a in ts)
                    tok_ts = tokens >= ts_base
                    ts = (tok_ts, prev, torch.where(tok_ts, torch.maximum(max_ts, tokens), max_ts))
                t += 1

        # the store is top_k-sorted best-first; argmax kept for the
        # interface contract
        best = torch.argmax(fin[1], dim=1)
        return GenerateResult(tokens=fin[0], lengths=fin[2], scores=fin[1], best=best)

    return generate


def _host_check(flag: torch.Tensor) -> bool:
    """The loop's one host sync a token: a 0-d bool tensor read on the
    host, timed as an ``asr.sync`` span and counted."""
    count("asr.sync")
    with span("asr.sync"):
        return bool(flag)


def trim_tokens(tokens: np.ndarray, length: int) -> np.ndarray:
    """Host-side: cut a beam's token row at its emitted length, dropping
    the trailing EOT if present."""
    row = np.asarray(tokens[:length])
    if length > 0 and row[-1] == EOT:
        row = row[:-1]
    return row
