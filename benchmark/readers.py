"""Arithmetic the metric readers (``metrics/<name>.py``) share: latencies
from the host clock, the engine's spans, the trace's kernel groups and
the model FLOPs of the served work. A reader that finds nothing to read
returns None, and the run leaves its metric out."""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Optional

from benchmark import stats, work
from benchmark.trace import params

# --------------------------------------------------------------------------- #
# Host clock
# --------------------------------------------------------------------------- #
def latencies_ms(run, stamp) -> List[float]:
    """Per request, from its due time to ``stamp(r)``; a failed request
    counts at the drain limit."""
    out = []
    for r in run.requests:
        end = stamp(r) if r["ok"] else None
        if end is None:
            end = run.t1 + run.drain_s
        out.append((end - r["due_abs"]) * 1e3)
    return out


def percentile(values: List[float], q: float) -> Optional[float]:
    return stats.percentile(values, q) if values else None


def p95(values: List[float]) -> Optional[float]:
    return percentile(values, 95)


# --------------------------------------------------------------------------- #
# The ASR engine's calls (RecordingEngine) and their StageTimer spans
# --------------------------------------------------------------------------- #
def calls(run) -> List[dict]:
    """The engine calls that ended in the window, before the traced slice."""
    return [c for c in run.system.calls if c["t1"] <= run.t_stamps]


def median(values: Iterable[float]) -> Optional[float]:
    values = list(values)
    return statistics.median(values) if values else None


def n_dispatches(call: dict) -> int:
    return sum(math.ceil(g["n"] / g["B"]) for g in call["groups"])


def asr_useful_flops(run, call: dict) -> float:
    """Model FLOPs of a call's real windows (padding rows left out): the
    encoder, the cross-KV, the prompt's prefill and, per beam row, each
    decode step its served tokens needed, with the logits head."""
    cfg = run.config
    d, layers, vocab = cfg["d_model"], cfg["decoder_layers"], cfg["vocab_size"]
    g = call["groups"][0]
    total = 0.0
    for toks, _, _ in call["served"]:
        total += work.whisper_encoder_flops(d=d, layers=cfg["encoder_layers"],
                                            n_mels=cfg["num_mel_bins"])
        total += work.whisper_cross_kv_flops(d=d, layers=layers)
        total += sum(work.whisper_decoder_token_flops(d=d, layers=layers, vocab=vocab, pos=p,
                                                      logits=p == g["P"] - 1)
                     for p in range(g["P"]))
        total += g["K"] * sum(work.whisper_decoder_token_flops(d=d, layers=layers, vocab=vocab,
                                                               pos=g["P"] + i)
                              for i in range(max(len(toks) - 1, 0)))
    return total


def asr_mfu(run) -> Optional[float]:
    cs = calls(run)
    seconds = sum(c["timings"].get("asr_dispatch", 0.0) for c in cs) / 1e3
    if not cs or seconds <= 0:
        return None
    return 100.0 * sum(asr_useful_flops(run, c) for c in cs) / (seconds * work.BF16_FLOPS)


# --------------------------------------------------------------------------- #
# The trace
# --------------------------------------------------------------------------- #
def named(ops, names) -> list:
    return [o for o in ops if any(n in o.name for n in names)]


def dur_s(ops) -> float:
    return sum(o.te - o.ts for o in ops) / 1e6


def idle_share(run, spans) -> Optional[float]:
    """1 − the device's busy time inside ``spans`` (on the trace's clock,
    cut to the traced slice) over their union's length."""
    tr = run.trace
    if tr is None:
        return None
    spans = stats.clip(spans, tr.lo, tr.hi)
    length = stats.union_length(spans)
    if length <= 0:
        return None
    busy = stats.covered_within([(o.ts, o.te) for o in tr.device], spans)
    return 100.0 * (1.0 - busy / length)


def asr_dispatches(run):
    """(the bench.windows range's shapes, the real rows, the asr_dispatch
    range) for each dispatch wholly inside the traced slice, of a range
    that began inside it. A range of n
    windows in buckets of B runs its g-th dispatch on min(n − g·B, B)
    real rows; the rest of the bucket is padding."""
    tr = run.trace
    if tr is None:
        return []
    out = []
    windows = tr.ranges("bench.windows", whole=False)
    seen = {}
    for disp in sorted(tr.ranges("asr_dispatch"), key=lambda d: d.ts):
        owner = next((w for w in windows if w.tid == disp.tid and w.ts <= disp.ts
                      and disp.te <= w.te), None)
        if owner is None or owner.ts < tr.lo:  # its earlier groups went untraced
            continue
        p = params(owner.name)
        g = seen.setdefault(id(owner), 0)
        seen[id(owner)] = g + 1
        out.append((p, min(p["n"] - g * p["B"], p["B"]), disp))
    return out


def decode_step_roofline(run, step_kernels, head_kernels) -> Optional[float]:
    """Σ least time of each fused step call over Σ device time of the
    step's kernels, in the dispatches inside the slice, counted over the
    real rows. Call i of a dispatch runs at cache position P + i; the
    columns it reads are at least the prompt's, replicated per beam row,
    and one per sequence for each generated position."""
    cfg = run.config
    bound = spent = 0.0
    for p, rows, disp in asr_dispatches(run):
        ops = run.trace.launched_in(disp)
        heads = named(ops, head_kernels)
        if not heads:
            continue
        K, P = p["K"], p["P"]
        bk = rows * K
        t_cache = -(-(P + p["M"]) // 128) * 128
        for i in range(len(heads)):
            bound += work.whisper_step_ms(
                L=cfg["decoder_layers"], D=cfg["d_model"], H=cfg["decoder_attention_heads"],
                bk=bk, n_seq=rows, s_audio=cfg["max_source_positions"], xa_elem=1,
                xa_scaled=True, picked=P * bk + i * rows, per_row_cols=P + i + 1,
                sel_numel=bk * t_cache * bk) / 1e3
        spent += dur_s(named(ops, step_kernels))
    return 100.0 * bound / spent if spent > 0 else None


def head_roofline(run, head_kernels) -> Optional[float]:
    """Σ least time of each fused logits/top-k call, over the real rows,
    over Σ its device time."""
    cfg = run.config
    bound = spent = 0.0
    for p, rows, disp in asr_dispatches(run):
        heads = named(run.trace.launched_in(disp), head_kernels)
        bk, k = rows * p["K"], (1 if p["K"] == 1 else p["K"] + 1)
        bound += len(heads) * work.whisper_head_ms(V=cfg["vocab_size"], D=cfg["d_model"],
                                                   bk=bk, k=k, int8=True, grammar=False) / 1e3
        spent += dur_s(heads)
    return 100.0 * bound / spent if spent > 0 else None
