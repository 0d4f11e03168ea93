"""What the program records about itself (``wis_tpu_torch/utils/timing``):
its closed records (``asr_call``, ``asr_batch``, ``tts_stream``) that began
in the window and ended before the traced slice, which the profiler slows,
and the program's own ranges in the trace. A program without the ring or
the ranges (an older commit) gives every reader here nothing to read, and
each returns None."""

from __future__ import annotations

from typing import List, Optional

from benchmark import readers
from benchmark.trace import params


def records(run, kind: str) -> list:
    """The program's ``kind`` records with t0 ≥ the window's start and
    t1 ≤ ``run.t_stamps``."""
    try:
        from wis_tpu_torch.utils import timing
    except ImportError:
        return []
    recent = getattr(timing, "recent", None)
    if recent is None:
        return []
    return [t for t in recent() if getattr(t, "kind", None) == kind and t.t1 is not None
            and t.t0 >= run.t0 and t.t1 <= run.t_stamps]


def spans(recs, name: str) -> list:
    return [s for t in recs for s in t.spans if s.name == name]


def span_ms(run, kind: str, name: str) -> List[float]:
    return [(s.end - s.start) * 1e3 for s in spans(records(run, kind), name)]


def step_host_ms(run) -> Optional[float]:
    """Median over engine calls of the host time a decode step takes to
    launch: Σ ``asr.step`` ms over the call's ``asr.step`` count."""
    per_call = []
    for t in records(run, "asr_call"):
        n = t.counts.get("asr.step", 0)
        if n:
            per_call.append(sum((s.end - s.start) * 1e3 for s in spans([t], "asr.step")) / n)
    return readers.median(per_call)


def decode_idle_share(run) -> Optional[float]:
    """Idle share of the device inside the ``asr.decode`` ranges of the
    traced slice."""
    if run.trace is None:
        return None
    return readers.idle_share(run, [(h.ts, h.te) for h in run.trace.ranges("asr.decode")])


def encoder_ms_per_row(run) -> Optional[float]:
    """Median over the dispatches in the traced slice of the device time
    launched inside their ``asr.encode`` ranges, over the dispatch's real
    rows (``rows=``; its padding rows are paid for by the real ones)."""
    tr = run.trace
    if tr is None:
        return None
    encodes = tr.ranges("asr.encode")
    out = []
    for disp in tr.ranges("asr_dispatch"):
        rows = params(disp.name).get("rows")
        enc = [h for h in encodes if h.tid == disp.tid and disp.ts <= h.ts and h.te <= disp.te]
        if rows and enc:
            out.append(1e3 * sum(readers.dur_s(tr.launched_in(h)) for h in enc) / rows)
    return readers.median(out)
