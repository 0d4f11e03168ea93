"""What the omni program records about itself (``omni_call`` records of
``wis_tpu_torch/utils/timing``, written by ``runtime/engine.
transcribe_omni``), for the omni cell's readers: the records before the
traced slice, each traced ``omni_dispatch`` range with its record, and the
readings made of them. A program without these records (an older commit)
gives nothing to read, and each reader returns None."""

from __future__ import annotations

from typing import List, Optional, Tuple

from benchmark import program, readers, work, work_omni

#: the grouped expert kernel's two launches (``ops/moe_experts``; the
#: trace names each with its template arguments)
MOE_KERNELS = ("moe_gate_up_kernel", "moe_down_kernel")


def records(run) -> list:
    return program.records(run, "omni_call")


def dispatch_span(rec):
    return next((s for s in rec.spans if s.name == "omni_dispatch"), None)


def mfu(run) -> Optional[float]:
    """Useful FLOPs of the dispatches (``work_omni.dispatch_flops``) over
    their summed ``omni_dispatch`` time at the bf16 peak."""
    flops = seconds = 0.0
    for rec in records(run):
        s = dispatch_span(rec)
        if s is None or s.end is None:
            continue
        flops += work_omni.dispatch_flops(run.config, int(s.attrs["rows"]), rec.counts)
        seconds += s.end - s.start
    return 100.0 * flops / (seconds * work.BF16_FLOPS) if seconds > 0 else None


def step_ms(run) -> Optional[float]:
    return readers.median(program.span_ms(run, "omni_call", "omni.step"))


def experts_per_token(run) -> Optional[float]:
    recs = records(run)
    tokens = sum(r.counts.get("moe.tokens", 0) for r in recs)
    rows = sum(r.counts.get("moe.expert_rows", 0) for r in recs)
    return rows / tokens if tokens else None


def traced(run) -> List[Tuple[object, object]]:
    """(trace range, record) of each ``omni_dispatch`` range wholly inside
    the traced slice: the record whose ``omni_dispatch`` span began nearest
    to it on the trace's clock (within 20 ms)."""
    tr = run.trace
    if tr is None:
        return []
    try:
        from wis_tpu_torch.utils import timing
    except ImportError:
        return []
    recs = [t for t in getattr(timing, "recent", lambda: [])()
            if getattr(t, "kind", None) == "omni_call" and dispatch_span(t) is not None]
    out = []
    for rng in tr.ranges("omni_dispatch"):
        best = min(recs, key=lambda t: abs(tr.at(dispatch_span(t).start) - rng.ts), default=None)
        if best is not None and abs(tr.at(dispatch_span(best).start) - rng.ts) < 20e3:
            out.append((rng, best))
    return out


def moe_roofline(run) -> Optional[float]:
    """Σ least time of the grouped expert calls of the traced dispatches
    (their prefill's and their steps' apart: ``work_omni.moe_experts_ms``
    over the routing counters) over Σ device time of the two kernels."""
    cfg = run.config
    d, f = cfg["hidden_size"], cfg["dynamic_intermediate_size"]
    bound = spent = 0.0
    for rng, rec in traced(run):
        c = rec.counts
        if "moe.prefill_expert_rows" not in c:
            continue
        ops = readers.named(run.trace.launched_in(rng), MOE_KERNELS)
        if not ops:
            continue
        pre_rows, pre_touched = c["moe.prefill_expert_rows"], c["moe.prefill_experts_touched"]
        bound += work_omni.moe_experts_ms(touched=pre_touched, rows=pre_rows, d=d, f=f)
        bound += work_omni.moe_experts_ms(touched=c["moe.experts_touched"] - pre_touched,
                                          rows=c["moe.expert_rows"] - pre_rows, d=d, f=f)
        spent += readers.dur_s(ops) * 1e3
    return 100.0 * bound / spent if spent > 0 else None


def idle_share(run) -> Optional[float]:
    if run.trace is None:
        return None
    return readers.idle_share(run, [(h.ts, h.te) for h in run.trace.ranges("omni_dispatch")])
