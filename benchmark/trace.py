"""The device trace of a ``--trace 1`` run: taken with ``torch.profiler``
over a slice of the window and reduced here.

The profiler records CPU ranges on every thread (the executor's, the TTS
producers') and, through CUPTI, every kernel, copy and set on the device.
Each device operation is tied to the host range that launched it through
its correlation id. The harness marks its own ranges ``bench.*`` with the
shapes of the work inside them in the name (``bench.windows B=4 K=5``), so
the readers can count a kernel's work from the request shapes.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from benchmark import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
#: the main thread's range around the traced slice
SLICE = "bench.traced"


@dataclass
class Op:
    ts: float  # µs, the profiler's clock
    te: float
    name: str
    tid: int = 0
    corr: Optional[int] = None
    launch_tid: Optional[int] = None
    launch_ts: Optional[float] = None


@dataclass
class Trace:
    device: List[Op]
    host: List[Op]
    lo: float
    hi: float
    _by_tid: Dict[int, Tuple[List[float], List[Op]]] = field(default_factory=dict)
    #: the host clock (time.perf_counter) at the slice's start
    anchor: float = 0.0

    def at(self, t: float) -> float:
        """A host-clock time on the trace's clock (µs)."""
        return self.lo + (t - self.anchor) * 1e6

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def device_in(self, lo: Optional[float] = None, hi: Optional[float] = None) -> List[Op]:
        lo = self.lo if lo is None else lo
        hi = self.hi if hi is None else hi
        return [o for o in self.device if o.te > lo and o.ts < hi]

    def busy_s(self) -> float:
        return stats.union_length(stats.clip([(o.ts, o.te) for o in self.device],
                                             self.lo, self.hi)) / 1e6

    def ranges(self, prefix: str, whole: bool = True) -> List[Op]:
        """Host ranges whose name starts with ``prefix``; with ``whole``
        only those inside the slice from end to end."""
        out = [h for h in self.host if h.name.startswith(prefix)]
        if whole:
            out = [h for h in out if h.ts >= self.lo and h.te <= self.hi]
        return out

    def launched_in(self, rng: Op) -> List[Op]:
        """Device operations launched from inside a host range (its thread,
        its time)."""
        if not self._by_tid:
            for o in sorted((o for o in self.device if o.launch_ts is not None),
                            key=lambda o: o.launch_ts):
                self._by_tid.setdefault(o.launch_tid, ([], []))
                self._by_tid[o.launch_tid][0].append(o.launch_ts)
                self._by_tid[o.launch_tid][1].append(o)
        keys, ops = self._by_tid.get(rng.tid, ([], []))
        return ops[bisect.bisect_left(keys, rng.ts):bisect.bisect_right(keys, rng.te)]

    def innermost_at(self, points: List[float]) -> List[Optional[Op]]:
        """For each sorted time point, the shortest host range on any
        thread that covers it (each thread's ranges nest, so a sweep with
        a stack per thread finds its innermost one)."""
        best: List[Optional[Op]] = [None] * len(points)
        threads: Dict[int, List[Op]] = defaultdict(list)
        for h in self.host:
            if not h.name.startswith((SLICE, "ProfilerStep")):
                threads[h.tid].append(h)
        for ranges in threads.values():
            ranges.sort(key=lambda h: (h.ts, -h.te))
            stack: List[Op] = []
            j = 0
            for i, t in enumerate(points):
                while j < len(ranges) and ranges[j].ts <= t:
                    while stack and stack[-1].te < ranges[j].ts:
                        stack.pop()
                    stack.append(ranges[j])
                    j += 1
                while stack and stack[-1].te < t:
                    stack.pop()
                if stack:
                    h = stack[-1]
                    if best[i] is None or h.te - h.ts < best[i].te - best[i].ts:
                        best[i] = h
        return best

    # -------------------------------------------------------------- #
    def breakdown(self, n: int = 10) -> Dict[str, list]:
        """The device operations that took most time in the slice, and the
        idle time grouped by what the host was doing (the innermost host
        range over each gap's middle)."""
        by_name: Dict[str, float] = defaultdict(float)
        for o in self.device_in():
            by_name[o.name] += (min(o.te, self.hi) - max(o.ts, self.lo)) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        ops = [(name[:160], v) for name, v in ops]
        idle: Dict[str, float] = defaultdict(float)
        holes = stats.gaps([(o.ts, o.te) for o in self.device], self.lo, self.hi)
        owners = self.innermost_at([(a + b) / 2 for a, b in holes])
        for (a, b), h in zip(holes, owners):
            idle[_label(h.name) if h else "no host range"] += (b - a) / 1e6
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def _label(name: str) -> str:
    """A host range's name without the shapes the harness puts in it."""
    return name.split(" ", 1)[0]


_PARAM = re.compile(r"(\w+)=([-\w.]+)")


def params(name: str) -> Dict[str, float]:
    """``bench.windows B=4 K=5`` → {"B": 4, "K": 5}."""
    out = {}
    for k, v in _PARAM.findall(name):
        try:
            out[k] = int(v)
        except ValueError:
            out[k] = float(v)
    return out


def parse(events: List[dict]) -> Trace:
    """A chrome trace's events → the slice's device operations and host
    ranges, each device operation tied to its launch."""
    launches: Dict[int, Tuple[int, float]] = {}
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append(Op(ts, ts + dur, e.get("name", ""), corr=args.get("correlation")))
        elif cat in HOST_CATS:
            host.append(Op(ts, ts + dur, e.get("name", ""), tid=e.get("tid", 0)))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid", 0), ts)
    for o in device:
        if o.corr in launches:
            o.launch_tid, o.launch_ts = launches[o.corr]
    device.sort(key=lambda o: o.ts)
    marks = [h for h in host if h.name == SLICE]
    if not marks:
        raise RuntimeError(f"the trace has no {SLICE} range")
    return Trace(device, host, marks[0].ts, marks[0].te)


class SliceProfiler:
    """``torch.profiler`` over one slice of the window: CPU ranges on every
    thread and CUDA activity. ``prepare`` brings the profiler up before the
    window opens (its start takes seconds and would stall the served
    path), ``begin`` and ``end`` bound the slice, which a ``bench.traced``
    range marks, and ``end`` returns the parsed Trace. The trace file lives
    under TMPDIR and is removed after parsing."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function, schedule

        self._anchor = 0.0
        self._mark = record_function(SLICE)
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                             experimental_config=config)

    def prepare(self) -> None:
        self._prof.start()

    def begin(self) -> None:
        self._prof.step()
        self._anchor = time.perf_counter()
        self._mark.__enter__()

    def end(self) -> None:
        self._mark.__exit__(None, None, None)
        self._prof.step()
        self._prof.stop()

    def trace(self) -> Trace:
        """The slice's Trace, read once the run no longer serves: the
        export and its parse hold the interpreter for seconds."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                tr = parse(json.load(f)["traceEvents"])
        finally:
            os.remove(path)
        tr.anchor = self._anchor
        return tr
