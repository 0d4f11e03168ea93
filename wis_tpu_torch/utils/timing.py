"""Spans and counts of the port's work, kept in memory (the port of
``wis_tpu/utils/timing.py``, grown into the port's one tracing mechanism).

A ``StageTimer`` is the record of one unit of work: its ``kind``
(``asr_call``: one engine call; ``asr_batch``: one batcher dispatch;
``tts_stream``: one TTS stream; ``omni_call``: one Uni-MoE-2.0-Omni
dispatch), the ids of the requests it served, its
bounds ``t0``/``t1`` on ``time.perf_counter`` (the clock a caller stamps
requests with), its spans (name, start, end, the span open around it on
its thread, attributes) and its counts. Entered as a context manager it is
the calling thread's current timer, and the module-level ``span`` and
``count`` record into whichever timer is current, so the decoding, model
and server code below the engine, the batcher and the TTS app records
without taking a timer. On exit a timer goes into a bounded process-wide
ring (``recent()``) and one debug line (``TIMING``).

A span costs two clock reads and an append. Only while a torch profiler
records does it also open a ``record_function`` range, named ``name k=v
...`` from its attributes, so every span appears in a profiler trace with
the shapes of its work. Nothing here reads the device: a span around a
host sync only times it.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Deque, Dict, Iterator, List, Optional, Sequence

import torch.autograd.profiler as _autograd_profiler
from torch.autograd.profiler import record_function

logger = logging.getLogger("wis_tpu_torch")

#: closed timers kept by ``recent()``
RING_SIZE = 4096

_ring: Deque["StageTimer"] = collections.deque(maxlen=RING_SIZE)
_ring_lock = threading.Lock()
_tls = threading.local()
_levels: Dict[str, int] = {}
_levels_lock = threading.Lock()


def profiling() -> bool:
    """True while a torch profiler records. torch.profiler sets this module
    flag for the whole process; ``torch.autograd._profiler_enabled()`` reads
    the calling thread's state only, and stays false on every thread under
    a profiler started with ``profile_all_threads``."""
    return _autograd_profiler._is_profiler_enabled


def _thread() -> threading.local:
    if not hasattr(_tls, "timers"):
        _tls.timers, _tls.open, _tls.ids = [], [], ()
    return _tls


@dataclass(slots=True)
class TimingSpan:
    name: str
    start: float
    end: Optional[float] = None
    #: the name of the span open around this one on its thread
    parent: Optional[str] = None
    attrs: Optional[Dict[str, object]] = None
    #: no span of its own timer was open around it
    top: bool = True

    @property
    def ms(self) -> float:
        end = self.end if self.end is not None else time.perf_counter()
        return (end - self.start) * 1000.0


def _range_name(name: str, attrs: Optional[Dict[str, object]]) -> str:
    """``asr_dispatch B=4 rows=3``: the form trace readers parse."""
    return name + "".join(f" {k}={v}" for k, v in attrs.items()) if attrs else name


class _Span:
    """One open span: recorded into ``timer`` (if any), and a profiler range
    while a profiler records."""

    __slots__ = ("timer", "span", "range")

    def __init__(self, timer: Optional["StageTimer"], name: str, attrs: Dict[str, object]):
        self.timer = timer
        self.span = TimingSpan(name, 0.0, attrs=attrs or None)
        self.range = None

    def __enter__(self) -> TimingSpan:
        st, s = _thread(), self.span
        if st.open:
            outer = st.open[-1]
            s.parent, s.top = outer.span.name, outer.timer is not self.timer
        if profiling():
            self.range = record_function(_range_name(s.name, s.attrs))
            self.range.__enter__()
        st.open.append(self)
        if self.timer is not None:
            self.timer.spans.append(s)
        s.start = time.perf_counter()
        return s

    def __exit__(self, *exc) -> None:
        self.span.end = time.perf_counter()
        _thread().open.pop()
        if self.range is not None:
            self.range.__exit__(*exc)


class StageTimer:
    """The spans and counts of one unit of work (module docstring). ``ids``
    defaults to those the calling thread is ``serving``."""

    def __init__(self, kind: str = "call", ids: Optional[Sequence[int]] = None):
        self.kind = kind
        self.ids = list(ids if ids is not None else _thread().ids)
        self.t0 = time.perf_counter()
        self.t1: Optional[float] = None
        self.spans: List[TimingSpan] = []
        self.counts: Dict[str, int] = {}
        #: per-request values of a batch (the batcher's queued_ms, held_ms)
        self.requests: List[Dict[str, float]] = []

    def __enter__(self) -> "StageTimer":
        _thread().timers.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _thread().timers.pop()
        self.t1 = time.perf_counter()
        with _ring_lock:
            _ring.append(self)
        if logger.isEnabledFor(logging.DEBUG):
            logger.debug("TIMING %s ids=%s %.2f ms %s counts=%s", self.kind, self.ids,
                         (self.t1 - self.t0) * 1e3, self.as_dict(), self.counts)

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def count(self, name: str, k: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + k

    def total_ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1000.0

    def as_dict(self) -> Dict[str, float]:
        """ms by name of the spans opened directly under this timer (those
        sharing a name sum); nested spans stay in ``spans``."""
        out: Dict[str, float] = {}
        for s in self.spans:
            if s.top:
                out[s.name] = round(out.get(s.name, 0.0) + s.ms, 3)
        return out


def current() -> Optional[StageTimer]:
    """The calling thread's current timer, if any."""
    timers = _thread().timers
    return timers[-1] if timers else None


def span(name: str, **attrs) -> _Span:
    """A span in the current timer; with none, only a profiler range (while
    a profiler records)."""
    return _Span(current(), name, attrs)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to a count of the current timer (nothing without one)."""
    timer = current()
    if timer is not None:
        timer.count(name, k)


@contextmanager
def serving(ids: Sequence[int]) -> Iterator[None]:
    """Timers made on this thread inside serve the requests ``ids``."""
    st = _thread()
    before, st.ids = st.ids, tuple(ids)
    try:
        yield
    finally:
        st.ids = before


def recent() -> List[StageTimer]:
    """The closed timers still in the ring, oldest first."""
    with _ring_lock:
        return list(_ring)


@contextmanager
def inside(name: str) -> Iterator[None]:
    """Count the holder in the process-wide level ``name`` while inside."""
    with _levels_lock:
        _levels[name] = _levels.get(name, 0) + 1
    try:
        yield
    finally:
        with _levels_lock:
            _levels[name] -= 1


def level(name: str) -> int:
    """How many holders are inside ``name`` now."""
    return _levels.get(name, 0)
