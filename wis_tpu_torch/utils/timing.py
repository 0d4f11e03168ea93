"""Per-stage wall-clock spans for one request (the port of
``wis_tpu/utils/timing.py``). ``trace=True`` spans also appear in a
``torch.profiler`` trace as ``record_function`` ranges."""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import torch

logger = logging.getLogger("wis_tpu_torch")


@dataclass
class TimingSpan:
    name: str
    start: float
    end: Optional[float] = None

    @property
    def ms(self) -> float:
        end = self.end if self.end is not None else time.perf_counter()
        return (end - self.start) * 1000.0


@dataclass
class StageTimer:
    """Collects named wall-clock spans for one request."""

    spans: List[TimingSpan] = field(default_factory=list)
    _t0: float = field(default_factory=time.perf_counter)

    @contextmanager
    def span(self, name: str, trace: bool = False) -> Iterator[TimingSpan]:
        s = TimingSpan(name, time.perf_counter())
        self.spans.append(s)
        try:
            if trace:
                with torch.profiler.record_function(name):
                    yield s
            else:
                yield s
        finally:
            s.end = time.perf_counter()
            logger.debug("TIMING: %s took %.2f ms", name, s.ms)

    def total_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1000.0

    def as_dict(self) -> Dict[str, float]:
        """Spans sharing a name sum."""
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s.name] = round(out.get(s.name, 0.0) + s.ms, 3)
        return out
