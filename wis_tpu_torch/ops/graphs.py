"""CUDA graphs in the port: the one place that captures a graph and counts
what a kernel entry launches.

Every counted kernel entry of ``ops/`` ends its CUDA path in
``launched(entry)``: eagerly that adds to the entry's ``launches``; on a
stream being captured, to the capture's tally, which each replay adds to
``launches``, so a replayed kernel counts as an eager one.

A ``GraphPool`` is a graph memory pool: a capture takes over the pool
memory the captures before it freed, never their outputs, so the pool's
owner replays its graphs one at a time on one stream. ``capture`` holds
one process-wide lock and, after the caller's stream, runs on the
device's one capture stream (the allocator reuses a block on its own
stream only): ``warm()`` eagerly (kernels built, cuBLAS up; its launches
taken back), then ``body()`` captured in ``thread_local`` mode, so other
threads go on launching.
"""

from __future__ import annotations

import gc
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

#: one capture at a time in the process, so ``_tally`` is that capture's
_LOCK = threading.Lock()
#: entry → launches on a capturing stream since the capture began
_tally: Dict[Any, int] = {}
#: device → the stream its captures run on, made at the first
_streams: Dict[torch.device, torch.cuda.Stream] = {}


def launched(entry, n: int = 1) -> None:
    """Count ``n`` launches of a kernel entry in its ``launches``, or in
    the capture's tally while the current stream is being captured.
    Called on an entry's CUDA path only."""
    if torch.cuda.is_current_stream_capturing():
        _tally[entry] = _tally.get(entry, 0) + n
    else:
        entry.launches += n


def _count(tally: Dict[Any, int], times: int) -> None:
    for entry, n in tally.items():
        entry.launches += n * times


@dataclass
class Graph:
    """A captured graph, ``out`` (what its body returned), ``tally``
    (entry → launches in one replay) and ``bytes`` (what the capture grew
    its pool by)."""

    graph: torch.cuda.CUDAGraph
    out: Any
    tally: Dict[Any, int]
    bytes: int

    def replay(self, times: int = 1):
        """Replay ``times`` times on the current stream, counting each
        replay's launches → ``out``."""
        for _ in range(times):
            self.graph.replay()
        _count(self.tally, times)
        return self.out


class GraphPool:
    """A graph memory pool on ``device``, made at the first capture."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.handle = None

    def capture(self, body: Callable[[], Any], warm: Optional[Callable[[], Any]] = None) -> Graph:
        with _LOCK:
            self.handle = self.handle or torch.cuda.graph_pool_handle()
            if self.device not in _streams:
                _streams[self.device] = torch.cuda.Stream(self.device)
            cur, side = torch.cuda.current_stream(self.device), _streams[self.device]
            side.wait_stream(cur)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                (warm or body)()
                _tally.clear()
                reserved = torch.cuda.memory_reserved(self.device)
                collect = gc.isenabled()
                gc.disable()  # a graph the collector frees mid-capture would end the capture
                graph.capture_begin(pool=self.handle, capture_error_mode="thread_local")
                try:
                    out = body()
                finally:
                    graph.capture_end()
                    if collect:
                        gc.enable()
                code = Graph(graph, out, dict(_tally),
                             torch.cuda.memory_reserved(self.device) - reserved)
            cur.wait_stream(side)
        _count(code.tally, -1)  # the warm-up's launches
        return code
