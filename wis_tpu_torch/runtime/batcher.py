"""Dynamic batcher / inference executor (port of
``wis_tpu/runtime/batcher.py``).

A dedicated inference thread owns the device. Concurrent short (≤ 30 s,
single-window) requests that share (model, effective beam, timestamps,
word timestamps) are coalesced into one padded batch — per-row prompts
let mixed languages and tasks batch together — and dispatched as one
``transcribe_coalesced`` call. Long-form (chunked) requests run alone,
since they fill a batch with their own windows; ``word_timestamps``
batches run per request (each needs its own alignment call). Callers get
a ``concurrent.futures.Future``.

The drain has the JAX executor's three stages: requests that queued while
the device was busy join at once; a lone request lingers for
``batch_window_s``; a batch already coalescing admits stragglers in
``batch_admit_s`` windows under the absolute ``batch_admit_max_s``
deadline. An incompatible request is requeued for the next batch, an
engine failure is set on every waiting future, and ``None`` on the queue
stops the thread.

On a CUDA engine the thread makes the engine's device its current one
first (``torch.cuda.set_device`` is per thread), so a replica on
``cuda:N`` launches on that device's stream.

Tracing (``utils/timing``): ``submit`` gives each request a process-wide
monotonic ``id`` and stamps it; the thread marks a ``batcher.wait`` range
while it waits for the next request and a ``batcher.admit n=`` span over the
timed drain windows (n: the requests held while they wait), and each
dispatch leaves one ``asr_batch`` record with its requests' ids and, per
request, ``queued_ms`` (submit → taken off the queue by the thread) and
``held_ms`` (taken → its engine call starts).
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, List, Optional, Tuple

import numpy as np
import torch

from wis_tpu_torch.settings import APISettings
from wis_tpu_torch.utils.timing import StageTimer, serving, span

if TYPE_CHECKING:  # the engine imports this module for ASRRequest
    from wis_tpu_torch.runtime.engine import TranscriptionResult, WhisperEngine

logger = logging.getLogger("wis_tpu_torch")

#: request ids, monotonic across the process's executors
_request_ids = itertools.count(1)


@dataclass
class ASRRequest:
    audio: np.ndarray  # 16 kHz mono, float32 or int16
    model: str
    beam_size: int
    task: str = "transcribe"
    detect_language: bool = False
    force_language: Optional[str] = None
    translate: bool = False
    max_tokens: Optional[int] = None
    timestamps: bool = False
    word_timestamps: bool = False
    future: Future = field(default_factory=Future)
    #: set by ``InferenceExecutor.submit``
    id: int = 0
    #: perf_counter stamps: submitted, last taken off the queue
    t_submit: Optional[float] = field(default=None, repr=False)
    t_taken: Optional[float] = field(default=None, repr=False)

    def effective_beam(self, settings: APISettings) -> int:
        if self.audio.shape[0] / 16 >= settings.long_beam_size_threshold:
            return settings.long_beam_size
        return self.beam_size

    def is_long(self) -> bool:
        return self.audio.shape[0] > 30 * 16000

    def batch_key(self, settings: APISettings):
        # timestamped requests take another program; word_timestamps
        # requests run an alignment call each, so they never coalesce with
        # plain ones. Detect, forced and default-language rows do coalesce:
        # the program takes a per-row detect mask.
        return (
            self.model,
            self.effective_beam(settings),
            self.timestamps,
            self.word_timestamps,
        )


class InferenceExecutor:
    """Single consumer thread that owns device dispatch order."""

    def __init__(self, engine: "WhisperEngine", settings: Optional[APISettings] = None):
        self.engine = engine
        self.settings = settings or engine.settings
        self._queue: "queue.Queue[Optional[ASRRequest]]" = queue.Queue()
        self._thread = threading.Thread(
            target=self._worker, name="wis-inference", daemon=True
        )
        self._started = False
        self._lock = threading.Lock()

    def start(self) -> None:
        with self._lock:
            if not self._started:
                self._started = True
                self._thread.start()

    def shutdown(self) -> None:
        if self._started:
            self._queue.put(None)
            self._thread.join(timeout=5)
            self._started = False

    # ------------------------------------------------------------------ #
    def submit(self, req: ASRRequest) -> Future:
        self.start()
        req.id = next(_request_ids)
        req.t_submit = time.perf_counter()
        self._queue.put(req)
        return req.future

    def submit_sync(self, req: ASRRequest) -> "TranscriptionResult":
        return self.submit(req).result()

    @property
    def queue_depth(self) -> int:
        return self._queue.qsize()

    # ------------------------------------------------------------------ #
    def _take(self, block: bool = True, timeout: Optional[float] = None
              ) -> Optional[ASRRequest]:
        """The next item off the queue, a request stamped as taken (raises
        queue.Empty as ``Queue.get`` does)."""
        req = self._queue.get(block, timeout)
        if req is not None:
            req.t_taken = time.perf_counter()
        return req

    def _worker(self) -> None:
        device = getattr(self.engine, "device", None)
        if isinstance(device, torch.device) and device.type == "cuda":
            torch.cuda.set_device(device)
        while True:
            with span("batcher.wait"):
                req = self._take()
            if req is None:
                return
            with StageTimer("asr_batch") as timer:
                batch, stop = self._collect(req)
                timer.ids = [r.id for r in batch]
                self._run(batch, timer)
            if stop:
                return

    def _collect(self, req: ASRRequest) -> Tuple[List[ASRRequest], bool]:
        """→ (the batch that starts with ``req``, whether the shutdown
        sentinel was taken)."""
        batch = [req]
        if req.is_long():
            return batch, False
        max_batch = self.settings.batch_bucket_list()[-1]
        key = req.batch_key(self.settings)
        stop = False

        def drain(block_until: Optional[float]) -> bool:
            """Pull compatible requests into ``batch``; True when the batch
            is closed (full, an incompatible request or the shutdown
            sentinel). block_until=None: no wait."""
            nonlocal stop
            while len(batch) < max_batch:
                try:
                    if block_until is None:
                        nxt = self._take(block=False)
                    else:
                        tmo = block_until - time.monotonic()
                        if tmo <= 0:
                            return False
                        nxt = self._take(timeout=tmo)
                except queue.Empty:
                    return False
                if nxt is None:
                    stop = True
                    return True
                if nxt.is_long() or nxt.batch_key(self.settings) != key:
                    # incompatible: run what we have, requeue it
                    self._queue.put(nxt)
                    return True
                batch.append(nxt)
            return True

        # 1) requests that queued while the device was busy join this
        #    dispatch with no wait
        if drain(None):
            return batch, stop
        with span("batcher.admit", n=len(batch)):
            # 2) a lone request lingers one window for near-simultaneous
            #    arrivals
            full = False
            if len(batch) == 1:
                full = drain(time.monotonic() + self.settings.batch_window_s)
            # 3) a batch already coalescing admits stragglers: each window
            #    that lands one extends the wait, a silent one dispatches,
            #    and the whole wait is capped by an absolute deadline so a
            #    trickle cannot hold the first request
            deadline = time.monotonic() + self.settings.batch_admit_max_s
            while not full and not stop and 1 < len(batch) < max_batch:
                before = len(batch)
                until = min(time.monotonic() + self.settings.batch_admit_s, deadline)
                if until <= time.monotonic():
                    break
                full = drain(until)
                if len(batch) == before:
                    break
        return batch, stop

    def _run(self, batch: List[ASRRequest], timer: StageTimer) -> None:
        try:
            # word_timestamps batches (homogeneous by batch_key) run per
            # request: each needs its own alignment call
            if len(batch) == 1 or batch[0].word_timestamps:
                for r in batch:
                    _held(timer, [r])
                    with serving([r.id]):
                        res = self.engine.transcribe(
                            r.audio,
                            model=r.model,
                            beam_size=r.beam_size,
                            task=r.task,
                            detect_language=r.detect_language,
                            force_language=r.force_language,
                            translate=r.translate,
                            max_tokens=r.max_tokens,
                            timestamps=r.timestamps,
                            word_timestamps=r.word_timestamps,
                        )
                    r.future.set_result(res)
                return
            logger.debug("BATCHER: coalesced %d requests", len(batch))
            _held(timer, batch)
            with serving(timer.ids):
                results = self.engine.transcribe_coalesced(batch)
            for r, res in zip(batch, results):
                r.future.set_result(res)
        except Exception as e:  # propagate to all waiters
            logger.exception("BATCHER: inference failed")
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)


def _held(timer: StageTimer, reqs: List[ASRRequest]) -> None:
    """Record each request's queued_ms and held_ms as its engine call
    starts (requests put on the queue without ``submit`` have no submit
    stamp)."""
    now = time.perf_counter()
    for r in reqs:
        if r.t_submit is None or r.t_taken is None:
            continue
        timer.requests.append({"id": r.id, "queued_ms": (r.t_taken - r.t_submit) * 1e3,
                               "held_ms": (now - r.t_taken) * 1e3})
