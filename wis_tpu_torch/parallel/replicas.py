"""Per-device replica pool (port of ``wis_tpu/parallel/replicas.py``).

One ``ModelRegistry``, ``WhisperEngine`` and ``InferenceExecutor`` per
device, parameters placed on that device; requests go to the least-loaded
executor, round-robin on ties. No collectives are on this path.

By default the pool takes every visible CUDA device, ``cuda:0`` to
``cuda:<device_count() - 1>``. Without a CUDA device and without an
explicit ``devices`` list it raises: it never falls back to the CPU
(tests pass ``devices=["cpu", "cpu"]``).
"""

from __future__ import annotations

import itertools
import logging
from concurrent.futures import Future
from typing import List, Optional

import torch

from wis_tpu_torch.runtime.batcher import ASRRequest, InferenceExecutor
from wis_tpu_torch.runtime.engine import WhisperEngine
from wis_tpu_torch.runtime.residency import ModelRegistry
from wis_tpu_torch.settings import APISettings, get_api_settings

logger = logging.getLogger("wis_tpu_torch")


def cuda_devices() -> List[str]:
    """Every visible CUDA device; raises when there is none."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "ReplicaPool: no CUDA device is visible (pass devices= to place "
            "replicas explicitly)"
        )
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


class ReplicaPool:
    def __init__(
        self,
        settings: Optional[APISettings] = None,
        devices: Optional[list] = None,
    ):
        self.settings = settings or get_api_settings()
        devices = devices if devices is not None else cuda_devices()
        self.engines: List[WhisperEngine] = []
        self.executors: List[InferenceExecutor] = []
        for dev in devices:
            engine = WhisperEngine(ModelRegistry(self.settings, dev))
            self.engines.append(engine)
            self.executors.append(InferenceExecutor(engine, self.settings))
        self._rr = itertools.count()
        logger.info("REPLICAS: %d device replicas", len(self.executors))

    def start(self) -> None:
        for ex in self.executors:
            ex.start()

    @property
    def queue_depth(self) -> int:
        return sum(ex.queue_depth for ex in self.executors)

    def _pick(self) -> InferenceExecutor:
        # least-loaded; round-robin tiebreak
        start = next(self._rr) % len(self.executors)
        order = self.executors[start:] + self.executors[:start]
        return min(order, key=lambda e: e.queue_depth)

    def submit(self, req: ASRRequest) -> Future:
        return self._pick().submit(req)

    def submit_sync(self, req: ASRRequest):
        return self.submit(req).result()

    def preload(self) -> None:
        for engine in self.engines:
            engine.registry.preload()

    def warmup(self, **kw) -> None:
        for engine in self.engines:
            engine.warmup(**kw)

    def shutdown(self) -> None:
        for ex in self.executors:
            ex.shutdown()
