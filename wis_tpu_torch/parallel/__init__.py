"""Parallelism: per-device replicas of the port's engine
(``replicas.ReplicaPool``), and the ("data", "model") mesh with its
Megatron tensor-parallel specs over ``torch.distributed`` (``mesh.py``;
``axis.py`` holds what the model code sees of it; ``world.run_world``
starts a world of local processes, one per rank).

The mesh names load on first use, so the model layers that import
``parallel.axis`` do not pull in ``mesh.py`` and the model configs it
reads."""

import importlib

__all__ = [
    "make_mesh",
    "whisper_param_specs",
    "shard_params",
    "replicate_params",
]


def __getattr__(name):
    if name in __all__:
        return getattr(importlib.import_module("wis_tpu_torch.parallel.mesh"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
