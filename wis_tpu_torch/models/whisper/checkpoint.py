"""Cache of a converted parameter tree (counterpart of
``wis_tpu/models/whisper/checkpoint.py``).

The JAX package caches a converted HF checkpoint as an Orbax checkpoint
under ``<model_dir>/_converted``; the port keeps its own cache beside it,
``<model_dir>/_converted_torch/params-<dtype>.pt`` (``torch.save`` of the
tree, read back with ``torch.load(weights_only=True)`` straight onto the
device), so a restart skips the safetensors conversion. Neither package
reads the other's cache. A failed save or restore only logs a warning.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import torch

from wis_tpu_torch.device import DeviceLike

logger = logging.getLogger("wis_tpu_torch")

CONVERTED_SUBDIR = "_converted_torch"


def converted_path(model_dir: str, dtype: torch.dtype) -> str:
    """The cache file of ``model_dir``'s tree converted to ``dtype``."""
    name = str(dtype).removeprefix("torch.")
    return os.path.join(model_dir, CONVERTED_SUBDIR, f"params-{name}.pt")


def save_params(params: Dict, path: str) -> bool:
    tmp = f"{path}.tmp"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(params, tmp)
        os.replace(tmp, path)
        logger.info("CHECKPOINT: saved params to %s", path)
        return True
    except Exception as e:  # noqa: BLE001
        logger.warning("CHECKPOINT: save failed (%s)", e)
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def load_params(path: str, device: DeviceLike) -> Optional[Dict]:
    if not os.path.isfile(path):
        return None
    try:
        params = torch.load(path, map_location=torch.device(device), weights_only=True)
        logger.info("CHECKPOINT: restored params from %s", path)
        return params
    except Exception as e:  # noqa: BLE001
        logger.warning("CHECKPOINT: restore failed (%s)", e)
        return None
