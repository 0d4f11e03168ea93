"""Model registry (port of ``wis_tpu/runtime/residency.py``).

Loads a whisper size lazily onto one explicit device: the config, the
weights, int8 quantization when ``settings.quant`` is int8 (decoder
matmul weights plus ``tok_emb_q``, ``ops/quant.py``), and the tokenizer.
A load that would take the resident parameters past
``settings.hbm_budget_bytes`` (with the JAX package's headroom for
activations and caches) is refused with ``MemoryError``, as in the JAX
package.

Weights come from one of two sources:
- a bridged tree (``jax_trees[size]``): numpy arrays in the JAX package's
  layout, served exactly as given — quantize before bridging if the tree
  should be int8 (the JAX registry's loaded trees already are);
- otherwise ``load_or_init_params`` on the size's model directory: an HF
  checkpoint there (``*.safetensors``) is converted on the device and
  cached under ``_converted_torch``; without one, seeded random weights
  are made on the device. The seed is a stable CRC of the size name. (The
  JAX registry seeds with ``hash(size)``, which Python salts per process;
  the port does not reproduce that.)

Beside the Whisper sizes it holds Uni-MoE-2.0-Omni under its name
(``models/unimoe``; ``LoadedOmni``): its checkpoint's safetensors in its
model directory converted on the device, else seeded weights
(``load_or_init_omni``), in bf16 with the router in float32, under the
same budget.
"""

from __future__ import annotations

import logging
import os
import threading
import zlib
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from wis_tpu_torch.decoding.prefill_slots import PrefillSlots
from wis_tpu_torch.device import DeviceLike, resolve_device
from wis_tpu_torch.models.unimoe.config import OmniConfig, is_omni, omni_config
from wis_tpu_torch.models.unimoe.weights import load_or_init as load_or_init_omni
from wis_tpu_torch.models.whisper.config import (
    WHISPER_CONFIGS,
    WhisperConfig,
    resolve_model_name,
)
from wis_tpu_torch.models.whisper.tokenizer import WhisperTokenizer, layout_for_vocab
from wis_tpu_torch.models.whisper.weights import load_or_init_params, params_from_jax
from wis_tpu_torch.ops.fused_decode import PackedDecoder
from wis_tpu_torch.settings import APISettings

logger = logging.getLogger("wis_tpu_torch")

#: activation + KV-cache headroom reserved out of the device-memory budget
#: (the JAX package's ``_HEADROOM_BYTES``)
_HEADROOM_BYTES = 4 * 1024**3


def stable_seed(size: str) -> int:
    """The random-weight seed for a model size: the same in every process."""
    return zlib.crc32(size.encode()) % 2**31


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


@dataclass
class LoadedModel:
    name: str
    cfg: WhisperConfig
    params: Dict
    tokenizer: WhisperTokenizer
    param_bytes: int
    #: the fused step's repacked decoder weights, filled on first use by
    #: the engine (``WhisperEngine._packed_decoder``)
    packed: Optional[PackedDecoder] = None
    #: the size's asset directory (tokenizer, alignment heads), if any
    model_dir: Optional[str] = None
    #: the fused programs' prompt prefills by key, each replayed from a
    #: captured graph on the card (``decoding/prefill_slots``); filled at
    #: first use, shared by every program of the model
    prefill_slots: PrefillSlots = field(default_factory=PrefillSlots)


@dataclass
class LoadedOmni:
    """Uni-MoE-2.0-Omni's speech-to-text path (``models/unimoe``)."""

    name: str
    cfg: OmniConfig
    params: Dict
    param_bytes: int
    model_dir: Optional[str] = None
    #: the decode step's slots by batch bucket (``decoding/omni.StepSlot``),
    #: made by the engine at first use
    slots: Dict = field(default_factory=dict)


class ModelRegistry:
    """Lazy, thread-safe model store on one device."""

    def __init__(
        self,
        settings: APISettings,
        device: DeviceLike,
        jax_trees: Optional[Dict[str, Dict]] = None,
    ):
        self.settings = settings
        self.device = resolve_device(device)
        self.dtype = getattr(torch, settings.dtype)
        if self.device.type == "cuda" and self.dtype != torch.bfloat16:
            # the encoder's flash attention kernel takes bf16 only
            raise ValueError(
                f"dtype {settings.dtype!r} on {self.device}: the CUDA path "
                "runs bfloat16 activations"
            )
        self.jax_trees = dict(jax_trees or {})
        self._models: Dict[str, LoadedModel] = {}
        self._lock = threading.Lock()
        self._tokenizer: Optional[WhisperTokenizer] = None

    def tokenizer(self) -> WhisperTokenizer:
        """Shared tokenizer across sizes, from the first model directory
        that has one, else the placeholder vocabulary."""
        if self._tokenizer is None:
            for size in ("base", "tiny", "small", "medium", "large"):
                d = self._model_dir(size)
                if d:
                    self._tokenizer = WhisperTokenizer.from_dir(d)
                    break
            else:
                self._tokenizer = WhisperTokenizer()
        return self._tokenizer

    def _model_dir(self, size: str) -> Optional[str]:
        root = self.settings.model_dir
        for candidate in (
            os.path.join(root, size),
            os.path.join(root, f"whisper-{size}"),
            os.path.join(root, f"tovera-wis-whisper-{size}"),
        ):
            if os.path.isdir(candidate):
                return candidate
        return None

    def resident_bytes(self) -> int:
        return sum(m.param_bytes for m in self._models.values())

    def would_fit(self, cfg: WhisperConfig) -> bool:
        need = cfg.hbm_bytes(2 if self.dtype == torch.bfloat16 else 4)
        return (
            self.resident_bytes() + need + _HEADROOM_BYTES
            <= self.settings.hbm_budget_bytes
        )

    def get(self, name: str) -> LoadedModel:
        if is_omni(name):
            return self._get_omni(name)
        size = resolve_model_name(name)
        with self._lock:
            if size in self._models:
                return self._models[size]
            cfg = WHISPER_CONFIGS[size]
            if not self.would_fit(cfg):
                raise MemoryError(
                    f"Loading whisper-{size} would exceed the HBM budget "
                    f"({self.resident_bytes()/2**30:.1f} GiB resident, "
                    f"budget {self.settings.hbm_budget_bytes/2**30:.1f} GiB)"
                )
            if size in self.jax_trees:
                logger.info("REGISTRY: bridging whisper %s onto %s", size, self.device)
                params = params_from_jax(self.jax_trees[size], self.device)
            else:
                logger.info("REGISTRY: loading whisper %s onto %s", size, self.device)
                params = load_or_init_params(
                    cfg, self._model_dir(size), stable_seed(size), self.device, self.dtype
                )
                if self.settings.quant in ("int8", "int4"):
                    from wis_tpu_torch.ops.quant import quantize_whisper_params

                    params = quantize_whisper_params(params)
            lay = layout_for_vocab(cfg.n_vocab)
            tok = self.tokenizer()
            if tok.layout is not lay:
                d = self._model_dir(size)
                tok = (
                    WhisperTokenizer.from_dir(d, layout=lay)
                    if d
                    else WhisperTokenizer(layout=lay)
                )
            model = LoadedModel(size, cfg, params, tok, tree_bytes(params),
                                model_dir=self._model_dir(size))
            self._models[size] = model
            return model

    def _get_omni(self, name: str) -> LoadedOmni:
        """Uni-MoE-2.0-Omni under its name: a checkpoint in its model
        directory, else seeded weights (``load_or_init_omni``)."""
        key = name.strip().lower()
        with self._lock:
            if key in self._models:
                return self._models[key]
            cfg = omni_config(key)
            need = cfg.hbm_bytes(2 if self.dtype == torch.bfloat16 else 4)
            if self.resident_bytes() + need + _HEADROOM_BYTES > self.settings.hbm_budget_bytes:
                raise MemoryError(
                    f"Loading {key} would exceed the HBM budget "
                    f"({self.resident_bytes()/2**30:.1f} GiB resident, "
                    f"budget {self.settings.hbm_budget_bytes/2**30:.1f} GiB)")
            logger.info("REGISTRY: loading %s onto %s", key, self.device)
            params = load_or_init_omni(cfg, self._model_dir(key), stable_seed(key), self.device,
                                       self.dtype)
            model = LoadedOmni(key, cfg, params, tree_bytes(params), self._model_dir(key))
            self._models[key] = model
            return model

    def loaded(self) -> Dict[str, LoadedModel]:
        return dict(self._models)

    def evict(self, name: str) -> bool:
        """Drop a model from the registry; True if one was resident. Its
        tree, the fused step's packed weights (``LoadedModel.packed``) and
        its prefill slots go with it: the device memory is freed once no
        request still holds the model."""
        size = name.strip().lower() if is_omni(name) else resolve_model_name(name)
        with self._lock:
            return self._models.pop(size, None) is not None

    def preload(self) -> None:
        """Eager loads per the preload flags."""
        s = self.settings
        flags = {
            "tiny": s.preload_whisper_model_tiny,
            "base": s.preload_whisper_model_base,
            "small": s.preload_whisper_model_small,
            "medium": s.preload_whisper_model_medium,
            "large": s.preload_whisper_model_large,
        }
        for size, flag in flags.items():
            if s.preload_all_models or flag:
                self.get(size)
