"""WavLM x-vector speaker embedder (port of ``wis_tpu/models/wavlm``)."""

from wis_tpu_torch.models.wavlm.model import (
    BASE_PLUS_SV,
    WavLMConfig,
    default_embedder,
    load_or_init_wavlm,
    xvector_embed,
)

__all__ = [
    "BASE_PLUS_SV",
    "WavLMConfig",
    "xvector_embed",
    "load_or_init_wavlm",
    "default_embedder",
]
