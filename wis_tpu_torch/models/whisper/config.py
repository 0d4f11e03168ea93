"""Whisper model family configs — a copy of
``wis_tpu/models/whisper/config.py``.

Public OpenAI Whisper architecture hyperparameters. Carried as a copy
because importing the ``wis_tpu`` module runs
``wis_tpu/models/whisper/__init__.py``, which imports JAX; a CPU test holds
every entry equal to ``wis_tpu``'s.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class WhisperConfig:
    name: str
    n_mels: int = 80
    n_audio_ctx: int = 1500  # encoder positions (3000 frames / conv stride 2)
    n_audio_state: int = 512
    n_audio_head: int = 8
    n_audio_layer: int = 6
    n_vocab: int = 51865  # multilingual v2 vocabulary
    n_text_ctx: int = 448
    n_text_state: int = 512
    n_text_head: int = 8
    n_text_layer: int = 6

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head

    def hbm_bytes(self, bytes_per_param: int = 2) -> int:
        """Approximate parameter footprint for residency planning
        (replaces the reference's VRAM thresholds, main.py:256-292)."""
        d, dl = self.n_audio_state, self.n_text_state
        enc = self.n_audio_layer * (4 * d * d + 8 * d * d)  # attn + mlp
        dec = self.n_text_layer * (8 * dl * dl + 8 * dl * dl)
        emb = self.n_vocab * dl + 3 * self.n_mels * d
        return (enc + dec + emb) * bytes_per_param


def _cfg(name, d, h, l, *, dec_layers=None, n_mels=80, n_vocab=51865) -> WhisperConfig:
    return WhisperConfig(
        name=name,
        n_mels=n_mels,
        n_vocab=n_vocab,
        n_audio_state=d,
        n_audio_head=h,
        n_audio_layer=l,
        n_text_state=d,
        n_text_head=h,
        n_text_layer=dec_layers if dec_layers is not None else l,
    )


WHISPER_CONFIGS = {
    # The five sizes the reference serves (main.py:319-448), v2 layout.
    "tiny": _cfg("tiny", 384, 6, 4),
    "base": _cfg("base", 512, 8, 6),
    "small": _cfg("small", 768, 12, 12),
    "medium": _cfg("medium", 1024, 16, 24),
    "large": _cfg("large", 1280, 20, 32),  # large == large-v2 (reference naming)
    "large-v2": _cfg("large-v2", 1280, 20, 32),
    # Beyond the reference: the v3 family (128 mel bins, 51866-token
    # vocabulary with <|yue|>) and the distilled decoders. Architecture
    # hyperparameters are public OpenAI/HF model metadata.
    "large-v3": _cfg("large-v3", 1280, 20, 32, n_mels=128, n_vocab=51866),
    "large-v3-turbo": _cfg(
        "large-v3-turbo", 1280, 20, 32, dec_layers=4, n_mels=128, n_vocab=51866
    ),
    "distil-large-v2": _cfg("distil-large-v2", 1280, 20, 32, dec_layers=2),
    "distil-large-v3": _cfg(
        "distil-large-v3", 1280, 20, 32, dec_layers=2, n_mels=128, n_vocab=51866
    ),
}

#: model alias normalization (the reference accepts exactly these strings,
#: main.py:564-573; unknown strings there crash — here they 400 at the API)
def resolve_model_name(name: str) -> str:
    name = (name or "").strip().lower()
    if name == "large-v2":
        return "large"
    if name == "turbo":
        return "large-v3-turbo"
    if name in WHISPER_CONFIGS:
        return name
    raise KeyError(f"Unknown whisper model: {name!r}")
