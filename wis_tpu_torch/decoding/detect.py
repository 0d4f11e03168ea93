"""Language detection (port of ``wis_tpu/decoding/detect.py``): one decoder
step from ``<|startoftranscript|>`` over precomputed cross-attention K/V,
the distribution restricted to the language tokens."""

from __future__ import annotations

import torch

from wis_tpu_torch.models.whisper.config import WhisperConfig
from wis_tpu_torch.models.whisper.model import DecoderCache, prefill
from wis_tpu_torch.models.whisper.tokenizer import (
    LANG_BASE,
    SOT,
    _LANG_CODES_V3,
    layout_for_vocab,
)


def _detect_from_kv(params, xa_kv, cfg: WhisperConfig):
    """→ (lang_index (B,) int32, prob (B,) f32) for every window."""
    b = xa_kv[0].shape[1]
    device = xa_kv[0].device
    dtype = params["decoder"]["tok_emb"].dtype
    cache = DecoderCache.zeros(cfg, b, 1, dtype, device)
    sot = torch.full((b, 1), SOT, dtype=torch.long, device=device)
    logits, _ = prefill(params, sot, cache, xa_kv, cfg)
    n_lang = layout_for_vocab(cfg.n_vocab).n_langs
    lang_logits = logits[:, -1, LANG_BASE : LANG_BASE + n_lang]
    probs = torch.softmax(lang_logits, dim=-1)
    idx = torch.argmax(probs, dim=-1)
    return idx.to(torch.int32), torch.gather(probs, -1, idx[:, None])[:, 0]


def lang_index_to_code(idx: int) -> str:
    # index 99 (<|yue|>) only arises from v3-layout models
    return _LANG_CODES_V3[int(idx)]
