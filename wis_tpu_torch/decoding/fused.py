"""The one-call ASR program (port of ``wis_tpu/decoding/fused.py``).

int16 audio (B, n_samples) → log-mel → encoder → cross-KV → optional
language detect (the prompt's language token replaced per detecting row)
→ prompt prefill + beam search → one packed int32 (B, W) tensor:

    [tokens (K·max_new)] [lengths (K)] [best] [lang_idx] [lang_prob‰]

with W = ``packed_width``, doubled (transcribe ‖ translate halves) when
translate=True. ``ctl`` packs prompt ‖ detect_mask ‖ token_cap
(``pack_ctl``). ``pack_ctl``/``unpack_asr_result``/``packed_width`` are
copies of the JAX package's host-side helpers.

The program runs eagerly on the device of its inputs. ``fused_step=True``
decodes through the fused step and head (``decoding/beam.py``'s fused
branch); the program then takes the packed decoder right after ``params``.
``with_timestamps`` decodes with the timestamp grammar. ``chunked=True`` is
the long-form variant: the audio is ONE (n_samples,) segment and the
program cuts the 22 s windows at multiples of the 14 s step on the device,
each zero-padded to the 30 s window — bit-identical to the host's
``chunk_iter`` followed by ``pad_or_trim``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wis_tpu_torch.audio.chunking import CHUNK_LEN, STRIDE_LEFT, STRIDE_RIGHT
from wis_tpu_torch.audio.mel import N_SAMPLES, log_mel
from wis_tpu_torch.decoding.beam import build_generate_xa
from wis_tpu_torch.decoding.detect import _detect_from_kv
from wis_tpu_torch.models.whisper.config import WhisperConfig
from wis_tpu_torch.models.whisper.model import cross_kv, encode
from wis_tpu_torch.models.whisper.tokenizer import LANG_BASE, layout_for_vocab
from wis_tpu_torch.utils.timing import span


def build_asr_program(
    cfg: WhisperConfig,
    *,
    beam_size: int,
    batch: int,
    max_new_tokens: int,
    prompt_len: int,
    suppress_tokens: Tuple[int, ...],
    begin_suppress_tokens: Tuple[int, ...],
    detect_language: bool = False,
    translate: bool = False,
    with_timestamps: bool = False,
    fused_step: bool = False,
    xa_int8: bool = False,
    n_samples: int = N_SAMPLES,
    chunked: bool = False,
):
    """Return asr(params, audio_i16 (B, n_samples), ctl (B, P+2),
    slots=None) → packed int32 (B, W) on the inputs' device; with
    fused_step, asr(params, packed_dec, audio_i16, ctl, slots=None).
    xa_int8 streams the cross-KV as per-column int8 inside the fused step.
    chunked: audio_i16 is one (n_samples,) segment with n_samples ≥
    (batch − 1)·step + CHUNK_LEN. ``slots``: the model's prefill slots,
    which a fused program on the card replays its prefill from (each call
    of a translating program twice); ``asr.prefill_key`` names its slot
    (``build_generate_xa``)."""
    translate_tok = layout_for_vocab(cfg.n_vocab).translate
    K = beam_size
    gen = build_generate_xa(
        cfg,
        beam_size=beam_size,
        batch=batch,
        max_new_tokens=max_new_tokens,
        prompt_len=prompt_len,
        suppress_tokens=suppress_tokens,
        begin_suppress_tokens=begin_suppress_tokens,
        with_timestamps=with_timestamps,
        fused=fused_step,
        xa_int8=fused_step and xa_int8,
    )

    @torch.inference_mode()
    def _asr(params, packed_dec, audio_i16: torch.Tensor, ctl: torch.Tensor,
             slots) -> torch.Tensor:
        device = audio_i16.device
        prompt = ctl[:, :prompt_len].long()
        detect_mask = ctl[:, prompt_len]
        token_cap = int(ctl[0, prompt_len + 1])
        with span("asr.encode"):
            if chunked:
                step = CHUNK_LEN - STRIDE_LEFT - STRIDE_RIGHT
                long_audio = audio_i16.float() / 32768.0
                audio = torch.stack(
                    [long_audio[w * step: w * step + CHUNK_LEN] for w in range(batch)]
                )
                audio = F.pad(audio, (0, N_SAMPLES - CHUNK_LEN))
            else:
                audio = audio_i16.float() / 32768.0
                if n_samples < N_SAMPLES:
                    audio = F.pad(audio, (0, N_SAMPLES - n_samples))
            mel = log_mel(audio, n_mels=cfg.n_mels)  # (B, n_mels, 3000)
            xa = encode(params, mel, cfg)
            xa_kv = cross_kv(params, xa, cfg)

        if detect_language:
            with span("asr.detect"):
                lang_idx, lang_prob = _detect_from_kv(params, xa_kv, cfg)
                row_detects = detect_mask.bool()
                prompt = prompt.clone()
                prompt[:, 1] = torch.where(row_detects, LANG_BASE + lang_idx.long(),
                                           prompt[:, 1])
                lang_idx = torch.where(row_detects, lang_idx, -1)
                lang_prob = torch.where(row_detects, lang_prob, 0.0)
        else:
            lang_idx = torch.full((batch,), -1, dtype=torch.int32, device=device)
            lang_prob = torch.zeros((batch,), dtype=torch.float32, device=device)

        def pack(result):
            return torch.cat(
                [
                    result.tokens.reshape(batch, K * max_new_tokens).to(torch.int32),
                    result.lengths.to(torch.int32),
                    result.best[:, None].to(torch.int32),
                    lang_idx[:, None].to(torch.int32),
                    (lang_prob * 1000).to(torch.int32)[:, None],
                ],
                dim=1,
            )

        def run(p):
            if fused_step:
                return gen(params, packed_dec, xa_kv, p, token_cap, slots)
            return gen(params, xa_kv, p, token_cap)

        packed = pack(run(prompt))
        if translate:
            tr_prompt = prompt.clone()
            tr_prompt[:, 2] = translate_tok
            packed = torch.cat([packed, pack(run(tr_prompt))], dim=1)
        return packed

    if fused_step:
        def asr(params, packed_dec, audio_i16, ctl, slots=None):
            return _asr(params, packed_dec, audio_i16, ctl, slots)
    else:
        def asr(params, audio_i16, ctl, slots=None):
            return _asr(params, None, audio_i16, ctl, slots)
    asr.prefill_key = gen.prefill_key
    return asr


def pack_ctl(prompts: np.ndarray, detect_mask: np.ndarray,
             token_cap: int) -> np.ndarray:
    """Host-side: prompts (B, P) ‖ detect_mask (B,) ‖ token_cap → (B, P+2)
    int32."""
    b = prompts.shape[0]
    return np.concatenate(
        [
            np.asarray(prompts, np.int32),
            np.asarray(detect_mask, np.int32).reshape(b, 1),
            np.full((b, 1), token_cap, np.int32),
        ],
        axis=1,
    )


def unpack_asr_result(packed: np.ndarray, beam_size: int, max_new_tokens: int):
    """Host-side unpack of one packed half → (tokens (B,K,max), lengths
    (B,K), best (B,), lang_idx (B,), lang_prob (B,))."""
    b = packed.shape[0]
    k = beam_size
    tokens = packed[:, : k * max_new_tokens].reshape(b, k, max_new_tokens)
    lengths = packed[:, k * max_new_tokens : k * max_new_tokens + k]
    best = packed[:, k * max_new_tokens + k]
    lang_idx = packed[:, k * max_new_tokens + k + 1]
    lang_prob = packed[:, k * max_new_tokens + k + 2].astype(np.float32) / 1000.0
    return tokens, lengths, best, lang_idx, lang_prob


def packed_width(beam_size: int, max_new_tokens: int) -> int:
    return beam_size * max_new_tokens + beam_size + 3
