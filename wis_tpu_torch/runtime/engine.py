"""WhisperEngine — the ASR orchestrator (port of the single-window path of
``wis_tpu/runtime/engine.py``).

Same request semantics as the JAX engine for requests of at most one 30 s
window: per-request model/beam/language/task, the ≥12 s long-mode beam
override, optional language detection and translate, the same batch,
audio-length, decode-length and beam buckets, and the same
``TranscriptionResult``. Each request is one ASR program call
(``decoding/fused.py``) on the registry's device: one int16 audio
transfer in, one packed int32 fetch out. ``settings.fused_decode`` picks
the decode path as the JAX engine does: "auto" runs the fused decode step
and head on a CUDA device (the JAX engine: on a TPU) and the eager
decoder elsewhere, "on" runs them anywhere (the CPU takes their plain
versions), "off" never; beams above 7 always take the eager decoder.
``settings.xa_quant`` = "int8" with int8 weights streams the cross-KV as
per-column int8 inside the fused step.

It exposes ``.registry`` and ``._programs`` like the JAX engine, so
``wis_tpu.server.app.create_app(settings, engine=...)`` can serve
``/api/asr`` with it.

Not ported yet, each raising ``NotImplementedError``: chunked long-form
(> 30 s with chunking on), timestamps, word timestamps and
``transcribe_coalesced`` (the dynamic batcher's multi-request batches).
"""

from __future__ import annotations

import logging
import math
import re
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from wis_tpu_torch.audio.mel import N_SAMPLES, SAMPLE_RATE, pad_or_trim
from wis_tpu_torch.decoding.beam import trim_tokens
from wis_tpu_torch.decoding.detect import lang_index_to_code
from wis_tpu_torch.decoding.fused import (
    build_asr_program,
    pack_ctl,
    packed_width,
    unpack_asr_result,
)
from wis_tpu_torch.languages import to_language_code
from wis_tpu_torch.models.whisper.tokenizer import build_prompt
from wis_tpu_torch.ops.fused_decode import MAX_ROWS as FUSED_MAX_ROWS
from wis_tpu_torch.ops.fused_decode import pack_decoder
from wis_tpu_torch.runtime.residency import LoadedModel, ModelRegistry
from wis_tpu_torch.utils.timing import StageTimer

logger = logging.getLogger("wis_tpu_torch")


@dataclass
class TranscriptionResult:
    """The reference's 6-tuple plus structured timings (the JAX engine's
    result type)."""

    language: str
    text: str
    infer_time_ms: float
    translation: Optional[str]
    infer_speedup: int
    audio_duration_ms: int
    timings: Dict[str, float] = field(default_factory=dict)
    segments: Optional[list] = None
    words: Optional[list] = None


def _to_i16(audio: np.ndarray) -> np.ndarray:
    return np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)


class WhisperEngine:
    def __init__(self, registry: ModelRegistry):
        self.settings = registry.settings
        # both beam sizes must fall in the beam buckets: refused at
        # construction, not by the first request that reaches long mode
        self.settings.beam_bucket(self.settings.beam_size)
        self.settings.beam_bucket(self.settings.long_beam_size)
        self.registry = registry
        self.device = registry.device
        # LRU of ASR programs, one per request shape (the JAX engine's
        # compile-cache key without the paths the port does not have)
        self._programs: "OrderedDict[tuple, object]" = OrderedDict()
        self._programs_lock = threading.Lock()
        # serializes device work, as in the JAX engine
        self.device_lock = threading.Lock()

    # ------------------------------------------------------------------ #
    # Program cache and buckets
    # ------------------------------------------------------------------ #
    def _use_fused(self, batch: int, beam: int = 1) -> bool:
        """The fused decode step and head: "off" never; beams above 7
        never (the head keeps beam + 1 candidates in 8 slots), nor more
        rows than the kernels take (the port's counterpart of the JAX
        engine's VMEM gate); "on" anywhere; "auto" on a CUDA device."""
        if (beam + 1 > 8 and beam != 1) or batch * beam > FUSED_MAX_ROWS:
            return False
        mode = self.settings.fused_decode
        if mode == "off":
            return False
        if mode == "on":
            return True
        return self.device.type == "cuda"

    def _xa_int8(self) -> bool:
        """Per-column int8 cross-KV inside the fused step: only alongside
        int8 weights, as in the JAX engine."""
        return self.settings.xa_quant == "int8" and self.settings.quant in ("int8", "int4")

    def _packed_decoder(self, model: LoadedModel):
        """The fused step's decoder weights, repacked once per model on its
        device (the eager paths — prefill, encoder, detect — still read the
        original tree)."""
        if model.packed is None:
            model.packed = pack_decoder(model.params, model.cfg)
        return model.packed

    def _program(self, model: LoadedModel, *, beam: int, batch: int,
                 prompt_len: int, detect: bool, translate: bool,
                 max_new: int, n_samples: int):
        """→ (program, fused): a fused program takes the packed decoder
        right after params."""
        fused = self._use_fused(batch, beam)
        key = (model.name, beam, batch, prompt_len, detect, translate,
               max_new, fused, n_samples)
        with self._programs_lock:
            prog = self._programs.get(key)
            if prog is not None:
                self._programs.move_to_end(key)
                return prog, fused
            tok = model.tokenizer
            prog = build_asr_program(
                model.cfg,
                beam_size=beam,
                batch=batch,
                max_new_tokens=max_new,
                prompt_len=prompt_len,
                suppress_tokens=tok.suppress_tokens,
                begin_suppress_tokens=tok.begin_suppress_tokens,
                detect_language=detect,
                translate=translate,
                fused_step=fused,
                xa_int8=self._xa_int8(),
                n_samples=n_samples,
            )
            self._programs[key] = prog
            cap = max(1, int(self.settings.compile_cache_max))
            while len(self._programs) > cap:
                self._programs.popitem(last=False)
            return prog, fused

    def _bucket(self, n: int) -> int:
        for b in self.settings.batch_bucket_list():
            if n <= b:
                return b
        return self.settings.batch_bucket_list()[-1]

    def _sample_bucket(self, content_samples: int) -> int:
        """Audio-length bucket: the request transfers bucket-many int16
        samples and the program zero-pads to the 30 s window."""
        for sec in self.settings.audio_second_bucket_list():
            n = sec * SAMPLE_RATE
            if content_samples <= n:
                return min(n, N_SAMPLES)
        return N_SAMPLES

    def _decode_bucket(self, duration_ms: int, token_cap: Optional[int]) -> int:
        """Decode-length bucket: audio ≤ short_audio_threshold_ms uses the
        smallest bucket that holds the requested cap."""
        s = self.settings
        buckets = sorted(int(b) for b in s.decode_token_buckets)
        if duration_ms > s.short_audio_threshold_ms:
            return buckets[-1]
        want = (
            min(token_cap, s.max_decode_tokens)
            if token_cap is not None
            else buckets[0]
        )
        for b in buckets:
            if want <= b:
                return b
        return buckets[-1]

    def warmup(self, models: Optional[List[str]] = None,
               beams: Optional[List[int]] = None) -> None:
        """Run each (model, beam) once so first requests find the CUDA
        context, cuBLAS handles and kernels ready."""
        s = self.settings
        models = models or [s.whisper_model_default]
        beams = beams or sorted({s.beam_size, s.long_beam_size})
        audio = np.zeros(SAMPLE_RATE, dtype=np.float32)
        for name in models:
            for beam in beams:
                for _ in range(max(1, s.warmup_iterations)):
                    self.transcribe(audio, model=name, beam_size=beam, max_tokens=4)

    # ------------------------------------------------------------------ #
    # One window through the ASR program
    # ------------------------------------------------------------------ #
    def _run_window(
        self,
        loaded: LoadedModel,
        window_i16: np.ndarray,  # (N_SAMPLES,) int16, the padded 30 s window
        content_samples: int,  # samples of real audio in the window
        prompt: np.ndarray,  # (P,) int32
        beam: int,
        detect: bool,
        translate: bool,
        token_cap: int,
        max_new: int,
        timer: StageTimer,
    ) -> dict:
        """→ {tokens, length, lang_idx, lang_prob[, tr_tokens, tr_length]}
        for the best beam."""
        bucket = self._bucket(1)
        n_samp = self._sample_bucket(content_samples)
        audio = np.zeros((bucket, n_samp), np.int16)
        audio[0] = window_i16[:n_samp]
        prompts = np.tile(prompt[None], (bucket, 1))
        mask = np.zeros(bucket, np.int32)
        mask[0] = 1
        prog, fused = self._program(
            loaded, beam=beam, batch=bucket, prompt_len=prompt.shape[0],
            detect=detect, translate=translate, max_new=max_new,
            n_samples=n_samp,
        )
        ctl = pack_ctl(prompts, mask, token_cap)
        weights = (loaded.params, self._packed_decoder(loaded)) if fused else (loaded.params,)
        with timer.span("asr_dispatch", trace=True):
            d_audio = torch.from_numpy(audio).to(self.device)
            d_ctl = torch.from_numpy(ctl).to(self.device)
            packed = prog(*weights, d_audio, d_ctl).cpu().numpy()
        width = packed_width(beam, max_new)
        tokens, lengths, best, lang_idx, lang_prob = unpack_asr_result(
            packed[:, :width], beam, max_new
        )
        k = int(best[0])
        entry = {
            "tokens": tokens[0, k],
            "length": int(lengths[0, k]),
            "lang_idx": int(lang_idx[0]),
            "lang_prob": float(lang_prob[0]),
        }
        if translate:
            tr = unpack_asr_result(packed[:, width:], beam, max_new)
            tk = int(tr[2][0])
            entry["tr_tokens"] = tr[0][0, tk]
            entry["tr_length"] = int(tr[1][0, tk])
        return entry

    # ------------------------------------------------------------------ #
    # The hot path
    # ------------------------------------------------------------------ #
    def transcribe(
        self,
        audio: np.ndarray,
        model: Optional[str] = None,
        beam_size: Optional[int] = None,
        task: str = "transcribe",
        detect_language: bool = False,
        force_language: Optional[str] = None,
        translate: bool = False,
        max_tokens: Optional[int] = None,
        timestamps: bool = False,
        word_timestamps: bool = False,
    ) -> TranscriptionResult:
        """audio: 1-D PCM at 16 kHz, float32 or int16. Requests of at most
        one 30 s window (longer audio is truncated when chunking is off)."""
        if timestamps or word_timestamps:
            raise NotImplementedError(
                "timestamps and word_timestamps are not ported to wis_tpu_torch yet"
            )
        s = self.settings
        timer = StageTimer()
        model_name = model or s.whisper_model_default
        beam = s.beam_bucket(beam_size or s.beam_size)
        loaded = self.registry.get(model_name)
        tok = loaded.tokenizer

        audio = np.asarray(audio).reshape(-1)
        if audio.dtype != np.int16:
            audio = audio.astype(np.float32, copy=False)
        duration_ms = int(audio.shape[0] / SAMPLE_RATE * 1000)

        # long-mode beam override (it overrides the *requested* beam)
        if duration_ms >= s.long_beam_size_threshold:
            beam = s.beam_bucket(s.long_beam_size)
        if duration_ms > 30_000 and s.support_chunking:
            raise NotImplementedError(
                "chunked long-form (> 30 s) is not ported to wis_tpu_torch yet"
            )
        if duration_ms > 30_000:
            logger.warning("ENGINE: audio > 30 s without chunking — truncating")

        with timer.span("features"):
            w = pad_or_trim(audio)
            window = w if w.dtype == np.int16 else _to_i16(w)

        language = s.language
        detect = bool(detect_language and not force_language)
        if force_language:
            language = to_language_code(force_language)
            _check_layout_language(language, tok, model_name)
        prompt = np.asarray(
            build_prompt(language, task, notimestamps=True, layout=tok.layout),
            np.int32,
        )

        decode_bucket = self._decode_bucket(duration_ms, max_tokens)
        with self.device_lock:
            result = self._run_window(
                loaded,
                window,
                audio.shape[0],
                prompt,
                beam,
                detect,
                translate,
                min(max_tokens or s.max_decode_tokens, decode_bucket),
                decode_bucket,
                timer,
            )

        with timer.span("decode_text"):
            if detect and result["lang_idx"] >= 0:
                language = lang_index_to_code(result["lang_idx"])
            text = tok.decode(trim_tokens(result["tokens"], result["length"])).strip()
            translation = None
            if translate:
                translation = tok.decode(
                    trim_tokens(result["tr_tokens"], result["tr_length"])
                ).strip()

        language = _normalize_language(language)
        infer_ms = timer.total_ms()
        speedup = math.floor(duration_ms / infer_ms) if infer_ms > 0 else 0
        return TranscriptionResult(
            language=language,
            text=text,
            infer_time_ms=infer_ms,
            translation=translation,
            infer_speedup=speedup,
            audio_duration_ms=duration_ms,
            timings=timer.as_dict(),
        )

    def transcribe_coalesced(self, requests) -> List[TranscriptionResult]:
        raise NotImplementedError(
            "coalesced multi-request batches are not ported to wis_tpu_torch yet"
        )


_LANG_RE = re.compile(r"[A-Za-z0-9]+")


class UnsupportedLanguageError(ValueError):
    """A forced language the selected model's vocabulary cannot express."""


def _check_layout_language(language: str, tok, model_name: str) -> None:
    """Reject v3-only language codes on v2-layout models."""
    if language and language not in tok.layout.lang_codes:
        raise UnsupportedLanguageError(
            f"language {language!r} is not in model {model_name!r}'s "
            f"vocabulary (requires a large-v3-family model)"
        )


def _normalize_language(language: str) -> str:
    """Strip token decoration like <|en|>."""
    m = _LANG_RE.findall(language)
    return m[0] if m else language
