"""Engine settings — the ``wis_tpu.settings.APISettings`` fields the ASR
engine, the model registry and the speaker verifier read, with the same
names and defaults.

``wis_tpu.settings`` needs pydantic, which the card's machine does not
have, so the port carries a plain dataclass. A CPU test holds the
defaults equal to ``wis_tpu``'s.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class APISettings:
    #: default beam size — 1 is greedy
    beam_size: int = 1
    #: beam size for long transcriptions ("long mode")
    long_beam_size: int = 3
    #: audio duration (ms) at/above which long mode activates
    long_beam_size_threshold: int = 12000
    #: default language
    language: str = "en"

    preload_all_models: bool = False
    preload_whisper_model_tiny: bool = True
    preload_whisper_model_base: bool = True
    preload_whisper_model_small: bool = True
    preload_whisper_model_medium: bool = True
    preload_whisper_model_large: bool = True
    #: default whisper model: tiny | base | small | medium | large
    whisper_model_default: str = "medium"

    #: long-form chunking: audio over 30 s is cut into 22 s windows at a
    #: 14 s step and the window texts are LCS-merged (else it is truncated)
    support_chunking: bool = True
    #: most long-form windows decoded in one ASR program call (the batch
    #: bucket of the chunked path)
    concurrent_gpu_chunks: int = 4

    #: computation dtype for model weights/activations
    dtype: str = "bfloat16"
    #: weight quantization: "none" | "int8" (decoder matmul weights,
    #: per-output-channel symmetric, plus the per-row int8 logits
    #: embedding — ops/quant.py); "int4" aliases "int8"
    quant: str = "int8"
    #: cross-attention K/V inside the fused decode step: "int8" (per
    #: audio-position int8 with bf16 scales, applied outside the
    #: contraction; ops/fused_decode.quantize_xa_columns) | "none". Only
    #: active when ``quant`` is int8 and the fused path runs.
    xa_quant: str = "int8"
    #: the fused decode path (ops/fused_decode + ops/fused_logits):
    #: "auto" (on a CUDA device) | "on" (anywhere — the CPU runs the
    #: plain versions) | "off" (the eager per-layer decoder)
    fused_decode: str = "auto"
    #: batch-size buckets requests are padded up to
    batch_buckets: List[str] = field(default_factory=lambda: ["1", "2", "4"])
    #: beam-size buckets: requested beams round UP; larger ones are refused
    beam_buckets: List[str] = field(
        default_factory=lambda: ["1", "2", "3", "5"]
    )
    #: hard cap on generated tokens per 30 s window
    max_decode_tokens: int = 224
    #: decode-length buckets; audio ≤ short_audio_threshold_ms uses the first
    decode_token_buckets: List[str] = field(
        default_factory=lambda: ["96", "224"]
    )
    short_audio_threshold_ms: int = 12000
    #: audio-length buckets (seconds) a request's samples pad up to
    audio_second_buckets: List[str] = field(
        default_factory=lambda: ["4", "8", "16", "30"]
    )
    #: directory holding one subdirectory per model size (``<size>``,
    #: ``whisper-<size>`` or ``tovera-wis-whisper-<size>``): an HF checkpoint
    #: (``*.safetensors``) and tokenizer files; a size without a checkpoint
    #: gets seeded random weights
    model_dir: str = "models"
    #: device-memory budget in bytes that resident model parameters, plus a
    #: fixed headroom for activations and caches, must fit (the JAX
    #: package's default)
    hbm_budget_bytes: int = 16 * 1024**3
    warmup_iterations: int = 1
    #: max cached ASR programs per engine
    compile_cache_max: int = 32

    #: speaker verification: None = auto (on iff WavLM weights are present
    #: at startup, ``server.sv.sv_weights_present``); true/false always wins
    support_sv: Optional[bool] = None
    #: cosine at or above which a voice matches an enrolled speaker
    sv_threshold: float = 0.75
    #: directory of enrolled speaker embeddings (<name>.npy)
    sv_speaker_dir: str = "speakers/voice_auth"

    def batch_bucket_list(self) -> List[int]:
        return sorted(int(b) for b in self.batch_buckets)

    def beam_bucket(self, beam: int) -> int:
        """Round a requested beam size UP to the nearest beam bucket;
        reject out-of-range values."""
        buckets = sorted(int(b) for b in self.beam_buckets)
        if not isinstance(beam, int) or beam < 1 or beam > buckets[-1]:
            raise ValueError(
                f"beam_size {beam!r} outside compiled beam buckets "
                f"{buckets} (max {buckets[-1]})"
            )
        for b in buckets:
            if beam <= b:
                return b
        return buckets[-1]

    def audio_second_bucket_list(self) -> List[int]:
        return sorted(int(b) for b in self.audio_second_buckets)

