"""Settings from the environment — the ``wis_tpu.settings.APISettings``
fields the ASR engine, the model registry, the dynamic batcher, the
replica pool, the streaming session, the speaker verifier and the HTTP
apps read, with the same names and defaults.

``wis_tpu.settings`` needs pydantic, which the card's machine does not
have, so the port carries a plain dataclass and the JAX package's
loader: every field is settable by an environment variable of the same
name, case-insensitive, over a flat ``.env`` file in the working
directory (the process environment wins), and a module named
``custom_settings`` that defines ``get_api_settings`` replaces the whole
loader. CPU tests hold the defaults and the parsing equal to
``wis_tpu``'s.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import typing
from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, Optional


def _coerce(raw: str, annotation) -> object:
    """Parse an env-var string into the field's type (pydantic-settings
    rules, as ``wis_tpu.settings._coerce``)."""
    if annotation in (bool, Optional[bool]):
        return raw.strip().lower() in ("1", "true", "yes", "on", "t", "y")
    if annotation is int:
        return int(raw)
    if annotation is float:
        return float(raw)
    if annotation in (List[str], list):
        raw = raw.strip()
        if raw.startswith("["):
            return json.loads(raw)
        return [s.strip() for s in raw.split(",") if s.strip()]
    return raw


_ZERO_FRACTION = re.compile(r"\s*([+-]?\d[\d_]*)\.0+\s*")


def _refused(name: str, raw: str, annotation) -> object:
    """A value ``_coerce`` could not parse. The JAX loader passes it on raw
    and its pydantic model validates it: an integer written with a zero
    fraction ("3.0") becomes that integer, anything else is refused."""
    m = _ZERO_FRACTION.fullmatch(raw)
    if annotation is int and m:
        return int(m.group(1))
    raise ValueError(f"setting {name}: cannot parse {raw!r} as {annotation}")


@dataclass
class APISettings:
    name: str = "Willow Inference Server (TPU)"
    description: str = "High Performance Language Inference API — TPU-native"
    version: str = "1.0"

    #: default beam size — 1 is greedy
    beam_size: int = 1
    #: beam size for long transcriptions ("long mode")
    long_beam_size: int = 3
    #: audio duration (ms) at/above which long mode activates
    long_beam_size_threshold: int = 12000
    #: default language
    language: str = "en"
    #: detect the language by default
    detect_language: bool = False

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
    #: mesh axis layout (``parallel/mesh.py``): data-parallel replicas and
    #: tensor parallelism; read by nothing, as in the JAX package
    mesh_replica_axis: int = -1  # -1 = all local devices
    mesh_tensor_axis: int = 1
    #: max cached ASR programs per engine
    compile_cache_max: int = 32

    #: dynamic batcher window (s): how long a lone request is held open
    #: for near-simultaneous arrivals before dispatch
    batch_window_s: float = 0.004
    #: straggler admission (s): a batch already coalescing (≥ 2) but below
    #: the largest batch bucket waits in windows of this length; each
    #: window that lands a request extends the wait, a silent one dispatches
    batch_admit_s: float = 0.02
    #: absolute ceiling on the straggler wait, from the first admit window
    batch_admit_max_s: float = 0.08
    #: one engine replica per device ("auto": when more than one is visible)
    replica_pool: str = "auto"

    #: TTS speaker-latent store directory
    xtts_speaker_dir: str = "speakers/xtts"
    #: default TTS decoder chunk size in tokens
    tts_stream_chunk_size: int = 20

    #: speaker verification: None = auto (on iff WavLM weights are present
    #: at startup, ``server.sv.sv_weights_present``); true/false always wins
    support_sv: Optional[bool] = None
    #: cosine at or above which a voice matches an enrolled speaker
    sv_threshold: float = 0.75
    #: directory of enrolled speaker embeddings (<name>.npy)
    sv_speaker_dir: str = "speakers/voice_auth"

    #: origins answered with CORS headers (["*"]: any)
    cors_allowed_origins: List[str] = field(default_factory=list)
    #: HTTP Basic auth; a falsy user or password skips that half of the check
    basic_auth_user: Optional[str] = None
    basic_auth_pass: Optional[str] = None
    #: UDP port range of the WebRTC media
    rtc_port_start: int = 10000
    rtc_port_end: int = 10050
    #: XTTS GPT weight quantization: "int8" | "none"
    xtts_quant: str = "int8"

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



def _load_dotenv(path: str = ".env") -> dict:
    """Flat KEY=VALUE file; keys lower-cased, quotes stripped."""
    out = {}
    if os.path.isfile(path):
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                key, _, value = line.partition("=")
                out[key.strip().lower()] = value.strip().strip("'\"")
    return out


def _settings_from_env() -> APISettings:
    env = _load_dotenv()
    env.update({k.lower(): v for k, v in os.environ.items()})
    # the module's annotations are strings (``from __future__ import
    # annotations``): resolve them before coercing, or every bool, int and
    # list field would stay a string
    hints = typing.get_type_hints(APISettings)
    kwargs = {}
    for f in dataclasses.fields(APISettings):
        if f.name in env:
            try:
                kwargs[f.name] = _coerce(env[f.name], hints[f.name])
            except (ValueError, json.JSONDecodeError):
                kwargs[f.name] = _refused(f.name, env[f.name], hints[f.name])
    return APISettings(**kwargs)


@lru_cache()
def get_api_settings() -> APISettings:
    """Process-wide settings, honouring the ``custom_settings`` override
    hook."""
    try:
        import custom_settings  # type: ignore

        if hasattr(custom_settings, "get_api_settings"):
            return custom_settings.get_api_settings()
    except ImportError:
        pass
    return _settings_from_env()
