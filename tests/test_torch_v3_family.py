"""The v3 family and the short decoders on the port's engine against the JAX
engine (``engine_pair``, shared weights): a micro v3 config (128 mel bins,
the 51866-token vocabulary with ``<|yue|>``) and a micro config with a
2-layer decoder (the distil and turbo decoders' depth) get
``tests/test_v3_family.py``'s requests — detection, timestamps, a forced
``yue``, a coalesced pair with per-row prompts — and give equal tokens,
languages and segments. The 2-layer decoder also runs the fused decode
path (``fused_decode="on"``: the JAX kernels in interpret mode, the port's
plain versions).
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import V3_MICRO, engine_pair

torch.set_num_threads(1)

#: a 2-layer decoder under a 3-layer encoder (distil-large-v2's shape, cut),
#: head_dim 64 as the fused step takes
DEC2_MICRO = dict(name="micro-dec2", n_audio_state=128, n_audio_head=2, n_audio_layer=3,
                  n_text_state=128, n_text_head=2, n_text_layer=2)
#: the same decoder on the v3 layout (distil-large-v3's)
DEC2_V3_MICRO = dict(DEC2_MICRO, name="micro-dec2-v3", n_mels=128, n_vocab=51866)


def _audio(seed, seconds=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(seconds * 16000)) * 0.05).astype(np.float32)


@pytest.fixture(scope="module", params=[V3_MICRO, DEC2_MICRO, DEC2_V3_MICRO],
                ids=lambda spec: spec["name"])
def engines(request):
    from wis_tpu.models.whisper.config import WHISPER_CONFIGS as JAX_CONFIGS
    from wis_tpu.models.whisper.config import WhisperConfig as JaxConfig
    from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS, WhisperConfig

    spec = request.param
    name = spec["name"]
    JAX_CONFIGS[name] = JaxConfig(**spec)
    WHISPER_CONFIGS[name] = WhisperConfig(**spec)
    try:
        yield (name, spec.get("n_vocab", 51865)) + engine_pair(
            model=name, batch_buckets=["1", "2"], concurrent_gpu_chunks=4)
    finally:
        JAX_CONFIGS.pop(name, None)
        WHISPER_CONFIGS.pop(name, None)


def _equal(got, want):
    assert (got.text, got.language, got.segments, got.translation, got.audio_duration_ms) == (
        want.text, want.language, want.segments, want.translation, want.audio_duration_ms)


def test_detect(engines):
    name, _, jax_engine, port = engines
    kw = dict(model=name, detect_language=True)
    _equal(port.transcribe(_audio(5), **kw), jax_engine.transcribe(_audio(5), **kw))


def test_timestamps(engines):
    name, _, jax_engine, port = engines
    kw = dict(model=name, timestamps=True)
    got = port.transcribe(_audio(6), **kw)
    _equal(got, jax_engine.transcribe(_audio(6), **kw))
    assert got.segments is not None
    assert all(0.0 <= s["start"] <= s["end"] <= 30.0 for s in got.segments)


def test_force_yue(engines):
    """v3 vocabularies take yue; v2 ones refuse it in both engines."""
    from wis_tpu.runtime.engine import UnsupportedLanguageError as JaxUnsupported
    from wis_tpu_torch.runtime.engine import UnsupportedLanguageError

    name, n_vocab, jax_engine, port = engines
    kw = dict(model=name, force_language="yue")
    if n_vocab == 51866:
        got = port.transcribe(_audio(8), **kw)
        _equal(got, jax_engine.transcribe(_audio(8), **kw))
        assert got.language == "yue"
    else:
        with pytest.raises(JaxUnsupported):
            jax_engine.transcribe(_audio(8), **kw)
        with pytest.raises(UnsupportedLanguageError):
            port.transcribe(_audio(8), **kw)


def test_coalesced_pair(engines):
    from wis_tpu.runtime.batcher import ASRRequest as JaxRequest
    from wis_tpu_torch.runtime.batcher import ASRRequest

    name, n_vocab, jax_engine, port = engines
    first = "yue" if n_vocab == 51866 else "de"

    def reqs(cls):
        return [cls(audio=_audio(9 + i), model=name, beam_size=1,
                    force_language=first if i == 0 else "en") for i in range(2)]

    want = jax_engine.transcribe_coalesced(reqs(JaxRequest))
    for got in (port.transcribe_coalesced(reqs(JaxRequest)),
                port.transcribe_coalesced(reqs(ASRRequest))):
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _equal(g, w)
        assert [g.language for g in got] == [first, "en"]


@pytest.mark.parametrize("spec", [DEC2_MICRO, DEC2_V3_MICRO], ids=lambda s: s["name"])
def test_two_layer_decoder_fused(spec):
    """The fused decode path at a 2-layer decoder, beam 1 and beam 5, with
    detection on the v3 layout: the same tokens as the JAX engine's."""
    from wis_tpu.models.whisper.config import WHISPER_CONFIGS as JAX_CONFIGS
    from wis_tpu.models.whisper.config import WhisperConfig as JaxConfig
    from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS, WhisperConfig

    name = spec["name"]
    JAX_CONFIGS[name] = JaxConfig(**spec)
    WHISPER_CONFIGS[name] = WhisperConfig(**spec)
    try:
        jax_engine, port = engine_pair(fused=True, model=name, quant="int8")
        for beam, detect in ((1, False), (5, spec.get("n_vocab") == 51866)):
            kw = dict(model=name, beam_size=beam, max_tokens=6, detect_language=detect)
            _equal(port.transcribe(_audio(20 + beam), **kw),
                   jax_engine.transcribe(_audio(20 + beam), **kw))
        assert port._use_fused(1, 1) and port._use_fused(1, 5)
    finally:
        JAX_CONFIGS.pop(name, None)
        WHISPER_CONFIGS.pop(name, None)
