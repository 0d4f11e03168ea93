"""PyTorch port: weight bridge, quantizers, host-side copies and the import
boundary, held against the JAX package (wis_tpu) on the CPU."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import JAX_CFG, PORT_CFG, np_tree
from wis_tpu.models.whisper.weights import random_params as jax_random_params
from wis_tpu_torch.models.whisper.weights import params_from_jax, random_params

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _bits(a: np.ndarray) -> np.ndarray:
    """Raw bit pattern (bf16 has no numpy arithmetic of its own)."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_leaf_round_trips(dtype):
    """Every leaf — bf16 bit patterns, int8 {q, s} leaves and tok_emb_q —
    crosses the bridge exactly (bit-equal), with its shape and dtype."""
    from wis_tpu.ops.quant import quantize_whisper_params

    tree = np_tree(
        quantize_whisper_params(
            jax_random_params(JAX_CFG, seed=1, dtype=getattr(jnp, dtype))
        )
    )
    got = params_from_jax(tree, "cpu")
    src = dict(_leaves(tree))
    dst = dict(_leaves(got))
    assert src.keys() == dst.keys()
    assert "/decoder/tok_emb_q/q" in dst and "/decoder/blocks/attn/q_w/s" in dst
    for name, a in src.items():
        t = dst[name]
        assert tuple(t.shape) == a.shape, name
        assert str(t.dtype).removeprefix("torch.") == a.dtype.name, name
        np.testing.assert_array_equal(_torch_bits(t), _bits(a), err_msg=name)


def test_random_params_layout_matches_jax():
    """The port's seeded init builds the JAX package's tree: same leaves,
    shapes and dtypes; deterministic per seed."""
    ref = dict(_leaves(np_tree(jax_random_params(JAX_CFG, seed=0))))
    a = dict(_leaves(random_params(PORT_CFG, seed=3, device="cpu")))
    b = dict(_leaves(random_params(PORT_CFG, seed=3, device="cpu")))
    c = dict(_leaves(random_params(PORT_CFG, seed=4, device="cpu")))
    assert a.keys() == ref.keys()
    for name, r in ref.items():
        assert tuple(a[name].shape) == r.shape, name
        assert str(a[name].dtype).removeprefix("torch.") == r.dtype.name, name
        assert torch.equal(a[name], b[name]), name
    assert not torch.equal(a["/decoder/tok_emb"], c["/decoder/tok_emb"])
    # the scales of the dense leaves follow the JAX init (1/sqrt(fan_in))
    w = a["/encoder/blocks/mlp/w2"].float()
    assert abs(float(w.std()) - (4 * PORT_CFG.n_audio_state) ** -0.5) < 2e-3


def test_registry_seed_is_stable():
    from wis_tpu_torch.runtime.residency import stable_seed

    # a CRC, not Python's per-process salted hash()
    assert stable_seed("large") == 1500195262
    assert stable_seed("tiny") == 1354274761


@pytest.mark.parametrize("kind", ["weight", "rows", "whisper_params"])
def test_quantizers_bit_equal(kind):
    from wis_tpu.ops import quant as jq
    from wis_tpu_torch.ops import quant as tq

    rng = np.random.default_rng(5)
    if kind == "whisper_params":
        src = jax_random_params(JAX_CFG, seed=2, dtype=jnp.float32)
        want = dict(_leaves(np_tree(jq.quantize_whisper_params(src))))
        got = dict(_leaves(tq.quantize_whisper_params(params_from_jax(np_tree(src), "cpu"))))
        assert want.keys() == got.keys()
    else:
        w = rng.standard_normal((3, 96, 40)).astype(np.float32)
        w[0, :, 7] = 0.0  # an all-zero column hits the 1e-8 floor
        w[1, 5] = 127.5 / 7  # exact .5 quotients round half to even
        fn = "quantize_weight" if kind == "weight" else "quantize_rows"
        want = np_tree(getattr(jq, fn)(jnp.asarray(w)))
        got = getattr(tq, fn)(torch.from_numpy(w))
    for name in want:
        np.testing.assert_array_equal(
            _torch_bits(got[name]), _bits(want[name]), err_msg=str(name)
        )


def test_config_and_aliases_equal():
    from wis_tpu.models.whisper import config as jc
    from wis_tpu_torch.models.whisper import config as tc

    assert jc.WHISPER_CONFIGS.keys() == tc.WHISPER_CONFIGS.keys()
    for name, cfg in jc.WHISPER_CONFIGS.items():
        port = tc.WHISPER_CONFIGS[name]
        assert dataclasses.asdict(port) == dataclasses.asdict(cfg), name
        assert port.hbm_bytes() == cfg.hbm_bytes() and port.head_dim == cfg.head_dim
    for alias in ("tiny", "Large-V2", "large", "turbo", "distil-large-v3", " base "):
        assert tc.resolve_model_name(alias) == jc.resolve_model_name(alias)
    with pytest.raises(KeyError):
        tc.resolve_model_name("huge")


def test_tokenizer_layout_prompts_and_decode_equal():
    from wis_tpu.decoding.detect import lang_index_to_code as j_code
    from wis_tpu.models.whisper import tokenizer as jt
    from wis_tpu_torch.decoding.detect import lang_index_to_code as t_code
    from wis_tpu_torch.models.whisper import tokenizer as tt

    for n_vocab in (51865, 51866):
        jl, tl = jt.layout_for_vocab(n_vocab), tt.layout_for_vocab(n_vocab)
        props = ("eot", "sot", "lang_base", "translate", "transcribe", "sot_lm",
                 "sot_prev", "no_speech", "no_timestamps", "timestamp_base",
                 "n_vocab", "lang_codes")
        assert [getattr(tl, p) for p in props] == [getattr(jl, p) for p in props]
        assert tt.default_suppress_tokens(tl) == jt.default_suppress_tokens(jl)
        for lang in ("en", "de", "yue", "xx"):
            for task in ("transcribe", "translate"):
                for nots in (True, False):
                    assert tt.build_prompt(lang, task, nots, tl) == jt.build_prompt(
                        lang, task, nots, jl
                    )
        jtok, ttok = jt.WhisperTokenizer(layout=jl), tt.WhisperTokenizer(layout=tl)
        assert ttok.suppress_tokens == jtok.suppress_tokens
        assert ttok.begin_suppress_tokens == jtok.begin_suppress_tokens
        ids = list(range(0, 60000, 997)) + [jl.eot, jl.sot, jl.translate,
                                              jl.no_timestamps, jl.timestamp_base + 7]
        for skip in (True, False):
            assert ttok.decode(ids, skip_special=skip) == jtok.decode(ids, skip_special=skip)
    assert (tt.EOT, tt.SOT, tt.LANG_BASE) == (jt.EOT, jt.SOT, jt.LANG_BASE)
    assert tt.DEFAULT_SUPPRESS_TOKENS == jt.DEFAULT_SUPPRESS_TOKENS
    for i in (0, 1, 50, 98, 99):
        assert t_code(i) == j_code(i)


def test_tokenizer_vocab_files_equal(tmp_path):
    """A model directory's vocab.json, merges.txt and generation config load
    the same decode table, merges and suppress lists on both sides."""
    import json

    from wis_tpu.models.whisper.tokenizer import WhisperTokenizer as J
    from wis_tpu_torch.models.whisper.tokenizer import WhisperTokenizer as T

    vocab = {"hello": 0, "Ġworld": 1, "!": 2}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\nh e\n\nhe llo\nĠ w\n")
    (tmp_path / "generation_config.json").write_text(
        json.dumps({"suppress_tokens": [1, 2], "begin_suppress_tokens": [220]})
    )
    j, t = J.from_dir(str(tmp_path)), T.from_dir(str(tmp_path))
    assert t.decode([0, 1, 2, 50257]) == j.decode([0, 1, 2, 50257]) == "hello world!"
    assert (t.suppress_tokens, t.begin_suppress_tokens) == (
        j.suppress_tokens, j.begin_suppress_tokens)
    assert t.merges == j.merges == {("h", "e"): 0, ("he", "llo"): 1, ("Ġ", "w"): 2}


def test_languages_equal():
    from wis_tpu import languages as jl
    from wis_tpu_torch import languages as tl

    assert tl.LANGUAGES == jl.LANGUAGES
    assert tl.TO_LANGUAGE_CODE == jl.TO_LANGUAGE_CODE
    assert tl.EXTRA_V3_LANGUAGES == jl.EXTRA_V3_LANGUAGES
    for name in ("English", "german", "cantonese", "yue", "de"):
        assert tl.to_language_code(name) == jl.to_language_code(name)
    for name in ("English", " DE ", "yue", "cantonese", "xx", "", "klingon"):
        assert tl.check_language(name) == jl.check_language(name)


def test_settings_defaults_equal():
    from wis_tpu.settings import APISettings as JaxSettings
    from wis_tpu_torch.settings import APISettings

    port, ref = APISettings(), JaxSettings()
    for f in dataclasses.fields(APISettings):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    # the HTTP apps' fields
    assert (port.detect_language, port.cors_allowed_origins, port.basic_auth_user,
            port.basic_auth_pass, port.rtc_port_start, port.rtc_port_end, port.xtts_quant) == (
        False, [], None, None, 10000, 10050, "int8") == (
        ref.detect_language, ref.cors_allowed_origins, ref.basic_auth_user,
        ref.basic_auth_pass, ref.rtc_port_start, ref.rtc_port_end, ref.xtts_quant)
    assert APISettings().cors_allowed_origins is not port.cors_allowed_origins
    # the speaker verifier's fields
    assert (port.support_sv, port.sv_threshold, port.sv_speaker_dir) == (
        None, 0.75, "speakers/voice_auth") == (
        ref.support_sv, ref.sv_threshold, ref.sv_speaker_dir)
    assert port.batch_bucket_list() == ref.batch_bucket_list()
    assert port.audio_second_bucket_list() == ref.audio_second_bucket_list()
    for beam in (1, 2, 3, 4, 5):
        assert port.beam_bucket(beam) == ref.beam_bucket(beam)
    for bad in (0, 6, 40):
        with pytest.raises(ValueError):
            port.beam_bucket(bad)


def test_device_policy_refuses_a_missing_card(monkeypatch):
    """Asking for the card without one raises; nothing falls back."""
    from wis_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_kernel_wrappers_have_no_fallback():
    """A tensor that is neither on the CPU nor on the card is refused, not
    sent down the plain path."""
    from wis_tpu_torch.ops.flash import flash_attention_packed
    from wis_tpu_torch.ops.layernorm import layer_norm_cuda

    x = torch.empty((1, 8, 128), device="meta")
    g = torch.empty((128,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        layer_norm_cuda(x, g, g)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_packed(x, x, x, 2)
    assert layer_norm_cuda.launches == 0 and flash_attention_packed.launches == 0


def test_port_imports_no_jax_pydantic_or_aiohttp():
    """Importing every module of the port (the conditioning encoder, WavLM,
    the speaker verifier, the settings loader, the batcher, the replica
    pool, codecs, ingest, VAD, the streaming session, the recorder and the
    HTTP apps among them; not ``server.rtc``, which imports aiortc as the
    JAX module does), chip_smoke.py and chip_profile.py in a fresh
    interpreter loads neither JAX, pydantic, aiohttp, aiortc nor the
    wis_tpu package — the card's machine has none of them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import wis_tpu_torch, chip_smoke, chip_profile\n"
        "for m in pkgutil.walk_packages(wis_tpu_torch.__path__, 'wis_tpu_torch.'):\n"
        "    if m.name != 'wis_tpu_torch.server.rtc':  # imports aiortc, as wis_tpu's does\n"
        "        importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'pydantic', 'aiohttp', 'aiortc', 'wis_tpu'))\n"
        "new = ('wis_tpu_torch.models.xtts.conditioning', 'wis_tpu_torch.models.wavlm',\n"
        "       'wis_tpu_torch.models.wavlm.model', 'wis_tpu_torch.server.sv',\n"
        "       'wis_tpu_torch.settings', 'wis_tpu_torch.runtime.engine',\n"
        "       'wis_tpu_torch.runtime.batcher', 'wis_tpu_torch.parallel.replicas',\n"
        "       'wis_tpu_torch.audio.codecs', 'wis_tpu_torch.audio.ingest',\n"
        "       'wis_tpu_torch.audio.vad', 'wis_tpu_torch.server.session',\n"
        "       'wis_tpu_torch.server.media', 'wis_tpu_torch.server.app',\n"
        "       'wis_tpu_torch.server.auth', 'wis_tpu_torch.server.schemas',\n"
        "       'wis_tpu_torch.server.tts_app', 'wis_tpu_torch.server.reply',\n"
        "       'wis_tpu_torch.utils.logging')\n"
        "bad += [m for m in new if m not in sys.modules]\n"
        "print(len([m for m in sys.modules if m.startswith('wis_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 20
