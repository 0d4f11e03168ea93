"""HF checkpoints on the PyTorch port, held against the ``safetensors``
package and the JAX package on the CPU:

- the port's own safetensors reader (``safetensors_io.py``; the card's
  machine has no ``safetensors``) equal to ``safetensors.safe_open`` on
  files the package writes — F32, F16 and BF16, two shards — and refusing
  malformed files;
- ``params_from_hf`` bit-equal to ``wis_tpu``'s, leaf for leaf, in bf16
  and f32, from f32, f16 and bf16 checkpoints (rounding to bf16 is to
  nearest even, ties included), for a micro config and a v3 micro config;
- the registry loading from ``model_dir``, its ``_converted_torch`` cache,
  and ``would_fit`` / ``MemoryError`` equal to the JAX registry's;
- a JAX engine and a port engine reading the same checkpoint directory:
  equal packed int32 from the ASR program and equal text, greedy and
  beam 5 (f32, int8 decoder, as the engines serve by default).

Tolerance: none — every comparison here is exact.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import SMALL, V3_MICRO, audio_i16
from wis_tpu.models.whisper.config import WHISPER_CONFIGS as JAX_CONFIGS
from wis_tpu.models.whisper.config import WhisperConfig as JaxConfig
from wis_tpu_torch.models.whisper import weights as tw
from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS, WhisperConfig
from wis_tpu_torch.models.whisper.safetensors_io import SafetensorsError, read_safetensors
from wis_tpu_torch.utils.selftest import hf_whisper_shapes

torch.set_num_threads(1)

MICRO = dict(SMALL, name="micro-ckpt")
MICRO_V3 = dict(V3_MICRO, name="micro-ckpt-v3")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 \
            else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def hf_checkpoint(cfg, seed, dtype=np.float32, emb_scale=16.0):
    """A random HF state dict at cfg's dims (numpy, ``dtype``; bf16 as
    ml_dtypes): Linear and conv weights at 1/sqrt(fan_in), small biases,
    LayerNorm gains near 1, the token embedding at emb_scale/sqrt(V) so the
    logits spread (every decode decision far from a tie). Some weights sit
    exactly halfway between two bf16 values, so rounding to bf16 meets
    ties."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in hf_whisper_shapes(cfg).items():
        if name == "proj_out.weight":
            out[name] = out["model.decoder.embed_tokens.weight"]
            continue
        if "layer_norm" in name:
            base = 1.0 if name.endswith("weight") else 0.0
            a = base + 0.1 * rng.standard_normal(shape)
        elif name.endswith("bias"):
            a = 0.02 * rng.standard_normal(shape)
        elif "embed_tokens" in name:
            a = rng.standard_normal(shape) * emb_scale / np.sqrt(shape[0])
        elif "embed_positions" in name:
            a = rng.standard_normal(shape) / np.sqrt(shape[0])
        else:
            a = rng.standard_normal(shape) / np.sqrt(shape[1])
        a = a.astype(np.float32)
        if name.endswith("fc1.weight"):
            # 1 + 2^-8 and -(3 + 2^-7): halfway between bf16 neighbours,
            # to nearest even 1 and -3
            a.flat[:2] = (1.0 + 2.0 ** -8, -(3.0 + 2.0 ** -7))
        out[name] = a.astype(dtype)
    return out


def _torch(tensors):
    """numpy arrays (bf16 as ml_dtypes) → CPU torch tensors, bits kept."""
    return {n: tw._leaf_from_numpy(a, "cpu") for n, a in tensors.items()}


def write_checkpoint(path, tensors, shards=2):
    """``tensors`` (numpy) as HF shards in ``path``, split by key order;
    bf16 through safetensors.torch, the rest through safetensors.numpy."""
    from safetensors.numpy import save_file as save_np
    from safetensors.torch import save_file as save_pt

    os.makedirs(path, exist_ok=True)
    names = [n for n in tensors if n != "proj_out.weight"]  # tied, as HF saves
    for i in range(shards):
        part = {n: tensors[n] for n in names[i::shards]}
        fname = os.path.join(path, f"model-{i + 1:05d}-of-{shards:05d}.safetensors")
        if any(a.dtype.name == "bfloat16" for a in part.values()):
            save_pt(_torch(part), fname, metadata={"format": "pt"})
        else:
            save_np(part, fname, metadata={"format": "np"})


# --------------------------------------------------------------------------- #
# the reader
# --------------------------------------------------------------------------- #
def test_reader_equals_safe_open(tmp_path):
    from safetensors import safe_open
    from safetensors.numpy import save_file as save_np
    from safetensors.torch import save_file as save_pt

    rng = np.random.default_rng(0)
    save_np({"a.f32": rng.standard_normal((3, 5)).astype(np.float32),
             "b.f16": rng.standard_normal((7,)).astype(np.float16),
             "scalar": np.asarray(2.5, np.float32),
             "empty": np.zeros((0, 4), np.float32)},
            str(tmp_path / "model-00001-of-00002.safetensors"))
    save_pt({"c.bf16": torch.randn(4, 3, 2, generator=torch.Generator().manual_seed(1))
             .bfloat16(), "d.f32": torch.arange(6.0).reshape(2, 3)},
            str(tmp_path / "model-00002-of-00002.safetensors"), metadata={"format": "pt"})
    got = tw._hf_tensors(str(tmp_path))
    want = {}
    for f in sorted(os.listdir(tmp_path)):
        with safe_open(str(tmp_path / f), framework="pt") as h:
            want.update({k: h.get_tensor(k) for k in h.keys()})
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)


def test_reader_takes_shards_in_sorted_order(tmp_path):
    from safetensors.numpy import save_file as save_np

    save_np({"w": np.ones(2, np.float32)}, str(tmp_path / "b.safetensors"))
    save_np({"w": np.zeros(2, np.float32)}, str(tmp_path / "a.safetensors"))
    assert tw._hf_tensors(str(tmp_path))["w"].tolist() == [1.0, 1.0]  # the later shard wins
    empty = tmp_path / "none"
    empty.mkdir()
    (empty / "config.json").write_text("{}")
    assert tw._hf_tensors(str(empty)) is None


def _raw(header, data: bytes) -> bytes:
    h = json.dumps(header).encode()
    return len(h).to_bytes(8, "little") + h + data


@pytest.mark.parametrize(
    "blob,match",
    [
        (b"\x05\x00", "no header"),
        ((1 << 40).to_bytes(8, "little") + b"{}", "overruns the file"),
        (b"\x04" + b"\x00" * 7 + b"{x:1", "not JSON"),
        (_raw({"a": {"dtype": "I64", "shape": [1], "data_offsets": [0, 8]}}, b"\0" * 8),
         "I64 is not F32"),
        (_raw({"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}, b"\0" * 8),
         "overrun"),
        (_raw({"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}, b"\0" * 8),
         "8 bytes for F32"),
        (_raw({"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
               "b": {"dtype": "F16", "shape": [2], "data_offsets": [4, 8]}}, b"\0" * 8),
         "overlaps"),
        (_raw({"a": {"dtype": "F32", "shape": [-2], "data_offsets": [0, 8]}}, b"\0" * 8),
         "shape"),
        (_raw({"a": {"dtype": "F32"}}, b""), "malformed"),
    ],
    ids=["short", "header-overrun", "not-json", "dtype", "offsets-overrun", "size",
         "overlap", "negative-shape", "missing-offsets"],
)
def test_reader_refuses_malformed_files(tmp_path, blob, match):
    p = tmp_path / "bad.safetensors"
    p.write_bytes(blob)
    with pytest.raises(SafetensorsError, match=match):
        read_safetensors(str(p))


# --------------------------------------------------------------------------- #
# the conversion
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("spec", [MICRO, MICRO_V3], ids=["micro", "micro-v3"])
@pytest.mark.parametrize("src", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_hf_bit_equal_to_jax(spec, src, dtype):
    from wis_tpu.models.whisper.weights import params_from_hf as jax_params_from_hf

    cfg = WhisperConfig(**spec)
    tensors = hf_checkpoint(cfg, seed=len(src) + len(dtype),
                            dtype=getattr(jnp, src) if src == "bfloat16" else getattr(np, src))
    want = dict(_leaves(jax_params_from_hf(tensors, JaxConfig(**spec), getattr(jnp, dtype))))
    got = dict(_leaves(tw.params_from_hf(_torch(tensors), cfg, getattr(torch, dtype), "cpu")))
    assert got.keys() == want.keys()
    for name, w in want.items():
        w = np.asarray(w)
        t = got[name]
        assert tuple(t.shape) == w.shape and str(t.dtype).removeprefix("torch.") == w.dtype.name, name
        np.testing.assert_array_equal(_bits(t), _bits(w), err_msg=name)
    # the tie cases rounded to nearest even
    w1 = got["/encoder/blocks/mlp/w1"]
    if dtype == "bfloat16" and src == "float32":
        assert w1[0, 0, 0].item() == 1.0 and w1[0, 1, 0].item() == -3.0


# --------------------------------------------------------------------------- #
# the registry
# --------------------------------------------------------------------------- #
@pytest.fixture
def micro_registered():
    JAX_CONFIGS[MICRO["name"]] = JaxConfig(**MICRO)
    WHISPER_CONFIGS[MICRO["name"]] = WhisperConfig(**MICRO)
    try:
        yield MICRO["name"]
    finally:
        JAX_CONFIGS.pop(MICRO["name"], None)
        WHISPER_CONFIGS.pop(MICRO["name"], None)


def _port_settings(root, **kw):
    from wis_tpu_torch.settings import APISettings

    base = dict(whisper_model_default=MICRO["name"], dtype="float32", max_decode_tokens=8,
                beam_size=1, long_beam_size=5, model_dir=str(root))
    return APISettings(**{**base, **kw})


def test_registry_loads_the_checkpoint_and_caches_it(tmp_path, micro_registered):
    from wis_tpu_torch.runtime.residency import ModelRegistry

    size = micro_registered
    cfg = WHISPER_CONFIGS[size]
    tensors = hf_checkpoint(cfg, seed=3, dtype=np.float16)
    write_checkpoint(str(tmp_path / size), tensors)
    os.makedirs(tmp_path / size / "_converted")  # the JAX package's cache: not read
    (tmp_path / size / "_converted" / "junk").write_text("not a checkpoint")
    want = dict(_leaves(tw.params_from_hf(_torch(tensors), cfg, torch.float32, "cpu")))

    def load():
        reg = ModelRegistry(_port_settings(tmp_path, quant="none"), "cpu")
        return reg.get(size)

    first = load()
    cache = tmp_path / size / "_converted_torch" / "params-float32.pt"
    assert cache.is_file() and sorted(os.listdir(tmp_path / size / "_converted")) == ["junk"]
    for f in os.listdir(tmp_path / size):  # the second load reads the cache alone
        if f.endswith(".safetensors"):
            os.remove(tmp_path / size / f)
    second = load()
    for model in (first, second):
        got = dict(_leaves(model.params))
        assert got.keys() == want.keys()
        for name, w in want.items():
            assert torch.equal(got[name], w), name
    assert first.model_dir == str(tmp_path / size)
    # int8 as the JAX registry: the decoder quantized after loading
    quantized = ModelRegistry(_port_settings(tmp_path), "cpu").get(size)
    assert "tok_emb_q" in quantized.params["decoder"]


def test_registry_without_a_checkpoint_keeps_seeded_random(tmp_path, micro_registered):
    from wis_tpu_torch.runtime.residency import ModelRegistry, stable_seed

    size = micro_registered
    params = ModelRegistry(_port_settings(tmp_path, quant="none"), "cpu").get(size).params
    want = tw.random_params(WHISPER_CONFIGS[size], stable_seed(size), "cpu", torch.float32)
    for (name, a), (_, b) in zip(_leaves(params), _leaves(want)):
        assert torch.equal(a, b), name
    assert not os.listdir(tmp_path)


def test_save_failure_only_warns(tmp_path, micro_registered, caplog):
    from wis_tpu_torch.models.whisper import checkpoint

    size = micro_registered
    write_checkpoint(str(tmp_path / size), hf_checkpoint(WHISPER_CONFIGS[size], seed=4), 1)
    (tmp_path / size / "_converted_torch").write_text("a file where the cache dir goes")
    params = tw.load_or_init_params(WHISPER_CONFIGS[size], str(tmp_path / size), 0, "cpu",
                                    torch.float32)
    assert params["encoder"]["pos"].dtype == torch.float32
    assert "save failed" in caplog.text
    assert checkpoint.load_params(str(tmp_path / "missing.pt"), "cpu") is None


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_would_fit_and_memory_error_equal_jax(dtype):
    from wis_tpu.runtime.residency import ModelRegistry as JaxRegistry
    from wis_tpu.settings import APISettings as JaxSettings
    from wis_tpu_torch.runtime.residency import ModelRegistry
    from wis_tpu_torch.settings import APISettings

    for budget in (4 * 2**30, 5 * 2**30, 6 * 2**30, 8 * 2**30, 16 * 2**30):
        jr = JaxRegistry(JaxSettings(dtype=dtype, hbm_budget_bytes=budget))
        tr = ModelRegistry(APISettings(dtype=dtype, hbm_budget_bytes=budget), "cpu")
        for size, cfg in WHISPER_CONFIGS.items():
            assert tr.would_fit(cfg) == jr.would_fit(JAX_CONFIGS[size]), (budget, size)
    settings = dict(dtype=dtype, hbm_budget_bytes=2**30)
    jr = JaxRegistry(JaxSettings(**settings))
    tr = ModelRegistry(APISettings(**settings), "cpu")
    with pytest.raises(MemoryError) as want:
        jr.get("tiny")
    with pytest.raises(MemoryError) as got:
        tr.get("tiny")
    assert str(got.value) == str(want.value)


def test_settings_carry_the_budget():
    from wis_tpu.settings import APISettings as JaxSettings
    from wis_tpu_torch.settings import APISettings

    fields = {f.name for f in dataclasses.fields(APISettings)}
    assert "hbm_budget_bytes" in fields
    assert APISettings().hbm_budget_bytes == JaxSettings().hbm_budget_bytes == 16 * 2**30


# --------------------------------------------------------------------------- #
# both packages on one checkpoint directory
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def checkpoint_engines(tmp_path_factory):
    """(JAX engine, port engine) whose registries read the same f16
    checkpoint directory of the micro config."""
    from wis_tpu.runtime.engine import WhisperEngine as JaxEngine
    from wis_tpu.runtime.residency import ModelRegistry as JaxRegistry
    from wis_tpu.settings import APISettings as JaxSettings
    from wis_tpu_torch.runtime.engine import WhisperEngine
    from wis_tpu_torch.runtime.residency import ModelRegistry

    root = tmp_path_factory.mktemp("models")
    size = MICRO["name"]
    JAX_CONFIGS[size] = JaxConfig(**MICRO)
    WHISPER_CONFIGS[size] = WhisperConfig(**MICRO)
    write_checkpoint(str(root / size), hf_checkpoint(WHISPER_CONFIGS[size], seed=7,
                                                     dtype=np.float16))
    try:
        ps = _port_settings(root)
        js = JaxSettings(**dict(dataclasses.asdict(ps), batch_window_s=0.01))
        jax_engine = JaxEngine(JaxRegistry(js), js)
        port = WhisperEngine(ModelRegistry(ps, "cpu"))
        jax_engine.registry.get(size)
        port.registry.get(size)
        yield jax_engine, port, size
    finally:
        JAX_CONFIGS.pop(size, None)
        WHISPER_CONFIGS.pop(size, None)


def test_both_registries_hold_the_checkpoint(checkpoint_engines):
    jax_engine, port, size = checkpoint_engines
    want = dict(_leaves(jax_engine.registry.get(size).params))
    got = dict(_leaves(port.registry.get(size).params))
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_array_equal(_bits(got[name]), _bits(w), err_msg=name)
    d = port.registry.get(size).model_dir
    assert os.path.isdir(os.path.join(d, "_converted_torch"))


@pytest.mark.parametrize("beam,detect,seed", [(1, False, 1), (5, True, 2)])
def test_engines_on_one_checkpoint_agree(checkpoint_engines, beam, detect, seed):
    from wis_tpu.decoding.fused import build_asr_program as jax_program
    from wis_tpu.models.whisper.tokenizer import (
        DEFAULT_BEGIN_SUPPRESS,
        DEFAULT_SUPPRESS_TOKENS,
        build_prompt,
    )
    from wis_tpu_torch.decoding.fused import build_asr_program, pack_ctl

    jax_engine, port, size = checkpoint_engines
    n = 64000
    kw = dict(beam_size=beam, batch=2, max_new_tokens=8, prompt_len=4,
              suppress_tokens=DEFAULT_SUPPRESS_TOKENS,
              begin_suppress_tokens=DEFAULT_BEGIN_SUPPRESS,
              detect_language=detect, n_samples=n)
    audio = audio_i16(n, seed=seed, batch=2)
    prompts = np.asarray([build_prompt("en"), build_prompt("de")], np.int32)
    ctl = pack_ctl(prompts, np.asarray([1, 0], np.int32), 8)
    want = np.asarray(jax_program(JAX_CONFIGS[size], **kw)(
        jax_engine.registry.get(size).params, jnp.asarray(audio), jnp.asarray(ctl)))
    with torch.inference_mode():
        got = build_asr_program(WHISPER_CONFIGS[size], **kw)(
            port.registry.get(size).params, torch.from_numpy(audio), torch.from_numpy(ctl))
    np.testing.assert_array_equal(got.numpy(), want)
    tk = dict(model=size, beam_size=beam, detect_language=detect, max_tokens=8)
    j_res = jax_engine.transcribe(audio[0], **tk)
    t_res = port.transcribe(audio[0], **tk)
    assert t_res.text and t_res.text == j_res.text and t_res.language == j_res.language
