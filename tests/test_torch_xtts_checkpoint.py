"""The port's Coqui XTTS checkpoint path (``wis_tpu_torch/models/xtts/
convert.py`` and ``XTTSModel(model_dir=...)``) held against wis_tpu's on
the CPU, at micro configs:

- the converters give the JAX package's trees leaf for leaf, bit for bit
  (f32 and bf16 outputs), on seeded state dicts with the vocoder's
  weight-norm in both key styles and on the JAX package's zero-filled
  ``synthetic_coqui_sd``; the port's copy of that key list equals the
  JAX one's GPT and HiFi-GAN half;
- a ``model.pth`` written with ``torch.save`` gives a JAX and a port
  ``XTTSModel`` the same (int8-quantized) GPT and vocoder trees and the
  same sampled stream for the same gumbel rows, within the stream tests'
  1e-3;
- a checkpoint missing a key keeps the seeded weights in both packages,
  and a bf16 ``model.pth`` (which the JAX loader cannot read) converts in
  the port to its f32 values rounded once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_gumbel_rows
from wis_tpu.models.xtts import convert as jc
from wis_tpu.models.xtts import gpt as jg
from wis_tpu.models.xtts import hifigan as jh
from wis_tpu.models.xtts import model as jm
from wis_tpu.models.xtts.conditioning import ConditioningConfig
from wis_tpu.utils.selftest import synthetic_coqui_sd as jax_synthetic_coqui_sd
from wis_tpu_torch.models.xtts import convert as tc
from wis_tpu_torch.models.xtts import gpt as tg
from wis_tpu_torch.models.xtts import hifigan as th
from wis_tpu_torch.models.xtts import model as tm
from wis_tpu_torch.utils.selftest import synthetic_coqui_sd

torch.set_num_threads(1)

GPT = dict(n_layer=2, n_head=2, d_model=32, n_text_vocab=256, n_audio_vocab=68,
           max_text_tokens=32, max_audio_tokens=40, start_audio_token=66,
           stop_audio_token=67)
VOC = dict(in_dim=32, cond_dim=16, upsample_initial=32, upsample_rates=(4, 2),
           upsample_kernels=(8, 4), resblock_kernels=(3,), resblock_dilations=((1, 3),),
           gpt_code_stride=16)
JGPT, TGPT = jg.GPTConfig(**GPT), tg.GPTConfig(**GPT)
JVOC, TVOC = jh.HiFiGANConfig(**VOC), th.HiFiGANConfig(**VOC)
KW = dict(text_buckets=(8, 16, 32), cond_len=4, left_context_frames=2)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _seeded_sd(style: str):
    """A seeded micro checkpoint; the vocoder's weight-norm in ``style``
    ("legacy": weight_g/weight_v, "parametrizations": original0/1), its
    gains away from 1 so the norm matters, and per-stage ``conds``."""
    sd = synthetic_coqui_sd(TGPT, TVOC, seed=7)
    gen = torch.Generator().manual_seed(8)
    h = "hifigan_decoder.waveform_decoder."
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight_g"):
            v = 0.5 + torch.rand(v.shape, generator=gen)
        if style == "parametrizations":
            k = k.replace(".weight_g", ".parametrizations.weight.original0")
            k = k.replace(".weight_v", ".parametrizations.weight.original1")
        out[k] = v
    ch = TVOC.upsample_initial
    for i in range(len(TVOC.upsample_rates)):
        ch //= 2
        out[h + f"conds.{i}.weight"] = torch.randn((ch, TVOC.cond_dim, 1), generator=gen)
        out[h + f"conds.{i}.bias"] = torch.randn(ch, generator=gen)
    return out


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_trees_equal(port, want, path=""):
    if isinstance(want, dict):
        assert isinstance(port, dict) and set(port) == set(want), path
        for k in want:
            _assert_trees_equal(port[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(port) == len(want), path
        for i, (p, w) in enumerate(zip(port, want)):
            _assert_trees_equal(p, w, f"{path}/{i}")
    else:
        w = np.asarray(want)
        assert tuple(port.shape) == w.shape, path
        assert str(port.dtype).split(".")[-1] == str(w.dtype), (path, port.dtype, w.dtype)
        np.testing.assert_array_equal(port.float().numpy(), w.astype(np.float32), err_msg=path)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("style", ["legacy", "parametrizations"])
def test_converters_match_jax_leaf_for_leaf(style, dtype):
    jdt, tdt = DTYPES[dtype]
    sd = _seeded_sd(style)
    _assert_trees_equal(tc.gpt_from_coqui(sd, TGPT, tdt), jc.gpt_from_coqui(_np(sd), JGPT, jdt))
    _assert_trees_equal(tc.hifigan_from_coqui(sd, TVOC, tdt),
                        jc.hifigan_from_coqui(_np(sd), JVOC, jdt))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_converters_match_jax_on_its_synthetic_checkpoint(dtype):
    """The JAX package's zero-filled key list (conditioning keys left
    unread) converts to the same trees, and the port's copy of its GPT and
    HiFi-GAN half has the same keys, shapes and values."""
    jdt, tdt = DTYPES[dtype]
    jsd = jax_synthetic_coqui_sd(JGPT, JVOC, ConditioningConfig())
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in jsd.items()}
    _assert_trees_equal(tc.gpt_from_coqui(sd, TGPT, tdt), jc.gpt_from_coqui(jsd, JGPT, jdt))
    _assert_trees_equal(tc.hifigan_from_coqui(sd, TVOC, tdt),
                        jc.hifigan_from_coqui(jsd, JVOC, jdt))
    mine = synthetic_coqui_sd(TGPT, TVOC)
    half = {k: v.shape for k, v in jsd.items()
            if k.startswith(("gpt.", "hifigan_decoder.")) and "conditioning" not in k}
    assert {k: tuple(v.shape) for k, v in mine.items()} == half
    for k, v in mine.items():
        np.testing.assert_array_equal(v.numpy(), jsd[k], err_msg=k)


def _write(tmp_path, sd):
    torch.save(sd, tmp_path / "model.pth")
    return str(tmp_path)


def _models(model_dir):
    jmodel = jm.XTTSModel(model_dir, cfg=jm.XTTSConfig(gpt=JGPT, vocoder=JVOC, **KW),
                          dtype=jnp.float32)
    port = tm.XTTSModel("cpu", cfg=tm.XTTSConfig(gpt=TGPT, vocoder=TVOC, **KW),
                        dtype=torch.float32, model_dir=model_dir, fused="on")
    return jmodel, port


def test_model_pth_serves_the_same_weights_and_stream(tmp_path, monkeypatch):
    model_dir = _write(tmp_path, {"model": _seeded_sd("legacy")})
    monkeypatch.setenv("XTTS_FUSED", "0")
    jmodel, port = _models(model_dir)
    _assert_trees_equal(port.gpt_params, jmodel.gpt_params)
    _assert_trees_equal(port.vocoder_params, jmodel.vocoder_params)
    seeded = tg.random_gpt(TGPT, seed=0, dtype=torch.float32)
    assert not torch.equal(port.gpt_params["text_emb"], seeded["text_emb"])

    rng = np.random.default_rng(5)
    latent = rng.standard_normal((4, 32)).astype(np.float32) * 0.1
    speaker = rng.standard_normal(16).astype(np.float32)
    kw = dict(stream_chunk_size=8, overlap_wav_len=16, do_sample=True, temperature=1.0,
              top_k=30, top_p=0.95, seed=11, min_audio_tokens=10)
    want = list(jmodel.inference_stream("checkpoint speech", "en", latent, speaker, **kw))
    key = [jax.random.PRNGKey(kw["seed"])]

    def jax_rows(gen, n):
        key[0], sub = jax.random.split(key[0])
        return torch.from_numpy(jax_gumbel_rows(sub, n, TGPT.n_audio_vocab))

    monkeypatch.setattr(port, "_gumbel", jax_rows)
    got = list(port.inference_stream("checkpoint speech", "en", latent, speaker, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.abs(g - w).max() <= 1e-3


def test_missing_key_keeps_the_seeded_weights_in_both(tmp_path):
    sd = _seeded_sd("legacy")
    del sd["gpt.gpt.h.1.mlp.c_fc.weight"]
    jmodel, port = _models(_write(tmp_path, sd))
    seeded_j, seeded_t = _models(None)
    _assert_trees_equal(port.gpt_params, jmodel.gpt_params)
    _assert_trees_equal(port.vocoder_params, jmodel.vocoder_params)
    _assert_trees_equal(port.gpt_params, seeded_t.gpt_params)
    _assert_trees_equal(port.vocoder_params, seeded_t.vocoder_params)


def test_a_vocoder_fault_keeps_both_trees_seeded(tmp_path):
    """A checkpoint whose GPT converts but whose vocoder does not keeps
    both seeded trees (never a checkpoint GPT with a seeded vocoder)."""
    sd = _seeded_sd("legacy")
    del sd["hifigan_decoder.waveform_decoder.conv_post.bias"]
    port = _models(_write(tmp_path, sd))[1]
    seeded = _models(None)[1]
    _assert_trees_equal(port.gpt_params, seeded.gpt_params)
    _assert_trees_equal(port.vocoder_params, seeded.vocoder_params)


def test_bf16_checkpoint_converts(tmp_path):
    """A bf16 ``model.pth`` loads with its dtype kept and converts to the
    trees of its values widened to f32 (exact), not to the seeded ones."""
    from wis_tpu_torch.ops.quant import quantize_gpt_params

    sd16 = {k: v.to(torch.bfloat16) for k, v in _seeded_sd("parametrizations").items()}
    port = _models(_write(tmp_path, sd16))[1]
    assert tc.load_coqui_checkpoint(str(tmp_path / "model.pth"))[
        "gpt.text_embedding.weight"].dtype == torch.bfloat16
    up = {k: v.float() for k, v in sd16.items()}
    _assert_trees_equal(port.gpt_params,
                        quantize_gpt_params(tc.gpt_from_coqui(up, TGPT, torch.float32)))
    _assert_trees_equal(port.vocoder_params, tc.hifigan_from_coqui(up, TVOC, torch.float32))
    assert not torch.equal(port.gpt_params["text_emb"], _models(None)[1].gpt_params["text_emb"])
