"""XTTS GPT tensor parallelism in the port (``parallel/mesh.py``
``xtts_gpt_param_specs``, ``models/xtts/gpt.py`` under ``tp``) held
against ``wis_tpu``'s (tests/test_xtts_tp.py), on the CPU in f32.

One world of four ``gloo`` ranks runs every case once: 2-way TP on a
2×2 mesh (both data rows decode the same inputs) and 4-way on 1×4, each
with f32 and int8 block weights. The port's ``random_gpt`` and
``quantize_gpt_params`` are bit-equal to JAX's, so both sides build the
same weights from the seed. Greedy tokens equal JAX's tensor-parallel
run's; latents within ``rtol=1e-4, atol=1e-5``. JAX is imported inside
the tests only: the ranks import this module and need no JAX.
"""

import numpy as np
import pytest
import torch

from wis_tpu_torch.models.xtts.gpt import (
    GPTConfig,
    build_prefill,
    random_gpt,
    run_decode_chunk,
)
from wis_tpu_torch.ops.quant import quantize_gpt_params
from wis_tpu_torch.parallel.mesh import make_mesh, shard_params, xtts_gpt_param_specs
from wis_tpu_torch.parallel.world import run_world

torch.set_num_threads(1)

CFG_KW = dict(n_layer=2, n_head=4, d_model=32, n_text_vocab=64, n_audio_vocab=36,
              max_text_tokens=16, max_audio_tokens=24, start_audio_token=34,
              stop_audio_token=35)
CFG = GPTConfig(**CFG_KW)
COND, TEXT, CHUNK = 2, 4, 6
MAX_LEN = COND + TEXT + 1 + CFG.max_audio_tokens
#: (n_data, n_model) meshes of the four-rank world
MESHES = [(2, 2), (1, 4)]
QUANTS = ["none", "int8"]


def _cond():
    return np.random.default_rng(1).standard_normal((1, COND, CFG.d_model)).astype(np.float32)


def _decode_once(params, tp=None):
    """test_xtts_tp.py's _decode_once: prefill + one greedy chunk
    (top_k 5, top_p 0.9, repetition penalty 2.0) → (tokens, latents)."""
    prefill = build_prefill(CFG, batch=1, cond_len=COND, text_len=TEXT, max_len=MAX_LEN, tp=tp)
    _, cache = prefill(params, torch.from_numpy(_cond()), torch.tensor([[3, 5, 7, 9]]))
    tokens, latents, *_ = run_decode_chunk(
        params, torch.full((1,), CFG.start_audio_token), cache,
        torch.zeros((1, CFG.max_audio_tokens), dtype=torch.long), 0,
        torch.zeros((CHUNK, 1, CFG.n_audio_vocab)), 1.0, 5, 0.9, 2.0, False,
        cfg=CFG, chunk=CHUNK, batch=1, tp=tp)
    return tokens.numpy(), latents.numpy()


def _params(quant):
    params = random_gpt(CFG, seed=0, dtype=torch.float32)
    return quantize_gpt_params(params) if quant == "int8" else params


def _rank_cases(rank, devices):
    out = {}
    with torch.inference_mode():
        for n_data, n_model in MESHES:
            mesh = make_mesh(n_data, n_model, devices)
            for quant in QUANTS:
                local = shard_params(_params(quant), mesh, xtts_gpt_param_specs())
                out[(n_model, quant)] = _decode_once(local, mesh.model_axis)
    return out


@pytest.fixture(scope="module")
def port_tp():
    reports = run_world(_rank_cases, ["cpu"] * 4, timeout=600)
    for r in reports[1:]:
        for key, (tokens, latents) in r.items():
            np.testing.assert_array_equal(tokens, reports[0][key][0])
            np.testing.assert_array_equal(latents, reports[0][key][1])
    return reports[0]


def _jax_decode(n_model, quant):
    """JAX's tensor-parallel run (tests/test_xtts_tp.py) on its virtual
    mesh."""
    import jax
    import jax.numpy as jnp

    from wis_tpu.models.xtts.gpt import GPTConfig as JaxGPTConfig
    from wis_tpu.models.xtts.gpt import build_decode_chunk, build_prefill as jprefill
    from wis_tpu.models.xtts.gpt import random_gpt as jrandom_gpt
    from wis_tpu.ops.quant import quantize_gpt_params as jquantize
    from wis_tpu.parallel.mesh import make_mesh as jmake_mesh
    from wis_tpu.parallel.mesh import shard_params as jshard
    from wis_tpu.parallel.mesh import xtts_gpt_param_specs as jspecs

    cfg = JaxGPTConfig(**CFG_KW)
    params = jrandom_gpt(cfg, seed=0, dtype=jnp.float32)
    if quant == "int8":
        params = jquantize(params)
    params = jshard(params, jmake_mesh(n_data=1, n_model=n_model), jspecs())
    prefill = jprefill(cfg, batch=1, cond_len=COND, text_len=TEXT, max_len=MAX_LEN)
    decode = build_decode_chunk(cfg, batch=1, chunk=CHUNK, max_len=MAX_LEN)
    _, cache = prefill(params, jnp.asarray(_cond()), jnp.asarray([[3, 5, 7, 9]], jnp.int32))
    tokens, latents, *_ = decode(
        params, jnp.full((1,), cfg.start_audio_token, jnp.int32), cache,
        jnp.zeros((1, cfg.max_audio_tokens), jnp.int32), jnp.int32(0), jax.random.PRNGKey(0),
        jnp.float32(1.0), jnp.int32(5), jnp.float32(0.9), jnp.float32(2.0), jnp.bool_(False))
    return np.asarray(tokens), np.asarray(latents)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("n_model", [2, 4])
def test_tp_decode_matches_jax(port_tp, n_model, quant):
    """Tensor parallelism is a pure layout change in the port too, in the
    production parameter form (int8 blocks, the per-output-channel scales
    split with their columns): the greedy tokens of JAX's TP run, its
    latents within rtol 1e-4, atol 1e-5, and the port's single-device run's."""
    tokens, latents = port_tp[(n_model, quant)]
    ref_tokens, ref_latents = _jax_decode(n_model, quant)
    np.testing.assert_array_equal(tokens, ref_tokens)
    np.testing.assert_allclose(latents, ref_latents, rtol=1e-4, atol=1e-5)
    with torch.inference_mode():
        one_tokens, one_latents = _decode_once(_params(quant))
    np.testing.assert_array_equal(tokens, one_tokens)
    np.testing.assert_allclose(latents, one_latents, rtol=1e-4, atol=1e-5)


def test_specs_cover_param_tree():
    """Every GPT parameter leaf has a spec of its rank or less, and the
    head-split axes divide evenly (test_xtts_tp.py's check, on the port's
    tree)."""
    params = random_gpt(CFG, seed=0, dtype=torch.float32)
    specs = xtts_gpt_param_specs()

    def walk(spec, leaf):
        if isinstance(leaf, dict):
            assert set(spec) == set(leaf)
            for k in leaf:
                walk(spec[k], leaf[k])
        else:
            assert len(spec) <= leaf.dim()
            for dim, name in enumerate(spec):
                if name == "model":
                    assert leaf.shape[dim] % 4 == 0

    walk(specs, params)
    for leaf in ("q_w", "k_w", "v_w"):
        assert params["blocks"][leaf].shape[-1] == CFG.d_model


def test_fused_gpt_path_refuses_tp():
    from wis_tpu_torch.models.xtts.gpt import run_decode_chunk_fused
    from wis_tpu_torch.parallel.mesh import ModelAxis

    with pytest.raises(ValueError, match="tensor parallelism"):
        run_decode_chunk_fused(None, None, None, None, None, None, 0, None, 0, None,
                               1.0, 5, 0.9, 2.0, False, cfg=CFG, chunk=1, batch=1,
                               tp=ModelAxis(2, 0))
