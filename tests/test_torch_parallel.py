"""The port's mesh (``wis_tpu_torch/parallel/mesh.py``) held against
``wis_tpu/parallel/mesh.py`` (tests/test_parallel.py's cases), on the CPU
in f32.

The port's ranks are processes of a ``torch.distributed`` world on
``gloo`` (``parallel/world.run_world``); one world of two ranks (TP 2 and
DP 2) and one of four (TP 4, DP×TP 2×2, TP 4 with int8 encoder and
decoder weights) run every case once per module. Their prefill logits
are held to the port's single-device forward and to JAX's tensor-parallel
forward on the virtual 8-device mesh, on the same weights (JAX's tree
bridged), at test_parallel.py's ``atol=2e-3, rtol=1e-3``. The spec trees
and each rank's ``shard_params`` slices are held equal to JAX's, leaf for
leaf (no world needed), and ``tp=None`` to the single-device path as it
was, bit for bit.

JAX is imported inside the tests only: the ranks import this module to
find their function, and need no JAX.
"""

import numpy as np
import pytest
import torch

from wis_tpu_torch.models.whisper.config import WhisperConfig
from wis_tpu_torch.models.whisper.model import DecoderCache, cross_kv, encode, prefill
from wis_tpu_torch.models.whisper.tokenizer import SOT
from wis_tpu_torch.models.whisper.weights import params_from_jax
from wis_tpu_torch.parallel.mesh import (
    P,
    Mesh,
    batch_sharding,
    make_mesh,
    replicate_params,
    shard_params,
    whisper_param_specs,
)
from wis_tpu_torch.parallel.world import run_world

torch.set_num_threads(1)

MICRO = dict(name="micro-tp", n_audio_state=64, n_audio_head=4, n_audio_layer=2,
             n_text_state=64, n_text_head=4, n_text_layer=2)
CFG = WhisperConfig(**MICRO)
TOL = dict(atol=2e-3, rtol=1e-3)
#: (case, n_data, n_model, weights) for each world size
WORLDS = {
    2: [("tp2", 1, 2, "f32"), ("dp2", 2, 1, "f32")],
    4: [("tp4", 1, 4, "f32"), ("dp2xtp2", 2, 2, "f32"), ("tp4_int8", 1, 4, "int8")],
}


def _forward(params, mel, tp=None):
    """test_parallel.py's _forward: encoder, cross-KV, SOT prefill → the
    last position's logits (B, V)."""
    xa = encode(params, mel, CFG, tp)
    xa_kv = cross_kv(params, xa, CFG, tp)
    cache = DecoderCache.zeros(CFG, mel.shape[0], 4, torch.float32, mel.device, tp)
    sot = torch.full((mel.shape[0], 1), SOT, dtype=torch.long)
    logits, _ = prefill(params, sot, cache, xa_kv, CFG, tp)
    return logits[:, -1]


def _rank_cases(rank, devices, trees, mel, cases):
    """One rank: each case's mesh, this rank's shard, the forward on its
    batch slice; the data axis gathers the batch back. → {case: logits}."""
    out = {}
    with torch.inference_mode():
        for name, n_data, n_model, key in cases:
            mesh = make_mesh(n_data, n_model, devices)
            params = params_from_jax(trees[key], mesh.device)
            if n_model > 1:
                local = shard_params(params, mesh, whisper_param_specs(CFG))
            else:
                local = replicate_params(params, mesh)
            logits = _forward(local, batch_sharding(mesh)(torch.from_numpy(mel)),
                              mesh.model_axis if n_model > 1 else None)
            out[name] = mesh.data_axis.all_gather(logits, dim=0).numpy()
    return out


@pytest.fixture(scope="module")
def jax_side():
    """The JAX trees (f32; int8 encoder + decoder as test_parallel.py's
    int8 case), a seeded mel of two windows, the single-device logits and
    JAX's logits on each case's mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from torch_port_helpers import np_tree
    from wis_tpu.models.whisper.config import WhisperConfig as JaxConfig
    from wis_tpu.models.whisper.model import DecoderCache as JCache
    from wis_tpu.models.whisper.model import cross_kv as jcross_kv
    from wis_tpu.models.whisper.model import encode as jencode
    from wis_tpu.models.whisper.model import prefill as jprefill
    from wis_tpu.models.whisper.weights import random_params
    from wis_tpu.ops.quant import quantize_whisper_params
    from wis_tpu.parallel import mesh as jmesh

    jcfg = JaxConfig(**MICRO)

    def forward(params, mel):
        xa = jencode(params, mel, jcfg)
        xa_kv = jcross_kv(params, xa, jcfg)
        cache = JCache.zeros(jcfg, mel.shape[0], 4, jnp.float32)
        sot = jnp.full((mel.shape[0], 1), SOT, jnp.int32)
        logits, _ = jprefill(params, sot, cache, xa_kv, jcfg)
        return logits[:, -1]

    f32 = random_params(jcfg, seed=3, dtype=jnp.float32)
    trees = {"f32": f32,
             "int8": quantize_whisper_params(f32, subtrees=("encoder", "decoder"))}
    mel = np.random.default_rng(0).standard_normal((2, 80, 3000)).astype(np.float32)
    single = {k: np.asarray(jax.jit(forward)(t, jnp.asarray(mel))) for k, t in trees.items()}
    sharded = {}
    for worlds in WORLDS.values():
        for name, n_data, n_model, key in worlds:
            mesh = jmesh.make_mesh(n_data=n_data, n_model=n_model)
            if n_model > 1:
                params = jmesh.shard_params(trees[key], mesh, jmesh.whisper_param_specs(jcfg))
            else:
                params = jmesh.replicate_params(trees[key], mesh)
            x = jax.device_put(jnp.asarray(mel), NamedSharding(mesh, JP("data", None, None)))
            sharded[name] = np.asarray(jax.jit(forward)(params, x))
    return dict(trees={k: np_tree(t) for k, t in trees.items()}, mel=mel, single=single,
                sharded=sharded)


@pytest.fixture(scope="module")
def port_side(jax_side):
    """Each world once: {case: logits} from rank 0 (every rank's equal)."""
    out = {}
    for n, cases in WORLDS.items():
        reports = run_world(_rank_cases, ["cpu"] * n,
                            (jax_side["trees"], jax_side["mel"], cases), timeout=600)
        for name in reports[0]:
            for r in reports[1:]:
                np.testing.assert_array_equal(r[name], reports[0][name])
        out.update(reports[0])
    return out


def _port_single(jax_side, key):
    params = params_from_jax(jax_side["trees"][key], "cpu")
    with torch.inference_mode():
        return _forward(params, torch.from_numpy(jax_side["mel"])).numpy()


@pytest.mark.parametrize("case", ["tp2", "tp4"])
def test_tensor_parallel_matches_single_device(jax_side, port_side, case):
    np.testing.assert_allclose(port_side[case], _port_single(jax_side, "f32"), **TOL)
    np.testing.assert_allclose(port_side[case], jax_side["sharded"][case], **TOL)
    np.testing.assert_allclose(port_side[case], jax_side["single"]["f32"], **TOL)


def test_data_parallel_batch_sharding(jax_side, port_side):
    np.testing.assert_allclose(port_side["dp2"], _port_single(jax_side, "f32"), **TOL)
    np.testing.assert_allclose(port_side["dp2"], jax_side["sharded"]["dp2"], **TOL)


def test_dp_tp_composed_mesh(jax_side, port_side):
    np.testing.assert_allclose(port_side["dp2xtp2"], _port_single(jax_side, "f32"), **TOL)
    np.testing.assert_allclose(port_side["dp2xtp2"], jax_side["sharded"]["dp2xtp2"], **TOL)


def test_tensor_parallel_with_int8_params(jax_side, port_side):
    """int8 encoder and decoder: the {"q", "s"} leaves take the weight's
    column/row split, column-parallel scales split with their outputs."""
    np.testing.assert_allclose(port_side["tp4_int8"], _port_single(jax_side, "int8"), **TOL)
    np.testing.assert_allclose(port_side["tp4_int8"], jax_side["sharded"]["tp4_int8"], **TOL)
    np.testing.assert_allclose(port_side["tp4_int8"], jax_side["single"]["int8"], **TOL)


# --------------------------------------------------------------------------- #
# Specs and shards against JAX's, leaf for leaf (no world)
# --------------------------------------------------------------------------- #
def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _spec_leaves(tree, prefix=""):
    if not isinstance(tree, dict):  # a P, or jax's PartitionSpec
        return {prefix: tuple(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_spec_leaves(v, f"{prefix}/{k}"))
    return out


def _jax_quant_trees():
    import jax.numpy as jnp

    from wis_tpu.models.whisper.config import WhisperConfig as JaxConfig
    from wis_tpu.models.whisper.weights import random_params
    from wis_tpu.ops.quant import quantize_whisper_params

    jcfg = JaxConfig(**MICRO)
    f32 = random_params(jcfg, seed=3, dtype=jnp.float32)
    return {"f32": f32, "int8": quantize_whisper_params(f32),
            "int8_all": quantize_whisper_params(f32, subtrees=("encoder", "decoder"))}


@pytest.mark.parametrize("tensor_parallel", [True, False])
def test_whisper_specs_equal_jax(tensor_parallel):
    from wis_tpu.models.whisper.config import WhisperConfig as JaxConfig
    from wis_tpu.parallel import mesh as jmesh

    got = whisper_param_specs(CFG, tensor_parallel)
    want = jmesh.whisper_param_specs(JaxConfig(**MICRO), tensor_parallel)
    assert _spec_leaves(got) == _spec_leaves(want)
    assert all(isinstance(s, P) for s in _leaves(got).values())


def test_xtts_specs_equal_jax():
    from wis_tpu.parallel import mesh as jmesh
    from wis_tpu_torch.parallel.mesh import xtts_cache_spec, xtts_gpt_param_specs

    assert _spec_leaves(xtts_gpt_param_specs()) == _spec_leaves(jmesh.xtts_gpt_param_specs())
    assert tuple(xtts_cache_spec()) == tuple(jmesh.xtts_cache_spec())


@pytest.mark.parametrize("quant", ["int8", "int8_all"])
def test_expand_specs_for_quant_equal_jax(quant):
    """The expanded spec of every quantized leaf: column-parallel scales
    split with their outputs, row-parallel scales whole, tok_emb_q's
    per-row scale as tok_emb."""
    from wis_tpu.models.whisper.config import WhisperConfig as JaxConfig
    from wis_tpu.parallel import mesh as jmesh
    from wis_tpu_torch.parallel.mesh import expand_specs_for_quant

    from torch_port_helpers import np_tree

    tree = _jax_quant_trees()[quant]
    got = expand_specs_for_quant(whisper_param_specs(CFG),
                                 params_from_jax(np_tree(tree), "cpu"))
    want = jmesh.expand_specs_for_quant(jmesh.whisper_param_specs(JaxConfig(**MICRO)), tree)
    assert _spec_leaves(got) == _spec_leaves(want)
    assert tuple(got["decoder"]["blocks"]["attn"]["q_w"]["s"]) == (None, None, "model")
    assert tuple(got["decoder"]["blocks"]["attn"]["o_w"]["s"]) == (None, None, None)
    assert tuple(got["decoder"]["tok_emb_q"]["s"]) == (None, None)


def _jax_shards_equal_port(jtree, jspecs, pspecs, n_data, n_model, jmesh):
    """Every leaf's JAX addressable shard on each mesh device equals the
    port's shard_params slice at that device's coordinates."""
    from torch_port_helpers import np_tree

    mesh = jmesh.make_mesh(n_data=n_data, n_model=n_model)
    jshard = _leaves(jmesh.shard_params(jtree, mesh, jspecs))
    whole = params_from_jax(np_tree(jtree), "cpu")
    for d in range(n_data):
        for m in range(n_model):
            port = _leaves(shard_params(whole, Mesh((n_data, n_model), (d, m), "cpu"),
                                        pspecs))
            assert set(port) == set(jshard)
            dev = mesh.devices[d, m]
            for name, arr in jshard.items():
                (shard,) = [s for s in arr.addressable_shards if s.device == dev]
                got = port[name]
                assert got.is_contiguous(), name
                want = np.asarray(shard.data)
                assert tuple(got.shape) == want.shape, name
                np.testing.assert_array_equal(got.float().numpy() if got.is_floating_point()
                                              else got.numpy(), want.astype(np.float32)
                                              if got.is_floating_point() else want,
                                              err_msg=name)


@pytest.mark.parametrize("quant", ["f32", "int8", "int8_all"])
@pytest.mark.parametrize("n_data,n_model", [(1, 4), (2, 2)])
def test_shard_params_slices_equal_jax_shards(quant, n_data, n_model):
    from wis_tpu.models.whisper.config import WhisperConfig as JaxConfig
    from wis_tpu.parallel import mesh as jmesh

    _jax_shards_equal_port(_jax_quant_trees()[quant],
                           jmesh.whisper_param_specs(JaxConfig(**MICRO)),
                           whisper_param_specs(CFG), n_data, n_model, jmesh)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_xtts_shard_params_slices_equal_jax_shards(quant):
    import jax.numpy as jnp

    from wis_tpu.models.xtts.gpt import GPTConfig, random_gpt
    from wis_tpu.ops.quant import quantize_gpt_params
    from wis_tpu.parallel import mesh as jmesh
    from wis_tpu_torch.parallel.mesh import xtts_gpt_param_specs

    cfg = GPTConfig(n_layer=2, n_head=4, d_model=32, n_text_vocab=64, n_audio_vocab=36,
                    max_text_tokens=16, max_audio_tokens=24, start_audio_token=34,
                    stop_audio_token=35)
    tree = random_gpt(cfg, seed=0, dtype=jnp.float32)
    if quant == "int8":
        tree = quantize_gpt_params(tree)
    _jax_shards_equal_port(tree, jmesh.xtts_gpt_param_specs(), xtts_gpt_param_specs(),
                           1, 4, jmesh)


def test_replicate_and_batch_sharding():
    params = {"a": torch.arange(6.0).reshape(2, 3)}
    mesh = Mesh((2, 1), (1, 0), "cpu")
    rep = replicate_params(params, mesh)
    assert torch.equal(rep["a"], params["a"]) and rep["a"].data_ptr() != params["a"].data_ptr()
    x = torch.arange(8).reshape(4, 2)
    assert torch.equal(batch_sharding(mesh)(x), x[2:4])
    with pytest.raises(ValueError, match="split"):
        batch_sharding(Mesh((3, 1), (0, 0), "cpu"))(x)
    with pytest.raises(ValueError, match="split"):
        shard_params({"w": torch.zeros(3, 5)}, Mesh((1, 2), (0, 1), "cpu"),
                     {"w": P(None, "model")})
    with pytest.raises(ValueError, match="spec keys"):
        shard_params({"w": torch.zeros(2)}, mesh, {"v": P()})


# --------------------------------------------------------------------------- #
# tp=None: the single-device path as it was
# --------------------------------------------------------------------------- #
def _parent_linear(x, w, b=None, tp=None):
    """``models/whisper/model.py`` ``_linear`` before tensor parallelism
    (the call sites now pass ``tp``, None here)."""
    from wis_tpu_torch.ops.quant import qmatmul

    assert tp is None
    y = qmatmul(x, w)
    if b is not None:
        y = (y.float() + b.float()).to(x.dtype)
    return y


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tp_none_is_bit_identical(monkeypatch, dtype):
    """With tp=None no f32 partial product (the row-parallel path) runs,
    and the encoder, cross-KV, prefill and beam decode equal, bit for bit,
    the same calls through the single-device ``_linear`` the port had."""
    from wis_tpu_torch.decoding.beam import build_generate_xa
    from wis_tpu_torch.models.whisper import model as port_model
    from wis_tpu_torch.models.whisper.weights import random_params
    from wis_tpu_torch.ops.quant import quantize_whisper_params

    params = quantize_whisper_params(random_params(CFG, seed=5, device="cpu",
                                                   dtype=getattr(torch, dtype)))
    mel = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 80, 3000))
                           .astype(np.float32))
    gen = build_generate_xa(CFG, beam_size=2, batch=1, max_new_tokens=4, prompt_len=1,
                            suppress_tokens=(), begin_suppress_tokens=())

    def run():
        with torch.inference_mode():
            xa = encode(params, mel, CFG)
            kv = cross_kv(params, xa, CFG)
            res = gen(params, kv, torch.tensor([SOT]), 4)
            return [xa, *kv, res.tokens, res.scores]

    from wis_tpu_torch.ops.quant import qmatmul
    from wis_tpu_torch.parallel import axis

    def single(x, w, out_dtype=None):
        assert out_dtype is None, "an f32 partial product ran"
        return qmatmul(x, w)

    monkeypatch.setattr(axis, "qmatmul", single)
    got = run()
    monkeypatch.setattr(port_model, "_linear", _parent_linear)
    want = run()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


# --------------------------------------------------------------------------- #
# The mesh's device, the f32 partial product, the row-parallel check
# --------------------------------------------------------------------------- #
def test_make_mesh_defaults_to_the_rank_card(monkeypatch, tmp_path):
    """Without ``devices`` a rank's mesh sits on its current card, and
    raises where there is none; the CPU only when it is named."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            world_size=1, rank=0)
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(1, 1)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
        assert make_mesh(1, 1).device == torch.device("cuda", 3)
        assert make_mesh(1, 1, ["cpu"]).device == torch.device("cpu")
    finally:
        dist.destroy_process_group()


def test_qmatmul_out_dtype():
    """``out_dtype=torch.float32``: the product before its rounding to x's
    dtype (the row-parallel partial sum); rounded, it is the default
    product, bit for bit."""
    from wis_tpu_torch.ops.quant import (
        int8_matmul,
        int8_matmul_plain,
        matmul_f32,
        qmatmul,
        quantize_weight,
    )

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 5, 256), dtype=np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((256, 128), dtype=np.float32) * 0.05)
    leaf = quantize_weight(w)
    wq = leaf["q"].bfloat16() * leaf["s"].bfloat16()
    y = qmatmul(x, leaf, out_dtype=torch.float32)
    assert y.dtype == torch.float32 and y.shape == (3, 5, 128)
    assert torch.equal(y, matmul_f32(x, wq))
    assert torch.equal(qmatmul(x, leaf), torch.matmul(x, wq))
    assert torch.equal(qmatmul(x, w.bfloat16(), out_dtype=torch.float32),
                       matmul_f32(x, w.bfloat16()))
    x2 = x.reshape(15, 256)
    y8 = int8_matmul(x2, leaf["q"], leaf["s"], torch.float32)
    assert y8.dtype == torch.float32
    assert torch.equal(y8, int8_matmul_plain(x2, leaf["q"], leaf["s"], torch.float32))
    assert torch.equal(y8.bfloat16(), int8_matmul(x2, leaf["q"], leaf["s"]))


def _row_check_rank(rank, devices):
    """The stages' row-parallel check on one int8 product, then again with
    the fault it exists to catch: each rank's partial sum rounded to bf16
    before the reduce."""
    from wis_tpu_torch import entry
    from wis_tpu_torch.ops.quant import qmatmul, quantize_weight
    from wis_tpu_torch.parallel import axis

    mesh = make_mesh(1, 2, devices)
    tp = mesh.model_axis
    rng = np.random.default_rng(0)
    full = quantize_weight(torch.from_numpy(rng.standard_normal((512, 256), dtype=np.float32)
                                            * 0.05))
    local = shard_params({"w": full}, mesh, {"w": P("model", None)})["w"]
    ref = full if tp.index == 0 else None
    sound = entry._row_parallel_check(tp, 5, local, ref, seed=1)

    def rounded_partials(x, w, out_dtype=None):
        return qmatmul(x, w).to(out_dtype or x.dtype)

    axis.qmatmul = rounded_partials
    return sound, entry._row_parallel_check(tp, 5, local, ref, seed=1)


def test_row_parallel_check_tells_the_bf16_partial_fault():
    from wis_tpu_torch import entry

    (sound, fault), (other, _) = run_world(_row_check_rank, ["cpu"] * 2, timeout=300)
    assert other == {}
    entry._hold_rows("sound", {"w": sound})
    assert sound["frac"] <= entry.ROW_MISMATCH_MAX < sound["ctl_frac"]
    assert fault["frac"] > 0.2
    with pytest.raises(AssertionError, match="at most"):
        entry._hold_rows("fault", {"w": fault})
