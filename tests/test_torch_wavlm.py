"""The port's WavLM x-vector (``wis_tpu_torch/models/wavlm``) on the CPU,
at ``tests/test_wavlm.py``'s micro config:

- against HF ``WavLMForXVector`` at random init: the embedding within a
  relative L2 of 1e-3 (the embeddings are ~1e-7, so an absolute bound says
  nothing);
- against wis_tpu: the seeded trees bit-equal; the feature encoder, and
  the encoder and TDNN head's frames, within rtol/atol 1e-4 at 1 s and
  2 s (lengths the JAX embedder does not pad);
- the departures from wis_tpu, each pinned: the unbiased pooling std, the
  relative-position gate taken from the layer's input, no padding above
  1 s, and sorted BF16 shards;
- ``hf_wavlm_shapes`` equal to ``transformers``' state dict;
- HF's weighted layer sum (``use_weighted_layer_sum``, which the JAX
  package lacks): with ``layer_weights`` the embedding within 1e-3 of HF's
  and the last state alone clearly off it; without the key the frames are
  the last-state path's, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wis_tpu.models.wavlm import model as jw
from wis_tpu_torch.models.wavlm import model as tw
from wis_tpu_torch.utils.selftest import hf_wavlm_shapes

torch.set_num_threads(1)

MICRO = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
             conv_dim=(16,) * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
             num_buckets=40, max_bucket_distance=100, tdnn_dim=(24, 24, 24, 24, 48),
             xvector_output_dim=24)
JCFG, TCFG = jw.WavLMConfig(**MICRO), tw.WavLMConfig(**MICRO)


def _hf_config(**kw):
    from transformers import WavLMConfig as HFConfig

    return HFConfig(
        hidden_size=TCFG.hidden_size, num_hidden_layers=TCFG.num_layers,
        num_attention_heads=TCFG.num_heads, intermediate_size=TCFG.intermediate_size,
        conv_dim=list(TCFG.conv_dim), conv_kernel=list(TCFG.conv_kernel),
        conv_stride=list(TCFG.conv_stride), conv_bias=TCFG.conv_bias,
        num_conv_pos_embeddings=TCFG.num_conv_pos_embeddings,
        num_conv_pos_embedding_groups=TCFG.num_conv_pos_embedding_groups,
        num_buckets=TCFG.num_buckets, max_bucket_distance=TCFG.max_bucket_distance,
        tdnn_dim=list(TCFG.tdnn_dim), tdnn_kernel=list(TCFG.tdnn_kernel),
        tdnn_dilation=list(TCFG.tdnn_dilation), xvector_output_dim=TCFG.xvector_output_dim,
        do_stable_layer_norm=False, feat_extract_norm="group", apply_spec_augment=False,
        layerdrop=0.0, **kw,
    )


def _hf_model(sd=None, **kw):
    from transformers import WavLMForXVector

    torch.manual_seed(0)
    model = WavLMForXVector(_hf_config(**kw)).eval()
    if sd is not None:
        model.load_state_dict(sd)
    return model


@pytest.fixture(scope="module")
def hf():
    model = _hf_model()
    return model, {k: v.detach().clone() for k, v in model.state_dict().items()}


def _audio(n, seed=0):
    return (np.random.default_rng(seed).standard_normal((1, n)) * 0.1).astype(np.float32)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_xvector_matches_hf(hf):
    model, sd = hf
    audio = _audio(16000)
    with torch.no_grad():
        want = model(input_values=torch.from_numpy(audio)).embeddings.numpy()
        got = tw.xvector_embed(tw.params_from_hf_wavlm(sd, TCFG), torch.from_numpy(audio),
                               TCFG).numpy()
    assert got.shape == want.shape == (1, TCFG.xvector_output_dim)
    assert _rel(got, want) < 1e-3


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_leaves_equal(port, jax_tree):
    got, want = dict(_paths(port)), dict(_paths(jax_tree))
    assert got.keys() == want.keys()
    for name, w in want.items():
        w = np.asarray(w)
        assert got[name].dtype == torch.float32 and tuple(got[name].shape) == w.shape, name
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)


def test_trees_equal_jax(hf):
    """Seeded weights and the HF conversion: every leaf bit-equal."""
    _assert_leaves_equal(tw.random_wavlm(TCFG, seed=1), jw.random_wavlm(JCFG, seed=1))
    _, sd = hf
    _assert_leaves_equal(tw.params_from_hf_wavlm(sd, TCFG),
                         jw.params_from_hf_wavlm({k: v.numpy() for k, v in sd.items()}, JCFG))


def _jax_tdnn_frames(p, audio):
    x = jw._layer_norm(jw.feature_encoder(p["feature_encoder"], audio, JCFG),
                       p["fp_ln_g"], p["fp_ln_b"])
    x = jw.encoder(p["encoder"], x @ p["fp_w"] + p["fp_b"], JCFG)
    x = x @ p["proj_w"] + p["proj_b"]
    for t, k, dil in zip(p["tdnn"], JCFG.tdnn_kernel, JCFG.tdnn_dilation):
        x = jw._tdnn_layer(x, t["w"], t["b"], k, dil)
    return np.asarray(x)


@pytest.mark.parametrize("seconds", [1, 2])
def test_frames_match_jax(seconds):
    """The feature encoder on the seeded tree, then the encoder and the
    TDNN head with the gate's projection zero in both trees: there the two
    gates are the same function, sigmoid(gru_b); the port takes the gate
    from the layer's input and the JAX package from the query projection
    (pinned in test_the_gate_follows_hf)."""
    audio = _audio(16000 * seconds, seed=seconds)
    jp, tp = jw.random_wavlm(JCFG, seed=2), tw.random_wavlm(TCFG, seed=2)
    with torch.no_grad():
        got = tw.feature_encoder(tp["feature_encoder"], torch.from_numpy(audio), TCFG).numpy()
    want = np.asarray(jw.feature_encoder(jp["feature_encoder"], jnp.asarray(audio), JCFG))
    assert got.shape == want.shape == (1, 50 * seconds - 1, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    for layer in jp["encoder"]["layers"]:
        layer["gru_w"] = jnp.zeros_like(layer["gru_w"])
    for layer in tp["encoder"]["layers"]:
        layer["gru_w"] = torch.zeros_like(layer["gru_w"])
    want = _jax_tdnn_frames(jp, jnp.asarray(audio))
    with torch.no_grad():
        got = tw.tdnn_frames(tp, torch.from_numpy(audio), TCFG).numpy()
    assert got.shape == want.shape and got.shape[1] == 50 * seconds - 1 - 14
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_the_pooling_std_is_unbiased(hf):
    """HF pools with the unbiased std: the JAX embedding (population std)
    is more than 0.5% off HF's, the port's under 1e-3."""
    model, sd = hf
    audio = _audio(16000)
    with torch.no_grad():
        want = model(input_values=torch.from_numpy(audio)).embeddings.numpy()
        got = tw.xvector_embed(tw.params_from_hf_wavlm(sd, TCFG), torch.from_numpy(audio),
                               TCFG).numpy()
    ref = np.asarray(jw.xvector_embed(
        jw.params_from_hf_wavlm({k: v.numpy() for k, v in sd.items()}, JCFG),
        jnp.asarray(audio), JCFG))
    assert _rel(ref, want) > 5e-3
    assert _rel(got, want) < 1e-3


def test_the_gate_follows_hf(hf):
    """With gate and bucket weights large enough for the gate to matter,
    the port's encoder output stays on HF's ``last_hidden_state``; the JAX
    package's, gated from the query projection, does not."""
    _, sd = hf
    sd = {k: v * 50 if ("gru_rel_pos_linear.weight" in k or "rel_attn_embed" in k) else v
          for k, v in sd.items()}
    model = _hf_model(sd)
    audio = _audio(16000)
    with torch.no_grad():
        want = model.wavlm(torch.from_numpy(audio)).last_hidden_state.numpy()
        tp = tw.params_from_hf_wavlm(sd, TCFG)
        x = tw._layer_norm(tw.feature_encoder(tp["feature_encoder"], torch.from_numpy(audio),
                                              TCFG), tp["fp_ln_g"], tp["fp_ln_b"])
        got = tw.encoder(tp["encoder"], x @ tp["fp_w"] + tp["fp_b"], TCFG).numpy()
    jp = jw.params_from_hf_wavlm({k: v.numpy() for k, v in sd.items()}, JCFG)
    jx = jw._layer_norm(jw.feature_encoder(jp["feature_encoder"], jnp.asarray(audio), JCFG),
                        jp["fp_ln_g"], jp["fp_ln_b"])
    ref = np.asarray(jw.encoder(jp["encoder"], jx @ jp["fp_w"] + jp["fp_b"], JCFG))
    assert _rel(got, want) < 1e-5
    assert _rel(ref, want) > 1e-4


def test_default_embedder_does_not_pad():
    """Above 1 s the embedder embeds at the true length (the JAX embedder
    pads 2.5 s to 4 s, which moves the embedding); 0.2 s is padded to 1 s
    and gives a finite embedding."""
    embed = tw.default_embedder(None, "cpu", cfg=TCFG)
    params = tw.load_or_init_wavlm(None, TCFG)
    audio = _audio(40000, seed=3)
    with torch.no_grad():
        want = tw.xvector_embed(params, torch.from_numpy(audio), TCFG)[0].numpy()
        padded = tw.xvector_embed(params, torch.from_numpy(np.pad(audio, ((0, 0), (0, 24000)))),
                                  TCFG)[0].numpy()
    got = embed(audio[0])
    assert got.dtype == np.float32 and got.shape == (TCFG.xvector_output_dim,)
    np.testing.assert_array_equal(got, want)
    assert _rel(padded, want) > 1e-3
    short = embed(audio[0, :3200])
    assert short.shape == (TCFG.xvector_output_dim,) and np.isfinite(short).all()


def test_bf16_shards_load_in_sorted_order(hf, tmp_path, monkeypatch):
    """A MICRO HF state dict in two BF16 shards, listed in reverse sorted
    order, with a stale zero copy of one tensor in the shard that sorts
    first: every leaf equal to ``params_from_hf_wavlm`` of the same tensors
    in memory, the real copy read last."""
    from safetensors.torch import save_file

    _, sd = hf
    sd16 = {k: v.to(torch.bfloat16).contiguous() for k, v in sd.items()}
    names = list(sd16)
    first, second = names[: len(names) // 2], names[len(names) // 2:]
    key = "wavlm.encoder.layers.0.attention.q_proj.weight"
    assert key in first
    stale = {key: torch.zeros_like(sd16[key])}
    save_file({**{n: sd16[n] for n in first}}, str(tmp_path / "model-00001-of-00002.safetensors"))
    save_file({**{n: sd16[n] for n in second}, **stale},
              str(tmp_path / "model-00000-of-00002.safetensors"))
    listdir = tw.os.listdir
    monkeypatch.setattr(tw.os, "listdir", lambda d: sorted(listdir(d), reverse=True))
    got = dict(_paths(tw.load_or_init_wavlm(str(tmp_path), TCFG)))
    want = dict(_paths(tw.params_from_hf_wavlm(sd16, TCFG)))
    assert got.keys() == want.keys()
    assert all(got[k].dtype == torch.float32 and torch.equal(got[k], want[k]) for k in want)
    assert got["/encoder/layers/0/q_w"].abs().max() > 0
    # the JAX loader reads the shards in listdir order: the stale copy wins
    jax_loaded = jw.load_or_init_wavlm(str(tmp_path), JCFG)
    assert not np.asarray(jax_loaded["encoder"]["layers"][0]["q_w"]).any()


def test_hf_key_list_equals_transformers():
    from transformers import WavLMForXVector

    with torch.device("meta"):
        model = WavLMForXVector(_hf_config())
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = hf_wavlm_shapes(TCFG)
    assert list(got) == list(want)
    assert got == want


def test_hf_key_list_with_weighted_layer_sum_equals_transformers():
    from transformers import WavLMForXVector

    with torch.device("meta"):
        model = WavLMForXVector(_hf_config(use_weighted_layer_sum=True))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = hf_wavlm_shapes(TCFG, weighted_layer_sum=True)
    assert list(got) == list(want)
    assert got == want and got["layer_weights"] == (TCFG.num_layers + 1,)


@pytest.fixture(scope="module")
def hf_weighted(hf):
    """HF ``WavLMForXVector(use_weighted_layer_sum=True)`` with the ``hf``
    fixture's weights, the encoder layers' matrices ×10 (at HF's init each
    layer barely moves the state, and every h_i is near the last), and
    seeded non-uniform ``layer_weights``."""
    _, sd = hf
    sd = {k: v * 10 if k.startswith("wavlm.encoder.layers.") and v.ndim == 2
          and "rel_attn_embed" not in k else v for k, v in sd.items()}
    sd = {"layer_weights": torch.from_numpy(
        np.random.default_rng(5).standard_normal(TCFG.num_layers + 1).astype(np.float32)),
        **sd}
    return _hf_model(sd, use_weighted_layer_sum=True), sd


def test_weighted_layer_sum_matches_hf(hf_weighted):
    """The softmax-weighted sum of the embedding output and each layer's
    output feeds the projector: the port's embedding within 1e-3 of HF's;
    the same weights read from the last state only are far off it."""
    model, sd = hf_weighted
    audio = _audio(16000, seed=4)
    params = tw.params_from_hf_wavlm(sd, TCFG)
    assert torch.equal(params["layer_weights"], sd["layer_weights"])
    last_only = {k: v for k, v in params.items() if k != "layer_weights"}
    with torch.no_grad():
        want = model(input_values=torch.from_numpy(audio)).embeddings.numpy()
        got = tw.xvector_embed(params, torch.from_numpy(audio), TCFG).numpy()
        last = tw.xvector_embed(last_only, torch.from_numpy(audio), TCFG).numpy()
    assert got.shape == want.shape == (1, TCFG.xvector_output_dim)
    assert _rel(got, want) < 1e-3
    assert _rel(last, want) > 1e-2


def test_without_layer_weights_the_frames_are_the_last_states(hf):
    """No ``layer_weights`` key: no leaf, and ``tdnn_frames`` bit-equal to
    the last-state path written out (the frames' parity with the JAX
    package is test_frames_match_jax's)."""
    _, sd = hf
    p = tw.params_from_hf_wavlm(sd, TCFG)
    assert "layer_weights" not in p
    audio = torch.from_numpy(_audio(32000, seed=6))
    with torch.no_grad():
        x = tw._layer_norm(tw.feature_encoder(p["feature_encoder"], audio, TCFG),
                           p["fp_ln_g"], p["fp_ln_b"])
        x = tw.encoder(p["encoder"], x @ p["fp_w"] + p["fp_b"], TCFG)
        x = x @ p["proj_w"] + p["proj_b"]
        for t, k, dil in zip(p["tdnn"], TCFG.tdnn_kernel, TCFG.tdnn_dilation):
            x = tw._tdnn_layer(x, t["w"], t["b"], k, dil)
        assert torch.equal(tw.tdnn_frames(p, audio, TCFG), x)
