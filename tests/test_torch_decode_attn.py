"""Beam self-attention with ancestry resolved at read time: the port's plain
``ancestry_attention`` (``wis_tpu_torch/ops/decode_attn.py``, the plain
version of ``csrc/ancestry_attention.cu``) held against wis_tpu's Pallas
``ancestry_attention`` in interpret mode and its XLA oracle
``ancestry_attention_reference``, and the port's eager decoder
(``_self_attn_anc``), fed the same map in its (Bq, K, T) form, against it.

In f32 all of them compute the same scores, softmax and weighted sums in
another order: within 1e-5 relative. The ancestry map is scrambled (any
beam's row at any position), -1 past pos, and the cache columns past pos
hold huge values that a read of them would show."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wis_tpu.ops.decode_attn import ancestry_attention as jax_kernel
from wis_tpu.ops.decode_attn import ancestry_attention_reference as jax_reference
from wis_tpu_torch.ops import decode_attn

torch.set_num_threads(1)

H, DH = 4, 64


def _case(bk, t, pos, seed, beams=None, dh=DH):
    """q, caches and a scrambled (BK, T) map of physical rows; the map
    picks rows inside each group of ``beams`` (all rows by default)."""
    beams = beams or bk
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bk, H, dh)).astype(np.float32)
    kc = (rng.standard_normal((bk, H, dh, t)) * 0.5).astype(np.float32)
    vc = rng.standard_normal((bk, H, dh, t)).astype(np.float32)
    kc[..., pos + 1:] = 1e4
    vc[..., pos + 1:] = 1e4
    anc = np.full((bk, t), -1, np.int32)
    for r in range(bk):
        base = (r // beams) * beams
        anc[r, : pos + 1] = base + rng.integers(0, beams, pos + 1)
    return q, kc, vc, anc


@pytest.mark.parametrize("bk,t,pos", [(5, 128, 70), (10, 64, 63), (5, 32, 0)])
def test_plain_matches_jax_kernel_and_oracle(bk, t, pos):
    q, kc, vc, anc = _case(bk, t, pos, seed=bk + t)
    with pltpu.force_tpu_interpret_mode():
        kern = np.asarray(jax_kernel(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                     jnp.asarray(anc), jnp.int32(pos)))
    oracle = np.asarray(jax.jit(jax_reference)(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                               jnp.asarray(anc), jnp.int32(pos)))
    before = decode_attn.ancestry_attention.launches
    got = decode_attn.ancestry_attention(*(torch.from_numpy(a) for a in (q, kc, vc, anc)), pos)
    assert decode_attn.ancestry_attention.launches == before  # the plain version ran
    assert got.shape == (bk, H, DH) and got.dtype == torch.float32
    got = got.numpy()
    assert np.abs(got).max() < 10  # no column past pos was read
    np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bk,t,pos,beams,dh", [
    (20, 64, 40, 5, DH),  # four windows' groups of five beams
    (5, 100, 99, None, DH),  # T % 8 != 0, pos at the last column
    (5, 64, 40, None, 80),  # a head width off the powers of two
])
def test_plain_matches_jax_kernel_more_shapes(bk, t, pos, beams, dh):
    """The shapes the card's kernel plans differently for (rows in groups,
    runs that start mid-vector, a lane's d values not filling its class),
    held against the JAX kernel in interpret mode."""
    q, kc, vc, anc = _case(bk, t, pos, seed=bk + t + dh, beams=beams, dh=dh)
    with pltpu.force_tpu_interpret_mode():
        kern = np.asarray(jax_kernel(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                     jnp.asarray(anc), jnp.int32(pos)))
    got = decode_attn.ancestry_attention(*(torch.from_numpy(a) for a in (q, kc, vc, anc)), pos)
    assert got.shape == (bk, H, dh)
    got = got.numpy()
    assert np.abs(got).max() < 10  # no column past pos was read
    np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-5)


def test_negative_rows_read_zero_keys_and_values():
    """A -1 inside pos reads a zero key and value (score 0, nothing added),
    as the TPU kernel's one-hot selection does."""
    q, kc, vc, anc = _case(5, 64, 40, seed=3)
    anc[:, 7] = -1
    with pltpu.force_tpu_interpret_mode():
        kern = np.asarray(jax_kernel(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                     jnp.asarray(anc), jnp.int32(40)))
    got = decode_attn.ancestry_attention_plain(
        *(torch.from_numpy(a) for a in (q, kc, vc, anc)), 40).numpy()
    np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bq,k", [(1, 5), (2, 5), (4, 5)])
def test_eager_decoder_attention_agrees(bq, k):
    """The eager decoder's self-attention (``_self_attn_anc`` in
    model._decoder_pass) on the port's (Bq, K, T) map with group-local rows
    equals the plain kernel on the same map made global (``global_rows``)
    — BK = 20 for four windows of five beams. One decoder layer with
    identity q/k/v projections: the step writes LayerNorm(x) as its own key
    and value at pos, and the same vector is each row's query."""
    from wis_tpu_torch.models.whisper import model as model_mod
    from wis_tpu_torch.models.whisper.config import WhisperConfig

    bk, t, pos = bq * k, 48, 30
    q, kc, vc, ganc = _case(bk, t, pos, seed=bk, beams=k)
    local = torch.from_numpy(ganc.astype(np.int64)).reshape(bq, k, t)
    local = torch.where(local >= 0, local % k, -1)
    assert torch.equal(decode_attn.global_rows(local), torch.from_numpy(ganc))

    d = H * DH
    cfg = WhisperConfig(name="attn-only", n_text_state=d, n_text_head=H, n_text_layer=1)
    eye, zero = torch.eye(d)[None], torch.zeros(1, d)
    ln = {"g": torch.ones(1, d), "b": torch.zeros(1, d)}
    params = {"decoder": {
        "tok_emb": torch.from_numpy(q.reshape(bk, d)), "pos": torch.zeros(t, d),
        "ln": {"g": torch.ones(d), "b": torch.zeros(d)},
        "blocks": {
            "attn_ln": ln, "cross_ln": ln, "mlp_ln": ln,
            "attn": {"q_w": eye, "q_b": zero, "k_w": eye, "v_w": eye, "v_b": zero,
                     "o_w": eye, "o_b": zero},
            "cross": {"q_w": eye, "q_b": zero, "o_w": eye, "o_b": zero},
            "mlp": {"w1": torch.zeros(1, d, 4 * d), "b1": torch.zeros(1, 4 * d),
                    "w2": torch.zeros(1, 4 * d, d), "b2": zero},
        },
    }}
    cache = model_mod.DecoderCache(torch.from_numpy(kc)[None].clone(),
                                   torch.from_numpy(vc)[None].clone(), pos)
    xa = (torch.zeros(1, bq, H, DH, 4), torch.zeros(1, bq, H, DH, 4))
    merged, merge_heads = [], model_mod.merge_heads

    def capture(x):
        merged.append(x)
        return merge_heads(x)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(model_mod, "merge_heads", capture)
        model_mod.decode_step(params, torch.arange(bk), cache, xa, cfg, anc=local)
    kc_now, vc_now = cache.k[0], cache.v[0]  # written in place at pos
    want = decode_attn.ancestry_attention_plain(
        kc_now[..., pos].contiguous(), kc_now, vc_now, torch.from_numpy(ganc), pos)
    got = merged[0][:, :, 0]  # the layer's self-attention, before cross-attention
    assert np.abs(got.numpy()).max() < 10  # no column past pos was read
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
