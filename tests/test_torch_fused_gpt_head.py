"""The fused XTTS GPT sampling head of the PyTorch port (``wis_tpu_torch/
ops/fused_gpt_head.py``) held against wis_tpu's on the CPU: the packing bit
for bit, and the plain version against the JAX kernel in interpret mode
(as tests/test_fused_gpt_head.py runs it) over a grid of knobs, with exact
ties, the stop floor and the token-0 quirk of the zero-padded history.

Tolerances: the token equal; hidden within one bf16 ulp (in bf16 both
round the same f32 LayerNorm, computed in another order, once; in f32 to
1e-6); the masked logits equal in set and within 1e-5 where kept (the same
bf16-staged dot, summed in another order, divided by the same knobs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import np_tree
from wis_tpu.models.xtts import gpt as jg
from wis_tpu.ops import fused_gpt_head as jfh
from wis_tpu_torch.models.xtts import gpt as tg
from wis_tpu_torch.models.xtts.weights import params_from_jax
from wis_tpu_torch.ops import fused_gpt_head as tfh

torch.set_num_threads(1)

#: the JAX head tests' config (tests/test_fused_gpt_head.py)
HEAD = dict(n_layer=2, n_head=2, d_model=128, n_text_vocab=256, n_audio_vocab=68,
            max_text_tokens=32, max_audio_tokens=40, start_audio_token=66, stop_audio_token=67)
JG, TG = jg.GPTConfig(**HEAD), tg.GPTConfig(**HEAD)
V, VP = 68, 128


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_pack_head_bit_equal(dtype):
    p = jg.random_gpt(JG, seed=1, dtype=getattr(jnp, dtype))
    want = jfh.pack_head(p, JG, getattr(jnp, dtype))
    got = tfh.pack_head(params_from_jax(np_tree(p), "cpu"), TG, getattr(torch, dtype))
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and str(g.dtype).removeprefix("torch.") == w.dtype.name
        np.testing.assert_array_equal(_torch_bits(g), _bits(w))
    assert tfh.v_padded(1026) == jfh.v_padded(1026) == 1152


def _case(seed, dtype, tie=False):
    """Weights, a row, the hit mask of a zero-padded history (token 0
    included) and a gumbel row, on both sides."""
    p = jg.random_gpt(JG, seed=seed, dtype=getattr(jnp, dtype))
    if tie:  # every column identical: all logits tie
        col = np.random.default_rng(0).standard_normal((128, 1)).astype(np.float32)
        p["head_w"] = jnp.asarray(np.tile(col, (1, V)), getattr(jnp, dtype))
    rng = np.random.default_rng(seed + 10)
    x = rng.standard_normal((1, 128)).astype(np.float32)
    history = np.zeros((1, 12), np.int64)
    history[0, :7] = rng.integers(1, V, 7)
    hist = np.zeros((1, VP), np.float32)
    hist[0, history[0]] = 1.0  # the zero padding marks token 0
    gum = np.zeros((1, VP), np.float32)
    gum[:, :V] = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (1, V), jnp.float32))
    return p, x, hist, gum


def _run_both(p, x, hist, gum, knobs, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    head = jfh.build_fused_gpt_head(JG, dtype=jdt)
    want = head(jnp.asarray(x), *jfh.pack_head(p, JG, jdt), jnp.asarray(hist), jnp.asarray(gum),
                jnp.asarray(knobs, jnp.float32))
    tp = params_from_jax(np_tree(p), "cpu")
    got = tfh.build_fused_gpt_head(TG, dtype=tdt)(
        torch.from_numpy(x), *tfh.pack_head(tp, TG, tdt), torch.from_numpy(hist),
        torch.from_numpy(gum), torch.from_numpy(np.asarray(knobs, np.float32)))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _check(want, got, dtype):
    (wt, wh, wl), (gt, gh, gl) = want, got
    assert gt.dtype == np.int32 and gt.shape == (1, 1)
    assert int(gt[0, 0]) == int(wt[0, 0])
    if dtype == "bfloat16":
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(wh), 2.0 ** -126))) - 7)
        assert (np.abs(gh - wh) <= ulp).all()
    else:
        np.testing.assert_allclose(gh, wh, rtol=1e-6, atol=1e-6)
    kept = wl > -1e29
    np.testing.assert_array_equal(gl > -1e29, kept)
    assert not kept[0, V:].any()
    np.testing.assert_allclose(gl[kept], wl[kept], rtol=1e-5, atol=1e-5)


#: (temperature, top_k, top_p, repetition_penalty, stop_blocked, do_sample)
HEAD_KNOBS = [
    (0.7, 12, 0.8, 7.0, 0.0, 1.0), (0.1, 50, 0.85, 7.0, 1.0, 1.0),
    (1.0, 2, 0.5, 1.0, 0.0, 0.0), (0.75, 1000, 1.0, 2.0, 0.0, 1.0),
    (0.1, 50, 0.8, 7.0, 1.0, 0.0), (1.0, 1, 1.0, 1.0, 1.0, 1.0),
]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("knobs", HEAD_KNOBS)
def test_head_plain_matches_jax_kernel(knobs, dtype):
    p, x, hist, gum = _case(2, dtype)
    want, got = _run_both(p, x, hist, gum, [list(knobs) + [0.0, 0.0]], dtype)
    _check(want, got, dtype)


def test_head_ties_follow_the_sort_order():
    """Every logit equal: the reversed-stable tie order of jnp.sort decides
    the top-p cutoff, the lowest index the greedy pick."""
    p, x, hist, gum = _case(3, "float32", tie=True)
    for knobs in ((0.7, 10, 0.6, 1.0, 0.0, 0.0), (0.7, 10, 0.6, 1.0, 0.0, 1.0)):
        want, got = _run_both(p, x, np.zeros_like(hist), gum, [list(knobs) + [0.0, 0.0]],
                              "float32")
        _check(want, got, "float32")


def test_head_penalty_marks_token_zero():
    """Token 0 is penalized from the zero-padded history: with a large
    positive logit at token 0 the penalty (÷7) changes the greedy pick on
    both sides in the same way."""
    p, x, hist, gum = _case(4, "float32")
    tp = params_from_jax(np_tree(p), "cpu")
    logits0 = tfh.fused_gpt_head_plain(
        torch.from_numpy(x), *tfh.pack_head(tp, TG, torch.float32), torch.zeros((1, VP)),
        torch.from_numpy(gum), torch.tensor([[1.0, 1000, 1.0, 1.0, 0, 0, 0, 0]]),
        cfg=TG, dtype=torch.float32)[2]
    best = int(logits0.argmax())
    p["head_b"] = p["head_b"].at[0].set(float(logits0.max()) + 1.0)  # token 0 now the best
    for hit in (np.zeros_like(hist), hist):
        want, got = _run_both(p, x, hit, gum, [[1.0, 1000, 1.0, 7.0, 0.0, 0.0, 0.0, 0.0]],
                              "float32")
        _check(want, got, "float32")
        assert int(got[0][0, 0]) == (best if hit[0, 0] else 0)


def test_head_refuses_a_tensor_off_the_cpu_and_the_card():
    p, x, hist, gum = _case(2, "float32")
    meta = torch.empty((1, 128), device="meta")
    before = tfh.fused_gpt_head.launches
    with pytest.raises(ValueError, match="unsupported device"):
        tfh.fused_gpt_head(meta, meta, meta, meta, meta, meta, meta, cfg=TG)
    assert tfh.fused_gpt_head.launches == before
