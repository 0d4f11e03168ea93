"""The fused XTTS GPT step of the PyTorch port (``wis_tpu_torch/ops/
fused_gpt.py``) and the chunk decoders of ``models/xtts/gpt.py`` held
against wis_tpu's on the CPU: the packing bit for bit; the plain version of
the step against the JAX oracle ``fused_gpt_step_reference`` and the JAX
kernel itself in interpret mode, on standard and trap inputs; and
``run_decode_chunk`` / ``run_decode_chunk_fused`` (fused head off and on)
against JAX's with JAX's key chain handed over as gumbel rows.

Tolerances. The step: both sides compute every product as an f32 dot of
the same bf16 operands and every LayerNorm in f32, in another summation
order, so x_out is held within 1e-3 in relative norm, the K/V columns the
step writes within one bf16 ulp (a value on a rounding boundary may round
either way), and every other cache column bit-identical. The chunks
(f32 activations, int8 weights): tokens equal, latents within 1e-3 in
relative norm.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_gumbel_rows, np_tree
from wis_tpu.models.xtts import gpt as jg
from wis_tpu.ops import fused_gpt as jf
from wis_tpu.ops.quant import quantize_gpt_params
from wis_tpu_torch.models.xtts import gpt as tg
from wis_tpu_torch.models.xtts.weights import params_from_jax
from wis_tpu_torch.ops import fused_gpt as tf

torch.set_num_threads(1)

#: 2 layers, D=128, 2 heads: head dim 64, the kernel's
GPT = dict(n_layer=2, n_head=2, d_model=128, n_text_vocab=64, n_audio_vocab=68,
           max_text_tokens=16, max_audio_tokens=24, start_audio_token=66, stop_audio_token=67)
JG, TG = jg.GPTConfig(**GPT), tg.GPTConfig(**GPT)
L, D, H = 2, 128, 2
T = 128
TRAP_KEY, TRAP_VALUE = 30.0, 100.0


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@lru_cache(maxsize=None)
def _params(seed=1, dtype="bfloat16"):
    p = quantize_gpt_params(jg.random_gpt(JG, seed=seed, dtype=getattr(jnp, dtype)))
    return p, params_from_jax(np_tree(p), "cpu")


@lru_cache(maxsize=None)
def _packed(seed=1):
    jp, tp = _params(seed)
    return jf.pack_gpt(jp, JG), tf.pack_gpt(tp, TG)


@pytest.mark.parametrize("quant", [True, False])
def test_pack_gpt_bit_equal(quant):
    """pack_gpt equals JAX's leaf for leaf: on the int8 tree the model packs
    (as the JAX model calls it), and on a bf16 tree it quantizes itself
    (under jit, where XLA's /127 is a multiply)."""
    p = jg.random_gpt(JG, seed=4, dtype=jnp.bfloat16)
    if quant:
        p = quantize_gpt_params(p)
        want = jf.pack_gpt(p, JG)
    else:
        want = jax.jit(lambda t: jf.pack_gpt(t, JG))(p)
    got = tf.pack_gpt(params_from_jax(np_tree(p), "cpu"), TG)
    for name in ("w", "s", "b", "ln"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name)
        assert tuple(g.shape) == w.shape and str(g.dtype).removeprefix("torch.") == w.dtype.name
        np.testing.assert_array_equal(_torch_bits(g), _bits(w), err_msg=name)


def _inputs(pos, trap, seed=0):
    """Step inputs at bk=1: the cache written before pos, the causal sel.
    With ``trap`` every column sel excludes (the stale one at pos and the
    unwritten ones) holds keys of ±30 and values of 100."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((1, D)) * 0.3).astype(np.float32)
    kc = rng.standard_normal((L, D, T)).astype(np.float32) * 0.3
    vc = rng.standard_normal((L, D, T)).astype(np.float32) * 0.3
    sel = (np.arange(T) < pos).astype(np.float32)[None]
    if trap:
        kc[..., pos:] = TRAP_KEY * np.sign(rng.standard_normal((L, D, T - pos)))
        vc[..., pos:] = TRAP_VALUE
    return x, jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16), sel


def _check_step(got, want, kc_before, pos):
    gx, gk, gv = (t.float().numpy() for t in got)
    wx, wk, wv = (np.asarray(t).astype(np.float32) for t in want)
    assert np.linalg.norm(gx - wx) <= 1e-3 * np.linalg.norm(wx)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(wk[..., pos]), 2.0 ** -126))) - 7)
    assert (np.abs(gk[..., pos] - wk[..., pos]) <= ulp).all()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(wv[..., pos]), 2.0 ** -126))) - 7)
    assert (np.abs(gv[..., pos] - wv[..., pos]) <= ulp).all()
    other = np.arange(T) != pos
    before = np.asarray(kc_before).astype(np.float32)
    np.testing.assert_array_equal(gk[..., other], before[..., other])


@pytest.mark.parametrize("pos,trap", [(7, False), (7, True), (100, True), (0, False)])
def test_step_plain_matches_reference(pos, trap):
    x, kc, vc, sel = _inputs(pos, trap)
    jpk, tpk = _packed()
    want = jf.fused_gpt_step_reference(JG, jpk, jnp.asarray(x), kc, vc, jnp.asarray(sel), pos)
    step = tf.build_fused_gpt_step(TG, bk=1, t_cache=T)
    got = step(tpk, torch.from_numpy(x), _to_torch(kc), _to_torch(vc), torch.from_numpy(sel), pos)
    _check_step(got, want, kc, pos)


@pytest.mark.parametrize("pos,trap", [(9, False), (50, True)])
def test_step_plain_matches_jax_kernel(pos, trap):
    """The JAX kernel itself, in interpret mode (as tests/test_fused_gpt.py
    runs it)."""
    x, kc, vc, sel = _inputs(pos, trap, seed=1)
    jpk, tpk = _packed()
    step = jf.build_fused_gpt_step(JG, bk=1, t_cache=T)
    want = step(jpk, jnp.asarray(x), kc, vc, jnp.asarray(sel), jnp.int32(pos))
    got = tf.fused_gpt_step(TG, tpk, torch.from_numpy(x), _to_torch(kc), _to_torch(vc),
                            torch.from_numpy(sel), pos)
    _check_step(got, want, kc, pos)


def test_step_refuses_what_it_does_not_take():
    """A width that does not match the build raises; a tensor neither on the
    CPU nor on the card is refused, not run plain; the CPU path counts no
    launch."""
    x, kc, vc, sel = _inputs(7, False)
    _, tpk = _packed()
    step = tf.build_fused_gpt_step(TG, bk=1, t_cache=T)
    with pytest.raises(ValueError, match="cache width"):
        step(tpk, torch.from_numpy(x), _to_torch(kc)[..., :-1], _to_torch(vc)[..., :-1],
             torch.from_numpy(sel), 7)
    before = tf.fused_gpt_step.launches
    step(tpk, torch.from_numpy(x), _to_torch(kc), _to_torch(vc), torch.from_numpy(sel), 7)
    assert tf.fused_gpt_step.launches == before
    meta = torch.empty((1, D), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tf.fused_gpt_step(TG, tpk, meta, meta, meta, meta, 0)


# --------------------------------------------------------------------------- #
# the chunk decoders against JAX's, with JAX's draws
# --------------------------------------------------------------------------- #
COND_LEN, TEXT_LEN, CHUNK = 2, 4, 6


@lru_cache(maxsize=None)
def _prefilled(seed):
    """f32 activations over int8 weights; the prefill's cache on both
    sides (JAX's, bridged, so both chunks start from the same numbers)."""
    jp, tp = _params(seed, "float32")
    max_len = COND_LEN + TEXT_LEN + 1 + JG.max_audio_tokens
    rng = np.random.default_rng(3 + seed)
    cond = jnp.asarray(rng.standard_normal((1, COND_LEN, D)) * 0.1, jnp.float32)
    text = jnp.asarray(rng.integers(0, 64, (1, TEXT_LEN)), jnp.int32)
    _, cache = jg.build_prefill(JG, batch=1, cond_len=COND_LEN, text_len=TEXT_LEN,
                                max_len=max_len)(jp, cond, text)
    return jp, tp, cache


def _port_cache(cache):
    return tg.GPTCache(_to_torch(cache.k), _to_torch(cache.v), int(cache.pos))


#: (temperature, top_k, top_p, repetition_penalty, do_sample): sampled at
#: temperature 1 (every draw a real decision) and greedy with the penalty
CHUNK_KNOBS = [(1.0, 20, 0.95, 2.0, True), (1.0, 5, 0.9, 2.0, False), (0.8, 8, 0.9, 1.3, True)]


@pytest.mark.parametrize("knobs,seed", [(CHUNK_KNOBS[0], 1), (CHUNK_KNOBS[1], 2),
                                         (CHUNK_KNOBS[2], 1)])
def test_eager_chunk_matches_jax(seed, knobs):
    """run_decode_chunk (gpt_pass per token) against JAX's: tokens equal,
    latents within 1e-3, the history written the same way; the second
    chunk starts past the first (hist_len and the stop floor carry)."""
    temperature, top_k, top_p, rp, ds = knobs
    jp, tp, cache = _prefilled(seed)
    key = jax.random.PRNGKey(seed)
    jargs = (jnp.float32(temperature), jnp.int32(top_k), jnp.float32(top_p), jnp.float32(rp),
             jnp.bool_(ds), jnp.int32(CHUNK + 2))
    last = jnp.full((1,), JG.start_audio_token, jnp.int32)
    hist = jnp.zeros((1, JG.max_audio_tokens), jnp.int32)
    tcache = _port_cache(cache)
    t_last = torch.full((1,), TG.start_audio_token)
    t_hist = torch.zeros((1, TG.max_audio_tokens), dtype=torch.long)
    t_len = 0
    for _ in range(2):
        key, sub = jax.random.split(key)
        tok_j, lat_j, cache, hist, hlen, done_j = jg.run_decode_chunk(
            jp, last, cache, hist, jnp.int32(t_len), sub, *jargs, cfg=JG, chunk=CHUNK, batch=1)
        gum = torch.from_numpy(jax_gumbel_rows(sub, CHUNK, JG.n_audio_vocab))
        tok_t, lat_t, tcache, t_hist, t_len, done_t = tg.run_decode_chunk(
            tp, t_last, tcache, t_hist, t_len, gum, temperature, top_k, top_p, rp, ds,
            CHUNK + 2, cfg=TG, chunk=CHUNK, batch=1)
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
        np.testing.assert_array_equal(t_hist.numpy(), np.asarray(hist))
        assert bool(done_t[0]) == bool(done_j[0]) and t_len == int(hlen)
        lat_j = np.asarray(lat_j)
        assert np.linalg.norm(lat_t.numpy() - lat_j) <= 1e-3 * np.linalg.norm(lat_j)
        last, t_last = tok_j[:, -1], tok_t[:, -1]


@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("knobs", CHUNK_KNOBS[:2])
def test_fused_chunk_matches_jax(knobs, head):
    """run_decode_chunk_fused (the plain step on the CPU; the fused head
    off and on) against JAX's fused chunk (the Pallas step and head in
    interpret mode): tokens equal, latents within 1e-3, the flat caches'
    written columns within one bf16 ulp of their magnitude."""
    from wis_tpu.ops import fused_gpt_head as jfh
    from wis_tpu_torch.ops import fused_gpt_head as tfh

    temperature, top_k, top_p, rp, ds = knobs
    jp, tp, cache = _prefilled(1)
    jpk, tpk = jf.pack_gpt(jp, JG), tf.pack_gpt(tp, TG)
    kc, vc = jg.flatten_gpt_cache(cache, T)
    tkc, tvc = tg.flatten_gpt_cache(_port_cache(cache), T)
    np.testing.assert_array_equal(_torch_bits(tkc), _bits(kc))
    key = jax.random.PRNGKey(7)
    jhead = dict(head_packed=jfh.pack_head(jp, JG, jnp.float32),
                 head_fn=jfh.build_fused_gpt_head(JG, dtype=jnp.float32)) if head else {}
    thead = dict(head_packed=tfh.pack_head(tp, TG, torch.float32),
                 head_fn=tfh.build_fused_gpt_head(TG, dtype=torch.float32)) if head else {}
    jstep = jf.build_fused_gpt_step(JG, bk=1, t_cache=T)
    tstep = tf.build_fused_gpt_step(TG, bk=1, t_cache=T)
    tok_j, lat_j, kc, vc, pos, hist, hlen, done_j = jg.run_decode_chunk_fused(
        jp, jpk, jstep, jnp.full((1,), JG.start_audio_token, jnp.int32), kc, vc, cache.pos,
        jnp.zeros((1, JG.max_audio_tokens), jnp.int32), jnp.int32(0), key,
        jnp.float32(temperature), jnp.int32(top_k), jnp.float32(top_p), jnp.float32(rp),
        jnp.bool_(ds), jnp.int32(3), cfg=JG, chunk=CHUNK, batch=1, **jhead)
    gum = torch.from_numpy(jax_gumbel_rows(key, CHUNK, JG.n_audio_vocab))
    tok_t, lat_t, tkc, tvc, tpos, thist, tlen, done_t = tg.run_decode_chunk_fused(
        tp, tpk, tstep, torch.full((1,), TG.start_audio_token), tkc, tvc, int(cache.pos),
        torch.zeros((1, TG.max_audio_tokens), dtype=torch.long), 0, gum, temperature, top_k,
        top_p, rp, ds, 3, cfg=TG, chunk=CHUNK, batch=1, **thead)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    np.testing.assert_array_equal(thist.numpy(), np.asarray(hist))
    assert tpos == int(pos) and tlen == int(hlen) and bool(done_t[0]) == bool(done_j[0])
    lat_j = np.asarray(lat_j)
    assert np.linalg.norm(lat_t.numpy() - lat_j) <= 1e-3 * np.linalg.norm(lat_j)
    kc = np.asarray(kc).astype(np.float32)
    assert np.abs(tkc.float().numpy() - kc).max() <= 2.0 ** -8 * np.abs(kc).max()
