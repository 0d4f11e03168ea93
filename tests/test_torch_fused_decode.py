"""The fused decode step of the PyTorch port (``wis_tpu_torch/ops/
fused_decode.py``) held against wis_tpu's on the CPU: the host-side
packing and cross-KV quantization bit for bit, and the plain version of the
step against the JAX oracle ``fused_decode_step_reference`` and the JAX
kernel itself in interpret mode, on bf16 trees (the JAX kernel's caches are
bf16) of the narrow config.

Tolerances. Both sides compute every product as an f32 dot of the same bf16
operands and every LayerNorm in f32, but in another summation order; where
an f32 result lands on a bf16 rounding boundary the two round apart by one
bf16 ulp, and that moves the products it feeds. So x_out is held within one
bf16 ulp of its largest magnitude (2⁻⁸·max|x|), the K/V columns the step
writes within two (2⁻⁷·max|column|), and every other cache column
bit-identical.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import JAX_CFG, PORT_CFG, np_tree
from wis_tpu.models.whisper.weights import random_params
from wis_tpu.ops import fused_decode as jf
from wis_tpu.ops.quant import quantize_whisper_params
from wis_tpu_torch.models.whisper.weights import params_from_jax
from wis_tpu_torch.ops import fused_decode as tf

torch.set_num_threads(1)

L, D, H = JAX_CFG.n_text_layer, JAX_CFG.n_text_state, JAX_CFG.n_text_head
DH = D // H
T = 128
POS = 9


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


@lru_cache(maxsize=None)
def _packed(seed=3):
    params = quantize_whisper_params(random_params(JAX_CFG, seed=seed, dtype=jnp.bfloat16))
    want = jax.jit(lambda p: jf.pack_decoder(p, JAX_CFG))(params)
    got = tf.pack_decoder(params_from_jax(np_tree(params), "cpu"), PORT_CFG)
    return want, got


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_pack_decoder_bit_equal(quant, dtype):
    """The port's packing equals jax.jit(pack_decoder) — how the engine
    runs it — leaf for leaf, for int8 trees and for trees it quantizes
    itself."""
    params = random_params(JAX_CFG, seed=4, dtype=getattr(jnp, dtype))
    if quant:
        params = quantize_whisper_params(params)
    want = jax.jit(lambda p: jf.pack_decoder(p, JAX_CFG))(params)
    got = tf.pack_decoder(params_from_jax(np_tree(params), "cpu"), PORT_CFG)
    for name in ("w", "s", "b", "ln"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name)
        assert tuple(g.shape) == w.shape and str(g.dtype).removeprefix("torch.") == w.dtype.name
        np.testing.assert_array_equal(_torch_bits(g), _bits(w), err_msg=name)


def test_quantize_xa_columns_bit_equal():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((L, H, DH, 256)).astype(np.float32)
    x[:, :, :, 5] = 0.0  # an all-zero column hits the 1e-8 floor
    xk = jnp.asarray(x, jnp.bfloat16)
    xv = jnp.asarray(x * 3.0, jnp.bfloat16)
    want = jax.jit(jf.quantize_xa_columns)(xk, xv)
    got = tf.quantize_xa_columns(_to_torch(xk), _to_torch(xv))
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_torch_bits(g), _bits(w))


def _inputs(xa_int8, n_seq, s_audio, beams, seed=0):
    """Numpy-seeded step inputs; random ancestry over each sequence's own
    beams for positions before POS."""
    rng = np.random.default_rng(seed)
    bk = beams * n_seq
    s_pad = ((s_audio + 127) // 128) * 128
    x = (rng.standard_normal((bk, D)) * 0.3).astype(np.float32)
    kc = jnp.asarray(rng.standard_normal((L, D, bk * T)) * 0.3, jnp.bfloat16)
    vc = jnp.asarray(rng.standard_normal((L, D, bk * T)) * 0.3, jnp.bfloat16)
    xk = jnp.asarray(rng.standard_normal((L, H, DH, n_seq * s_pad)) * 0.3, jnp.bfloat16)
    xv = jnp.asarray(rng.standard_normal((L, H, DH, n_seq * s_pad)) * 0.3, jnp.bfloat16)
    anc = rng.integers(0, beams, (bk, POS))
    sel = np.zeros((bk, T, bk), np.float32)
    for r in range(bk):
        sel[r, np.arange(POS), (r // beams) * beams + anc[r]] = 1.0
    sel = sel.reshape(bk, T * bk)
    xs = None
    if xa_int8:
        xk, xv, xs = jf.quantize_xa_columns(xk, xv)
    return dict(x=x, kc=kc, vc=vc, xk=xk, xv=xv, xs=xs, sel=sel, bk=bk)


def _port_step(inp, xa_int8, n_seq, s_audio):
    step = tf.build_fused_decode_step(
        PORT_CFG, bk=inp["bk"], t_cache=T, s_audio=s_audio, n_seq=n_seq, xa_int8=xa_int8
    )
    xa = [_to_torch(inp["xk"]), _to_torch(inp["xv"])]
    if xa_int8:
        xa.append(_to_torch(inp["xs"]))
    return step(
        _packed()[1], torch.from_numpy(inp["x"]), _to_torch(inp["kc"]), _to_torch(inp["vc"]),
        *xa, torch.from_numpy(inp["sel"]), POS,
    )


def _check(got, want, inp):
    gx, gk, gv = (t.float().numpy() for t in got)
    wx, wk, wv = (np.asarray(t).astype(np.float32) for t in want)
    assert np.abs(gx - wx).max() <= 2.0 ** -8 * np.abs(wx).max()
    bk = inp["bk"]
    cols = slice(POS * bk, (POS + 1) * bk)
    other = np.ones(bk * T, bool)
    other[cols] = False
    for g, w, before in ((gk, wk, inp["kc"]), (gv, wv, inp["vc"])):
        assert np.abs(g[..., cols] - w[..., cols]).max() <= 2.0 ** -7 * np.abs(w[..., cols]).max()
        np.testing.assert_array_equal(g[..., other], np.asarray(before).astype(np.float32)[..., other])


@pytest.mark.parametrize(
    "xa_int8,n_seq,s_audio,beams",
    [
        (False, 1, 128, 2),
        (True, 1, 128, 2),
        (False, 2, 100, 2),  # block-diagonal, pad columns masked
        (True, 2, 120, 3),
        (True, 1, 100, 5),
    ],
)
def test_step_plain_matches_reference(xa_int8, n_seq, s_audio, beams):
    inp = _inputs(xa_int8, n_seq, s_audio, beams)
    want = jf.fused_decode_step_reference(
        JAX_CFG, _packed()[0], jnp.asarray(inp["x"]), inp["kc"], inp["vc"], inp["xk"],
        inp["xv"], jnp.asarray(inp["sel"]), pos=POS, n_seq=n_seq, s_audio=s_audio,
        xa_s=inp["xs"],
    )
    _check(_port_step(inp, xa_int8, n_seq, s_audio), want, inp)


@pytest.mark.parametrize("xa_int8,n_seq,s_audio,beams", [(True, 1, 100, 2), (False, 2, 128, 2)])
def test_step_plain_matches_jax_kernel(xa_int8, n_seq, s_audio, beams):
    """The JAX kernel itself, in interpret mode under jit (as
    tests/test_fused_decode.py runs it)."""
    inp = _inputs(xa_int8, n_seq, s_audio, beams, seed=1)
    step = jf.build_fused_decode_step(
        JAX_CFG, bk=inp["bk"], t_cache=T, s_audio=s_audio, n_seq=n_seq, xa_int8=xa_int8
    )
    xa = (inp["xk"], inp["xv"]) + ((inp["xs"],) if xa_int8 else ())
    want = jax.jit(step)(
        _packed()[0], jnp.asarray(inp["x"]), inp["kc"], inp["vc"], *xa,
        jnp.asarray(inp["sel"]), jnp.int32(POS),
    )
    _check(_port_step(inp, xa_int8, n_seq, s_audio), want, inp)


def test_step_refuses_what_it_does_not_take():
    """Widths that do not match the build raise; a tensor neither on the
    CPU nor on the card is refused, not run plain; the CPU path counts no
    launch."""
    inp = _inputs(False, 1, 128, 2)
    with pytest.raises(ValueError, match="cache width"):
        _port_step(dict(inp, kc=inp["kc"][..., :-2], vc=inp["vc"][..., :-2]), False, 1, 128)
    with pytest.raises(ValueError, match="bk must be"):
        tf.build_fused_decode_step(PORT_CFG, bk=3, t_cache=T, n_seq=2)
    before = tf.fused_decode_step.launches
    _port_step(inp, False, 1, 128)
    assert tf.fused_decode_step.launches == before
    meta = torch.empty((2, D), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tf.fused_decode_step(PORT_CFG, _packed()[1], meta, meta, meta, meta, meta, meta, 0)
