"""The epilogue of a product in one pass (``ops/bias_act.py``): bias, then
optional GELU, then optional residual.

On the CPU: ``bias_act_plain`` is, bit for bit, the chain the Whisper
model ran before it had the epilogue (written out below as it was), for
every combination of GELU and residual, bf16 and f32 products and biases,
values at and past the GELU's exact tails at ±6; the Whisper model's
``_linear``, ``_mlp``, ``conv_stem`` and ``encode`` give the same bits as
that chain on a micro configuration with random biases; each ``encode``,
``cross_kv`` and ``prefill`` calls the epilogue 2 + 5 a layer, 1 a layer
and 7 a layer times; the wrapper refuses what the kernel does not take.

On the card (marker ``cuda``): the kernel against ``bias_act_plain`` at the
encoder's shapes for 1, 2 and 4 windows, the stem's f32 products (the
positions over a batch), a prefill's 20 and 80 rows, row counts off the
block, an f32 output; its launches, and a capture through
``ops/graphs.GraphPool`` replaying the same bits and tally. The card's
machine has no JAX; run them there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_bias_act.py

Tolerance on the card: equal bits, but where the GELU runs: there the
kernel's ``tanhf`` is CUDA's math library as nvcc builds it, PyTorch's the
one its own build compiled, so a share of the elements below 1e-4 may
differ, by at most one bf16 ulp.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wis_tpu_torch.models.whisper import model as model_mod
from wis_tpu_torch.models.whisper import stem as stem_mod
from wis_tpu_torch.models.whisper.config import WhisperConfig
from wis_tpu_torch.models.whisper.weights import random_params
from wis_tpu_torch.ops import bias_act as ba
from wis_tpu_torch.ops.attention import merge_heads, mha, qkv_heads
from wis_tpu_torch.ops.bias_act import bias_act, bias_act_plain
from wis_tpu_torch.ops.gelu import gelu
from wis_tpu_torch.ops.quant import matmul_f32, qmatmul

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32


# ------------------------------------------------- the chain as it was


def old_linear(x, w, b=None):
    y = qmatmul(x, w)
    if b is not None:
        y = (y.float() + b.float()).to(x.dtype)
    return y


def old_mlp(x, blk):
    h = gelu(old_linear(x, blk["w1"], blk["b1"]))
    return old_linear(h, blk["w2"], blk["b2"])


def old_conv_stem(enc, mel):
    w1, w2 = enc["conv1"]["w"], enc["conv2"]["w"]
    dtype = w1.dtype
    x = mel.transpose(-1, -2).to(dtype)
    b, t, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1))
    z1 = torch.cat([xp[:, 0:t], xp[:, 1 : t + 1], xp[:, 2 : t + 2]], dim=-1)
    y = matmul_f32(z1, w1.reshape(3 * c, w1.shape[-1]))
    y = gelu((y + enc["conv1"]["b"].float()).to(dtype))
    d = y.shape[-1]
    r = y.reshape(b, t // 2, 2, d)
    odd_prev = F.pad(r[:, :, 1][:, :-1], (0, 0, 1, 0))
    z2 = torch.cat([odd_prev, r[:, :, 0], r[:, :, 1]], dim=-1)
    y2 = matmul_f32(z2, w2.reshape(3 * d, w2.shape[-1]))
    y2 = gelu((y2 + enc["conv2"]["b"].float()).to(dtype))
    return y2 + enc["pos"].to(dtype)


def old_encode(params, mel, cfg):
    """The encoder on the CPU route (plain attention and LayerNorm)."""
    enc = params["encoder"]
    ln = model_mod.layer_norm
    x = old_conv_stem(enc, mel)
    for li in range(cfg.n_audio_layer):
        blk = model_mod._layer(enc["blocks"], li)
        h, a = ln(x, blk["attn_ln"]["g"], blk["attn_ln"]["b"]), blk["attn"]
        q, k, v = (qkv_heads(t, cfg.n_audio_head) for t in (
            old_linear(h, a["q_w"], a["q_b"]), old_linear(h, a["k_w"]),
            old_linear(h, a["v_w"], a["v_b"])))
        x = x + old_linear(merge_heads(mha(q, k, v)), a["o_w"], a["o_b"])
        x = x + old_mlp(ln(x, blk["mlp_ln"]["g"], blk["mlp_ln"]["b"]), blk["mlp"])
    return ln(x, enc["ln_post"]["g"], enc["ln_post"]["b"])


def old_chain(y, b, gelu_on, residual, dtype):
    out = (y.float() + b.float()).to(dtype)
    if gelu_on:
        out = gelu(out)
    return out if residual is None else residual + out


# ------------------------------------------------------------- the CPU


def _case(rng, rows, cols, y_dtype, b_dtype, out_dtype, residual, dev="cpu", res_rows=None):
    """y (rows, cols) around ±3, with the columns 0-3 at 6, −6, 6.5, −7
    after a zero bias (the GELU's tails and their edge); b (cols,); the
    residual (res_rows or rows, cols) in the output dtype, or None."""
    y = rng.standard_normal((rows, cols), dtype=np.float32) * 3.0
    b = rng.standard_normal(cols, dtype=np.float32) * 2.0
    y[:, :4], b[:4] = [6.0, -6.0, 6.5, -7.0], 0.0
    r = None
    if residual:
        r = torch.from_numpy(rng.standard_normal((res_rows or rows, cols), dtype=np.float32))
        r = r.to(dev, out_dtype)
    return (torch.from_numpy(y).to(dev, y_dtype), torch.from_numpy(b).to(dev, b_dtype), r)


DTYPES = [(BF16, BF16, BF16), (BF16, F32, BF16), (F32, BF16, BF16), (F32, F32, BF16),
          (F32, F32, F32), (F32, BF16, F32)]
MODES = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("gelu_on,residual", MODES, ids=["bias", "gelu", "residual",
                                                         "gelu+residual"])
@pytest.mark.parametrize("y_dtype,b_dtype,out_dtype", DTYPES,
                         ids=["-".join(str(d)[6:] for d in t) for t in DTYPES])
def test_plain_is_the_chain_bit_for_bit(gelu_on, residual, y_dtype, b_dtype, out_dtype):
    rng = np.random.default_rng(5)
    y, b, r = _case(rng, 37, 48, y_dtype, b_dtype, out_dtype, residual)
    got = bias_act_plain(y, b, gelu=gelu_on, residual=r, dtype=out_dtype)
    want = old_chain(y, b, gelu_on, r, out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)
    # the tails: gelu(6) = 6 from the polynomial, past 6 x itself, below −6 zero
    if gelu_on and not residual:
        assert got[:, 2].eq(y[:, 2].to(out_dtype)).all() and got[:, 3].eq(0).all()
    # a CPU tensor takes the plain version and counts no launch
    before = bias_act.launches
    assert torch.equal(bias_act(y, b, gelu=gelu_on, residual=r, dtype=out_dtype), want)
    assert bias_act.launches == before


def test_plain_broadcasts_the_positions_over_a_batch():
    rng = np.random.default_rng(6)
    y, b, pos = _case(rng, 2 * 30, 16, F32, BF16, BF16, True, res_rows=30)
    y = y.reshape(2, 30, 16)
    got = bias_act_plain(y, b, gelu=True, residual=pos, dtype=BF16)
    assert torch.equal(got, gelu((y + b.float()).to(BF16)) + pos)


MICRO = WhisperConfig(name="micro-epilogue", n_mels=80, n_audio_state=64, n_audio_head=2,
                      n_audio_layer=2, n_text_state=64, n_text_head=2, n_text_layer=2)


def _micro(dtype):
    """MICRO's seeded weights with random biases (±2, some w1 biases ±8 so
    that GELU inputs pass ±6)."""
    params = random_params(MICRO, seed=1, device="cpu", dtype=dtype)
    gen = torch.Generator().manual_seed(2)

    def fill(tree):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                fill(leaf)
            elif key in ("q_b", "v_b", "o_b", "b1", "b2") or (key == "b" and "w" in tree):
                scale = 8.0 if key == "b1" else 2.0
                tree[key] = (torch.randn(leaf.shape, generator=gen) * scale).to(leaf.dtype)

    fill(params)
    return params


def _mel():
    return torch.randn(1, MICRO.n_mels, 3000, generator=torch.Generator().manual_seed(3))


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_linear_and_mlp_give_the_chains_bits(dtype):
    params = _micro(dtype)
    blk = model_mod._layer(params["encoder"]["blocks"], 1)
    x = torch.randn(3, 7, 64, generator=torch.Generator().manual_seed(4)).to(dtype)
    a = blk["attn"]
    assert torch.equal(model_mod._linear(x, a["q_w"], a["q_b"]), old_linear(x, a["q_w"], a["q_b"]))
    assert torch.equal(model_mod._linear(x, a["k_w"]), old_linear(x, a["k_w"]))
    assert torch.equal(model_mod._linear(x, a["o_w"], a["o_b"], residual=x),
                       x + old_linear(x, a["o_w"], a["o_b"]))
    assert torch.equal(model_mod._mlp(x, blk["mlp"]), old_mlp(x, blk["mlp"]))
    assert torch.equal(model_mod._mlp(x, blk["mlp"], residual=x), x + old_mlp(x, blk["mlp"]))


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_conv_stem_and_encode_give_the_chains_bits(dtype):
    params, mel = _micro(dtype), _mel()
    with torch.inference_mode():
        stem = stem_mod.conv_stem(params["encoder"], mel)
        assert stem.dtype == dtype and torch.equal(stem, old_conv_stem(params["encoder"], mel))
        got = model_mod.encode(params, mel, MICRO)
        assert torch.equal(got, old_encode(params, mel, MICRO))


def test_each_call_runs_the_epilogue_as_often_as_the_card_counts_it(monkeypatch):
    """encode: the stem's two and q, v, o, w1 and w2 in each layer; cross_kv:
    the v bias of each layer; prefill: self q, v, o, cross q, o, w1 and w2
    in each layer — what the card's launch counts are held to."""
    calls = []

    def spy(*args, **kw):
        calls.append(kw)
        return bias_act_plain(*args, **kw)

    monkeypatch.setattr(model_mod, "bias_act", spy)
    monkeypatch.setattr(stem_mod, "bias_act", spy)
    params, L = _micro(F32), MICRO.n_audio_layer
    with torch.inference_mode():
        xa = model_mod.encode(params, _mel(), MICRO)
        assert len(calls) == 2 + 5 * L
        assert sum(bool(kw.get("gelu")) for kw in calls) == 2 + L
        assert sum(kw.get("residual") is not None for kw in calls) == 1 + 2 * L
        calls.clear()
        kv = model_mod.cross_kv(params, xa, MICRO)
        assert len(calls) == MICRO.n_text_layer
        calls.clear()
        cache = model_mod.DecoderCache.zeros(MICRO, 2, 16, F32, "cpu")
        model_mod.prefill(params, torch.tensor([[50258, 50259, 50359, 50363]] * 2), cache, kv,
                          MICRO)
        assert len(calls) == 7 * MICRO.n_text_layer
        assert sum(kw.get("residual") is not None for kw in calls) == 3 * MICRO.n_text_layer


def _raises(match, y, b, residual=None, dtype=BF16):
    with pytest.raises(ValueError, match=match):
        ba._launch_args(y, b, residual, dtype)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    y, b = torch.zeros(4, 24, dtype=BF16), torch.zeros(24, dtype=BF16)
    assert ba._launch_args(y, b, torch.zeros(4, 24, dtype=BF16), BF16) == (96, 24, 96)
    assert ba._launch_args(y.float(), b.float(), None, BF16) == (96, 24, 0)
    # a batch of positions: the residual repeats over the leading axes
    assert ba._launch_args(torch.zeros(2, 3, 24), b, torch.zeros(3, 24, dtype=BF16),
                           BF16) == (144, 24, 72)
    _raises("multiple of 8", torch.zeros(4, 20, dtype=BF16), torch.zeros(20, dtype=BF16))
    _raises("contiguous", torch.zeros(24, 4, dtype=BF16).T, b)
    _raises("contiguous", torch.zeros(4, 48, dtype=BF16)[:, ::2], b)
    _raises("contiguous", y, b, torch.zeros(24, 4, dtype=BF16).T)
    _raises("aligned", torch.zeros(97 * 8, dtype=BF16)[1:1 + 96].view(4, 24), b)
    _raises("bias must be", y, torch.zeros(16, dtype=BF16))
    _raises("bias must be", y, torch.zeros(24, dtype=torch.float16))
    _raises("residual must be", y, b, torch.zeros(4, 24, dtype=F32))
    _raises("residual must be", y, b, torch.zeros(2, 24, dtype=BF16))
    _raises("product dtype", y, b, dtype=F32)
    _raises("output dtype", y.half(), b, dtype=torch.float16)


# ------------------------------------------------------------- the card


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the epilogue kernel has no CPU mode")
    from wis_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def assert_bits(got, want, gelu_on):
    """Equal bits; where the GELU ran, a share below 1e-4 of the elements
    may differ (the two builds' tanhf), by at most one bf16 ulp."""
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = got.float() != want.float()
    share = float(diff.float().mean())
    if not gelu_on or share == 0.0:
        assert share == 0.0, f"{share:.3e} of the elements differ"
        return
    w = want.float()[diff]
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
    assert share < 1e-4 and bool(((got.float()[diff] - w).abs() <= ulp).all()), \
        f"{share:.3e} of the elements differ, by up to {float((got.float()[diff] - w).abs().max())}"


#: (rows, cols, y, bias, output dtypes, gelu, residual rows: None, or 0 for
#: y's own): the encoder at 1, 2 and 4 windows (q/v, o/w2, w1), the stem's
#: f32 products (conv1 of one window; conv2 of two with the positions), a
#: prefill's 20 and 80 rows, rows off the block, an f32 output
CARD_CASES = [
    *[(b * 1500, 1280, BF16, BF16, BF16, False, None) for b in (1, 2, 4)],
    *[(b * 1500, 1280, BF16, BF16, BF16, False, 0) for b in (1, 2, 4)],
    *[(b * 1500, 5120, BF16, BF16, BF16, True, None) for b in (1, 2, 4)],
    (3000, 1280, F32, BF16, BF16, True, None),
    (3000, 1280, F32, BF16, BF16, True, 1500),
    (20, 1280, BF16, BF16, BF16, False, 0),
    (20, 5120, BF16, BF16, BF16, True, None),
    (80, 1280, BF16, BF16, BF16, False, 0),
    (80, 5120, BF16, BF16, BF16, True, None),
    (7, 1280, BF16, F32, BF16, True, 0),
    (1001, 40, BF16, BF16, BF16, True, 0),
    (3, 8, F32, BF16, BF16, True, 0),
    (13, 136, F32, F32, F32, True, 0),
    (13, 136, F32, BF16, F32, False, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[
    f"{r}x{c}-{str(y)[6:]}-{str(o)[6:]}{'-gelu' if g else ''}"
    f"{'' if res is None else f'-res{res or r}'}" for r, c, y, _, o, g, res in CARD_CASES])
def test_the_kernel_is_the_plain_chain(dev, case):
    rows, cols, y_dtype, b_dtype, out_dtype, gelu_on, res_rows = case
    rng = np.random.default_rng(rows * 7 + cols)
    y, b, r = _case(rng, rows, cols, y_dtype, b_dtype, out_dtype, res_rows is not None, dev,
                    res_rows or None)
    if res_rows:  # the positions of each of a batch's windows
        y = y.reshape(rows // res_rows, res_rows, cols)
    before = bias_act.launches
    got = bias_act(y, b, gelu=gelu_on, residual=r, dtype=out_dtype)
    want = bias_act_plain(y, b, gelu=gelu_on, residual=r, dtype=out_dtype)
    torch.cuda.synchronize()
    assert bias_act.launches == before + 1
    assert_bits(got, want, gelu_on)


@pytest.mark.cuda
def test_a_captured_epilogue_replays_its_bits_and_tally(dev):
    from wis_tpu_torch.ops.graphs import GraphPool

    rng = np.random.default_rng(12)
    y, b, r = _case(rng, 80, 5120, BF16, BF16, BF16, True, dev)
    before = bias_act.launches
    graph = GraphPool(dev).capture(lambda: bias_act(y, b, gelu=True, residual=r))
    assert graph.tally == {bias_act: 1} and bias_act.launches == before
    for seed in (13, 14):
        y2, b2, r2 = _case(np.random.default_rng(seed), 80, 5120, BF16, BF16, BF16, True, dev)
        for dst, src in ((y, y2), (b, b2), (r, r2)):
            dst.copy_(src)
        want = bias_act(y, b, gelu=True, residual=r)
        got = graph.replay(3).clone()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert bias_act.launches == before + 2 + 6
