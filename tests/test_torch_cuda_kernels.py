"""The hand-written Hopper kernels against their plain PyTorch versions, on
the card: edge shapes the main path does not reach (ragged key and query
tiles, batches, row counts off the block size, float32 LayerNorm; the
fused step at 1, 5 and 10 rows over one or two audio windows, the head
at 1 to 8 candidates over ragged vocabularies), the wrappers' refusals,
and the encoder's routing to its two kernels. The fused kernels'
tolerances are stated above their tests.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The card's machine has no JAX, so run them there without the suite's
conftest, which imports it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: bf16 LayerNorm at one bf16 ulp plus 1e-6 (both sides compute
f32 statistics in another summation order and round once; near zero the
result is a cancellation, see chip_smoke.py), f32 LayerNorm at 1e-5 (the
same math in another summation order); attention at
4 bf16 ulps of the output's largest magnitude, each element within 2 bf16
ulps of itself plus 2^-8 of that magnitude, and 6e-3 in relative norm (the
kernel rounds the unnormalized probabilities to bf16 and divides at the
end, the plain version rounds the normalized ones; chip_smoke.py gives the
calibration).
"""

from unittest import mock

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    from wis_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    mag = torch.clamp_min(x.abs().float(), 2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _randn(rng, shape, dev, dtype, scale=1.0, shift=0.0):
    a = rng.standard_normal(shape, dtype=np.float32) * scale + shift
    return torch.from_numpy(a).to(dev, dtype)


@pytest.mark.parametrize(
    "shape,dtype",
    [
        ((1, 1500, 1280), torch.bfloat16),  # the encoder's
        ((5, 384), torch.bfloat16),  # 5 rows: a partial block of 4 warps
        ((2, 3, 1280), torch.float32),
        ((7, 8), torch.bfloat16),  # one vector per row, most lanes idle
    ],
)
def test_layer_norm_kernel_matches_plain(dev, shape, dtype):
    from wis_tpu_torch.ops.layernorm import layer_norm_cuda, layer_norm_plain

    rng = np.random.default_rng(sum(shape))
    d = shape[-1]
    x = _randn(rng, shape, dev, dtype, scale=3.0, shift=0.5)
    g = _randn(rng, (d,), dev, torch.float32, scale=0.1, shift=1.0)
    b = _randn(rng, (d,), dev, torch.float32, scale=0.1)
    before = layer_norm_cuda.launches
    got = layer_norm_cuda(x, g, b)
    want = layer_norm_plain(x, g, b)
    torch.cuda.synchronize()
    assert layer_norm_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    err = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        over = err > _bf16_ulp(want) + 1e-6
    else:
        over = err > 1e-5
    assert not bool(over.any()), f"{int(over.sum())} elements beyond tolerance"


@pytest.mark.parametrize(
    "b,t,d,heads",
    [
        (1, 1500, 1280, 20),  # large-v2's encoder
        (2, 1500, 512, 8),  # base's encoder, a batch of two
        (1, 65, 256, 2),  # head_dim 128; one key and one query past a tile
        (3, 1, 128, 2),  # a single key
        (1, 200, 384, 3),  # head_dim 128, ragged tiles
    ],
)
def test_flash_kernel_matches_plain(dev, b, t, d, heads):
    from wis_tpu_torch.ops.flash import (
        flash_attention_packed,
        flash_attention_packed_plain,
    )

    rng = np.random.default_rng(t + d)
    q, k, v = (_randn(rng, (b, t, d), dev, torch.bfloat16) for _ in range(3))
    before = flash_attention_packed.launches
    got = flash_attention_packed(q, k, v, heads)
    want = flash_attention_packed_plain(q, k, v, heads)
    torch.cuda.synchronize()
    assert flash_attention_packed.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    diff = (got.float() - want.float()).abs()
    r = want.float()
    tol = 4 * 2.0 ** -8 * float(r.abs().max())
    assert float(diff.max()) <= tol, (float(diff.max()), tol)
    over = diff > 2 * _bf16_ulp(r) + 2.0 ** -8 * float(r.abs().max())
    assert not bool(over.any()), f"{int(over.sum())} elements beyond tolerance"
    assert float(diff.norm()) <= 6e-3 * float(r.norm())


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from wis_tpu_torch.ops.flash import flash_attention_packed
    from wis_tpu_torch.ops.layernorm import layer_norm_cuda

    g = torch.ones(256, device=dev)
    x = torch.zeros((4, 256), device=dev, dtype=torch.bfloat16)
    q = torch.zeros((1, 64, 256), device=dev, dtype=torch.bfloat16)
    counts = (layer_norm_cuda.launches, flash_attention_packed.launches)
    with pytest.raises(ValueError, match="dtype"):
        layer_norm_cuda(x.half(), g, g)
    with pytest.raises(ValueError, match="contiguous"):
        layer_norm_cuda(torch.zeros((256, 4), device=dev).T, g, g)
    with pytest.raises(ValueError, match="f32"):
        layer_norm_cuda(x, g.bfloat16(), g)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_packed(q, q, q, 5)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention_packed(q, q.float(), q, 4)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_packed(q, q, torch.zeros_like(q).mT.contiguous().mT, 4)
    assert (layer_norm_cuda.launches, flash_attention_packed.launches) == counts


def test_encode_runs_both_kernels(dev):
    """A narrow bf16 encoder on the card goes through the kernels under the
    JAX package's shape gates (T=1500 ≥ 512, head_dim 64, D % 128 == 0),
    and sits no farther from the f32 encoder than the plain bf16 one does,
    up to 1.5×."""
    from wis_tpu_torch.models.whisper import model as model_mod
    from wis_tpu_torch.models.whisper.config import WhisperConfig
    from wis_tpu_torch.models.whisper.weights import random_params
    from wis_tpu_torch.ops.flash import (
        flash_attention_packed,
        flash_attention_packed_plain,
    )
    from wis_tpu_torch.ops.layernorm import layer_norm_cuda, layer_norm_plain

    cfg = WhisperConfig(name="narrow", n_audio_state=128, n_audio_head=2,
                        n_audio_layer=2, n_text_state=128, n_text_head=2,
                        n_text_layer=2)
    params = random_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    f32 = {"encoder": random_params(cfg, seed=0, device=dev, dtype=torch.float32)["encoder"]}
    rng = np.random.default_rng(9)
    mel = _randn(rng, (1, cfg.n_mels, 3000), dev, torch.float32)
    before = (layer_norm_cuda.launches, flash_attention_packed.launches)
    with torch.inference_mode():
        got = model_mod.encode(params, mel, cfg).float()
        launched = (
            layer_norm_cuda.launches - before[0],
            flash_attention_packed.launches - before[1],
        )
        with mock.patch.object(model_mod, "layer_norm_cuda", layer_norm_plain), \
                mock.patch.object(model_mod, "flash_attention_packed",
                                  flash_attention_packed_plain):
            plain = model_mod.encode(params, mel, cfg).float()
            exact = model_mod.encode(f32, mel, cfg)
    torch.cuda.synchronize()
    assert launched == (2 * cfg.n_audio_layer + 1, cfg.n_audio_layer)
    assert got.shape == (1, 1500, 128) and bool(torch.isfinite(got).all())

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    assert rel(got, exact) <= 1.5 * rel(plain, exact)


# --------------------------------------------------------------------------- #
# Head-major flash attention (the attention tolerances above) and the
# encoder's routes under the JAX package's environment switches
# --------------------------------------------------------------------------- #
def _head_major_inputs(dev, b, h, t, dh, trap, seed):
    """chip_smoke's head-major inputs: contiguous (b, h, t, dh) bf16 at the
    start of allocations that run on past the last head; with ``trap`` an
    unmasked ragged key tile, or a read past T of the last head, moves the
    output far off."""
    import chip_smoke

    return chip_smoke._head_major_inputs(torch, dev, b, h, t, dh, trap, seed)


def _assert_attention_close(got, want):
    diff = (got.float() - want.float()).abs()
    r = want.float()
    assert float(diff.max()) <= 4 * 2.0 ** -8 * float(r.abs().max())
    over = diff > 2 * _bf16_ulp(r) + 2.0 ** -8 * float(r.abs().max())
    assert not bool(over.any()), f"{int(over.sum())} elements beyond tolerance"
    assert float(diff.norm()) <= 6e-3 * float(r.norm())


@pytest.mark.parametrize(
    "b,h,t,dh",
    [
        (1, 20, 1500, 64),  # large-v2's encoder, head-major
        (1, 10, 1500, 128),
        (2, 2, 700, 32),  # the micro configs' head width
        (1, 16, 1500, 80),
        (1, 18, 600, 72),  # Dh % 16 == 8: half of the last k-slice is zero
        (3, 2, 65, 8),  # the narrowest head; one key and one query past a tile
        (1, 3, 200, 136),  # past 128: three 64-column blocks, the last mostly zeros
        (1, 2, 1, 24),  # a single key
        (1, 2, 97, 256),  # the widest head the kernel takes
    ],
)
@pytest.mark.parametrize("trap", [False, True])
def test_head_major_flash_matches_plain(dev, b, h, t, dh, trap):
    from wis_tpu_torch.ops.flash import flash_attention, flash_attention_plain

    q, k, v = _head_major_inputs(dev, b, h, t, dh, trap, seed=t + dh + trap)
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    want = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    if trap:
        assert float(want.float().abs().max()) < 10  # the plain version reads no trap
    _assert_attention_close(got, want)


@pytest.mark.parametrize("heads,dh", [(20, 64), (2, 128), (3, 64)])
def test_head_major_flash_bit_identical_to_packed(dev, heads, dh):
    """One kernel body for both layouts: the same numbers give the same
    bits after merge_heads."""
    from wis_tpu_torch.ops.attention import merge_heads
    from wis_tpu_torch.ops.flash import flash_attention, flash_attention_packed

    q, k, v = _head_major_inputs(dev, 1, heads, 1500, dh, False, seed=heads)
    head_major = merge_heads(flash_attention(q, k, v))
    packed = flash_attention_packed(*(merge_heads(x) for x in (q, k, v)), heads)
    torch.cuda.synchronize()
    assert torch.equal(head_major, packed)


@pytest.mark.parametrize("batch", [1, 9])
@pytest.mark.parametrize("layout", ["packed", "head-major"])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("t", [512, 513, 1499, 1500])
def test_hopper_flash_edges(dev, t, dh, layout, batch):
    """The Hopper body at key counts on and off its 64-key tiles and query
    counts on and off its 64- and 128-row blocks, in both layouts, with
    one consumer warpgroup per block (one batch of 4 heads: too few
    blocks for two) and two (nine batches): the attention tolerances,
    and the head-major output bit-identical to the packed one."""
    from wis_tpu_torch.ops.attention import merge_heads
    from wis_tpu_torch.ops.flash import (
        flash_attention,
        flash_attention_packed,
        flash_attention_plain,
    )

    q, k, v = _head_major_inputs(dev, batch, 4, t, dh, False, seed=t + dh)
    want = flash_attention_plain(q, k, v)
    packed = flash_attention_packed(*(merge_heads(x) for x in (q, k, v)), 4)
    if layout == "packed":
        got = packed.view(batch, t, 4, dh).transpose(1, 2)
    else:
        got = flash_attention(q, k, v)
        assert torch.equal(merge_heads(got), packed)
    torch.cuda.synchronize()
    _assert_attention_close(got, want)


@pytest.mark.parametrize("t", [513, 1499, 1500])
@pytest.mark.parametrize("heads", [20, 10])
def test_packed_flash_cross_batch_trap(dev, heads, t):
    """B = 2 with Inf in the values of batch 1's first 64 rows: batch 0's
    ragged last key tile must stop at its own batch (0 × Inf is NaN), so
    batch 0 stays finite and equal to its plain version."""
    import chip_smoke
    from wis_tpu_torch.ops.flash import flash_attention_packed, flash_attention_packed_plain

    q, k, v = chip_smoke.cross_batch_inputs(torch, dev, heads, seed=heads, t=t)
    got = flash_attention_packed(q, k, v, heads)[:1]
    want = flash_attention_packed_plain(q[:1], k[:1], v[:1], heads)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _assert_attention_close(got, want)


def test_head_major_flash_refuses_what_the_kernel_does_not_take(dev):
    from wis_tpu_torch.ops.flash import flash_attention

    def z(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, device=dev, dtype=dtype)

    before = flash_attention.launches
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention(z(1, 2, 64, 60), z(1, 2, 64, 60), z(1, 2, 64, 60))
    with pytest.raises(ValueError, match="multiple of 8 up to 256"):
        flash_attention(z(1, 1, 64, 264), z(1, 1, 64, 264), z(1, 1, 64, 264))
    q = z(1, 2, 64, 64)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention(q, q.float(), q)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q, z(1, 64, 2, 64).transpose(1, 2))
    with pytest.raises(ValueError, match="B, H, T, Dh"):
        flash_attention(z(2, 64, 64), z(2, 64, 64), z(2, 64, 64))
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(q, q, z(1 * 2 * 64 * 64 + 1)[1:].view(1, 2, 64, 64))
    assert flash_attention.launches == before


@pytest.mark.parametrize(
    "env,heads,want",
    [
        ((), 2, dict(packed=2, head_major=0, ln=5)),  # head_dim 64: packed
        (("WIS_NO_PACKED_FLASH",), 2, dict(packed=0, head_major=2, ln=5)),
        (("WIS_NO_FLASH",), 2, dict(packed=0, head_major=0, ln=5)),
        (("WIS_NO_LN_KERNEL",), 2, dict(packed=2, head_major=0, ln=0)),
        ((), 4, dict(packed=0, head_major=2, ln=5)),  # head_dim 32: head-major
        (("WIS_NO_FLASH", "WIS_NO_LN_KERNEL"), 4, dict(packed=0, head_major=0, ln=0)),
    ],
)
def test_encoder_routes_under_each_switch(dev, monkeypatch, env, heads, want):
    """A narrow bf16 encoder on the card launches the kernels the JAX gate
    names under each switch, and every route sits no farther from the f32
    encoder than the plain bf16 one does, up to 1.5×; the two flash routes
    give the same bits."""
    from wis_tpu_torch.models.whisper import model as model_mod
    from wis_tpu_torch.models.whisper.config import WhisperConfig
    from wis_tpu_torch.models.whisper.weights import random_params
    from wis_tpu_torch.ops.flash import flash_attention, flash_attention_packed
    from wis_tpu_torch.ops.layernorm import layer_norm_cuda

    for name in ("WIS_NO_FLASH", "WIS_NO_PACKED_FLASH", "WIS_NO_LN_KERNEL"):
        monkeypatch.delenv(name, raising=False)
    cfg = WhisperConfig(name="narrow", n_audio_state=128, n_audio_head=heads,
                        n_audio_layer=2, n_text_state=128, n_text_head=heads,
                        n_text_layer=2)
    params = random_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    f32 = {"encoder": random_params(cfg, seed=0, device=dev, dtype=torch.float32)["encoder"]}
    mel = _randn(np.random.default_rng(9), (1, cfg.n_mels, 3000), dev, torch.float32)
    counters = (flash_attention_packed, flash_attention, layer_norm_cuda)
    with torch.inference_mode():
        default = model_mod.encode(params, mel, cfg).float()
        for name in env:
            monkeypatch.setenv(name, "1")
        before = [c.launches for c in counters]
        got = model_mod.encode(params, mel, cfg).float()
        launched = [c.launches - n for c, n in zip(counters, before)]
        monkeypatch.setenv("WIS_NO_FLASH", "1")
        monkeypatch.setenv("WIS_NO_LN_KERNEL", "1")
        plain = model_mod.encode(params, mel, cfg).float()
        exact = model_mod.encode(f32, mel, cfg)
    torch.cuda.synchronize()
    assert launched == [want["packed"], want["head_major"], want["ln"]]
    assert got.shape == (1, 1500, 128) and bool(torch.isfinite(got).all())
    if "WIS_NO_FLASH" not in env and "WIS_NO_LN_KERNEL" not in env:
        assert torch.equal(got, default)

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    assert rel(got, exact) <= 1.5 * rel(plain, exact)


def test_float32_on_the_card_is_refused_not_run_plain(dev):
    """The flash kernel takes bf16 only: an f32 encoder on the card raises
    in the kernel's wrapper, and an f32 registry on the card is refused."""
    from wis_tpu_torch.models.whisper import model as model_mod
    from wis_tpu_torch.models.whisper.config import WhisperConfig
    from wis_tpu_torch.models.whisper.weights import random_params
    from wis_tpu_torch.runtime.residency import ModelRegistry
    from wis_tpu_torch.settings import APISettings

    cfg = WhisperConfig(name="narrow", n_audio_state=128, n_audio_head=2,
                        n_audio_layer=1, n_text_state=128, n_text_head=2,
                        n_text_layer=1)
    params = random_params(cfg, seed=0, device=dev, dtype=torch.float32)
    mel = torch.zeros((1, cfg.n_mels, 3000), device=dev)
    with torch.inference_mode(), pytest.raises(ValueError, match="bf16"):
        model_mod.encode(params, mel, cfg)
    with pytest.raises(ValueError, match="bfloat16"):
        ModelRegistry(APISettings(dtype="float32"), dev)


# --------------------------------------------------------------------------- #
# The fused decode step and the fused logits head (tolerances as in
# chip_smoke.py: the step's x_out and written K/V columns within 2e-2 of
# the plain version in relative norm — both run every product on the same
# bf16 operands in f32, in another summation order, and a bf16 rounding
# flip anywhere moves the layers after it — and every other cache column
# bit-identical; the head's values and lse within 0.05, a one-ulp flip of
# one bf16 LayerNorm output times an embedding element)
# --------------------------------------------------------------------------- #
STEP_REL_NORM = 2e-2
HEAD_ATOL = 0.05


def _narrow_decoder(dev, n_layer=2, d=256, heads=4):
    from wis_tpu_torch.models.whisper.config import WhisperConfig
    from wis_tpu_torch.models.whisper.weights import random_params
    from wis_tpu_torch.ops.fused_decode import pack_decoder

    cfg = WhisperConfig(name="narrow", n_audio_state=d, n_audio_head=heads,
                        n_audio_layer=1, n_text_state=d, n_text_head=heads,
                        n_text_layer=n_layer)
    return cfg, pack_decoder(random_params(cfg, seed=3, device=dev), cfg)


def _step_case(dev, cfg, bk, n_seq, t_cache, s_audio, xa_int8, seed, pos=None):
    """Step inputs at position ``pos`` (default t_cache // 2) with random
    ancestry inside each sequence's beams; the columns no row selects, and
    the cross-KV pad columns, hold keys of ±30 and values of 100 (a kernel
    reading them moves every output far off)."""
    from wis_tpu_torch.ops.fused_decode import quantize_xa_columns

    L, D, H = cfg.n_text_layer, cfg.n_text_state, cfg.n_text_head
    beams = bk // n_seq
    s_pad = ((s_audio + 127) // 128) * 128
    pos = t_cache // 2 if pos is None else pos
    rng = np.random.default_rng(seed)
    sel = np.zeros((bk, t_cache, bk), np.float32)
    for r in range(bk):
        base = (r // beams) * beams
        sel[r, np.arange(pos), base + rng.integers(0, beams, pos)] = 1.0
    sel = torch.from_numpy(sel.reshape(bk, t_cache * bk)).to(dev)
    kc = _randn(rng, (L, D, bk * t_cache), dev, torch.float32, scale=0.5)
    vc = _randn(rng, (L, D, bk * t_cache), dev, torch.float32, scale=0.5)
    excluded = sel.sum(dim=0) == 0
    kc[:, :, excluded] = 30.0 * torch.sign(kc[:, :, excluded])
    vc[:, :, excluded] = 100.0
    xk = _randn(rng, (L, H, D // H, n_seq * s_pad), dev, torch.float32, scale=0.5)
    xv = _randn(rng, (L, H, D // H, n_seq * s_pad), dev, torch.float32, scale=0.5)
    pad = (torch.arange(n_seq * s_pad, device=dev) % s_pad) >= s_audio
    xk[..., pad] = 30.0 * torch.sign(xk[..., pad])
    xv[..., pad] = 100.0
    kc, vc, xk, xv = (t.to(torch.bfloat16) for t in (kc, vc, xk, xv))
    xs = None
    if xa_int8:
        xk, xv, xs = quantize_xa_columns(xk, xv)
    x = _randn(rng, (bk, D), dev, torch.float32, scale=0.5)
    return dict(x_emb=x, k_cache=kc, v_cache=vc, xa_k=xk, xa_v=xv, sel=sel, pos=pos,
                n_seq=n_seq, s_audio=s_audio, xa_s=xs)


@pytest.mark.parametrize(
    "bk,n_seq,t_cache,s_audio,xa_int8",
    [
        (1, 1, 128, 1500, True),  # greedy
        (5, 1, 256, 1500, False),
        (10, 2, 128, 1500, True),  # two windows, block-diagonal cross-attention
        (10, 2, 256, 100, False),  # a short window: pad columns masked
        (20, 4, 256, 1500, True),  # four windows: long-form and coalesced batches
    ],
)
def test_fused_step_kernel_matches_plain(dev, bk, n_seq, t_cache, s_audio, xa_int8):
    from wis_tpu_torch.ops.fused_decode import fused_decode_step, fused_decode_step_plain

    cfg, packed = _narrow_decoder(dev)
    inp = _step_case(dev, cfg, bk, n_seq, t_cache, s_audio, xa_int8, seed=bk + t_cache)
    kc0, vc0 = inp["k_cache"], inp["v_cache"]
    before = fused_decode_step.launches
    got = fused_decode_step(cfg, packed, **dict(inp, k_cache=kc0.clone(), v_cache=vc0.clone()))
    want = fused_decode_step_plain(
        cfg, packed, **dict(inp, k_cache=kc0.clone(), v_cache=vc0.clone()))
    torch.cuda.synchronize()
    assert fused_decode_step.launches == before + 1
    cols = slice(inp["pos"] * bk, (inp["pos"] + 1) * bk)
    other = torch.ones(kc0.shape[-1], dtype=torch.bool, device=dev)
    other[cols] = False

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    assert got[0].shape == (bk, cfg.n_text_state) and bool(torch.isfinite(got[0]).all())
    assert rel(got[0], want[0]) <= STEP_REL_NORM
    for g, w, before_c in ((got[1], want[1], kc0), (got[2], want[2], vc0)):
        assert rel(g[..., cols], w[..., cols]) <= STEP_REL_NORM
        assert torch.equal(g[..., other], before_c[..., other])


def _run_step_both(dev, cfg, packed, inp):
    """(kernel result, plain result), each on its own copy of the caches."""
    from wis_tpu_torch.ops.fused_decode import fused_decode_step, fused_decode_step_plain

    kc0, vc0 = inp["k_cache"], inp["v_cache"]
    got = fused_decode_step(cfg, packed, **dict(inp, k_cache=kc0.clone(), v_cache=vc0.clone()))
    want = fused_decode_step_plain(
        cfg, packed, **dict(inp, k_cache=kc0.clone(), v_cache=vc0.clone()))
    torch.cuda.synchronize()
    return got, want


def _assert_step_close(got, want, inp, bk):
    """The step's output and this step's cache columns within STEP_REL_NORM
    of the plain version's, every other cache column untouched."""
    pos = inp["pos"]
    cols = slice(pos * bk, (pos + 1) * bk)
    other = torch.ones(inp["k_cache"].shape[-1], dtype=torch.bool, device=got[0].device)
    other[cols] = False

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    assert bool(torch.isfinite(got[0]).all()) and rel(got[0], want[0]) <= STEP_REL_NORM
    for g, w, before_c in ((got[1], want[1], inp["k_cache"]), (got[2], want[2], inp["v_cache"])):
        assert rel(g[..., cols], w[..., cols]) <= STEP_REL_NORM
        assert torch.equal(g[..., other], before_c[..., other])


@pytest.mark.parametrize("xa_int8", [True, False])
@pytest.mark.parametrize("s_audio", [1500, 100])
@pytest.mark.parametrize("where", ["first", "last"])
@pytest.mark.parametrize("bk,n_seq", [(1, 1), (5, 1), (8, 2), (20, 4), (32, 1), (32, 4)])
def test_fused_step_edges(dev, bk, n_seq, where, s_audio, xa_int8):
    """The step at BK 1-32 over one, two and four windows, at the first
    and the last cache position (no history, then a full one: the split
    self-attention's empty and full tiles), a full and a short window, int8
    and bf16 cross-KV, on the trap inputs."""
    cfg, packed = _narrow_decoder(dev)
    t_cache = 128
    pos = 0 if where == "first" else t_cache - 1
    inp = _step_case(dev, cfg, bk, n_seq, t_cache, s_audio, xa_int8, seed=bk + n_seq + pos,
                     pos=pos)
    _assert_step_close(*_run_step_both(dev, cfg, packed, inp), inp, bk)


@pytest.mark.parametrize("xa_int8", [True, False])
@pytest.mark.parametrize("n_seq", [8, 16, 32])
def test_fused_step_many_windows_at_large_v2_heads(dev, n_seq, xa_int8):
    """Beam 1 over 8, 16 and 32 windows at large-v2's 20 heads (D = 1280,
    one layer), as a coalesced batch gives the step: there the
    cross-attention's column split is set by its cap on columns per block,
    not by the SM count (int8 and bf16 cross-KV, the trap inputs)."""
    cfg, packed = _narrow_decoder(dev, n_layer=1, d=1280, heads=20)
    inp = _step_case(dev, cfg, n_seq, n_seq, 128, 1500, xa_int8, seed=n_seq + xa_int8)
    _assert_step_close(*_run_step_both(dev, cfg, packed, inp), inp, n_seq)


@pytest.mark.parametrize("bk,n_seq,xa_int8", [(5, 1, True), (20, 4, True), (8, 2, False)])
def test_fused_step_same_bits_call_to_call(dev, bk, n_seq, xa_int8):
    """Two calls on the same inputs give the same bits: every split sum
    (products, self- and cross-attention) is taken in a fixed order."""
    from wis_tpu_torch.ops.fused_decode import fused_decode_step

    cfg, packed = _narrow_decoder(dev)
    inp = _step_case(dev, cfg, bk, n_seq, 256, 1500, xa_int8, seed=7 + bk)
    runs = [fused_decode_step(cfg, packed, **dict(inp, k_cache=inp["k_cache"].clone(),
                                                   v_cache=inp["v_cache"].clone()))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_fused_step_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from wis_tpu_torch.ops.fused_decode import fused_decode_step

    cfg, packed = _narrow_decoder(dev)
    inp = _step_case(dev, cfg, 5, 1, 128, 1500, True, seed=0)
    before = fused_decode_step.launches
    for bad, match in (
        (dict(x_emb=inp["x_emb"].bfloat16()), "x_emb must be f32"),
        (dict(k_cache=inp["k_cache"][:1].contiguous()), "k_cache must be"),
        (dict(v_cache=inp["v_cache"].float()), "v_cache must be bf16"),
        (dict(xa_s=None), "xa_k must be"),
        (dict(sel=inp["sel"].bfloat16()), "sel must be f32"),
        (dict(x_emb=torch.zeros((33, cfg.n_text_state), device=dev)), "BK=33"),
        (dict(pos=128), "pos 128"),
        (dict(k_cache=inp["k_cache"][..., :60].contiguous(),
              v_cache=inp["v_cache"][..., :60].contiguous(), sel=inp["sel"][:, :60].contiguous(),
              pos=3), "cache width 60"),
        (dict(s_audio=5000, xa_k=torch.zeros((2, 4, 64, 5120), dtype=torch.int8, device=dev),
              xa_v=torch.zeros((2, 4, 64, 5120), dtype=torch.int8, device=dev),
              xa_s=torch.zeros((2, 8, 5120), dtype=torch.bfloat16, device=dev)), "s_audio 5000"),
    ):
        with pytest.raises(ValueError, match=match):
            fused_decode_step(cfg, packed, **dict(inp, **bad))
    assert fused_decode_step.launches == before


def _head_inputs(dev, bk, v, seed, d=128):
    rng = np.random.default_rng(seed)
    x = _randn(rng, (bk, d), dev, torch.float32, scale=2.0, shift=0.3)
    g = _randn(rng, (d,), dev, torch.float32, scale=0.1, shift=1.0)
    b = _randn(rng, (d,), dev, torch.float32, scale=0.1)
    emb = _randn(rng, (v, d), dev, torch.bfloat16)
    sup = torch.zeros(v, device=dev)
    sup[torch.from_numpy(rng.choice(v, v // 50, replace=False)).to(dev)] = -1e30
    return x, g, b, emb, sup


@pytest.mark.parametrize(
    "bk,k,v",
    [
        (1, 1, 1000),  # greedy; 1000 = 7 chunks of 128 and a ragged 104
        (10, 6, 1000),
        (5, 6, 51865),  # the vocabulary's ragged last chunk (25 columns)
        (32, 8, 333),  # the most rows and candidates the kernel takes
    ],
)
@pytest.mark.parametrize("int8", [False, True])
def test_fused_head_kernel_matches_plain(dev, bk, k, v, int8):
    """Values and lse within HEAD_ATOL; each returned id's own logit equal
    to the value returned beside it; ids equal to the plain version's
    wherever the value sits more than 2·HEAD_ATOL from its neighbours
    (closer values may legitimately swap)."""
    from wis_tpu_torch.ops.fused_logits import fused_logits_topk, fused_logits_topk_plain
    from wis_tpu_torch.ops.quant import quantize_rows

    x, g, b, emb, sup = _head_inputs(dev, bk, v, seed=bk + v)
    table = quantize_rows(emb) if int8 else emb
    for full in (False, True):
        before = fused_logits_topk.launches
        val, tok, lse = fused_logits_topk(x, g, b, table, sup, k=k, full_lse=full)
        want_val, want_tok, want_lse = fused_logits_topk_plain(x, g, b, table, sup, k=k,
                                                               full_lse=full)
        all_val, all_tok = fused_logits_topk_plain(x, g, b, table, sup, k=v)[:2]
        torch.cuda.synchronize()
        assert fused_logits_topk.launches == before + 1
        assert tok.shape == (bk, k) and tok.dtype == torch.int64 and lse.shape == (bk, 1)
        assert float((val - want_val).abs().max()) <= HEAD_ATOL
        assert float((lse - want_lse).abs().max()) <= HEAD_ATOL
        logits = torch.empty_like(all_val).scatter_(1, all_tok, all_val)
        assert float((logits.gather(1, tok) - val).abs().max()) <= HEAD_ATOL
        padded = torch.cat([all_val[:, :1] + 1e9, all_val[:, : k + 1]], dim=1)
        clear = ((padded[:, :-2] - padded[:, 1:-1]) > 2 * HEAD_ATOL) & (
            (padded[:, 1:-1] - padded[:, 2:]) > 2 * HEAD_ATOL)
        assert torch.equal(tok[clear], want_tok[clear])


def test_fused_head_refuses_what_the_kernel_does_not_take(dev):
    from wis_tpu_torch.models.whisper.config import WhisperConfig
    from wis_tpu_torch.ops.fused_logits import build_fused_logits_topk, fused_logits_topk

    cfg = WhisperConfig(name="narrow", n_text_state=128, n_text_head=2)
    x, g, b, emb, sup = _head_inputs(dev, 5, 1000, seed=0)
    with pytest.raises(ValueError, match="grammar=True takes ts_state"):
        build_fused_logits_topk(cfg, bk=5, k=6, grammar=True)(x, g, b, emb, sup)
    before = fused_logits_topk.launches
    for args, kw, match in (
        ((x.bfloat16(), g, b, emb, sup), dict(k=6), "x must be f32"),
        ((x, g, b, emb.float(), sup), dict(k=6), "emb must be bf16"),
        ((x, g, b, emb, sup[:-1]), dict(k=6), "sup must be f32"),
        ((x, g, b, emb, sup), dict(k=9), "k=9"),
        ((torch.zeros((33, 128), device=dev), g, b, emb, sup), dict(k=6), "BK=33"),
        ((x, g, b, emb, sup), dict(k=6, ts_state=torch.zeros((5, 4), device=dev)),
         "ts_state must be int32"),
    ):
        with pytest.raises(ValueError, match=match):
            fused_logits_topk(*args, **kw)
    assert fused_logits_topk.launches == before


# --------------------------------------------------------------------------- #
# The fused XTTS GPT step and sampling head (tolerances as in chip_smoke.py:
# the step within STEP_REL_NORM of its plain version in relative norm and
# every other cache column bit-identical; the head's values within two bf16
# ulps on a real head, and equal decisions on inputs whose logits are exact)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [1, 3, 3000])
@pytest.mark.parametrize("d", [384, 512, 768, 1024, 1280, 1000, 4104])
def test_layer_norm_widths(dev, d, rows, dtype):
    """Every Whisper width, one that is not a multiple of 256 (lanes past
    the row's end in the register body) and one past the register body
    (the three-pass body), at 1, 3 and 3000 rows."""
    test_layer_norm_kernel_matches_plain(dev, (rows, d), dtype)


def _narrow_gpt(dev, n_layer=2, d=256, heads=4):
    from wis_tpu_torch.models.xtts.gpt import GPTConfig, random_gpt
    from wis_tpu_torch.ops.fused_gpt import pack_gpt
    from wis_tpu_torch.ops.quant import quantize_gpt_params

    cfg = GPTConfig(n_layer=n_layer, n_head=heads, d_model=d)
    params = quantize_gpt_params(random_gpt(cfg, seed=3, device=dev))
    return cfg, params, pack_gpt(params, cfg)


@pytest.mark.parametrize("t_pad,pos", [(256, 200), (1152, 1096), (1152, 0)])
@pytest.mark.parametrize("trap", [False, True])
def test_fused_gpt_step_kernel_matches_plain(dev, t_pad, pos, trap):
    """bk=1 over the first cache bucket and the full one; with ``trap`` the
    columns sel excludes (the stale one at pos, the unwritten ones) hold keys
    of ±30 and values of 100."""
    from wis_tpu_torch.ops.fused_gpt import fused_gpt_step, fused_gpt_step_plain

    cfg, _, packed = _narrow_gpt(dev)
    rng = np.random.default_rng(t_pad + pos + trap)
    L, D = cfg.n_layer, cfg.d_model
    kc = _randn(rng, (L, D, t_pad), dev, torch.float32, scale=0.5)
    vc = _randn(rng, (L, D, t_pad), dev, torch.float32, scale=0.5)
    sel = (torch.arange(t_pad, device=dev) < pos).float()[None]
    if trap:
        kc[:, :, pos:] = 30.0 * torch.sign(kc[:, :, pos:])
        vc[:, :, pos:] = 100.0
    kc0, vc0 = kc.bfloat16(), vc.bfloat16()
    x = _randn(rng, (1, D), dev, torch.float32, scale=0.5)
    before = fused_gpt_step.launches
    got = fused_gpt_step(cfg, packed, x, kc0.clone(), vc0.clone(), sel, pos)
    want = fused_gpt_step_plain(cfg, packed, x, kc0.clone(), vc0.clone(), sel, pos)
    torch.cuda.synchronize()
    assert fused_gpt_step.launches == before + 1

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    other = torch.arange(t_pad, device=dev) != pos
    assert bool(torch.isfinite(got[0]).all()) and rel(got[0], want[0]) <= STEP_REL_NORM
    for g, w, c0 in ((got[1], want[1], kc0), (got[2], want[2], vc0)):
        assert rel(g[..., pos], w[..., pos]) <= STEP_REL_NORM
        assert torch.equal(g[..., other], c0[..., other])


def test_fused_gpt_step_same_bits_call_to_call(dev):
    from wis_tpu_torch.ops.fused_gpt import fused_gpt_step

    cfg, _, packed = _narrow_gpt(dev)
    rng = np.random.default_rng(11)
    L, D, t_pad, pos = cfg.n_layer, cfg.d_model, 1152, 900
    kc = _randn(rng, (L, D, t_pad), dev, torch.bfloat16, scale=0.5)
    vc = _randn(rng, (L, D, t_pad), dev, torch.bfloat16, scale=0.5)
    sel = (torch.arange(t_pad, device=dev) < pos).float()[None]
    x = _randn(rng, (1, D), dev, torch.float32, scale=0.5)
    runs = [fused_gpt_step(cfg, packed, x, kc.clone(), vc.clone(), sel, pos) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_fused_gpt_step_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from wis_tpu_torch.models.xtts.gpt import GPTConfig
    from wis_tpu_torch.ops.fused_gpt import fused_gpt_step

    cfg, _, packed = _narrow_gpt(dev)
    D = cfg.d_model
    kc = torch.zeros((cfg.n_layer, D, 256), dtype=torch.bfloat16, device=dev)
    sel = torch.zeros((1, 256), device=dev)
    x = torch.zeros((1, D), device=dev)
    before = fused_gpt_step.launches
    for args, match in (
        ((cfg, packed, x.bfloat16(), kc, kc, sel, 3), "x_emb must be f32"),
        ((cfg, packed, x, kc.float(), kc, sel, 3), "k_cache must be bf16"),
        ((cfg, packed, x, kc, kc, sel.bfloat16(), 3), "sel must be f32"),
        ((cfg, packed, x, kc, kc, sel, 256), "pos 256"),
        ((cfg, packed, x, kc[..., :252].contiguous(), kc[..., :252].contiguous(),
          sel[:, :252].contiguous(), 3), "cache width 252"),
        ((cfg, packed, torch.zeros((33, D), device=dev), kc, kc, sel, 3), "bk=33"),
        ((GPTConfig(n_layer=2, n_head=8, d_model=256), packed, x, kc, kc, sel, 3), "head_dim"),
    ):
        with pytest.raises(ValueError, match=match):
            fused_gpt_step(*args)
    assert fused_gpt_step.launches == before


@pytest.mark.parametrize(
    "knobs",
    [(0.1, 50, 0.8, 7.0, 1.0, 1.0), (0.1, 50, 0.8, 7.0, 0.0, 0.0), (1.0, 1, 1.0, 1.0, 0.0, 1.0),
     (0.7, 50, 1.0, 2.0, 0.0, 1.0), (1.0, 200, 0.95, 1.0, 1.0, 1.0)],
)
def test_fused_gpt_head_decisions_match_plain(dev, knobs):
    """On chip_smoke's constructed inputs (exact logits, a floored stop
    token among the best, penalized hits, token 0 in the history): the
    same token, kept set and values."""
    import chip_smoke
    from wis_tpu_torch.models.xtts.gpt import GPTConfig
    from wis_tpu_torch.ops.fused_gpt_head import fused_gpt_head, fused_gpt_head_plain

    cfg = GPTConfig()
    inputs, _, _ = chip_smoke._gpt_head_decision_case(torch, dev, cfg, seed=5)
    k = torch.tensor([list(knobs) + [0.0, 0.0]], device=dev)
    before = fused_gpt_head.launches
    tk, hk, lk = fused_gpt_head(*inputs, k, cfg=cfg)
    tp, hp, lp = fused_gpt_head_plain(*inputs, k, cfg=cfg)
    torch.cuda.synchronize()
    assert fused_gpt_head.launches == before + 1
    assert tk.dtype == torch.int32 and int(tk) == int(tp)
    assert torch.equal(lk > -1e29, lp > -1e29) and torch.equal(hk, hp)
    kept = lp > -1e29
    assert float((lk[kept] - lp[kept]).abs().max()) <= 1e-5


def test_fused_gpt_head_values_match_plain(dev):
    """A real (random) head and random LayerNorm rows, everything kept:
    hidden within one bf16 ulp, logits within two bf16 ulps."""
    from wis_tpu_torch.models.xtts.gpt import GPTConfig, random_gpt
    from wis_tpu_torch.ops.fused_gpt_head import fused_gpt_head, fused_gpt_head_plain, pack_head

    cfg = GPTConfig(n_layer=1)
    _, head_w, head_b = pack_head(random_gpt(cfg, seed=2, device=dev), cfg)
    rng = np.random.default_rng(4)
    x = _randn(rng, (1, 1024), dev, torch.float32, scale=2.0, shift=0.3)
    ln4 = torch.cat([_randn(rng, (1, 1024), dev, torch.float32, scale=0.1, shift=1.0),
                     _randn(rng, (1, 1024), dev, torch.float32, scale=0.1)] * 2)
    hist = torch.zeros((1, 1152), device=dev)
    hist[0, :30] = 1.0
    gum = torch.zeros((1, 1152), device=dev)
    k = torch.tensor([[1.0, 1152, 1.0, 2.0, 0.0, 0.0, 0.0, 0.0]], device=dev)
    _, hk, lk = fused_gpt_head(x, ln4, head_w, head_b, hist, gum, k, cfg=cfg)
    _, hp, lp = fused_gpt_head_plain(x, ln4, head_w, head_b, hist, gum, k, cfg=cfg)
    torch.cuda.synchronize()
    assert bool(((hk - hp).abs() <= _bf16_ulp(hp)).all())
    assert bool(((lk - lp).abs() <= 2.0 ** -7 * lp.abs() + 1e-6).all())


def test_fused_gpt_head_refuses_what_the_kernel_does_not_take(dev):
    from wis_tpu_torch.models.xtts.gpt import GPTConfig
    from wis_tpu_torch.ops.fused_gpt_head import fused_gpt_head

    cfg = GPTConfig()
    f = dict(device=dev)
    good = [torch.zeros((1, 1024), **f), torch.zeros((4, 1024), **f),
            torch.zeros((1024, 1152), dtype=torch.bfloat16, **f), torch.zeros((1, 1152), **f),
            torch.zeros((1, 1152), **f), torch.zeros((1, 1152), **f), torch.zeros((1, 8), **f)]
    before = fused_gpt_head.launches
    for i, bad, match in ((0, good[0].bfloat16(), "x must be"),
                          (2, good[2].float(), "head_w must be"),
                          (4, good[4][:, :-128], "hist must be")):
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError, match=match):
            fused_gpt_head(*args, cfg=cfg)
    with pytest.raises(ValueError, match="working dtype"):
        fused_gpt_head(*good, cfg=cfg, dtype=torch.float32)
    assert fused_gpt_head.launches == before


# --------------------------------------------------------------------------- #
# The fused head's grammar mode, int8_matmul and ancestry_attention
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("bk", [5, 20])
@pytest.mark.parametrize("int8", [False, True])
def test_fused_head_grammar_matches_plain(dev, bk, int8):
    """On inputs whose logits are exact (chip_smoke.grammar_head_case) the
    kernel's ids and values equal the plain version's, lse within 1e-5
    relative (f32 sums in another order), and the grammar's decisions
    hold: masks, the force rule, the tie, the min_ts floor, a masked
    region that adds nothing."""
    from chip_smoke import grammar_decisions, grammar_head_case
    from wis_tpu_torch.models.whisper.tokenizer import EOT, V2_LAYOUT
    from wis_tpu_torch.ops.fused_logits import fused_logits_topk, fused_logits_topk_plain
    from wis_tpu_torch.ops.quant import quantize_rows

    v, ts_base = V2_LAYOUT.n_vocab, V2_LAYOUT.timestamp_base
    x, g, b, emb, sup, ts = (torch.from_numpy(a).to(dev) for a in
                             grammar_head_case(bk, 256, v, ts_base, EOT, seed=bk))
    emb = emb.to(torch.bfloat16)
    table = quantize_rows(emb) if int8 else emb
    for full in (False, True):
        kw = dict(k=6, full_lse=full, ts_state=ts, ts_base=ts_base, eot=EOT)
        before = fused_logits_topk.launches
        val, tok, lse = fused_logits_topk(x, g, b, table, sup, **kw)
        want_val, want_tok, want_lse = fused_logits_topk_plain(x, g, b, table, sup, **kw)
        torch.cuda.synchronize()
        assert fused_logits_topk.launches == before + 1
        assert torch.equal(tok, want_tok)
        assert torch.equal(val, want_val)
        assert torch.allclose(lse, want_lse, rtol=1e-5, atol=1e-5)
        held = grammar_decisions(val.cpu().numpy(), tok.cpu().numpy(), ts_base, EOT)
        assert all(held.values()), held


def _exact_head_inputs(dev, bk, v, d=128, seed=0, live=None):
    """Head inputs whose logits are exact in any summation order: x rows ±1
    patterns of zero mean (the LayerNorm, γ = 1 and β = 0, returns them
    exactly in bf16), the table multiples of 1/8. Row 0's best ids are 63
    and 64, equal rows across a 64-row tile boundary; row 1's best are 5
    and v − 1, equal rows in different blocks. ``live``: only these ids
    unsuppressed. → (x, g, b, emb bf16, sup)."""
    rng = np.random.default_rng(seed)
    x = np.stack([np.where(rng.permutation(d) % 2 == 0, 1.0, -1.0) for _ in range(bk)])
    emb = np.clip(np.round(rng.standard_normal((v, d)) * 8), -32, 32) / 8
    emb[[63, 64]] = x[0] * 0.5
    if bk > 1:
        emb[[5, v - 1]] = x[1] * 0.5
    sup = np.zeros(v, np.float32)
    sup[rng.choice(np.arange(100, v - 1), min(200, v // 10), replace=False)] = -1e30
    if live is not None:
        sup[:] = -1e30
        sup[list(live)] = 0.0
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    return (f32(x), f32(np.ones(d)), f32(np.zeros(d)), f32(emb).to(torch.bfloat16), f32(sup))


def _assert_head_exact(got, want):
    assert torch.equal(got[1], want[1]), (got[1], want[1])
    assert torch.equal(got[0], want[0])
    assert torch.allclose(got[2], want[2], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "bk,k,v",
    [(1, 1, 51865), (5, 6, 51865), (8, 8, 51866), (20, 6, 51865), (32, 8, 1000),
     (20, 1, 51866), (5, 8, 1000), (32, 6, 51866)],
)
@pytest.mark.parametrize("int8", [False, True])
def test_fused_head_exact_at_every_shape(dev, bk, k, v, int8):
    """BK 1-32, k 1-8, both vocabularies and one (1000) that ends inside a
    64-row tile, both tables, lse over the suppressed and the raw logits:
    on exact logits ids and values equal the plain version's and lse is
    within 1e-5; the ties across a tile boundary and across blocks go to
    the lower id; two calls give the same bits."""
    from wis_tpu_torch.ops.fused_logits import fused_logits_topk, fused_logits_topk_plain
    from wis_tpu_torch.ops.quant import quantize_rows

    x, g, b, emb, sup = _exact_head_inputs(dev, bk, v, seed=bk + k + v)
    table = quantize_rows(emb) if int8 else emb
    for full in (False, True):
        before = fused_logits_topk.launches
        got = fused_logits_topk(x, g, b, table, sup, k=k, full_lse=full)
        again = fused_logits_topk(x, g, b, table, sup, k=k, full_lse=full)
        want = fused_logits_topk_plain(x, g, b, table, sup, k=k, full_lse=full)
        torch.cuda.synchronize()
        assert fused_logits_topk.launches == before + 2
        _assert_head_exact(got, want)
        assert got[1][0, :2].tolist() == [63, 64][:k]
        if bk > 1 and k > 1:
            assert got[1][1, :2].tolist() == [5, v - 1]
        for a, c in zip(got, again):
            assert torch.equal(a, c)


@pytest.mark.parametrize("v", [1000, 51865])
@pytest.mark.parametrize("int8", [False, True])
def test_fused_head_fills_with_masked_columns(dev, v, int8):
    """Fewer live columns than k: the rest of each row's candidates are
    suppressed columns at NEG, the lowest ids first, as the plain
    version's stable sort gives them."""
    from wis_tpu_torch.ops.fused_logits import fused_logits_topk, fused_logits_topk_plain
    from wis_tpu_torch.ops.quant import quantize_rows

    x, g, b, emb, sup = _exact_head_inputs(dev, 5, v, live=(700, 3, 999))
    table = quantize_rows(emb) if int8 else emb
    got = fused_logits_topk(x, g, b, table, sup, k=8)
    want = fused_logits_topk_plain(x, g, b, table, sup, k=8)
    torch.cuda.synchronize()
    _assert_head_exact(got, want)
    assert sorted(got[1][0, :3].tolist()) == [3, 700, 999]
    assert got[1][0, 3:].tolist() == [0, 1, 2, 4, 5]


@pytest.mark.parametrize("bk,v", [(5, 51866), (8, 51865), (20, 51866), (32, 51865)])
@pytest.mark.parametrize("int8", [False, True])
def test_fused_head_grammar_at_every_shape(dev, bk, v, int8):
    """Grammar mode at BK 5-32 on both vocabularies' layouts (exact
    inputs): ids and values equal, lse within 1e-5, every grammar rule
    held, the same bits call to call."""
    from chip_smoke import grammar_decisions, grammar_head_case
    from wis_tpu_torch.models.whisper.tokenizer import EOT, layout_for_vocab
    from wis_tpu_torch.ops.fused_logits import fused_logits_topk, fused_logits_topk_plain
    from wis_tpu_torch.ops.quant import quantize_rows

    ts_base = layout_for_vocab(v).timestamp_base
    x, g, b, emb, sup, ts = (torch.from_numpy(a).to(dev) for a in
                             grammar_head_case(bk, 256, v, ts_base, EOT, seed=bk + v))
    emb = emb.to(torch.bfloat16)
    table = quantize_rows(emb) if int8 else emb
    for full in (False, True):
        kw = dict(k=8, full_lse=full, ts_state=ts, ts_base=ts_base, eot=EOT)
        got = fused_logits_topk(x, g, b, table, sup, **kw)
        again = fused_logits_topk(x, g, b, table, sup, **kw)
        want = fused_logits_topk_plain(x, g, b, table, sup, **kw)
        torch.cuda.synchronize()
        _assert_head_exact(got, want)
        held = grammar_decisions(got[0].cpu().numpy(), got[1].cpu().numpy(), ts_base, EOT)
        assert all(held.values()), held
        for a, c in zip(got, again):
            assert torch.equal(a, c)


#: GPT head decisions: (temperature, top_k, top_p, repetition_penalty,
#: stop_blocked, do_sample) — k 1 and k ≥ V, p 1.0, 0.5 and near 0, the
#: stop token blocked or not, greedy and sampled; every prefix mass of the
#: candidates the p-threshold can cut stands GPT_HEAD_P_MARGIN or more
#: from p at both widths (asserted)
GPT_HEAD_EDGE_KNOBS = [
    (1.0, 1, 1.0, 1.0, 1.0, 0.0), (0.7, 50, 1.0, 2.0, 0.0, 1.0), (0.5, 5000, 0.5, 1.0, 0.0, 1.0),
    (0.7, 5000, 1e-3, 2.0, 1.0, 1.0), (0.5, 5000, 0.5, 1.0, 1.0, 0.0),
    (0.1, 50, 0.8, 7.0, 1.0, 1.0),
]


@pytest.mark.parametrize("n_audio_vocab", [1026, 4000])
@pytest.mark.parametrize("knobs", GPT_HEAD_EDGE_KNOBS)
def test_fused_gpt_head_decisions_at_both_widths(dev, knobs, n_audio_vocab):
    """V_pad 1152 and 4096, on chip_smoke's exact decision inputs: the same
    token, kept set, values and hidden state as the plain version; every
    top-p prefix mass of the kept candidates clear of p; two calls give the
    same bits."""
    import chip_smoke
    from wis_tpu_torch.models.xtts.gpt import GPTConfig
    from wis_tpu_torch.ops.fused_gpt_head import fused_gpt_head, fused_gpt_head_plain

    cfg = GPTConfig(n_layer=1, n_audio_vocab=n_audio_vocab,
                    start_audio_token=n_audio_vocab - 2, stop_audio_token=n_audio_vocab - 1)
    inputs, _, _ = chip_smoke._gpt_head_decision_case(torch, dev, cfg, seed=7)
    vp = inputs[2].shape[-1]
    k = torch.tensor([list(knobs) + [0.0, 0.0]], device=dev)
    got = fused_gpt_head(*inputs, k, cfg=cfg)
    again = fused_gpt_head(*inputs, k, cfg=cfg)
    tp, hp, lp = fused_gpt_head_plain(*inputs, k, cfg=cfg)
    pre = fused_gpt_head_plain(*inputs, torch.tensor(
        [[knobs[0], vp, 1.0, knobs[3], knobs[4], 0, 0, 0]], device=dev), cfg=cfg)[2]
    torch.cuda.synchronize()
    assert chip_smoke._prefix_margin(pre, knobs) > chip_smoke.GPT_HEAD_P_MARGIN
    tk, hk, lk = got
    assert int(tk) == int(tp) and torch.equal(hk, hp)
    kept = lp > -1e29
    assert torch.equal(lk > -1e29, kept)
    assert float((lk[kept] - lp[kept]).abs().max()) <= 1e-5
    for a, c in zip(got, again):
        assert torch.equal(a, c)


@pytest.mark.parametrize("sample", [0.0, 1.0])
@pytest.mark.parametrize("top_p", [1.0, 0.3, 1e-6])
def test_fused_gpt_head_all_logits_equal(dev, top_p, sample):
    """A zero head: every logit equal, so top-k and top-p keep every tie,
    greedy takes token 0 and sampling the gumbel row's argmax, as the
    plain version does."""
    from wis_tpu_torch.models.xtts.gpt import GPTConfig
    from wis_tpu_torch.ops.fused_gpt_head import fused_gpt_head, fused_gpt_head_plain

    cfg = GPTConfig(n_layer=1)
    rng = np.random.default_rng(3)
    x = _randn(rng, (1, 1024), dev, torch.float32, scale=2.0)
    ln4 = torch.cat([torch.ones((1, 1024), device=dev), torch.zeros((1, 1024), device=dev)] * 2)
    w = torch.zeros((1024, 1152), dtype=torch.bfloat16, device=dev)
    zeros = torch.zeros((1, 1152), device=dev)
    gum = _randn(rng, (1, 1152), dev, torch.float32)
    k = torch.tensor([[1.0, 50, top_p, 1.0, 1.0, sample, 0.0, 0.0]], device=dev)
    tk, hk, lk = fused_gpt_head(x, ln4, w, zeros, zeros, gum, k, cfg=cfg)
    tp, hp, lp = fused_gpt_head_plain(x, ln4, w, zeros, zeros, gum, k, cfg=cfg)
    torch.cuda.synchronize()
    assert int(tk) == int(tp) and torch.equal(lk, lp) and torch.equal(hk, hp)
    assert int((lk > -1e29).sum()) == cfg.n_audio_vocab - 1  # all but the blocked stop


@pytest.mark.parametrize(
    "m,k,n",
    [
        (1, 128, 128),
        (5, 1280, 1280),  # a decode step's rows
        (13, 1280, 5120),  # ragged M
        (20, 5120, 1280),
        (40, 256, 384),
        (289, 1024, 4096),  # the XTTS prefill
        (1500, 1280, 1280),  # one window's cross-KV
    ],
)
def test_int8_matmul_matches_plain(dev, m, k, n):
    """Each element within 2 bf16 ulps of the plain version plus 2⁻⁸ of
    its largest magnitude (f32 sums of the same bf16 products in another
    order, each side rounded once to bf16)."""
    from wis_tpu_torch.ops.quant import int8_matmul, int8_matmul_plain, quantize_weight

    rng = np.random.default_rng(m + k + n)
    x = _randn(rng, (m, k), dev, torch.bfloat16)
    leaf = quantize_weight(_randn(rng, (k, n), dev, torch.float32, scale=0.05))
    before = int8_matmul.launches
    got = int8_matmul(x, leaf["q"], leaf["s"])
    want = int8_matmul_plain(x, leaf["q"], leaf["s"])
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    r = want.float()
    over = (got.float() - r).abs() > 2 * _bf16_ulp(r) + 2.0 ** -8 * float(r.abs().max())
    assert not bool(over.any()), f"{int(over.sum())} elements beyond tolerance"


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [128, 384, 1280, 5120])
@pytest.mark.parametrize("m", [1, 5, 63, 64, 65, 127, 129, 289, 1500, 6000])
def test_int8_matmul_edges(dev, m, k, out):
    """Row counts about the 64-row (one consumer warpgroup, split K) and
    128-row tiles, K of 2, 6, 20 and 80 ring steps of 64 (fewer steps than
    stages, an odd count, many), a last column tile half full (N % 128 ==
    64), and both output types (bf16 for bf16 x; f32 x rounds to bf16 and
    the kernel stores f32): the tolerance of test_int8_matmul_matches_plain."""
    from wis_tpu_torch.ops.quant import int8_matmul, int8_matmul_plain, quantize_weight

    n = 1344
    rng = np.random.default_rng(m * k)
    x = _randn(rng, (m, k), dev, out)
    leaf = quantize_weight(_randn(rng, (k, n), dev, torch.float32, scale=0.05))
    before = int8_matmul.launches
    got = int8_matmul(x, leaf["q"], leaf["s"])
    want = int8_matmul_plain(x, leaf["q"], leaf["s"])
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    assert got.dtype == out and got.shape == (m, n)
    r = want.float()
    over = (got.float() - r).abs() > 2 * _bf16_ulp(r) + 2.0 ** -8 * float(r.abs().max())
    assert not bool(over.any()), f"{int(over.sum())} elements beyond tolerance"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("m,k,n", [(5, 5120, 1280), (1500, 1280, 1280)])
def test_qmatmul_float_activations_run_the_kernel(dev, dtype, m, k, n):
    """Activations other than bf16 (an XTTS model built in f32) take the
    kernel too, one launch per product, the output in x's dtype: x rounds
    to bf16 as in the plain version, the kernel stores f32, so the two
    differ only by the order of the f32 sums (and f16's own rounding)."""
    from wis_tpu_torch.ops.quant import int8_matmul, int8_matmul_plain, qmatmul, quantize_weight

    rng = np.random.default_rng(m + k)
    x = _randn(rng, (m, k), dev, dtype)
    leaf = quantize_weight(_randn(rng, (k, n), dev, torch.float32, scale=0.05))
    before = int8_matmul.launches
    got = qmatmul(x, leaf)
    want = int8_matmul_plain(x, leaf["q"], leaf["s"])
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    r = want.float()
    tol = 1e-5 * float(r.abs().max()) + (_bf16_ulp(r) / 8 if dtype == torch.float16 else 0)
    over = (got.float() - r).abs() > tol
    assert not bool(over.any()), f"{int(over.sum())} elements beyond tolerance"


def test_qmatmul_routes_int8_leaves_to_the_kernel(dev):
    """qmatmul on the card: a stacked leaf's layer view meeting the gate
    launches the kernel once per call, leading dims kept; a bf16 weight
    and a shape off the gate do not; the wrapper refuses what the kernel
    does not take."""
    from wis_tpu_torch.ops.quant import int8_matmul, int8_matmul_plain, qmatmul, quantize_weight

    rng = np.random.default_rng(3)
    leaf = quantize_weight(_randn(rng, (2, 256, 384), dev, torch.float32, scale=0.05))
    x = _randn(rng, (2, 3, 256), dev, torch.bfloat16)
    before = int8_matmul.launches
    got = qmatmul(x, {"q": leaf["q"][1], "s": leaf["s"][1]})
    assert int8_matmul.launches == before + 1 and got.shape == (2, 3, 384)
    want = int8_matmul_plain(x.reshape(6, 256), leaf["q"][1], leaf["s"][1]).reshape(2, 3, 384)
    assert torch.allclose(got.float(), want.float(), rtol=2 ** -7, atol=2 ** -8 * float(want.abs().max()))
    qmatmul(x, leaf["q"][1].bfloat16())
    odd = quantize_weight(_randn(rng, (96, 128), dev, torch.float32))
    qmatmul(x[..., :96].contiguous(), odd)
    assert int8_matmul.launches == before + 1
    for args, match in (
        ((x.reshape(6, 256).to(torch.int32), leaf["q"][1], leaf["s"][1]), "float tensor"),
        ((x[0, :, :96].contiguous(), odd["q"], odd["s"]), "multiple of 128"),
        ((x.reshape(6, 256), leaf["q"][1], leaf["s"][1].bfloat16()), "f32"),
    ):
        with pytest.raises(ValueError, match=match):
            int8_matmul(*args)
    assert int8_matmul.launches == before + 1


def _anc_case(dev, bk, beams, h, dh, t, pos, seed):
    """Caches with random values up to pos and, past it, keys of ±1e4 and
    values of 1e4 (a kernel that reads a column past pos is far off); anc
    scrambled within each group of ``beams`` rows up to pos, -1 after."""
    rng = np.random.default_rng(seed)
    q = _randn(rng, (bk, h, dh), dev, torch.bfloat16)
    kc = _randn(rng, (bk, h, dh, t), dev, torch.float32, scale=0.5)
    vc = _randn(rng, (bk, h, dh, t), dev, torch.float32)
    kc[..., pos + 1:] = 1e4 * torch.sign(kc[..., pos + 1:])
    vc[..., pos + 1:] = 1e4
    anc = np.full((bk, t), -1, np.int32)
    for r in range(bk):
        base = (r // beams) * beams
        anc[r, : pos + 1] = base + rng.integers(0, beams, pos + 1)
    return q, kc.to(torch.bfloat16), vc.to(torch.bfloat16), torch.from_numpy(anc).to(dev)


@pytest.mark.parametrize("bk,beams,t,pos", [
    (5, 5, 128, 70), (20, 5, 256, 200), (1, 1, 128, 0),
    (40, 5, 256, 200),  # eight groups of five: beyond the fused step's 32 rows
    (40, 40, 256, 200),  # a map across groups: any row in [0, BK)
    (5, 5, 100, 99),  # T % 8 != 0: runs start mid-vector; pos at the last column
])
def test_ancestry_attention_matches_plain(dev, bk, beams, t, pos):
    """Within 2 bf16 ulps plus 2⁻⁸ of the output's largest magnitude (both
    take f32 scores, softmax and sums in another order and round once);
    the trap columns past pos are never read."""
    from wis_tpu_torch.ops.decode_attn import ancestry_attention, ancestry_attention_plain

    q, kc, vc, anc = _anc_case(dev, bk, beams, 20, 64, t, pos, seed=bk + t)
    before = ancestry_attention.launches
    got = ancestry_attention(q, kc, vc, anc, pos)
    want = ancestry_attention_plain(q, kc, vc, anc, pos)
    torch.cuda.synchronize()
    assert ancestry_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _assert_anc_close(got, want)


def _assert_anc_close(got, want):
    r = want.float()
    assert float(r.abs().max()) < 10  # the plain version reads no trap either
    over = (got.float() - r).abs() > 2 * _bf16_ulp(r) + 2.0 ** -8 * float(r.abs().max())
    assert not bool(over.any()), f"{int(over.sum())} elements beyond tolerance"


@pytest.mark.parametrize("dh", [8, 80, 128, 256])
def test_ancestry_attention_head_widths(dev, dh):
    """Every class of head width the kernel takes (a lane's d values fill
    a quarter of 64, 128 or 256), against the plain version."""
    from wis_tpu_torch.ops.decode_attn import ancestry_attention, ancestry_attention_plain

    q, kc, vc, anc = _anc_case(dev, 10, 5, 4, dh, 96, 60, seed=dh)
    got = ancestry_attention(q, kc, vc, anc, 60)
    want = ancestry_attention_plain(q, kc, vc, anc, 60)
    torch.cuda.synchronize()
    _assert_anc_close(got, want)


def test_ancestry_attention_unaligned_caches(dev):
    """Caches that start 2 and 6 bytes past a 16-byte boundary (T a
    multiple of 8), read up to their last column: every run starts
    mid-vector, and the vectors across each tensor's first and last
    element, whose other halves hold NaN, are read element by element."""
    from wis_tpu_torch.ops.decode_attn import ancestry_attention, ancestry_attention_plain

    q, kc, vc, anc = _anc_case(dev, 5, 5, 20, 64, 128, 127, seed=9)
    n = kc.numel()
    kbuf = torch.empty(n + 8, dtype=torch.bfloat16, device=dev)
    vbuf = torch.empty(n + 8, dtype=torch.bfloat16, device=dev)
    k1, v1 = kbuf[1:1 + n].view(kc.shape), vbuf[3:3 + n].view(vc.shape)
    k1.copy_(kc)
    v1.copy_(vc)
    kbuf[0], kbuf[n + 1:] = float("nan"), float("nan")
    vbuf[:3], vbuf[n + 3:] = float("nan"), float("nan")
    assert k1.is_contiguous() and k1.data_ptr() % 16 == 2 and v1.data_ptr() % 16 == 6
    got = ancestry_attention(q, k1, v1, anc, 127)
    want = ancestry_attention_plain(q, kc, vc, anc, 127)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _assert_anc_close(got, want)


def test_ancestry_attention_same_bits_twice(dev):
    """The splits merge in a fixed order: two calls give the same bits."""
    from wis_tpu_torch.ops.decode_attn import ancestry_attention

    q, kc, vc, anc = _anc_case(dev, 20, 5, 20, 64, 256, 200, seed=3)
    first = ancestry_attention(q, kc, vc, anc, 200)
    second = ancestry_attention(q, kc, vc, anc, 200)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_ancestry_attention_refuses_other_head_widths(dev):
    from wis_tpu_torch.ops.decode_attn import ancestry_attention

    before = ancestry_attention.launches
    for dh in (12, 264):
        q, kc, vc, anc = _anc_case(dev, 2, 2, 1, dh, 16, 3, seed=dh)
        with pytest.raises(ValueError, match="multiple of 8"):
            ancestry_attention(q, kc, vc, anc, 3)
    assert ancestry_attention.launches == before


def test_eager_decoder_runs_the_new_kernels(dev):
    """A narrow int8 bf16 decoder step on the card with an ancestry map runs
    ancestry_attention once per layer and int8_matmul for its 8 int8
    products per layer, and agrees with the same step through the plain
    versions."""
    from wis_tpu_torch.models.whisper import model as model_mod
    from wis_tpu_torch.models.whisper.config import WhisperConfig
    from wis_tpu_torch.models.whisper.weights import random_params
    from wis_tpu_torch.ops import quant
    from wis_tpu_torch.ops.decode_attn import ancestry_attention, ancestry_attention_plain

    cfg = WhisperConfig(name="narrow", n_audio_state=256, n_audio_head=4, n_audio_layer=1,
                        n_text_state=256, n_text_head=4, n_text_layer=2)
    params = quant.quantize_whisper_params(
        random_params(cfg, seed=1, device=dev, dtype=torch.bfloat16))
    rng = np.random.default_rng(4)
    bq, k, t, pos = 2, 5, 64, 9
    shape = (cfg.n_text_layer, bq, 4, 64, cfg.n_audio_ctx)
    xa = tuple(_randn(rng, shape, dev, torch.bfloat16, scale=0.5) for _ in range(2))
    ck = _randn(rng, (cfg.n_text_layer, bq * k, 4, 64, t), dev, torch.bfloat16)
    cv = _randn(rng, (cfg.n_text_layer, bq * k, 4, 64, t), dev, torch.bfloat16)
    anc = torch.full((bq, k, t), -1, dtype=torch.long, device=dev)
    anc[..., : pos + 1] = torch.from_numpy(rng.integers(0, k, (bq, k, pos + 1))).to(dev)
    tokens = torch.from_numpy(rng.integers(0, 1000, bq * k)).to(dev)

    def step():
        cache = model_mod.DecoderCache(ck.clone(), cv.clone(), pos)
        with torch.inference_mode():
            return model_mod.decode_step(params, tokens, cache, xa, cfg, anc=anc)[0]

    counts = (ancestry_attention.launches, quant.int8_matmul.launches)
    got = step()
    assert (ancestry_attention.launches - counts[0], quant.int8_matmul.launches - counts[1]) == (
        cfg.n_text_layer, 8 * cfg.n_text_layer)
    with mock.patch.object(model_mod, "ancestry_attention", ancestry_attention_plain), \
            mock.patch.object(quant, "int8_matmul", quant.int8_matmul_plain):
        want = step()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).norm() / want.norm()) <= STEP_REL_NORM


def test_kernels_run_on_every_visible_card(dev):
    """One process drives every visible card (a replica pool over all of
    them, a rank that places a replica elsewhere): the kernels' opt-ins
    above 48 KB of shared memory are set on each card, not only the first
    one launched on. Each card's result equals the plain version's, at
    shapes that take the large shared-memory configurations."""
    from wis_tpu_torch.device import resolve_device
    from wis_tpu_torch.ops.decode_attn import ancestry_attention, ancestry_attention_plain
    from wis_tpu_torch.ops.flash import flash_attention_packed, flash_attention_packed_plain
    from wis_tpu_torch.ops.fused_logits import fused_logits_topk, fused_logits_topk_plain
    from wis_tpu_torch.ops.quant import int8_matmul, int8_matmul_plain, quantize_weight

    for index in range(torch.cuda.device_count()):
        card = resolve_device(f"cuda:{index}")
        rng = np.random.default_rng(index)
        x = _randn(rng, (1500, 1280), card, torch.bfloat16)
        leaf = quantize_weight(_randn(rng, (1280, 640), card, torch.float32, scale=0.05))
        got, want = int8_matmul(x, leaf["q"], leaf["s"]), int8_matmul_plain(x, leaf["q"], leaf["s"])
        assert float((got.float() - want.float()).abs().max()) <= 2.0 ** -8 * float(
            want.float().abs().max()) + 4 * float(_bf16_ulp(want).max())
        q, k, v = (_randn(rng, (1, 1500, 640), card, torch.bfloat16) for _ in range(3))
        got, want = flash_attention_packed(q, k, v, 10), flash_attention_packed_plain(q, k, v, 10)
        assert float((got.float() - want.float()).norm() / want.float().norm()) <= 6e-3
        qa = _randn(rng, (5, 10, 64), card, torch.bfloat16)
        kc, vc = (_randn(rng, (5, 10, 64, 40), card, torch.bfloat16) for _ in range(2))
        anc = torch.from_numpy(rng.integers(0, 5, (5, 40)).astype(np.int32)).to(card)
        got, want = (ancestry_attention(qa, kc, vc, anc, 35),
                     ancestry_attention_plain(qa, kc, vc, anc, 35))
        assert float((got.float() - want.float()).abs().max()) <= 2.0 ** -8 * float(
            want.float().abs().max()) + 4 * float(_bf16_ulp(want).max())
        xs = _randn(rng, (5, 1280), card, torch.float32)
        g, b = torch.ones(1280, device=card), torch.zeros(1280, device=card)
        table = _randn(rng, (25933, 1280), card, torch.bfloat16)
        sup = torch.zeros(25933, device=card)
        got, want = (fused_logits_topk(xs, g, b, table, sup, k=6),
                     fused_logits_topk_plain(xs, g, b, table, sup, k=6))
        torch.cuda.synchronize(card)
        assert float((got[0] - want[0]).abs().max()) <= 0.05
        assert float((got[2] - want[2]).abs().max()) <= 0.05


@pytest.mark.parametrize("m,k,n", [(5, 640, 1280), (5, 2560, 1280), (1, 512, 1024),
                                   (1, 2048, 1024)])
def test_int8_matmul_f32_store_at_row_parallel_shards(dev, m, k, n):
    """A row-parallel product's partial sums (``parallel/axis.row_parallel``
    at 2-way large-v2 o_w / w2 and XTTS v2 proj_w / mlp_w2): bf16 x, the
    kernel's f32 store, one launch; equal to the plain version's f32
    result up to the order of the f32 sums."""
    from wis_tpu_torch.ops.quant import int8_matmul, int8_matmul_plain, qmatmul, quantize_weight

    rng = np.random.default_rng(m + k + n)
    x = _randn(rng, (m, k), dev, torch.bfloat16)
    leaf = quantize_weight(_randn(rng, (k, n), dev, torch.float32, scale=0.05))
    before = int8_matmul.launches
    got = qmatmul(x, leaf, out_dtype=torch.float32)
    want = int8_matmul_plain(x, leaf["q"], leaf["s"], torch.float32)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    over = (got - want).abs() > 1e-5 * float(want.abs().max())
    assert not bool(over.any()), f"{int(over.sum())} elements beyond tolerance"
