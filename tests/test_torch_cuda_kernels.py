"""The hand-written Hopper kernels against their plain PyTorch versions, on
the card: edge shapes the main path does not reach (ragged key and query
tiles, batches, row counts off the block size, float32 LayerNorm), the
wrappers' refusals, and the encoder's routing to both kernels.

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
