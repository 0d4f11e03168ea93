"""PyTorch port: the ops that hold or sit beside a kernel, held against the
JAX package on the CPU. The Pallas kernels run as the JAX package's own
tests run them here, in interpret mode; the port's kernel wrappers take
their plain PyTorch versions for CPU tensors.

Tolerances: f32 results at ~1e-5 (the same math in another summation
order); bf16 results at one bf16 ulp (both sides round once from f32),
plus 1e-6 where a result is a cancellation near zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import JAX_CFG, jax_params, port_params, to_np

torch.set_num_threads(1)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _assert_within_bf16_ulp(got, want, atol=0.0):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    over = np.abs(got - want) > _bf16_ulp(want) + atol
    assert not over.any(), f"{int(over.sum())} elements beyond one bf16 ulp"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_plain_matches_pallas_kernel(dtype):
    from wis_tpu.ops.layernorm import layer_norm_pallas
    from wis_tpu_torch.ops.layernorm import layer_norm_cuda, layer_norm_plain

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 300, 256)) * 3 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    b = (0.1 * rng.standard_normal(256)).astype(np.float32)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = layer_norm_pallas(jx, jnp.asarray(g), jnp.asarray(b))
    got = layer_norm_plain(tx, torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-5, rtol=1e-5)
    else:
        # + 1e-6: near zero the output is the difference of two O(0.1)
        # terms, (x-μ)·rstd·γ and β, whose f32 rounding is many bf16 ulps
        # of a ~1e-6 result
        _assert_within_bf16_ulp(got, want, atol=1e-6)
    # the kernel wrapper takes the plain version for a CPU tensor
    assert torch.equal(layer_norm_cuda(tx, torch.from_numpy(g), torch.from_numpy(b)), got)


@pytest.mark.parametrize("n_heads", [4, 2])  # head_dim 64 and 128 at D=256
def test_packed_attention_plain_matches_pallas_kernel(n_heads):
    from wis_tpu.ops.flash import flash_attention_packed as jax_flash
    from wis_tpu_torch.ops.flash import (
        flash_attention_packed,
        flash_attention_packed_plain,
    )

    rng = np.random.default_rng(n_heads)
    q, k, v = (rng.standard_normal((2, 300, 256)).astype(np.float32) for _ in range(3))
    want = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_heads,
        block_q=128, block_k=128,
    )
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = flash_attention_packed_plain(tq, tk, tv, n_heads)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=2e-5, rtol=1e-5)
    assert torch.equal(flash_attention_packed(tq, tk, tv, n_heads), got)


def test_attention_helpers_match():
    from wis_tpu.ops import attention as ja
    from wis_tpu_torch.ops import attention as ta

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    heads = ta.qkv_heads(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(to_np(heads), to_np(ja.qkv_heads(jnp.asarray(x), 3)))
    np.testing.assert_array_equal(to_np(ta.merge_heads(heads)), x)
    q, k, v = (rng.standard_normal((2, 3, 5, 4)).astype(np.float32) for _ in range(3))
    mask = np.tril(np.ones((5, 5), bool))[None, None]
    for m in (None, mask):
        want = ja.mha(*map(jnp.asarray, (q, k, v)), None if m is None else jnp.asarray(m))
        got = ta.mha(*map(torch.from_numpy, (q, k, v)), None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-6, rtol=1e-5)


def test_gelu_matches():
    from wis_tpu.ops.gelu import gelu as jax_gelu
    from wis_tpu_torch.ops.gelu import gelu

    x = np.concatenate([np.linspace(-9, 9, 4001), [-6.0, 6.0, 0.0]]).astype(np.float32)
    np.testing.assert_allclose(
        to_np(gelu(torch.from_numpy(x))), to_np(jax_gelu(jnp.asarray(x))),
        atol=1e-6, rtol=1e-6,
    )
    # + 1e-6: for x ≪ 0, 1 + tanh(p) cancels and the last f32 bit of tanh
    # differs between XLA and torch, many bf16 ulps of a ~1e-7 result
    _assert_within_bf16_ulp(
        gelu(torch.from_numpy(x).bfloat16()), jax_gelu(jnp.asarray(x, jnp.bfloat16)),
        atol=1e-6,
    )


@pytest.mark.parametrize("case", ["bf16", "f32_int8", "bf16_int8"])
def test_qmatmul_matches(case):
    from wis_tpu.ops.quant import qmatmul as jax_qmatmul, quantize_weight
    from wis_tpu_torch.models.whisper.weights import params_from_jax
    from wis_tpu_torch.ops.quant import qmatmul

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 96)) / 8).astype(np.float32)
    x_dtype = "float32" if case.startswith("f32") else "bfloat16"
    jx = jnp.asarray(x, getattr(jnp, x_dtype))
    jw = quantize_weight(jnp.asarray(w)) if case.endswith("int8") else jnp.asarray(w, jnp.bfloat16)
    want = jax.jit(jax_qmatmul)(jx, jw)  # as the programs run it
    got = qmatmul(
        torch.from_numpy(x).to(getattr(torch, x_dtype)),
        params_from_jax(jax.tree.map(np.asarray, jw), "cpu"),
    )
    assert str(got.dtype).removeprefix("torch.") == x_dtype
    if x_dtype == "float32":
        np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-5, rtol=1e-5)
    else:
        _assert_within_bf16_ulp(got, want)


def test_matmul_f32_upcasts_off_the_card():
    from wis_tpu_torch.ops.quant import matmul_f32

    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((3, 4, 16)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32)).bfloat16()
    got = matmul_f32(a, b)
    assert got.dtype == torch.float32 and got.shape == (3, 4, 8)
    torch.testing.assert_close(got, a.float() @ b.float(), atol=0, rtol=0)


def test_mel_tables_equal():
    from wis_tpu.audio import mel as jm
    from wis_tpu_torch.audio import mel as tm

    np.testing.assert_array_equal(tm.mel_filterbank(), jm.mel_filterbank())
    np.testing.assert_array_equal(tm.mel_filterbank(n_mels=128), jm.mel_filterbank(n_mels=128))
    for a, b in zip(tm._stft_basis(), jm._stft_basis()):
        np.testing.assert_array_equal(a, b)
    x = np.arange(10, dtype=np.float32)
    for n in (4, 10, 16):
        np.testing.assert_array_equal(tm.pad_or_trim(x, n), jm.pad_or_trim(x, n))


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches(n_mels):
    from wis_tpu.audio.mel import _log_mel_jax
    from wis_tpu_torch.audio.mel import log_mel

    rng = np.random.default_rng(7)
    audio = (rng.standard_normal((2, 48000)) * 0.1).astype(np.float32)
    audio[1, 20000:] = 0.0  # a silent tail reaches the max-8 floor
    want = _log_mel_jax(jnp.asarray(audio), n_mels=n_mels)
    got = log_mel(torch.from_numpy(audio), n_mels=n_mels)
    assert got.shape == (2, n_mels, 300)
    # f32 DFT matmuls in another order; the log-mel values are O(1)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=2e-5)


def test_conv_stem_matches():
    from wis_tpu.models.whisper.stem import conv_stem as jax_stem
    from wis_tpu_torch.models.whisper.stem import conv_stem

    rng = np.random.default_rng(8)
    mel = rng.standard_normal((2, JAX_CFG.n_mels, 3000)).astype(np.float32)
    want = jax_stem(jax_params()["encoder"], jnp.asarray(mel))
    got = conv_stem(port_params()["encoder"], torch.from_numpy(mel))
    assert got.shape == (2, 1500, JAX_CFG.n_audio_state)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-5, rtol=1e-5)
