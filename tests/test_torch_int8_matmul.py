"""The W8A16 product of the PyTorch port (``wis_tpu_torch/ops/quant.py``
``int8_matmul``, the plain version of ``csrc/int8_matmul.cu``) held against
wis_tpu's Pallas ``int8_matmul`` in interpret mode, as tests/test_quant.py
runs it, and the CPU ``qmatmul`` held equal to wis_tpu's.

Both sides round x to bf16, contract against the int8 weight in f32 and
apply the f32 scale once after the contraction; they differ only in the
order of the f32 sums, so each bf16 output is within one bf16 ulp of the
other (the f32 results differ by a few f32 ulps, and rounding to bf16
splits them at most one ulp apart)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wis_tpu.ops.quant import qmatmul as jax_qmatmul
from wis_tpu.ops.quant import quantize_weight as jax_quantize
from wis_tpu.ops.quant_pallas import int8_matmul as jax_int8_matmul
from wis_tpu_torch.ops import quant

torch.set_num_threads(1)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    leaf = jax_quantize(jnp.asarray(rng.standard_normal((k, n)).astype(np.float32) * 0.1))
    return x, np.asarray(leaf["q"]), np.asarray(leaf["s"])


@pytest.mark.parametrize("m", [1, 5, 13, 40])
@pytest.mark.parametrize("k,n", [(128, 128), (256, 512), (512, 256)])
def test_plain_matches_jax_kernel(m, k, n):
    """bf16 activations, rows not a multiple of 8 (the TPU kernel pads
    them): equal within one bf16 ulp."""
    x, q, s = _case(m, k, n, seed=m + k + n)
    with pltpu.force_tpu_interpret_mode():
        want = jax_int8_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q), jnp.asarray(s),
                               block_n=128, block_k=128)
    want = np.asarray(want).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    before = quant.int8_matmul.launches
    got = quant.int8_matmul(xt, torch.from_numpy(q), torch.from_numpy(s))
    assert quant.int8_matmul.launches == before  # the CPU runs the plain version
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    got = got.float().numpy()
    assert (np.abs(got - want) <= _bf16_ulp(want)).all()


def test_plain_matches_jax_kernel_f32():
    """f32 activations: the output keeps x's dtype; x is rounded to bf16
    on both sides, and the f32 results agree to f32 summation order."""
    x, q, s = _case(5, 256, 384, seed=2)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                                          block_n=128, block_k=128))
    got = quant.int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_qmatmul_keeps_the_xla_numerics(dtype):
    """On the CPU qmatmul stays the JAX package's XLA path under jit (the
    product of the int8 weight and the bf16-rounded scale, itself rounded
    to bf16 only for bf16 activations), which the token-for-token tests
    rely on; it never reaches the kernel's wrapper."""
    x, q, s = _case(3, 256, 128, seed=7)
    want = np.asarray(jax.jit(jax_qmatmul)(jnp.asarray(x, getattr(jnp, dtype)),
                                           {"q": jnp.asarray(q), "s": jnp.asarray(s)}))
    before = quant.int8_matmul.launches
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = quant.qmatmul(xt, {"q": torch.from_numpy(q), "s": torch.from_numpy(s)})
    assert quant.int8_matmul.launches == before
    assert got.dtype == xt.dtype
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=tol,
                               atol=tol)


def test_kernel_gate_and_refusals():
    """The card's gate is the JAX package's shape gate (a 2-D int8 weight,
    K and N multiples of 128) without its TPU opt-in; a tensor neither on
    the CPU nor on the card is refused, not sent down the plain path."""
    q = torch.zeros((256, 384), dtype=torch.int8)
    meta = torch.empty((4, 256), device="meta", dtype=torch.bfloat16)
    assert not quant._use_kernel(torch.zeros((4, 256), dtype=torch.bfloat16), q)  # the CPU
    assert not quant._use_kernel(meta, q)  # not a CUDA tensor
    with pytest.raises(ValueError, match="unsupported device"):
        quant.int8_matmul(meta, q.to("meta"), torch.empty((1, 384), device="meta"))
    assert quant.int8_matmul.launches == 0
