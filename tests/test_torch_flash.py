"""Head-major flash attention and the encoder's attention gate on the
PyTorch port, held against the JAX package on the CPU.

- ``flash_attention_plain`` and the ``flash_attention`` wrapper on CPU
  tensors against ``wis_tpu.ops.flash.flash_attention`` in Pallas interpret
  mode (as tests/test_flash.py runs it), in f32: atol 2e-5, rtol 1e-5
  (the same f32 attention, softmax taken whole on one side and online over
  key tiles on the other).
- The port's ``attention_route`` and ``layer_norm_route`` against the JAX
  gates themselves: JAX's ``_attn_block`` and ``_enc_ln`` called with
  ``jax.default_backend`` patched to "tpu" (and left "cpu") and the kernels
  replaced by recording spies, over head widths, sequence lengths and every
  environment switch.
- Each route gives the same encoder on the CPU, equal to the JAX encoder
  within atol 1e-4 (f32, the tolerance tests/test_torch_whisper.py holds
  the encoder to).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wis_tpu.ops.flash import flash_attention as jax_flash
from wis_tpu_torch.models.whisper import model as tm
from wis_tpu_torch.ops.flash import flash_attention, flash_attention_plain

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-5
SWITCHES = ("WIS_NO_FLASH", "WIS_NO_PACKED_FLASH", "WIS_NO_LN_KERNEL")


@pytest.mark.parametrize(
    "b,h,t,dh",
    [(1, 2, 300, 32), (2, 2, 700, 32), (2, 2, 300, 64), (1, 3, 700, 72), (1, 2, 300, 128)],
)
def test_flash_matches_jax_interpret(b, h, t, dh):
    rng = np.random.default_rng(t + dh)
    q, k, v = (rng.standard_normal((b, h, t, dh)).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_flash(*(jnp.asarray(x) for x in (q, k, v)),
                                    block_q=128, block_k=256))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    before = flash_attention.launches
    plain = flash_attention_plain(tq, tk, tv)
    wrapped = flash_attention(tq, tk, tv)
    assert plain.shape == (b, h, t, dh) and plain.dtype == torch.float32
    np.testing.assert_allclose(plain.numpy(), want, atol=ATOL, rtol=RTOL)
    # a CPU tensor takes the plain version and launches nothing
    assert torch.equal(wrapped, plain) and flash_attention.launches == before


@pytest.mark.parametrize("b,h,t,dh", [(1, 2, 200, 80), (1, 2, 130, 136)])
def test_flash_matches_jax_interpret_padded_widths(b, h, t, dh):
    """Head widths the card's kernel pads to 128 and 192 columns."""
    rng = np.random.default_rng(t + dh)
    q, k, v = (rng.standard_normal((b, h, t, dh)).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_flash(*(jnp.asarray(x) for x in (q, k, v)),
                                    block_q=128, block_k=256))
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert got.shape == (b, h, t, dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_wrapper_refuses_other_devices():
    x = torch.empty((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(x, x, x)
    assert flash_attention.launches == 0


def _clear_switches(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


def _jax_attention_spies(monkeypatch):
    """Replace the JAX kernels with spies that record which one the gate
    picked and compute the same attention through ``mha``."""
    from wis_tpu.ops import flash as jflash
    from wis_tpu.ops.attention import merge_heads, mha, qkv_heads

    calls = []

    def packed(q, k, v, n_heads, **_):
        calls.append("packed")
        return merge_heads(mha(qkv_heads(q, n_heads), qkv_heads(k, n_heads),
                               qkv_heads(v, n_heads)))

    def head_major(q, k, v, **_):
        calls.append("head_major")
        return mha(q, k, v)

    monkeypatch.setattr(jflash, "flash_attention_packed", packed)
    monkeypatch.setattr(jflash, "flash_attention", head_major)
    return calls


@pytest.mark.parametrize("dh", [32, 64, 72, 128])
@pytest.mark.parametrize(
    "env", [(), ("WIS_NO_FLASH",), ("WIS_NO_PACKED_FLASH",),
            ("WIS_NO_FLASH", "WIS_NO_PACKED_FLASH")],
    ids=lambda e: "+".join(e) or "default",
)
def test_attention_route_agrees_with_the_jax_gate(monkeypatch, dh, env):
    from wis_tpu.models.whisper import model as jm

    _clear_switches(monkeypatch)
    for name in env:
        monkeypatch.setenv(name, "1")
    calls = _jax_attention_spies(monkeypatch)
    heads, d = 2, 2 * dh
    rng = np.random.default_rng(dh)
    blk = {name: jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.1)
           for name, shape in (("q_w", (d, d)), ("q_b", (d,)), ("k_w", (d, d)),
                               ("v_w", (d, d)), ("v_b", (d,)), ("o_w", (d, d)),
                               ("o_b", (d,)))}
    for backend, device_type in (("tpu", "cuda"), ("cpu", "cpu")):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        for t in (300, 1500):
            calls.clear()
            x = jnp.asarray(rng.standard_normal((1, t, d)).astype(np.float32))
            jm._attn_block(x, blk, None, heads)
            want = calls[0] if calls else "plain"
            assert len(calls) <= 1
            assert tm.attention_route(device_type, t, d, heads) == want, (backend, t)


@pytest.mark.parametrize("d", [64, 128, 384])
@pytest.mark.parametrize("switch", [False, True])
def test_layer_norm_route_agrees_with_the_jax_gate(monkeypatch, d, switch):
    from wis_tpu.models.whisper import model as jm
    from wis_tpu.ops import layernorm as jln

    _clear_switches(monkeypatch)
    if switch:
        monkeypatch.setenv("WIS_NO_LN_KERNEL", "1")
    calls = []

    def spy(x, g, b):
        calls.append("kernel")
        return jm.layer_norm(x, g, b)

    monkeypatch.setattr(jln, "layer_norm_pallas", spy)
    x = jnp.ones((1, 4, d), jnp.float32)
    g, b = jnp.ones((d,), jnp.float32), jnp.zeros((d,), jnp.float32)
    for backend, device_type in (("tpu", "cuda"), ("cpu", "cpu")):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        calls.clear()
        jm._enc_ln(x, g, b)
        want = calls[0] if calls else "plain"
        assert tm.layer_norm_route(device_type, d) == want, backend


def test_every_route_gives_the_same_encoder_on_the_cpu(monkeypatch):
    """Forcing each route on the CPU (the wrappers take their plain
    versions there) changes no bit of the encoder, and it matches the JAX
    encoder. The micro configs' head width 32 goes head-major on the card."""
    from torch_port_helpers import V3_MICRO
    from wis_tpu.models.whisper import model as jm
    from wis_tpu.models.whisper.config import WhisperConfig as JaxConfig
    from wis_tpu.models.whisper.weights import random_params
    from wis_tpu_torch.models.whisper.config import WhisperConfig
    from wis_tpu_torch.models.whisper.weights import params_from_jax

    spec = dict(V3_MICRO, name="micro-dh32", n_mels=80, n_vocab=51865)
    jcfg, cfg = JaxConfig(**spec), WhisperConfig(**spec)
    assert tm.attention_route("cuda", 1500, cfg.n_audio_state, cfg.n_audio_head) == "head_major"
    jp = random_params(jcfg, seed=3, dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    mel = np.random.default_rng(5).standard_normal((1, 80, 3000)).astype(np.float32)
    want = np.asarray(jm.encode(jp, jnp.asarray(mel), jcfg))
    outs = {}
    for route in ("packed", "head_major", "plain"):
        monkeypatch.setattr(tm, "attention_route", lambda *a, r=route: r)
        with torch.inference_mode():
            outs[route] = tm.encode(tp, torch.from_numpy(mel), cfg)
    assert torch.equal(outs["packed"], outs["plain"])
    assert torch.equal(outs["head_major"], outs["plain"])
    np.testing.assert_allclose(outs["plain"].numpy(), want, atol=1e-4)
