"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages get the same inputs, made with numpy from a seed; the JAX
package's parameter trees cross to the port through
``wis_tpu_torch.models.whisper.weights.params_from_jax``.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import torch

from wis_tpu.models.whisper.config import WhisperConfig as JaxConfig
from wis_tpu_torch.models.whisper.config import WhisperConfig as PortConfig
from wis_tpu_torch.models.whisper.weights import params_from_jax

#: a narrow whisper: 2 encoder + 2 decoder layers, D=128, 2 heads
#: (head_dim 64), the real 51865-token vocabulary so the layout holds
SMALL = dict(
    name="small-parity",
    n_audio_state=128,
    n_audio_head=2,
    n_audio_layer=2,
    n_text_state=128,
    n_text_head=2,
    n_text_layer=2,
)
JAX_CFG = JaxConfig(**SMALL)
PORT_CFG = PortConfig(**SMALL)
#: a v3-layout micro whisper (128 mel bins, 51866 tokens), tests/test_v3_family.py's
V3_MICRO = dict(name="micro-v3", n_mels=128, n_vocab=51866, n_audio_state=64,
                n_audio_head=2, n_audio_layer=2, n_text_state=64, n_text_head=2,
                n_text_layer=1)


def np_tree(tree):
    """A JAX pytree → the same tree of numpy arrays."""
    return jax.tree.map(np.asarray, tree)


@lru_cache(maxsize=None)
def jax_params(quant: bool = False, seed: int = 0, emb_scale: float = 1.0,
               dtype: str = "float32"):
    """JAX random weights for SMALL (f32, or ``dtype``), optionally int8-quantized the way
    production quantizes (decoder + tok_emb_q). emb_scale widens the
    token embedding: the random init's 1/sqrt(V) scale leaves the logits
    nearly uniform (std ~0.05), so token-exact tests spread them to keep
    every decision's margin far above the logits tolerance."""
    from wis_tpu.models.whisper.weights import random_params

    params = random_params(JAX_CFG, seed=seed, dtype=getattr(jnp, dtype))
    if emb_scale != 1.0:
        dec = dict(params["decoder"], tok_emb=params["decoder"]["tok_emb"] * emb_scale)
        params = dict(params, decoder=dec)
    if quant:
        from wis_tpu.ops.quant import quantize_whisper_params

        params = quantize_whisper_params(params)
    return params


def port_params(quant: bool = False, seed: int = 0, emb_scale: float = 1.0,
                dtype: str = "float32"):
    """The same weights, bridged to torch on the CPU."""
    return params_from_jax(np_tree(jax_params(quant, seed, emb_scale, dtype)), "cpu")


def to_np(x) -> np.ndarray:
    """torch tensor or JAX array → numpy (bf16 as f32)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def audio_i16(n_samples: int, seed: int, batch: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pcm = rng.standard_normal((batch, n_samples)) * 0.05
    return np.clip(pcm * 32768.0, -32768, 32767).astype(np.int16)


def wav_bytes(seconds: float, seed: int) -> bytes:
    """A 16 kHz mono 16-bit WAV of audio_i16's samples."""
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(audio_i16(int(seconds * 16000), seed)[0].astype("<i2").tobytes())
    return buf.getvalue()


def jax_gumbel_rows(key, chunk, v, batch=1):
    """The gumbel rows run_decode_chunk's key chain draws, in step order:
    per step ``key, sub = split(key)``, then ``categorical(sub, ·)`` adds
    ``gumbel(sub, (batch, v))``."""
    rows = []
    for _ in range(chunk):
        key, sub = jax.random.split(key)
        rows.append(np.asarray(jax.random.gumbel(sub, (batch, v), jnp.float32)))
    return np.stack(rows)


def engine_pair(fused: bool = False, model: str = "tiny", **settings):
    """(JAX engine, port engine) on ``model``, the port serving the
    weights the JAX registry loaded (f32, or bf16 with ``fused`` — then both
    run ``fused_decode="on"``: the JAX kernels in interpret mode, the port's
    plain versions). The JAX registry seeds random weights with
    ``hash(size)``, which Python salts per process; pinning it keeps the
    weights fixed."""
    import pytest

    from wis_tpu.runtime import residency as jax_residency
    from wis_tpu.runtime.engine import WhisperEngine as JaxEngine
    from wis_tpu.settings import APISettings as JaxSettings
    from wis_tpu_torch.runtime.engine import WhisperEngine
    from wis_tpu_torch.runtime.residency import ModelRegistry
    from wis_tpu_torch.settings import APISettings

    kw = dict(whisper_model_default=model, dtype="bfloat16" if fused else "float32",
              max_decode_tokens=8, beam_size=1, long_beam_size=5,
              fused_decode="on" if fused else "auto")
    kw.update(settings)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_residency, "hash", lambda s: 7, raising=False)
        js = JaxSettings(batch_window_s=0.01, **kw)
        jax_engine = JaxEngine(jax_residency.ModelRegistry(js), js)
        tree = np_tree(jax_engine.registry.get(model).params)
    port = WhisperEngine(ModelRegistry(APISettings(**kw), "cpu", jax_trees={model: tree}))
    return jax_engine, port


# --------------------------------------------------------------------------- #
# the HTTP apps: one request sequence on wis_tpu's app and on the port's
# --------------------------------------------------------------------------- #
#: response fields the two engines time on their own clocks
CLOCKS = ("infer_time", "infer_speedup")


async def http_reply(resp):
    """(status, JSON body or text) of an aiohttp client response."""
    if resp.content_type == "application/json":
        return resp.status, await resp.json()
    return resp.status, await resp.text()


def serve(make_app, go):
    """go(client) against make_app() under aiohttp's test client."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    async def runner():
        client = TestClient(TestServer(make_app()))
        await client.start_server()
        try:
            return await go(client)
        finally:
            await client.close()

    return asyncio.run(runner())


def comparable(replies):
    """(status, body) replies with the engines' clock fields dropped."""
    return [(status, {k: v for k, v in body.items() if k not in CLOCKS}
             if isinstance(body, dict) else body) for status, body in replies]


def replay(engines, go, static_root=None, **settings):
    """go(client) → a list of (status, body), on wis_tpu's ASR app with the
    pair's JAX engine, then on the port's with its engine (both with
    ``settings`` over the pair's, ``static_root``/jax and /port); asserts
    the two lists equal but for the clock fields, and equal field sets;
    → the port's replies."""
    import dataclasses

    from wis_tpu.server.app import create_app as jax_create_app
    from wis_tpu_torch.server.app import create_app

    jax_engine, port = engines
    js = jax_engine.settings.model_copy(update=settings)
    ps = dataclasses.replace(port.settings, **settings)
    want = serve(lambda: jax_create_app(settings=js, engine=jax_engine,
                                        static_root=static_root and f"{static_root}/jax"), go)
    got = serve(lambda: create_app(settings=ps, engine=port,
                                   static_root=static_root and f"{static_root}/port"), go)
    assert comparable(got) == comparable(want)
    for (_, g), (_, w) in zip(got, want):
        if isinstance(g, dict):
            assert set(g) == set(w)
    return got
