"""Whisper parameters for the port (counterpart of
``wis_tpu/models/whisper/weights.py``).

The tree keeps the JAX package's layout (stacked layers with a leading
layer axis, (in, out) matmul weights, int8 leaves as ``{"q", "s"}``; see
``model.py``). Two sources:

- ``params_from_jax(tree, device)`` bridges a tree the JAX package built, given
  as numpy arrays (``np.asarray`` of each leaf). Every leaf is taken as it
  is — bf16 bit patterns, int8 ``{q, s}`` leaves and ``tok_emb_q``
  included — never re-quantized or re-rounded.
- ``random_params(cfg, seed, device, dtype)`` draws seeded random weights
  with the same shapes, dtypes and scales as the JAX package's
  ``random_params``, from a ``torch.Generator`` on the target device, so a
  large-v2 model is made on the card in seconds. The numbers differ from
  ``jax.random``'s; tests that compare the two packages bridge one weight
  set instead.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from wis_tpu_torch.device import DeviceLike
from wis_tpu_torch.models.whisper.config import WhisperConfig


def sinusoid_positions(length: int, channels: int) -> np.ndarray:
    """Standard transformer sinusoidal embedding (whisper encoder)."""
    assert channels % 2 == 0
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(
        np.float32
    )


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)  # an owned, writable copy
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: move the bit pattern as uint16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree: Dict, device: DeviceLike) -> Dict:
    """A JAX-layout parameter tree of numpy arrays → the same tree of
    torch tensors on ``device``, leaf for leaf."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _leaf_from_numpy(tree, device)


class _Init:
    def __init__(self, seed: int, device: torch.device, dtype: torch.dtype):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device = device
        self.dtype = dtype

    def dense(self, *shape) -> torch.Tensor:
        scale = 1.0 / np.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
        w = torch.randn(shape, generator=self.gen, device=self.device)
        return (w * scale).to(self.dtype)

    def zeros(self, *shape, dtype=None) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype or self.dtype, device=self.device)

    def ones(self, *shape) -> torch.Tensor:
        return torch.ones(shape, dtype=torch.float32, device=self.device)


def _init_blocks(init: _Init, n_layers: int, d: int, cross: bool) -> Dict:
    L, F = n_layers, 4 * d
    f32 = torch.float32

    def attn():
        return {
            "q_w": init.dense(L, d, d),
            "q_b": init.zeros(L, d),
            "k_w": init.dense(L, d, d),
            "v_w": init.dense(L, d, d),
            "v_b": init.zeros(L, d),
            "o_w": init.dense(L, d, d),
            "o_b": init.zeros(L, d),
        }

    blocks = {
        "attn_ln": {"g": init.ones(L, d), "b": init.zeros(L, d, dtype=f32)},
        "attn": attn(),
        "mlp_ln": {"g": init.ones(L, d), "b": init.zeros(L, d, dtype=f32)},
        "mlp": {
            "w1": init.dense(L, d, F),
            "b1": init.zeros(L, F),
            "w2": init.dense(L, F, d),
            "b2": init.zeros(L, d),
        },
    }
    if cross:
        blocks["cross_ln"] = {"g": init.ones(L, d), "b": init.zeros(L, d, dtype=f32)}
        blocks["cross"] = attn()
    return blocks


def random_params(
    cfg: WhisperConfig,
    seed: int,
    device: DeviceLike,
    dtype: torch.dtype = torch.bfloat16,
) -> Dict:
    """Seeded random whisper weights, made on ``device``. Deterministic
    for a given (seed, device type): a stable integer seed, not
    ``hash()``."""
    device = torch.device(device)
    init = _Init(seed, device, dtype)
    d = cfg.n_audio_state
    f32 = torch.float32
    return {
        "encoder": {
            "conv1": {"w": init.dense(3, cfg.n_mels, d), "b": init.zeros(d)},
            "conv2": {"w": init.dense(3, d, d), "b": init.zeros(d)},
            "pos": torch.from_numpy(sinusoid_positions(cfg.n_audio_ctx, d)).to(device),
            "blocks": _init_blocks(init, cfg.n_audio_layer, d, cross=False),
            "ln_post": {"g": init.ones(d), "b": init.zeros(d, dtype=f32)},
        },
        "decoder": {
            "tok_emb": init.dense(cfg.n_vocab, cfg.n_text_state),
            "pos": init.dense(cfg.n_text_ctx, cfg.n_text_state),
            "blocks": _init_blocks(init, cfg.n_text_layer, cfg.n_text_state, cross=True),
            "ln": {
                "g": init.ones(cfg.n_text_state),
                "b": init.zeros(cfg.n_text_state, dtype=f32),
            },
        },
    }
