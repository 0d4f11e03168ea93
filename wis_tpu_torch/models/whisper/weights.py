"""Whisper parameters for the port (counterpart of
``wis_tpu/models/whisper/weights.py``).

The tree keeps the JAX package's layout (stacked layers with a leading
layer axis, (in, out) matmul weights, int8 leaves as ``{"q", "s"}``; see
``model.py``). Three sources:

- ``load_or_init_params(cfg, model_dir, seed, device, dtype)`` reads an HF
  checkpoint (``*.safetensors`` in ``model_dir``, with this package's own
  reader, ``safetensors_io.py``) and converts it with ``params_from_hf``,
  leaf for leaf the JAX package's conversion; the converted tree is cached
  under ``<model_dir>/_converted_torch`` (``checkpoint.py``). Without a
  checkpoint it falls back to ``random_params``, as the JAX package does.
- ``params_from_jax(tree, device)`` bridges a tree the JAX package built, given
  as numpy arrays (``np.asarray`` of each leaf). Every leaf is taken as it
  is — bf16 bit patterns, int8 ``{q, s}`` leaves and ``tok_emb_q``
  included — never re-quantized or re-rounded.
- ``random_params(cfg, seed, device, dtype)`` draws seeded random weights
  with the same shapes, dtypes and scales as the JAX package's
  ``random_params``, from a ``torch.Generator`` on the target device, so a
  large-v2 model is made on the card in seconds (on the ``meta`` device it
  gives the shapes and dtypes alone). The numbers differ from
  ``jax.random``'s; tests that compare the two packages bridge one weight
  set instead.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from wis_tpu_torch.device import DeviceLike
from wis_tpu_torch.models.whisper.config import WhisperConfig

logger = logging.getLogger("wis_tpu_torch")


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
        # the meta device draws nothing: its tree carries shapes and dtypes
        self.gen = (None if device.type == "meta"
                    else torch.Generator(device=device).manual_seed(seed))
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


# --------------------------------------------------------------------------- #
# HF safetensors conversion
# --------------------------------------------------------------------------- #
def _hf_tensors(model_dir: str) -> Optional[Dict[str, torch.Tensor]]:
    """Every tensor of the HF safetensors shard(s) in model_dir, shards in
    sorted filename order (a later shard's key wins), as CPU tensors over
    memory maps; None without a ``*.safetensors`` file."""
    from wis_tpu_torch.models.whisper.safetensors_io import read_safetensors

    files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if not files:
        return None
    tensors: Dict[str, torch.Tensor] = {}
    for fname in files:
        tensors.update(read_safetensors(os.path.join(model_dir, fname)))
    return tensors


def params_from_hf(
    tensors: Dict[str, torch.Tensor],
    cfg: WhisperConfig,
    dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = "cpu",
    parts: Tuple[str, ...] = ("encoder", "decoder"),
) -> Dict:
    """Convert HF ``WhisperForConditionalGeneration`` tensors (torch Linear
    layout: weight (out, in); on any device) into the stacked-layer tree, leaf for leaf the
    JAX package's ``params_from_hf``: LayerNorm gains and biases and the
    encoder's positions in f32, every other leaf in ``dtype``, conv weights
    (k, in, out), Linear weights transposed, the ``model.`` prefix
    stripped. Each tensor moves to ``device`` in the checkpoint's dtype and
    is rounded there (to nearest even, through f32, as XLA's convert does),
    so on the card large-v2's 1.55 B parameters never round on the host.
    ``parts`` names the halves converted (an audio tower has only the
    encoder's tensors)."""
    device = torch.device(device)
    t = {k.removeprefix("model."): v for k, v in tensors.items()}
    f32 = torch.float32

    def rounded(a, dt):
        # f16 and bf16 widen to f32 exactly, then round once to dt
        return a if a.dtype == dt else a.float().to(dt)

    def leaf(name, dt=dtype):
        return rounded(t[name].to(device), dt)

    def stacked(fmt, n_layers, transpose=False, dt=dtype):
        a = torch.stack([t[fmt.format(i)].to(device) for i in range(n_layers)])
        a = rounded(a, dt)
        return a.transpose(-1, -2).contiguous() if transpose else a

    def blocks(prefix, n_layers, cross):
        def s(sub, transpose=False, dt=dtype):
            return stacked(prefix + ".layers.{}." + sub, n_layers, transpose, dt)

        def attn(mod):
            return {
                "q_w": s(f"{mod}.q_proj.weight", transpose=True),
                "q_b": s(f"{mod}.q_proj.bias"),
                "k_w": s(f"{mod}.k_proj.weight", transpose=True),
                "v_w": s(f"{mod}.v_proj.weight", transpose=True),
                "v_b": s(f"{mod}.v_proj.bias"),
                "o_w": s(f"{mod}.out_proj.weight", transpose=True),
                "o_b": s(f"{mod}.out_proj.bias"),
            }

        def ln(mod):
            return {"g": s(f"{mod}.weight", dt=f32), "b": s(f"{mod}.bias", dt=f32)}

        out = {
            "attn_ln": ln("self_attn_layer_norm"),
            "attn": attn("self_attn"),
            "mlp_ln": ln("final_layer_norm"),
            "mlp": {
                "w1": s("fc1.weight", transpose=True),
                "b1": s("fc1.bias"),
                "w2": s("fc2.weight", transpose=True),
                "b2": s("fc2.bias"),
            },
        }
        if cross:
            out["cross_ln"] = ln("encoder_attn_layer_norm")
            out["cross"] = attn("encoder_attn")
        return out

    def conv(name):
        # torch conv1d weight (out, in, k) → (k, in, out)
        return {"w": leaf(f"{name}.weight").permute(2, 1, 0).contiguous(),
                "b": leaf(f"{name}.bias")}

    out = {}
    if "encoder" in parts:
        out["encoder"] = {
            "conv1": conv("encoder.conv1"),
            "conv2": conv("encoder.conv2"),
            "pos": leaf("encoder.embed_positions.weight", f32),
            "blocks": blocks("encoder", cfg.n_audio_layer, cross=False),
            "ln_post": {"g": leaf("encoder.layer_norm.weight", f32),
                        "b": leaf("encoder.layer_norm.bias", f32)},
        }
    if "decoder" in parts:
        out["decoder"] = {
            "tok_emb": leaf("decoder.embed_tokens.weight"),
            "pos": leaf("decoder.embed_positions.weight"),
            "blocks": blocks("decoder", cfg.n_text_layer, cross=True),
            "ln": {"g": leaf("decoder.layer_norm.weight", f32),
                   "b": leaf("decoder.layer_norm.bias", f32)},
        }
    return out


def load_or_init_params(
    cfg: WhisperConfig,
    model_dir: Optional[str],
    seed: int,
    device: DeviceLike,
    dtype: torch.dtype = torch.bfloat16,
) -> Dict:
    """Converted HF weights from ``model_dir`` if it holds a checkpoint
    (the converted tree cached under ``<model_dir>/_converted_torch`` for
    fast restarts), else seeded random weights with the exact shapes."""
    device = torch.device(device)
    if model_dir and os.path.isdir(model_dir):
        from wis_tpu_torch.models.whisper.checkpoint import (
            converted_path,
            load_params,
            save_params,
        )

        path = converted_path(model_dir, dtype)
        cached = load_params(path, device)
        if cached is not None:
            return cached
        tensors = _hf_tensors(model_dir)
        if tensors:
            logger.info("WHISPER: loading HF weights from %s", model_dir)
            params = params_from_hf(tensors, cfg, dtype, device)
            save_params(params, path)
            return params
    logger.warning(
        "WHISPER: no weights found for %s (dir=%s) — using seeded random "
        "init; transcripts will be meaningless but shapes/latency are exact",
        cfg.name,
        model_dir,
    )
    return random_params(cfg, seed, device, dtype)
