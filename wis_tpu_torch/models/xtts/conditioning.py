"""XTTS conditioning encoder: reference audio's log-mel → GPT speaker
latents (port of ``wis_tpu/models/xtts/conditioning.py``).

Coqui XTTS v2 derives ``gpt_cond_latent`` with two modules whose checkpoint
keys live under ``gpt.conditioning_encoder.*`` and
``gpt.conditioning_perceiver.*``:

1. **ConditioningEncoder** (tortoise lineage): a 1×1 convolution mel →
   d_model, then N AttentionBlocks of ``x + proj(attn(qkv(groupnorm(x))))``.
   GroupNorm normalizes over (channels / groups, time) per group, and the
   qkv convolution's channels are heads-major with (q, k, v) interleaved
   within each head (QKVAttentionLegacy's ``view(B*H, 3*ch, T).split(ch)``),
   so a checkpoint's weights drop in unchanged. q and k are each scaled
   by ``dh**-0.25`` before an f32 product, as there.
2. **PerceiverResampler** (depth 2, 8 heads × 64, 32 latents): learned
   latent queries cross-attend [latents ‖ sequence] with RMSNorm
   pre-norms, bias-free q/kv/out projections, RMSNorm-led feedforwards and
   a final RMSNorm.

The tree keeps the JAX package's layout ((in, out) weights, (B, D, T)
activations through the encoder blocks) and everything runs in float32
(``device.resolve_device`` turns TF32 off on the card), as the JAX package
runs it. The JAX package runs both modules as XLA ops, without a Pallas
kernel; here they are plain PyTorch ops. ``convert.conditioning_from_coqui``
maps the checkpoint keys.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from wis_tpu_torch.device import DeviceLike


@dataclass(frozen=True)
class ConditioningConfig:
    n_mels: int = 80
    d_model: int = 1024
    n_heads: int = 16  # ConditioningEncoder attention heads (= GPT heads)
    n_blocks: int = 6
    n_latents: int = 32
    n_groups: int = 32  # GroupNorm groups
    perceiver_heads: int = 8
    perceiver_dim_head: int = 64
    perceiver_depth: int = 2
    ff_mult: int = 4


def _group_norm(x_bdt: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                groups: int) -> torch.Tensor:
    """GroupNorm over (channels/groups, T) per group; x (B, D, T)."""
    bsz, d, t = x_bdt.shape
    xg = x_bdt.float().reshape(bsz, groups, d // groups, t)
    mu = xg.mean(dim=(2, 3), keepdim=True)
    var = torch.square(xg - mu).mean(dim=(2, 3), keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + 1e-5)
    out = xg.reshape(bsz, d, t) * g[None, :, None] + b[None, :, None]
    return out.to(x_bdt.dtype)


def _rms_norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """lucidrains RMSNorm: normalize(x) · sqrt(dim) · gamma."""
    x32 = x.float()
    inv = torch.rsqrt(torch.sum(x32 * x32, dim=-1, keepdim=True) + 1e-12)
    return (x32 * inv * (x.shape[-1] ** 0.5) * gamma).to(x.dtype)


def conditioning_forward(params: Dict, mel: torch.Tensor,
                         cfg: ConditioningConfig) -> torch.Tensor:
    """mel (B, n_mels, T) → gpt_cond_latent (B, n_latents, d_model)."""
    H = cfg.n_heads
    dh = cfg.d_model // H
    # init: a 1×1 convolution (stored (M, D)); (B, D, T) for the GroupNorms
    x = torch.einsum("bmt,md->bdt", mel.to(params["init_w"].dtype), params["init_w"])
    x = x + params["init_b"][None, :, None]

    scale = 1.0 / np.sqrt(np.sqrt(dh))
    for blk in params["blocks"]:
        h = _group_norm(x, blk["norm_g"], blk["norm_b"], cfg.n_groups)
        qkv = torch.einsum("bdt,dc->bct", h, blk["qkv_w"]) + blk["qkv_b"][None, :, None]
        bsz, _, t = qkv.shape
        # QKVAttentionLegacy layout: heads-major, (q, k, v) within each head
        qkv = qkv.reshape(bsz, H, 3, dh, t)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, H, dh, T)
        scores = torch.einsum("bhdq,bhdk->bhqk", (q * scale).float(), (k * scale).float())
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        a = torch.einsum("bhqk,bhdk->bhdq", w, v).reshape(bsz, cfg.d_model, t)
        x = x + torch.einsum("bdt,dc->bct", a, blk["proj_w"]) + blk["proj_b"][None, :, None]

    # the perceiver resampler over the (B, T, D) sequence
    ctx = x.transpose(1, 2)
    lat = params["latents"][None].expand(ctx.shape[0], -1, -1).to(ctx.dtype)
    ph, pdh = cfg.perceiver_heads, cfg.perceiver_dim_head

    def heads(a: torch.Tensor) -> torch.Tensor:  # (B, T, ph·dh) → (B, ph, T, dh)
        return a.reshape(a.shape[0], a.shape[1], ph, -1).transpose(1, 2)

    for blk in params["perceiver"]:
        h = _rms_norm(lat, blk["attn_norm_g"])
        # cross_attn_include_queries: keys and values over [queries ‖ context]
        kv_in = torch.cat([h, ctx], dim=1)
        q, k, v = heads(h @ blk["q_w"]), heads(kv_in @ blk["k_w"]), heads(kv_in @ blk["v_w"])
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (pdh ** -0.5)
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bhkd->bhqd", w, v)
        o = o.transpose(1, 2).reshape(lat.shape[0], lat.shape[1], ph * pdh)
        lat = lat + o @ blk["o_w"]
        h = _rms_norm(lat, blk["ff_norm_g"])
        h = F.gelu(h @ blk["ff1_w"] + blk["ff1_b"])
        lat = lat + (h @ blk["ff2_w"] + blk["ff2_b"])
    return _rms_norm(lat, params["out_norm_g"])


def random_conditioning(cfg: ConditioningConfig, seed: int = 0, dtype=torch.float32,
                        device: DeviceLike = "cpu") -> Dict:
    """Seeded random weights equal, leaf for leaf and bit for bit, to the JAX
    package's ``random_conditioning(cfg, seed, dtype)``: the same numpy draws
    in the same order, moved to ``device`` once."""
    rng = np.random.default_rng(seed)
    D = cfg.d_model
    inner = cfg.perceiver_heads * cfg.perceiver_dim_head
    Fd = cfg.ff_mult * D

    def dense(*shape, scale=None):
        scale = scale or 1.0 / np.sqrt(shape[0])
        a = rng.standard_normal(shape).astype(np.float32) * scale
        # numpy f64 → f32 → dtype, the rounding path jnp.asarray takes
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dtype)

    def const(fill, n, dt=dtype):
        return torch.full((n,), fill, dtype=dt, device=device)

    f32 = torch.float32
    blocks = [
        {
            "norm_g": const(1.0, D, f32),
            "norm_b": const(0.0, D, f32),
            "qkv_w": dense(D, 3 * D),
            "qkv_b": const(0.0, 3 * D),
            "proj_w": dense(D, D, scale=0.02),
            "proj_b": const(0.0, D),
        }
        for _ in range(cfg.n_blocks)
    ]
    perceiver = [
        {
            "attn_norm_g": const(1.0, D, f32),
            "q_w": dense(D, inner),
            "k_w": dense(D, inner),
            "v_w": dense(D, inner),
            "o_w": dense(inner, D),
            "ff_norm_g": const(1.0, D, f32),
            "ff1_w": dense(D, Fd),
            "ff1_b": const(0.0, Fd),
            "ff2_w": dense(Fd, D),
            "ff2_b": const(0.0, D),
        }
        for _ in range(cfg.perceiver_depth)
    ]
    return {
        "init_w": dense(cfg.n_mels, D),
        "init_b": const(0.0, D),
        "blocks": blocks,
        "latents": dense(cfg.n_latents, D, scale=0.02),
        "perceiver": perceiver,
        "out_norm_g": const(1.0, D, f32),
    }


def build_clone_program(cfg: ConditioningConfig):
    """(params, mel (1, n_mels, T)) → (n_latents, d_model); the JAX
    package's jitted program as a plain function."""

    def clone(params: Dict, mel: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return conditioning_forward(params, mel, cfg)[0]

    return clone
