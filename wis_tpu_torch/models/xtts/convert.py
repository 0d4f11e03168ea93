"""Coqui XTTS v2 checkpoint → the port's XTTS trees (port of
``wis_tpu/models/xtts/convert.py``).

``XTTSModel`` reads ``<model_dir>/model.pth`` with
:func:`load_coqui_checkpoint` and converts it here:

- GPT: HF-GPT2-style blocks under ``gpt.gpt.h.{i}`` with Conv1D weights
  (stored (in, out), not transposed like ``nn.Linear``), the packed
  ``c_attn`` split into q, k and v leaves, the token and position
  embeddings, ``gpt.gpt.ln_f`` then ``gpt.final_norm``, and the
  ``gpt.mel_head`` audio-code head;
- HiFi-GAN: ``hifigan_decoder.waveform_decoder.*`` with weight-norm in
  either key style (``weight_g``/``weight_v`` or
  ``parametrizations.weight.original0/1``), the convolutions to the
  JAX package's (k, in, out) layout, the transposed ones to (k, out, in);
- the conditioning encoder: ``gpt.conditioning_encoder.*`` (the 1×1
  ``init`` convolution and the AttentionBlocks' norm, qkv and proj_out)
  and ``gpt.conditioning_perceiver.*`` (latents, attention and
  feedforward layers, the final RMSNorm; RMSNorm gains under ``gamma`` or
  ``g``), with every key under the two prefixes that is left unread
  reported in ``_unmapped`` and logged.

The trees are the ones ``gpt.random_gpt``, ``hifigan.random_hifigan`` and
``conditioning.random_conditioning`` build (the position tables keep the
checkpoint's extra rows), on the requested device and in its dtype. Every
leaf equals the JAX package's
conversion of the same state dict: the same casts from the checkpoint's
values, and the weight-norm arithmetic in numpy, as there, at the
tensor's own precision (f32 for a bf16 tensor, which numpy cannot hold).
Unlike the JAX loader, :func:`load_coqui_checkpoint` keeps torch tensors,
so a bf16 ``model.pth`` loads too.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from wis_tpu_torch.device import DeviceLike
from wis_tpu_torch.models.xtts.gpt import GPTConfig
from wis_tpu_torch.models.xtts.hifigan import HiFiGANConfig

logger = logging.getLogger("wis_tpu_torch")

StateDict = Dict[str, torch.Tensor]


def _host(t: torch.Tensor) -> np.ndarray:
    """A checkpoint tensor as numpy at its own precision (f32 for bf16)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _wn(sd: StateDict, prefix: str) -> torch.Tensor:
    """Resolve a (possibly weight-normed) conv weight: g · v / ‖v‖ over
    every axis but the first, computed as the JAX package computes it."""
    for g_key, v_key in (
        (prefix + ".parametrizations.weight.original0",
         prefix + ".parametrizations.weight.original1"),
        (prefix + ".weight_g", prefix + ".weight_v"),
    ):
        if g_key in sd:
            g, v = _host(sd[g_key]), _host(sd[v_key])
            norm = np.linalg.norm(v.reshape(v.shape[0], -1), axis=1).reshape(
                -1, *([1] * (v.ndim - 1)))
            return torch.from_numpy(np.ascontiguousarray(
                g.reshape(norm.shape) * v / np.maximum(norm, 1e-12)))
    return sd[prefix + ".weight"]


def gpt_from_coqui(sd: StateDict, cfg: GPTConfig, dtype=torch.bfloat16,
                   device: DeviceLike = "cpu") -> Dict:
    """Convert the ``gpt.*`` keys. GPT2 Conv1D weights are already (in, out)."""
    L = cfg.n_layer
    p = "gpt.gpt.h.{}."

    def put(t, dt=dtype):
        return t.to(dtype=dt).contiguous().to(device)

    def stack(sub, dt=dtype):
        return put(torch.stack([sd[p.format(i) + sub] for i in range(L)]), dt)

    def stack_qkv(sub, part):
        # c_attn packs q‖k‖v along its last axis
        return put(torch.stack([torch.chunk(sd[p.format(i) + sub], 3, dim=-1)[part]
                                for i in range(L)]))

    f32 = torch.float32
    return {
        "text_emb": put(sd["gpt.text_embedding.weight"]),
        "text_pos": put(sd["gpt.text_pos_embedding.emb.weight"]),
        "audio_emb": put(sd["gpt.mel_embedding.weight"]),
        "audio_pos": put(sd["gpt.mel_pos_embedding.emb.weight"]),
        "blocks": {
            "ln1_g": stack("ln_1.weight", f32),
            "ln1_b": stack("ln_1.bias", f32),
            "q_w": stack_qkv("attn.c_attn.weight", 0),
            "q_b": stack_qkv("attn.c_attn.bias", 0),
            "k_w": stack_qkv("attn.c_attn.weight", 1),
            "k_b": stack_qkv("attn.c_attn.bias", 1),
            "v_w": stack_qkv("attn.c_attn.weight", 2),
            "v_b": stack_qkv("attn.c_attn.bias", 2),
            "proj_w": stack("attn.c_proj.weight"),
            "proj_b": stack("attn.c_proj.bias"),
            "ln2_g": stack("ln_2.weight", f32),
            "ln2_b": stack("ln_2.bias", f32),
            "mlp_w1": stack("mlp.c_fc.weight"),
            "mlp_b1": stack("mlp.c_fc.bias"),
            "mlp_w2": stack("mlp.c_proj.weight"),
            "mlp_b2": stack("mlp.c_proj.bias"),
        },
        # GPT2Model's own ln_f runs first, then the model's final_norm
        "gpt_lnf_g": put(sd["gpt.gpt.ln_f.weight"], f32),
        "gpt_lnf_b": put(sd["gpt.gpt.ln_f.bias"], f32),
        "lnf_g": put(sd["gpt.final_norm.weight"], f32),
        "lnf_b": put(sd["gpt.final_norm.bias"], f32),
        # mel_head is nn.Linear (out, in)
        "head_w": put(sd["gpt.mel_head.weight"].t()),
        "head_b": put(sd["gpt.mel_head.bias"]),
    }


def hifigan_from_coqui(sd: StateDict, cfg: HiFiGANConfig, dtype=torch.bfloat16,
                       device: DeviceLike = "cpu") -> Dict:
    """Convert the ``hifigan_decoder.waveform_decoder.*`` keys."""
    p = "hifigan_decoder.waveform_decoder."
    n_rk = len(cfg.resblock_kernels)

    def put(t):
        return t.to(dtype=dtype).contiguous().to(device)

    def conv(prefix):
        # torch conv1d (out, in, k) → (k, in, out)
        return put(_wn(sd, prefix).permute(2, 1, 0))

    def bias(prefix):
        return put(sd[prefix + ".bias"])

    def cond(prefix, width, present):
        # a Linear or 1×1 conv (out, in[, 1]) → (in, out), zeros where the
        # checkpoint has none; the bias is looked up on its own, as there
        w = _wn(sd, prefix).squeeze().t() if present else torch.zeros(cfg.cond_dim, width)
        return put(w), put(sd.get(prefix + ".bias", torch.zeros(width)))

    ch = cfg.upsample_initial
    cond_w, cond_b = cond(p + "cond_layer", ch, p + "cond_layer.weight" in sd
                          or p + "cond_layer.weight_v" in sd)
    params = {"pre_w": conv(p + "conv_pre"), "pre_b": bias(p + "conv_pre"),
              "cond_w": cond_w, "cond_b": cond_b, "ups": [], "resblocks": []}
    for i in range(len(cfg.upsample_rates)):
        out_ch = ch // 2
        up_cond_w, up_cond_b = cond(p + f"conds.{i}", out_ch,
                                    any(k.startswith(p + f"conds.{i}") for k in sd))
        params["ups"].append({
            # transposed conv (in, out, k) → (k, out, in)
            "w": put(_wn(sd, p + f"ups.{i}").permute(2, 1, 0)),
            "b": bias(p + f"ups.{i}"),
            "cond_w": up_cond_w,
            "cond_b": up_cond_b,
        })
        stage = []
        for j in range(n_rk):
            r = p + f"resblocks.{i * n_rk + j}."
            n_d = range(len(cfg.resblock_dilations[j]))
            stage.append({
                "w1": [conv(r + f"convs1.{d}") for d in n_d],
                "b1": [bias(r + f"convs1.{d}") for d in n_d],
                "w2": [conv(r + f"convs2.{d}") for d in n_d],
                "b2": [bias(r + f"convs2.{d}") for d in n_d],
            })
        params["resblocks"].append(stage)
        ch = out_ch
    params["post_w"] = conv(p + "conv_post")
    params["post_b"] = bias(p + "conv_post")
    return params


def conditioning_from_coqui(sd: StateDict, cfg, dtype=torch.float32,
                            device: DeviceLike = "cpu") -> Dict:
    """Convert ``gpt.conditioning_encoder.*`` and ``gpt.conditioning_perceiver.*``
    (XTTS v2: the tortoise ConditioningEncoder, an ``init`` 1×1 convolution
    and AttentionBlocks [norm, qkv, proj_out]; the PerceiverResampler,
    ``latents`` and ``layers.{i}.[0 = Attention(norm, to_q, to_kv, to_out) |
    1 = FeedForward(0 = RMSNorm, 1 = Linear, 3 = Linear)]`` and a final
    ``norm``) into ``conditioning.random_conditioning``'s tree.

    RMSNorm gains are looked up under ``gamma`` and ``g``; every key under
    the two prefixes that is left unread comes back, sorted, in
    ``params["_unmapped"]`` and is logged, so a checkpoint's naming drift
    shows instead of degrading the voice in silence."""
    consumed = set()

    def take(key, *alts, default=None):
        for k in (key,) + alts:
            if k in sd:
                consumed.add(k)
                return sd[k]
        if default is not None:
            return default
        raise KeyError(key)

    def put(t, dt=dtype):
        return t.to(dtype=dt).contiguous().to(device)

    def conv1x1(t):  # conv1d (out, in, 1) → (in, out)
        return put(t.squeeze(-1).t())

    f32 = torch.float32
    p = "gpt.conditioning_encoder."
    params = {
        "init_w": conv1x1(take(p + "init.weight")),  # (D, n_mels, 1) → (n_mels, D)
        "init_b": put(take(p + "init.bias")),
        "blocks": [],
        "perceiver": [],
    }
    for i in range(cfg.n_blocks):
        b = p + f"attn.{i}."
        params["blocks"].append({
            "norm_g": put(take(b + "norm.weight"), f32),
            "norm_b": put(take(b + "norm.bias"), f32),
            "qkv_w": conv1x1(take(b + "qkv.weight")),  # (3D, D, 1) → (D, 3D)
            "qkv_b": put(take(b + "qkv.bias")),
            "proj_w": conv1x1(take(b + "proj_out.weight")),
            "proj_b": put(take(b + "proj_out.bias")),
        })

    q = "gpt.conditioning_perceiver."
    ones = torch.ones(cfg.d_model)
    none = torch.zeros(0)
    params["latents"] = put(take(q + "latents"))
    for i in range(cfg.perceiver_depth):
        a = q + f"layers.{i}.0."
        f = q + f"layers.{i}.1."
        kv = take(a + "to_kv.weight")  # (2·inner, D)
        inner = kv.shape[0] // 2
        blk = {
            "attn_norm_g": put(take(a + "norm.gamma", a + "norm.g", default=ones), f32),
            "q_w": put(take(a + "to_q.weight").t()),
            "k_w": put(kv[:inner].t()),
            "v_w": put(kv[inner:].t()),
            "o_w": put(take(a + "to_out.weight").t()),
            "ff_norm_g": put(take(f + "0.gamma", f + "0.g", default=ones), f32),
            "ff1_w": put(take(f + "1.weight").t()),
            "ff1_b": put(take(f + "1.bias", default=none)),
            "ff2_w": put(take(f + "3.weight").t()),
            "ff2_b": put(take(f + "3.bias", default=none)),
        }
        # bias-free checkpoint linears → zero biases at the right width
        for wk, bk in (("ff1_w", "ff1_b"), ("ff2_w", "ff2_b")):
            if blk[bk].shape[0] != blk[wk].shape[1]:
                blk[bk] = put(torch.zeros(blk[wk].shape[1]))
        params["perceiver"].append(blk)
    params["out_norm_g"] = put(take(q + "norm.gamma", q + "norm.g", default=ones), f32)

    unmapped = sorted(k for k in sd if k.startswith((p, q)) and k not in consumed)
    if unmapped:
        logger.warning("XTTS: %d conditioning keys not mapped (naming drift?): %s",
                       len(unmapped), unmapped[:8])
    params["_unmapped"] = unmapped
    return params


def load_coqui_checkpoint(path: str) -> Optional[StateDict]:
    """A Coqui ``model.pth`` as a dict of CPU tensors in their stored dtype
    (its ``"model"`` entry where it has one); None, logged, if it cannot
    be read."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "model" in sd:
            sd = sd["model"]
        return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    except Exception as e:  # noqa: BLE001 — an unreadable file keeps the seeded weights
        logger.warning("XTTS: checkpoint load failed: %s", e)
        return None
