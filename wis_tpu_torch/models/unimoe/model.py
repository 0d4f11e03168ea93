"""Uni-MoE-2.0-Omni's speech-to-text path in PyTorch: the audio tower and
its connector, and the Qwen2 decoder with a mixture of experts in every
layer (``moe.py``), over a preallocated KV cache.

The parameter tree (``weights.params_from_hf`` makes it; dense weights in
the torch Linear layout (out, in), bf16 on the card; the router float32):

    params["encoder"]  the Whisper-large encoder in ``models/whisper``'s layout
    params["proj_w"] (D, 1280), ["proj_b"] (D,)     the connector
    params["embed"] (V, D), ["norm"] (D,), ["lm_head"] (V, D)
    params["layers"][i] = {ln1, qkv_w (D + 2·KV·Dh, D), qkv_b, o_w (D, D), ln2,
                           router (5, D), shared_gate_up (4·Ws, D), shared_down (D, 2·Ws),
                           w_gate, w_up (E, F, D), w_down (E, D, F)}

A layer (the Qwen2 block; M-RoPE with one position per token in all three
sections is plain RoPE, assumed for audio tokens):

    h = RMSNorm(x);  q, k, v = h Wqkv + b;  q, k = RoPE(q, k)       (x in float32)
    x = x + softmax(q kᵀ / √Dh + causal) v Wo          (28 query heads over 4 KV heads)
    x = x + moe(RMSNorm(x))

The audio tower is ``models/whisper/model.encode`` (the packed flash
kernel and the LayerNorm kernel on the card); the connector pools its 1500
frames to 200 tokens (``adaptive_avg_pool1d``, assumed) and applies one
linear layer, 1280 → D.

Every row of a batch holds the same prompt length, so the cache's
positions are shared: ``prefill`` writes [0, P) and attends causally over
them; decode ``step`` i writes P + i, a position it reads on the device,
and attends over the whole cache with the later columns masked, so one
CUDA graph holds every step (``decoding/omni.py``). Attention is
PyTorch's SDPA; the products are cuBLAS's; the routed experts run the
grouped kernel (``ops/moe_experts``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from wis_tpu_torch.models.unimoe.config import OmniConfig
from wis_tpu_torch.models.unimoe.moe import moe
from wis_tpu_torch.models.whisper.model import encode
from wis_tpu_torch.ops.quant import matmul_f32


class OmniCache(NamedTuple):
    """k, v (L, B, KV, T_max, Dh), and each token's routing codes
    (``moe.route``) by layer: routes (L, B, T_max, top_k) int8."""

    k: torch.Tensor
    v: torch.Tensor
    routes: torch.Tensor

    @classmethod
    def zeros(cls, cfg: OmniConfig, batch: int, max_len: int, dtype, device) -> "OmniCache":
        shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((cfg.num_hidden_layers, batch, max_len, cfg.mlp_dynamic_top_k),
                               dtype=torch.int8, device=device))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Qwen2's RMSNorm: float32 statistics, the gain applied in the
    weights' dtype (the products' input)."""
    x32 = x.float()
    x32 = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)
    return w * x32.to(w.dtype)


def rope_tables(cfg: OmniConfig, length: int, device) -> tuple:
    """cos, sin (length, Dh) float32 of rotate-half RoPE at positions
    0..length-1."""
    dh = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(0, dh, 2, dtype=torch.float64) / dh))
    ang = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().float().to(device), ang.sin().float().to(device)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, Dh); cos/sin (T, Dh)."""
    x32 = x.float()
    half = x32.shape[-1] // 2
    rot = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    return (x32 * cos[:, None] + rot * sin[:, None]).to(x.dtype)


def audio_tokens(params: dict, mel: torch.Tensor, cfg: OmniConfig) -> torch.Tensor:
    """mel (B, 128, 3000) → (B, 200, D): encoder, pooling, connector."""
    xa = encode(params, mel, cfg.encoder)  # (B, 1500, 1280)
    pooled = F.adaptive_avg_pool1d(xa.float().transpose(1, 2), cfg.whisper_query_tokens_size)
    return F.linear(pooled.transpose(1, 2).to(xa.dtype), params["proj_w"], params["proj_b"])


def embed_prompt(params: dict, audio: torch.Tensor, cfg: OmniConfig) -> torch.Tensor:
    """The prompt's embeddings (B, P, D) in float32, the residual stream's
    type: the head's text tokens, the audio tokens, the tail's text
    tokens."""
    b = audio.shape[0]
    dev = audio.device
    head = params["embed"][torch.tensor(cfg.prompt_head, device=dev)]
    tail = params["embed"][torch.tensor(cfg.prompt_tail, device=dev)]
    return torch.cat([head.expand(b, -1, -1), audio.to(head.dtype),
                      tail.expand(b, -1, -1)], dim=1).float()


def _block(x: torch.Tensor, layer: dict, cfg: OmniConfig, cos: torch.Tensor,
           sin: torch.Tensor, write, attend, valid: Optional[torch.Tensor],
           acc: Optional[torch.Tensor], record) -> torch.Tensor:
    """One layer over x (B, T, D), the residual stream in float32 (each
    product takes its input in the weights' dtype): ``write(k, v)``
    stores the new K/V (B, KV, T, Dh) in the cache, ``attend(q)`` (q (B,
    T, H, Dh)) returns the attention's output (B, T, H·Dh), and
    ``record(codes)`` stores the routing codes (B·T, top_k)."""
    b, t, d = x.shape
    nh, nkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    h = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
    q, k, v = F.linear(h, layer["qkv_w"], layer["qkv_b"]).split(
        [nh * dh, nkv * dh, nkv * dh], dim=-1)
    write(_rope(k.view(b, t, nkv, dh), cos, sin).transpose(1, 2),
          v.view(b, t, nkv, dh).transpose(1, 2))
    x = x + F.linear(attend(_rope(q.view(b, t, nh, dh), cos, sin)), layer["o_w"])
    h = rms_norm(x, layer["ln2"], cfg.rms_norm_eps)
    return x + moe(h.reshape(b * t, d), layer, cfg, valid, acc, record).view(b, t, d)


def prefill(params: dict, x: torch.Tensor, cache: OmniCache, cfg: OmniConfig, tables: tuple,
            valid: Optional[torch.Tensor] = None, acc: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """The prompt x (B, P, D) through every layer at positions [0, P), its
    K/V and routing written into the cache → the final norm's output (B,
    P, D).
    ``valid`` (B·P,) bool: the tokens whose experts run; ``acc`` the
    routing counts (``moe.count_into``)."""
    b, t, _ = x.shape
    rep = cfg.num_attention_heads // cfg.num_key_value_heads
    cos, sin = tables[0][:t], tables[1][:t]
    for li, layer in enumerate(params["layers"]):
        ck, cv, cr = cache.k[li], cache.v[li], cache.routes[li]

        def write(k, v, ck=ck, cv=cv):
            ck[:, :, :t] = k
            cv[:, :, :t] = v

        def record(codes, cr=cr):
            cr[:, :t] = codes.view(b, t, -1)

        def attend(q, ck=ck, cv=cv):
            o = F.scaled_dot_product_attention(
                q.transpose(1, 2), ck[:, :, :t].repeat_interleave(rep, dim=1),
                cv[:, :, :t].repeat_interleave(rep, dim=1), is_causal=True)
            return o.transpose(1, 2).reshape(b, t, -1)

        x = _block(x, layer, cfg, cos, sin, write, attend, valid, acc, record)
    return rms_norm(x, params["norm"], cfg.rms_norm_eps)


def step(params: dict, tok: torch.Tensor, pos: torch.Tensor, cache: OmniCache, cfg: OmniConfig,
         tables: tuple, valid: Optional[torch.Tensor] = None,
         acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``step_hidden`` and the head → the next tokens (B,), greedy."""
    return logits(params, step_hidden(params, tok, pos, cache, cfg, tables, valid, acc)
                  ).argmax(-1)


def step_hidden(params: dict, tok: torch.Tensor, pos: torch.Tensor, cache: OmniCache,
                cfg: OmniConfig, tables: tuple, valid: Optional[torch.Tensor] = None,
                acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step: the tokens tok (B,) at the position ``pos`` (a (1,)
    long tensor on the device) through every layer, their K/V and routing
    written into the cache there → the final norm's output (B, D). Nothing reads the host
    and every shape is fixed, so a CUDA graph can hold the step: the
    position is read on the device, and attention runs over the whole
    cache with the columns past ``pos`` masked."""
    b = tok.shape[0]
    nh, nkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    cos, sin = tables[0].index_select(0, pos), tables[1].index_select(0, pos)
    seen = (torch.arange(cache.k.shape[3], device=tok.device) <= pos).view(1, 1, 1, -1)
    x = params["embed"][tok][:, None].float()
    for li, layer in enumerate(params["layers"]):
        ck, cv, cr = cache.k[li], cache.v[li], cache.routes[li]

        def write(k, v, ck=ck, cv=cv):
            ck.index_copy_(2, pos, k)
            cv.index_copy_(2, pos, v)

        def record(codes, cr=cr):
            cr.index_copy_(1, pos, codes.view(b, 1, -1).to(cr.dtype))

        def attend(q, ck=ck, cv=cv):
            # each KV head's query heads attend as its rows
            o = F.scaled_dot_product_attention(q.view(b, nkv, nh // nkv, dh), ck, cv,
                                               attn_mask=seen)
            return o.reshape(b, 1, nh * dh)

        x = _block(x, layer, cfg, cos, sin, write, attend, valid, acc, record)
    return rms_norm(x[:, 0], params["norm"], cfg.rms_norm_eps)


def logits(params: dict, h: torch.Tensor) -> torch.Tensor:
    """The untied head over h (..., D) → float32 (..., V), accumulated and
    returned in float32."""
    return matmul_f32(h, params["lm_head"].T)
