"""WavLM x-vector speaker embedder (port of ``wis_tpu/models/wavlm/model.py``).

The reference runs speaker verification through HF's ``WavLMForXVector``
(wavlm-base-plus-sv → 512-dim x-vector → cosine against the enrolled
embeddings, threshold 0.75). The same architecture, in float32 PyTorch ops
(the JAX package runs it as XLA ops, with no Pallas kernel):

  raw 16 kHz PCM
    → 7-layer convolutional feature encoder (512 channels, stride 320)
    → LayerNorm + projection to the hidden size
    → convolutional positional embedding (16 groups, kernel 128, the
      SamePad trim for an even kernel)
    → transformer encoder with WavLM's gated relative position bias (the
      bias computed once and shared by every layer)
    → TDNN x-vector head (dilated frame windows → statistics pooling →
      512-dim embedding)

The tree keeps the JAX package's layout ((in, out) weights, convolutions
(K, C_in, C_out)); ``params_from_hf_wavlm`` converts an HF state dict and
``random_wavlm`` repeats the JAX package's numpy draws. Where the JAX
package departs from HF, the port follows HF:

- the statistics pooling takes the unbiased std (ddof 1), as ``torch.std``
  in ``WavLMForXVector``; the JAX package takes the population std;
- the relative-position gate is projected from the attention layer's input
  split into heads, as HF's ``WavLMAttention`` (and the original WavLM)
  does; the JAX package projects it from the query projection;
- ``default_embedder`` embeds at the true length (zero-padding only audio
  shorter than 1 s up to 1 s, which the TDNN's 15-frame span needs); the
  JAX package pads every input to a power-of-two number of seconds with no
  mask, and the padding enters attention and the pooling;
- ``load_or_init_wavlm`` reads the shards in sorted order through the
  port's safetensors reader, which returns BF16 tensors;
- a checkpoint with HF's ``layer_weights`` (``use_weighted_layer_sum``)
  feeds the projector the softmax-weighted sum of the embedding output and
  every layer's output, as ``WavLMForXVector`` does; the JAX package reads
  only the last state.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wis_tpu_torch.device import DeviceLike, resolve_device

logger = logging.getLogger("wis_tpu_torch")

StateDict = Dict[str, torch.Tensor]

#: audio shorter than this many samples (1 s at 16 kHz) is zero-padded to it
MIN_SAMPLES = 16000


@dataclass(frozen=True)
class WavLMConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    tdnn_dim: Tuple[int, ...] = (512, 512, 512, 512, 1500)
    tdnn_kernel: Tuple[int, ...] = (5, 3, 3, 1, 1)
    tdnn_dilation: Tuple[int, ...] = (1, 2, 3, 1, 1)
    xvector_output_dim: int = 512


BASE_PLUS_SV = WavLMConfig()


def _layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = torch.square(x32 - mu).mean(-1, keepdim=True)
    return (((x32 - mu) * torch.rsqrt(var + eps)) * g + b).to(x.dtype)


# --------------------------------------------------------------------------- #
# Feature encoder (raw waveform → (B, T', conv_dim[-1]))
# --------------------------------------------------------------------------- #
def feature_encoder(params: Dict, audio: torch.Tensor, cfg: WavLMConfig) -> torch.Tensor:
    """audio (B, N) → (B, T', conv_dim[-1]); total stride 320 (20 ms)."""
    x = audio[:, None, :].float()  # (B, 1, N)
    for i, s in enumerate(cfg.conv_stride):
        layer = params["conv_layers"][i]
        x = F.conv1d(x, layer["w"].permute(2, 1, 0), layer.get("b"), stride=s)
        if i == 0 and "gn_g" in layer:
            # GroupNorm with a group per channel: each channel over time
            x = F.group_norm(x, x.shape[1], layer["gn_g"], layer["gn_b"], eps=1e-5)
        x = F.gelu(x)
    return x.transpose(1, 2)


# --------------------------------------------------------------------------- #
# Gated relative position bias
# --------------------------------------------------------------------------- #
def _relative_position_buckets(n_query: int, n_key: int, num_buckets: int,
                               max_distance: int) -> np.ndarray:
    """T5-style bidirectional log-bucketed relative positions (host numpy,
    a copy of the JAX package's)."""
    context = np.arange(n_query)[:, None]
    memory = np.arange(n_key)[None, :]
    relative = memory - context
    num_buckets //= 2
    buckets = (relative > 0).astype(np.int64) * num_buckets
    relative = np.abs(relative)
    max_exact = num_buckets // 2
    is_small = relative < max_exact
    large = max_exact + (
        np.log(np.maximum(relative, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    buckets += np.where(is_small, relative, large)
    return buckets  # (n_query, n_key)


@lru_cache(maxsize=4)
def _bucket_index(seq_len: int, num_buckets: int, max_distance: int,
                  device: torch.device) -> torch.Tensor:
    """The (T, T) bucket table on ``device``, made once per length: later
    calls copy nothing from the host (a CUDA graph can capture them)."""
    buckets = _relative_position_buckets(seq_len, seq_len, num_buckets, max_distance)
    return torch.from_numpy(buckets).to(device)


def _position_bias(params: Dict, seq_len: int, cfg: WavLMConfig) -> torch.Tensor:
    """(H, T, T) bias from the bucket embedding, computed once and shared
    by every layer (HF computes it in layer 0 and passes it on)."""
    emb = params["rel_attn_embed"]  # (num_buckets, H)
    index = _bucket_index(seq_len, cfg.num_buckets, cfg.max_bucket_distance, emb.device)
    return emb[index].permute(2, 0, 1)


def _attention(x: torch.Tensor, layer: Dict, pos_bias: torch.Tensor,
               cfg: WavLMConfig) -> torch.Tensor:
    b, t, d = x.shape
    h = cfg.num_heads
    dh = d // h

    def heads(a: torch.Tensor) -> torch.Tensor:  # (B, T, D) → (B, H, T, dh)
        return a.reshape(b, t, h, dh).transpose(1, 2)

    q = heads(x @ layer["q_w"] + layer["q_b"])
    k = heads(x @ layer["k_w"] + layer["k_b"])
    v = heads(x @ layer["v_w"] + layer["v_b"])

    # the gate of the relative position bias, per query, from the layer's
    # input split into heads (HF WavLMAttention)
    gate_proj = heads(x) @ layer["gru_w"] + layer["gru_b"]  # (B, H, T, 8)
    gates = torch.sigmoid(gate_proj.reshape(b, h, t, 2, 4).sum(-1))
    gate_a, gate_b = gates[..., 0:1], gates[..., 1:2]
    gate_out = gate_a * (gate_b * layer["gru_const"] - 1.0) + 2.0  # (B, H, T, 1)

    scores = (q @ k.transpose(-1, -2)) * (dh ** -0.5) + gate_out * pos_bias[None]
    w = torch.softmax(scores, dim=-1)
    ctx = (w @ v).transpose(1, 2).reshape(b, t, d)
    return ctx @ layer["o_w"] + layer["o_b"]


def encoder(params: Dict, x: torch.Tensor, cfg: WavLMConfig,
            layer_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Feature-projected hidden states → the transformer's output (post-LN
    encoder, HF ``do_stable_layer_norm=False``). With ``layer_weights``
    (num_layers + 1 logits) → Σ softmax(layer_weights)[i] · h_i over the
    embedding output h_0 (after ``enc_ln``) and each layer's output, HF
    ``WavLMForXVector``'s weighted layer sum."""
    pc = params["pos_conv"]
    k = cfg.num_conv_pos_embeddings
    pos = F.conv1d(x.transpose(1, 2), pc["w"].permute(2, 1, 0), pc["b"], padding=k // 2,
                   groups=cfg.num_conv_pos_embedding_groups)
    if k % 2 == 0:
        pos = pos[..., :-1]  # SamePad trim for an even kernel
    x = x + F.gelu(pos).transpose(1, 2)
    x = _layer_norm(x, params["enc_ln_g"], params["enc_ln_b"])

    pos_bias = _position_bias(params, x.shape[1], cfg)
    # every state is kept only for the weighted sum
    states = None if layer_weights is None else [x]
    for layer in params["layers"]:
        x = _layer_norm(x + _attention(x, layer, pos_bias, cfg), layer["ln1_g"], layer["ln1_b"])
        ff = F.gelu(x @ layer["ff1_w"] + layer["ff1_b"]) @ layer["ff2_w"] + layer["ff2_b"]
        x = _layer_norm(x + ff, layer["ln2_g"], layer["ln2_b"])
        if states is not None:
            states.append(x)
    if states is None:
        return x
    # HF's order of operations: stack, scale by the softmax, sum
    w = torch.softmax(layer_weights, dim=-1)
    return (torch.stack(states, dim=1) * w.view(-1, 1, 1)).sum(dim=1)


# --------------------------------------------------------------------------- #
# TDNN x-vector head
# --------------------------------------------------------------------------- #
def _tdnn_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, kernel: int,
                dilation: int) -> torch.Tensor:
    """HF TDNNLayer: a linear map of a dilated window of frames, then ReLU.
    x (B, T, C_in), w (kernel·C_in, C_out) with the window's frames outer
    → (B, T − (kernel − 1)·dilation, C_out)."""
    c_in = x.shape[-1]
    wc = w.reshape(kernel, c_in, -1).permute(2, 1, 0)  # (C_out, C_in, kernel)
    y = F.conv1d(x.transpose(1, 2), wc, b, dilation=dilation)
    return torch.relu(y).transpose(1, 2)


def tdnn_frames(params: Dict, audio: torch.Tensor, cfg: WavLMConfig) -> torch.Tensor:
    """Raw PCM (B, N) → the TDNN head's frames (B, T'', tdnn_dim[-1]), the
    input of the statistics pooling."""
    x = _layer_norm(feature_encoder(params["feature_encoder"], audio, cfg),
                    params["fp_ln_g"], params["fp_ln_b"])
    x = x @ params["fp_w"] + params["fp_b"]
    x = encoder(params["encoder"], x, cfg, params.get("layer_weights"))
    x = x @ params["proj_w"] + params["proj_b"]
    for t, k, dil in zip(params["tdnn"], cfg.tdnn_kernel, cfg.tdnn_dilation):
        x = _tdnn_layer(x, t["w"], t["b"], k, dil)
    return x


def xvector_embed(params: Dict, audio: torch.Tensor, cfg: WavLMConfig) -> torch.Tensor:
    """Raw PCM (B, N) float32 → x-vector embeddings (B, xvector_output_dim),
    the ``.embeddings`` output of HF ``WavLMForXVector``: the mean and the
    unbiased std of the TDNN frames, then a linear map."""
    x = tdnn_frames(params, audio, cfg)
    stats = torch.cat([x.mean(dim=1), x.std(dim=1)], dim=-1)
    return stats @ params["fe_w"] + params["fe_b"]


# --------------------------------------------------------------------------- #
# Weights: HF conversion, seeded init, loading
# --------------------------------------------------------------------------- #
def params_from_hf_wavlm(sd: StateDict, cfg: WavLMConfig, dtype=torch.float32,
                         device: DeviceLike = "cpu") -> Dict:
    """Convert an HF ``WavLMForXVector`` state dict (torch tensors of any
    float dtype) into the JAX package's tree, on ``device`` in ``dtype``;
    leaf-equal to the JAX package's conversion of the same values. A
    ``layer_weights`` key (``use_weighted_layer_sum``) becomes the leaf
    ``params["layer_weights"]``, which the JAX package has no counterpart
    of."""

    def put(t: torch.Tensor) -> torch.Tensor:
        return t.to(dtype=dtype).contiguous().to(device)

    def g(key: str) -> torch.Tensor:
        return put(sd[key])

    def lin(prefix: str):  # torch Linear (out, in) → (in, out)
        return put(sd[prefix + ".weight"].t()), g(prefix + ".bias")

    conv_layers = []
    for i in range(len(cfg.conv_kernel)):
        p = f"wavlm.feature_extractor.conv_layers.{i}"
        layer = {"w": put(sd[p + ".conv.weight"].permute(2, 1, 0))}
        if p + ".conv.bias" in sd:
            layer["b"] = g(p + ".conv.bias")
        if i == 0 and p + ".layer_norm.weight" in sd:
            layer["gn_g"] = g(p + ".layer_norm.weight")
            layer["gn_b"] = g(p + ".layer_norm.bias")
        conv_layers.append(layer)

    # the weight-normed positional convolution (dim=2: one norm per tap),
    # in numpy at the tensor's own precision, as the JAX package computes it
    pc = "wavlm.encoder.pos_conv_embed.conv"
    for g_key, v_key in ((pc + ".parametrizations.weight.original0",
                          pc + ".parametrizations.weight.original1"),
                         (pc + ".weight_g", pc + ".weight_v")):
        if g_key in sd:
            g0, v = (_host(sd[g_key]), _host(sd[v_key]))
            norm = np.linalg.norm(v, axis=(0, 1), keepdims=True)
            w = torch.from_numpy(np.ascontiguousarray(g0 * v / np.maximum(norm, 1e-12)))
            break
    else:
        w = sd[pc + ".weight"]
    # grouped conv weight (C_out, C_in/groups, K) → (K, C_in/groups, C_out)
    pos_conv = {"w": put(w.permute(2, 1, 0)), "b": g(pc + ".bias")}

    layers = []
    for i in range(cfg.num_layers):
        p = f"wavlm.encoder.layers.{i}"
        qw, qb = lin(p + ".attention.q_proj")
        kw, kb = lin(p + ".attention.k_proj")
        vw, vb = lin(p + ".attention.v_proj")
        ow, ob = lin(p + ".attention.out_proj")
        gru_w, gru_b = lin(p + ".attention.gru_rel_pos_linear")
        ff1w, ff1b = lin(p + ".feed_forward.intermediate_dense")
        ff2w, ff2b = lin(p + ".feed_forward.output_dense")
        layers.append({
            "q_w": qw, "q_b": qb, "k_w": kw, "k_b": kb,
            "v_w": vw, "v_b": vb, "o_w": ow, "o_b": ob,
            "gru_w": gru_w, "gru_b": gru_b,
            "gru_const": g(p + ".attention.gru_rel_pos_const"),
            "ln1_g": g(p + ".layer_norm.weight"),
            "ln1_b": g(p + ".layer_norm.bias"),
            "ff1_w": ff1w, "ff1_b": ff1b,
            "ff2_w": ff2w, "ff2_b": ff2b,
            "ln2_g": g(p + ".final_layer_norm.weight"),
            "ln2_b": g(p + ".final_layer_norm.bias"),
        })

    fp_w, fp_b = lin("wavlm.feature_projection.projection")
    proj_w, proj_b = lin("projector")
    tdnn = []
    for i in range(len(cfg.tdnn_kernel)):
        w_, b_ = lin(f"tdnn.{i}.kernel")
        tdnn.append({"w": w_, "b": b_})
    fe_w, fe_b = lin("feature_extractor")
    params = {
        "feature_encoder": {"conv_layers": conv_layers},
        "fp_ln_g": g("wavlm.feature_projection.layer_norm.weight"),
        "fp_ln_b": g("wavlm.feature_projection.layer_norm.bias"),
        "fp_w": fp_w,
        "fp_b": fp_b,
        "encoder": {
            "pos_conv": pos_conv,
            "enc_ln_g": g("wavlm.encoder.layer_norm.weight"),
            "enc_ln_b": g("wavlm.encoder.layer_norm.bias"),
            "rel_attn_embed": g("wavlm.encoder.layers.0.attention.rel_attn_embed.weight"),
            "layers": layers,
        },
        "proj_w": proj_w,
        "proj_b": proj_b,
        "tdnn": tdnn,
        "fe_w": fe_w,
        "fe_b": fe_b,
    }
    if "layer_weights" in sd:
        params["layer_weights"] = g("layer_weights")
    return params


def _host(t: torch.Tensor) -> np.ndarray:
    """A checkpoint tensor as numpy at its own precision (f32 for bf16)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def random_wavlm(cfg: WavLMConfig, seed: int = 0, dtype=torch.float32,
                 device: DeviceLike = "cpu") -> Dict:
    """Seeded random weights equal, leaf for leaf and bit for bit, to the JAX
    package's ``random_wavlm(cfg, seed, dtype)``: the same numpy draws in the
    same order, moved to ``device`` once."""
    rng = np.random.default_rng(seed)

    def dense(*shape, scale=None):
        scale = scale or 1.0 / np.sqrt(shape[0])
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dtype)

    def const(fill, *shape, dt=dtype):
        return torch.full(shape, fill, dtype=dt, device=device)

    f32 = torch.float32
    d, hsz = cfg.conv_dim[0], cfg.hidden_size
    conv_layers = []
    c_in = 1
    for i, k in enumerate(cfg.conv_kernel):
        layer = {"w": dense(k, c_in, cfg.conv_dim[i], scale=0.05)}
        if cfg.conv_bias:
            layer["b"] = const(0.0, cfg.conv_dim[i])
        if i == 0:
            layer["gn_g"] = const(1.0, cfg.conv_dim[0], dt=f32)
            layer["gn_b"] = const(0.0, cfg.conv_dim[0], dt=f32)
        conv_layers.append(layer)
        c_in = cfg.conv_dim[i]

    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "q_w": dense(hsz, hsz), "q_b": const(0.0, hsz),
            "k_w": dense(hsz, hsz), "k_b": const(0.0, hsz),
            "v_w": dense(hsz, hsz), "v_b": const(0.0, hsz),
            "o_w": dense(hsz, hsz), "o_b": const(0.0, hsz),
            "gru_w": dense(hsz // cfg.num_heads, 8),
            "gru_b": const(0.0, 8),
            "gru_const": const(1.0, 1, cfg.num_heads, 1, 1),
            "ln1_g": const(1.0, hsz, dt=f32),
            "ln1_b": const(0.0, hsz, dt=f32),
            "ff1_w": dense(hsz, cfg.intermediate_size),
            "ff1_b": const(0.0, cfg.intermediate_size),
            "ff2_w": dense(cfg.intermediate_size, hsz),
            "ff2_b": const(0.0, hsz),
            "ln2_g": const(1.0, hsz, dt=f32),
            "ln2_b": const(0.0, hsz, dt=f32),
        })

    tdnn = []
    c = cfg.xvector_output_dim
    for i, k in enumerate(cfg.tdnn_kernel):
        tdnn.append({"w": dense(c * k, cfg.tdnn_dim[i]), "b": const(0.0, cfg.tdnn_dim[i])})
        c = cfg.tdnn_dim[i]

    return {
        "feature_encoder": {"conv_layers": conv_layers},
        "fp_ln_g": const(1.0, d, dt=f32),
        "fp_ln_b": const(0.0, d, dt=f32),
        "fp_w": dense(d, hsz),
        "fp_b": const(0.0, hsz),
        "encoder": {
            "pos_conv": {
                "w": dense(cfg.num_conv_pos_embeddings,
                           hsz // cfg.num_conv_pos_embedding_groups, hsz, scale=0.02),
                "b": const(0.0, hsz),
            },
            "enc_ln_g": const(1.0, hsz, dt=f32),
            "enc_ln_b": const(0.0, hsz, dt=f32),
            "rel_attn_embed": dense(cfg.num_buckets, cfg.num_heads, scale=0.02),
            "layers": layers,
        },
        "proj_w": dense(hsz, cfg.xvector_output_dim),
        "proj_b": const(0.0, cfg.xvector_output_dim),
        "tdnn": tdnn,
        "fe_w": dense(cfg.tdnn_dim[-1] * 2, cfg.xvector_output_dim),
        "fe_b": const(0.0, cfg.xvector_output_dim),
    }


def load_or_init_wavlm(model_dir: Optional[str] = None, cfg: WavLMConfig = BASE_PLUS_SV,
                       dtype=torch.float32, device: DeviceLike = "cpu") -> Dict:
    """The HF checkpoint in ``model_dir`` (every ``*.safetensors`` shard, in
    sorted order, F32, F16 or BF16) converted on ``device``; where there is
    none or it does not load, seeded random weights (logged)."""
    if model_dir and os.path.isdir(model_dir):
        files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
        if files:
            try:
                from wis_tpu_torch.models.whisper.safetensors_io import read_safetensors

                sd: StateDict = {}
                for fname in files:
                    sd.update(read_safetensors(os.path.join(model_dir, fname)))
                logger.info("WAVLM: loading weights from %s", model_dir)
                return params_from_hf_wavlm(sd, cfg, dtype, device)
            except Exception as e:  # noqa: BLE001 — a bad checkpoint keeps the seeded weights
                logger.warning("WAVLM: weight load failed (%s); using random init", e)
    logger.warning("WAVLM: using seeded random init (no checkpoint found)")
    return random_wavlm(cfg, dtype=dtype, device=device)


def default_embedder(model_dir: Optional[str] = None, device: DeviceLike = "cuda",
                     cfg: WavLMConfig = BASE_PLUS_SV):
    """A callable audio (N,) float32 at 16 kHz → (xvector_output_dim,)
    float32 numpy embedding, with ``model_dir``'s weights (seeded ones
    without a checkpoint) on ``device``. The audio is embedded at its own
    length; audio shorter than 1 s is zero-padded to 1 s."""
    dev = resolve_device(device)
    params = load_or_init_wavlm(model_dir, cfg, device=dev)

    def embed(audio: np.ndarray) -> np.ndarray:
        a = np.asarray(audio, np.float32).reshape(-1)
        if a.shape[0] < MIN_SAMPLES:
            a = np.pad(a, (0, MIN_SAMPLES - a.shape[0]))
        with torch.inference_mode():
            out = xvector_embed(params, torch.from_numpy(a).to(dev)[None], cfg)[0]
        return out.cpu().numpy()

    return embed
