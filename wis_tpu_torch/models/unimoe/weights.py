"""Uni-MoE-2.0-Omni's weights: the checkpoint's names, the converter into
the port's tree (``model.py``), seeded weights and the registry's loader.

The published checkpoint's speech-to-text tensors, by name (Qwen2's
decoder names; the audio tower under ``model.audio_tower.`` with HF
``WhisperEncoder``'s names; the connector, the router and the experts'
names are assumed, as ``hf_shapes`` lists them):

    model.audio_tower.{conv1,conv2,embed_positions,layers.i.*,layer_norm}.*
    model.audio_projector.{weight (D, 1280), bias}
    model.embed_tokens.weight, model.norm.weight, lm_head.weight
    model.layers.i.{input_layernorm,post_attention_layernorm}.weight
    model.layers.i.self_attn.{q,k,v}_proj.{weight,bias}, o_proj.weight
    model.layers.i.mlp.gate.weight (5, D)
    model.layers.i.mlp.shared_experts.j.{gate,up,down}_proj.weight   (j < 2)
    model.layers.i.mlp.experts.e.{gate,up,down}_proj.weight          (e < 4)

``params_from_hf`` takes the tensors out of the dict it is given as it
converts them, layer by layer, so a 52 GB model never stands twice on the
card (the caller's dict is emptied).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterator, Optional, Tuple

import torch

from wis_tpu_torch.device import DeviceLike
from wis_tpu_torch.models.unimoe.config import OmniConfig
from wis_tpu_torch.models.whisper.weights import params_from_hf as whisper_from_hf
from wis_tpu_torch.models.whisper.weights import sinusoid_positions

logger = logging.getLogger("wis_tpu_torch")

AUDIO = "model.audio_tower."


def hf_shapes(cfg: OmniConfig) -> Iterator[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every tensor the speech-to-text path reads."""
    e = cfg.encoder
    ed, mels, f_enc = e.n_audio_state, e.n_mels, 4 * e.n_audio_state
    yield AUDIO + "conv1.weight", (ed, mels, 3)
    yield AUDIO + "conv1.bias", (ed,)
    yield AUDIO + "conv2.weight", (ed, ed, 3)
    yield AUDIO + "conv2.bias", (ed,)
    yield AUDIO + "embed_positions.weight", (e.n_audio_ctx, ed)
    for i in range(e.n_audio_layer):
        p = f"{AUDIO}layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            yield p + f"self_attn.{name}.weight", (ed, ed)
        for name in ("q_proj", "v_proj", "out_proj"):
            yield p + f"self_attn.{name}.bias", (ed,)
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            yield p + f"{name}.weight", (ed,)
            yield p + f"{name}.bias", (ed,)
        yield p + "fc1.weight", (f_enc, ed)
        yield p + "fc1.bias", (f_enc,)
        yield p + "fc2.weight", (ed, f_enc)
        yield p + "fc2.bias", (ed,)
    yield AUDIO + "layer_norm.weight", (ed,)
    yield AUDIO + "layer_norm.bias", (ed,)
    d, v = cfg.hidden_size, cfg.vocab_size
    yield "model.audio_projector.weight", (d, cfg.whisper_hidden_size)
    yield "model.audio_projector.bias", (d,)
    yield "model.embed_tokens.weight", (v, d)
    kv = cfg.num_key_value_heads * cfg.head_dim
    f, fs = cfg.dynamic_intermediate_size, cfg.shared_intermediate_size
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        yield p + "input_layernorm.weight", (d,)
        for name, rows in (("q_proj", cfg.num_attention_heads * cfg.head_dim), ("k_proj", kv),
                           ("v_proj", kv)):
            yield p + f"self_attn.{name}.weight", (rows, d)
            yield p + f"self_attn.{name}.bias", (rows,)
        yield p + "self_attn.o_proj.weight", (d, d)
        yield p + "post_attention_layernorm.weight", (d,)
        yield p + "mlp.gate.weight", (cfg.router_slots, d)
        for kind, n, width in (("shared_experts", cfg.mlp_fixed_expert_num, fs),
                               ("experts", cfg.mlp_dynamic_expert_num, f)):
            for j in range(n):
                q = f"{p}mlp.{kind}.{j}."
                yield q + "gate_proj.weight", (width, d)
                yield q + "up_proj.weight", (width, d)
                yield q + "down_proj.weight", (d, width)
    yield "model.norm.weight", (d,)
    yield "lm_head.weight", (v, d)


def params_from_hf(sd: Dict[str, torch.Tensor], cfg: OmniConfig,
                   dtype: torch.dtype = torch.bfloat16, device: DeviceLike = "cpu") -> Dict:
    """The checkpoint's tensors (any device) → the port's tree on
    ``device``: the router in float32, the audio tower as
    ``models/whisper/weights.params_from_hf`` converts it, every other
    tensor in ``dtype``. Empties ``sd``."""
    device = torch.device(device)

    def take(name, dt=dtype):
        t = sd.pop(name).to(device)
        return t if t.dtype == dt else t.float().to(dt)

    def cat(names, dim=0, dt=dtype):
        return torch.cat([take(n, dt) for n in names], dim=dim)

    audio = {"model.encoder." + k[len(AUDIO):]: sd.pop(k) for k in list(sd) if k.startswith(AUDIO)}
    encoder = whisper_from_hf(audio, cfg.encoder, dtype, device, parts=("encoder",))["encoder"]
    del audio
    params = {"encoder": encoder,
              "proj_w": take("model.audio_projector.weight"),
              "proj_b": take("model.audio_projector.bias"),
              "embed": take("model.embed_tokens.weight"),
              "layers": []}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        a, m = p + "self_attn.", p + "mlp."
        shared = [f"{m}shared_experts.{j}." for j in range(cfg.mlp_fixed_expert_num)]
        experts = [f"{m}experts.{e}." for e in range(cfg.mlp_dynamic_expert_num)]
        params["layers"].append({
            "ln1": take(p + "input_layernorm.weight"),
            "qkv_w": cat([a + f"{n}_proj.weight" for n in "qkv"]),
            "qkv_b": cat([a + f"{n}_proj.bias" for n in "qkv"]),
            "o_w": take(a + "o_proj.weight"),
            "ln2": take(p + "post_attention_layernorm.weight"),
            "router": take(m + "gate.weight", torch.float32),
            "shared_gate_up": cat([s + "gate_proj.weight" for s in shared]
                                  + [s + "up_proj.weight" for s in shared]),
            "shared_down": cat([s + "down_proj.weight" for s in shared], dim=1),
            "w_gate": torch.stack([take(x + "gate_proj.weight") for x in experts]),
            "w_up": torch.stack([take(x + "up_proj.weight") for x in experts]),
            "w_down": torch.stack([take(x + "down_proj.weight") for x in experts]),
        })
    params["norm"] = take("model.norm.weight")
    params["lm_head"] = take("lm_head.weight")
    return params


#: the seeded weights' scales: dense weights N(0, 1/fan_in) (the decoder's
#: query and key ``qk_scale`` times that, the router ``router_scale``
#: times), biases N(0, 0.02²), norm gains 1 + N(0, 0.1²), token
#: embeddings N(0, 1), the encoder's positions its sinusoids
SEED_SCALES = {"qk_scale": 2.0, "router_scale": 2.0}


def seeded_hf(cfg: OmniConfig, seed: int, device: DeviceLike, dtype: torch.dtype = torch.bfloat16,
              qk_scale: float = SEED_SCALES["qk_scale"],
              router_scale: float = SEED_SCALES["router_scale"]) -> Dict[str, torch.Tensor]:
    """Seeded tensors under the checkpoint's names, drawn on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    sd = {}
    for name, shape in hf_shapes(cfg):
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        if name.endswith("norm.weight"):
            x.mul_(0.1).add_(1.0)
        elif name.endswith(".bias"):
            x.mul_(0.02)
        elif name.endswith("embed_positions.weight"):
            x = torch.from_numpy(sinusoid_positions(*shape)).to(device)
        elif "embed_tokens" in name:
            pass
        else:
            scale = shape[1] ** -0.5 if len(shape) == 2 else (shape[1] * shape[2]) ** -0.5
            if name.endswith(("q_proj.weight", "k_proj.weight")) and "layers" in name \
                    and not name.startswith(AUDIO):
                scale *= qk_scale
            elif name.endswith("mlp.gate.weight"):
                scale *= router_scale
            x.mul_(scale)
        sd[name] = x.to(dtype)
    return sd


def load_or_init(cfg: OmniConfig, model_dir: Optional[str], seed: int, device: DeviceLike,
                 dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The checkpoint's ``*.safetensors`` in ``model_dir`` converted, else
    seeded weights of the exact shapes (replies then mean nothing, but the
    work and its time are the model's)."""
    if model_dir and os.path.isdir(model_dir):
        files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
        if files:
            from wis_tpu_torch.models.whisper.safetensors_io import read_safetensors

            sd: Dict[str, torch.Tensor] = {}
            for fname in files:
                sd.update(read_safetensors(os.path.join(model_dir, fname)))
            logger.info("OMNI: loading weights from %s", model_dir)
            return params_from_hf(sd, cfg, dtype, device)
    logger.warning("OMNI: no weights for %s (dir=%s): seeded weights", cfg.name, model_dir)
    return params_from_hf(seeded_hf(cfg, seed, device, dtype), cfg, dtype, device)
