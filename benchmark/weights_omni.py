"""Seeded Uni-MoE-2.0-Omni tensors under the checkpoint's names, made on the
device (the scheme of ``weights.py``): the audio tower (HF
``WhisperEncoder`` names under ``model.audio_tower.``), the connector, and
the Qwen2 decoder with its router, 2 fixed and 4 dynamic experts a layer
(the names the configuration's ``assumed.checkpoint_names`` states).

Scales: Linear weights N(0, 1/fan_in), the decoder's query and key
``qk_scale`` times that and the router ``router_scale`` times, biases
N(0, 0.02²), norm gains 1 + N(0, 0.1²), token embeddings N(0, 1), the
encoder's positions its sinusoids; everything rounded to bf16, the
checkpoint's type. A layer's experts are drawn as one tensor, each
expert's matrix a view of it, so a converter that takes the views out of
the dict frees the draw as it goes. The same seed on the same kind of
device gives the same bits.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.weights import _Draw, sinusoids

AUDIO = "model.audio_tower."


def omni_hf(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The speech-to-text path's tensors for a configuration dict
    (``configs/uni-moe-2.0-omni.json``'s keys)."""
    device = torch.device(device)
    r = _Draw(seed, device)
    sd: Dict[str, torch.Tensor] = {}
    e = cfg["audio_encoder"]
    ed, ef, mels = e["d_model"], e["encoder_ffn_dim"], e["num_mel_bins"]
    sd[AUDIO + "conv1.weight"] = r.normal((ed, mels, 3), (mels * 3) ** -0.5)
    sd[AUDIO + "conv2.weight"] = r.normal((ed, ed, 3), (ed * 3) ** -0.5)
    cb = r.normal((2, ed), 0.02)
    sd[AUDIO + "conv1.bias"], sd[AUDIO + "conv2.bias"] = cb[0], cb[1]
    sd[AUDIO + "embed_positions.weight"] = sinusoids(e["max_source_positions"], ed).to(
        device).to(torch.bfloat16)
    for i in range(e["encoder_layers"]):
        p = f"{AUDIO}layers.{i}."
        w = r.normal((4, ed, ed), ed ** -0.5)
        b = r.normal((3, ed), 0.02)
        for j, name in enumerate(("q_proj", "k_proj", "v_proj", "out_proj")):
            sd[p + f"self_attn.{name}.weight"] = w[j]
        for j, name in enumerate(("q_proj", "v_proj", "out_proj")):
            sd[p + f"self_attn.{name}.bias"] = b[j]
        g = r.normal((2, ed), 0.1, 1.0)
        nb = r.normal((2, ed), 0.02)
        for j, name in enumerate(("self_attn_layer_norm", "final_layer_norm")):
            sd[p + f"{name}.weight"], sd[p + f"{name}.bias"] = g[j], nb[j]
        sd[p + "fc1.weight"] = r.normal((ef, ed), ed ** -0.5)
        sd[p + "fc2.weight"] = r.normal((ed, ef), ef ** -0.5)
        sd[p + "fc1.bias"] = r.normal((ef,), 0.02)
        sd[p + "fc2.bias"] = r.normal((ed,), 0.02)
    sd[AUDIO + "layer_norm.weight"] = r.normal((ed,), 0.1, 1.0)
    sd[AUDIO + "layer_norm.bias"] = r.normal((ed,), 0.02)

    d, v = cfg["hidden_size"], cfg["vocab_size"]
    nh, nkv, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    f, fs = cfg["dynamic_intermediate_size"], cfg["shared_intermediate_size"]
    n_dyn, n_fix = cfg["mlp_dynamic_expert_num"], cfg["mlp_fixed_expert_num"]
    slots = n_dyn + cfg["mlp_dynamic_null_expert_num"]
    sd["model.audio_projector.weight"] = r.normal((d, cfg["whisper_hidden_size"]),
                                                  cfg["whisper_hidden_size"] ** -0.5)
    sd["model.audio_projector.bias"] = r.normal((d,), 0.02)
    sd["model.embed_tokens.weight"] = r.normal((v, d), 1.0)
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        sd[a + "q_proj.weight"] = r.normal((nh * dh, d), cfg["qk_scale"] * d ** -0.5)
        sd[a + "k_proj.weight"] = r.normal((nkv * dh, d), cfg["qk_scale"] * d ** -0.5)
        sd[a + "v_proj.weight"] = r.normal((nkv * dh, d), d ** -0.5)
        sd[a + "o_proj.weight"] = r.normal((d, nh * dh), (nh * dh) ** -0.5)
        sd[a + "q_proj.bias"] = r.normal((nh * dh,), 0.02)
        sd[a + "k_proj.bias"] = r.normal((nkv * dh,), 0.02)
        sd[a + "v_proj.bias"] = r.normal((nkv * dh,), 0.02)
        g = r.normal((2, d), 0.1, 1.0)
        sd[p + "input_layernorm.weight"], sd[p + "post_attention_layernorm.weight"] = g[0], g[1]
        sd[p + "mlp.gate.weight"] = r.normal((slots, d), cfg["router_scale"] * d ** -0.5)
        for kind, n, width in (("shared_experts", n_fix, fs), ("experts", n_dyn, f)):
            up = r.normal((n, 2, width, d), d ** -0.5)
            down = r.normal((n, d, width), width ** -0.5)
            for j in range(n):
                q = f"{p}mlp.{kind}.{j}."
                sd[q + "gate_proj.weight"], sd[q + "up_proj.weight"] = up[j, 0], up[j, 1]
                sd[q + "down_proj.weight"] = down[j]
            del up, down
    sd["model.norm.weight"] = r.normal((d,), 0.1, 1.0)
    sd["lm_head.weight"] = r.normal((v, d), d ** -0.5)
    return sd
