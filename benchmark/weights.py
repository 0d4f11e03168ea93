"""Seeded weights in the published checkpoint layouts, made on the device.

These are inputs that the benchmark makes and hands to both sides: the
program converts them with its own loaders, the plain references read them
as they are. Each group of same-shaped tensors is one ``torch.randn`` call
on a ``torch.Generator`` of the device, scaled and rounded to bf16 (the
served type) in place; a state dict's entries are views of those groups.
The same seed on the same kind of device gives the same bits.

Scales: a linear or convolution weight N(0, 1/fan_in), biases N(0, 0.02²),
LayerNorm gains 1 + N(0, 0.1²) and biases N(0, 0.02²), embeddings
N(0, 1/d), so logits come out with a spread near 1. Whisper's query and
key weights are ``qk_scale`` times larger: at N(0, 1/fan_in) every
attention is near uniform, the cross-attention returns the mean over the
window whatever the audio, and every request decodes one token over and
over; sharper attention makes each token depend on the audio and the
tokens before it, so the comparison with the reference can see a fault.
XTTS's stop code has its head bias raised by the configuration's
``stop_bias``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

BF16 = torch.bfloat16


class _Draw:
    def __init__(self, seed: int, device: torch.device):
        self.gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
        self.device = device

    def normal(self, shape, scale: float, shift: float = 0.0) -> torch.Tensor:
        x = torch.randn(shape, generator=self.gen, device=self.device, dtype=torch.float32)
        x.mul_(scale)
        if shift:
            x.add_(shift)
        return x.to(BF16)


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's encoder positions (openai ``sinusoids``, HF's
    ``embed_positions``)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(scaled), np.cos(scaled)], 1).astype(np.float32))


def whisper_hf(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """HF ``WhisperForConditionalGeneration`` tensors (``model.`` names,
    Linear weights (out, in), conv weights (out, in, k)) for a Whisper
    configuration dict (``d_model``, layers, heads, ``vocab_size``,
    ``num_mel_bins``, ``max_source_positions``, ``max_target_positions``)."""
    device = torch.device(device)
    r = _Draw(seed, device)
    d, ffn = cfg["d_model"], cfg["encoder_ffn_dim"]
    sd: Dict[str, torch.Tensor] = {}

    def layers(prefix: str, n: int, cross: bool):
        mods = ["self_attn"] + (["encoder_attn"] if cross else [])
        for mod in mods:
            qk = r.normal((n, 2, d, d), cfg["qk_scale"] * d ** -0.5)
            vo = r.normal((n, 2, d, d), d ** -0.5)
            b = r.normal((n, 3, d), 0.02)
            for i in range(n):
                p = f"{prefix}.layers.{i}.{mod}."
                for j, name in enumerate(("q_proj", "k_proj", "v_proj", "out_proj")):
                    sd[p + name + ".weight"] = (qk if j < 2 else vo)[i, j % 2]
                for j, name in enumerate(("q_proj", "v_proj", "out_proj")):
                    sd[p + name + ".bias"] = b[i, j]
        norms = ["self_attn_layer_norm", "final_layer_norm"] + (
            ["encoder_attn_layer_norm"] if cross else [])
        g = r.normal((n, len(norms), d), 0.1, 1.0)
        nb = r.normal((n, len(norms), d), 0.02)
        w1 = r.normal((n, ffn, d), d ** -0.5)
        w2 = r.normal((n, d, ffn), ffn ** -0.5)
        b1 = r.normal((n, ffn), 0.02)
        b2 = r.normal((n, d), 0.02)
        for i in range(n):
            p = f"{prefix}.layers.{i}."
            for j, name in enumerate(norms):
                sd[p + name + ".weight"] = g[i, j]
                sd[p + name + ".bias"] = nb[i, j]
            sd[p + "fc1.weight"], sd[p + "fc1.bias"] = w1[i], b1[i]
            sd[p + "fc2.weight"], sd[p + "fc2.bias"] = w2[i], b2[i]

    mels = cfg["num_mel_bins"]
    sd["model.encoder.conv1.weight"] = r.normal((d, mels, 3), (mels * 3) ** -0.5)
    sd["model.encoder.conv2.weight"] = r.normal((d, d, 3), (d * 3) ** -0.5)
    cb = r.normal((2, d), 0.02)
    sd["model.encoder.conv1.bias"], sd["model.encoder.conv2.bias"] = cb[0], cb[1]
    sd["model.encoder.embed_positions.weight"] = sinusoids(
        cfg["max_source_positions"], d).to(device)
    layers("model.encoder", cfg["encoder_layers"], cross=False)
    layers("model.decoder", cfg["decoder_layers"], cross=True)
    fin = r.normal((2, 2, d), 0.02)
    fin_g = r.normal((2, d), 0.1, 1.0)
    for j, p in enumerate(("model.encoder.layer_norm", "model.decoder.layer_norm")):
        sd[p + ".weight"], sd[p + ".bias"] = fin_g[j], fin[j, 0]
    sd["model.decoder.embed_tokens.weight"] = r.normal((cfg["vocab_size"], d), d ** -0.5)
    sd["model.decoder.embed_positions.weight"] = r.normal(
        (cfg["max_target_positions"], d), d ** -0.5)
    return sd


def xtts_coqui(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Coqui XTTS v2 ``model.pth`` tensors for the GPT (``gpt.*``, GPT-2
    Conv1D weights (in, out)) and the HiFi-GAN decoder
    (``hifigan_decoder.waveform_decoder.*``, plain ``weight`` keys) for an
    XTTS configuration dict."""
    device = torch.device(device)
    r = _Draw(seed, device)
    g = cfg["gpt"]
    d, n = g["gpt_n_model_channels"], g["gpt_layers"]
    sd: Dict[str, torch.Tensor] = {}
    sd["gpt.text_embedding.weight"] = r.normal((g["gpt_number_text_tokens"], d), d ** -0.5)
    sd["gpt.text_pos_embedding.emb.weight"] = r.normal((g["text_pos_rows"], d), d ** -0.5)
    sd["gpt.mel_embedding.weight"] = r.normal((g["gpt_num_audio_tokens"], d), d ** -0.5)
    sd["gpt.mel_pos_embedding.emb.weight"] = r.normal((g["mel_pos_rows"], d), d ** -0.5)
    attn = r.normal((n, d, 3 * d), d ** -0.5)
    proj = r.normal((n, d, d), d ** -0.5)
    fc = r.normal((n, d, 4 * d), d ** -0.5)
    fc_out = r.normal((n, 4 * d, d), (4 * d) ** -0.5)
    bias = r.normal((n, 9 * d), 0.02)
    ln_g = r.normal((n, 2, d), 0.1, 1.0)
    ln_b = r.normal((n, 2, d), 0.02)
    for i in range(n):
        p = f"gpt.gpt.h.{i}."
        sd[p + "ln_1.weight"], sd[p + "ln_1.bias"] = ln_g[i, 0], ln_b[i, 0]
        sd[p + "ln_2.weight"], sd[p + "ln_2.bias"] = ln_g[i, 1], ln_b[i, 1]
        sd[p + "attn.c_attn.weight"], sd[p + "attn.c_attn.bias"] = attn[i], bias[i, :3 * d]
        sd[p + "attn.c_proj.weight"], sd[p + "attn.c_proj.bias"] = proj[i], bias[i, 3 * d:4 * d]
        sd[p + "mlp.c_fc.weight"], sd[p + "mlp.c_fc.bias"] = fc[i], bias[i, 4 * d:8 * d]
        sd[p + "mlp.c_proj.weight"], sd[p + "mlp.c_proj.bias"] = fc_out[i], bias[i, 8 * d:]
    fin_g = r.normal((2, d), 0.1, 1.0)
    fin_b = r.normal((2, d), 0.02)
    sd["gpt.gpt.ln_f.weight"], sd["gpt.gpt.ln_f.bias"] = fin_g[0], fin_b[0]
    sd["gpt.final_norm.weight"], sd["gpt.final_norm.bias"] = fin_g[1], fin_b[1]
    sd["gpt.mel_head.weight"] = r.normal((g["gpt_num_audio_tokens"], d), d ** -0.5)
    head_b = r.normal((g["gpt_num_audio_tokens"],), 0.02).float()
    # a trained model stops at the end of its text; seeded weights would
    # run on to the cap, so the stop code's bias is raised and a reply
    # ends as soon as its floor (``min_audio_tokens``) lets it
    head_b[g["gpt_stop_audio_token"]] += g["stop_bias"]
    sd["gpt.mel_head.bias"] = head_b.to(BF16)

    v = cfg["hifigan"]
    p = "hifigan_decoder.waveform_decoder."
    ch, cond = v["upsample_initial_channel"], v["cond_dim"]
    sd[p + "conv_pre.weight"] = r.normal((ch, v["input_dim"], 7), (v["input_dim"] * 7) ** -0.5)
    sd[p + "conv_pre.bias"] = r.normal((ch,), 0.02)
    sd[p + "cond_layer.weight"] = r.normal((ch, cond, 1), cond ** -0.5)
    sd[p + "cond_layer.bias"] = r.normal((ch,), 0.02)
    n_rk = len(v["resblock_kernel_sizes"])
    for i, (rate, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        out = ch // 2
        sd[p + f"ups.{i}.weight"] = r.normal((ch, out, k), (ch * k / rate) ** -0.5)
        sd[p + f"ups.{i}.bias"] = r.normal((out,), 0.02)
        sd[p + f"conds.{i}.weight"] = r.normal((out, cond, 1), cond ** -0.5)
        sd[p + f"conds.{i}.bias"] = r.normal((out,), 0.02)
        for j, (rk, dils) in enumerate(zip(v["resblock_kernel_sizes"],
                                           v["resblock_dilation_sizes"])):
            w = r.normal((2, len(dils), out, out, rk), (out * rk) ** -0.5)
            b = r.normal((2, len(dils), out), 0.02)
            for m in range(len(dils)):
                q = p + f"resblocks.{i * n_rk + j}."
                sd[q + f"convs1.{m}.weight"], sd[q + f"convs1.{m}.bias"] = w[0, m], b[0, m]
                sd[q + f"convs2.{m}.weight"], sd[q + f"convs2.{m}.bias"] = w[1, m], b[1, m]
        ch = out
    sd[p + "conv_post.weight"] = r.normal((1, ch, 7), (ch * 7) ** -0.5)
    sd[p + "conv_post.bias"] = r.normal((1,), 0.02)
    return sd


def xtts_voice(cfg: Dict, seed: int) -> Dict[str, list]:
    """A voice as the speaker store keeps one (``gpt_cond_latent`` and an
    L2-normalized ``speaker_embedding``, float16 lists), drawn from the seed
    on the host."""
    rng = np.random.default_rng(seed)
    g = cfg["gpt"]
    lat = rng.standard_normal((g["cond_len"], g["gpt_n_model_channels"])) * 0.5
    emb = rng.standard_normal(cfg["hifigan"]["cond_dim"])
    emb /= np.linalg.norm(emb)
    return {"gpt_cond_latent": lat.astype(np.float16).tolist(),
            "speaker_embedding": emb.astype(np.float16).tolist()}
