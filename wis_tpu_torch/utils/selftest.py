"""Full-dims converter self-test (port of ``wis_tpu/utils/selftest.py``,
the Whisper half).

The HF-parity tests hold the converter's math at micro dims; this
validates the converter at the REAL dims of a production checkpoint
without the checkpoint itself:

- :func:`hf_whisper_shapes` lists the keys and shapes
  ``transformers``' ``WhisperForConditionalGeneration.state_dict()`` holds
  at a config's dims, written out by hand (the card's machine has no
  ``transformers``; a CPU test holds the list equal to the package's);
- :func:`whisper_selftest` zero-fills that state dict on the device
  (values are irrelevant; keys, shapes and memory are the test), converts
  it through :func:`weights.params_from_hf`, checks the tree's shapes and
  dtypes against :func:`weights.random_params` made on the ``meta`` device
  (no second full-size tree), and optionally runs one full-dims encoder
  pass plus the cross-KV projection and checks both are finite.

Exposed as ``python -m wis_tpu_torch.cli convert-model --selftest <size>``.

:func:`synthetic_coqui_sd` is the GPT and HiFi-GAN half of the JAX
package's XTTS v2 ``model.pth`` key list, zero-filled as there or, given
a seed, filled with seeded values so that a stream from it differs from
one from the seeded random trees (``chip_smoke.py`` loads one at full
width).
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import torch

from wis_tpu_torch.device import DeviceLike, resolve_device


def _spec(tree, prefix=""):
    """{"/path/to/leaf": (shape, dtype)} of a parameter tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype))}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# --------------------------------------------------------------------------- #
# Whisper
# --------------------------------------------------------------------------- #
def hf_whisper_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """{key: shape} of an HF ``WhisperForConditionalGeneration`` state
    dict at cfg's dims, in transformers' order (Linear weights (out, in),
    conv weights (out, in, k); ``proj_out`` is tied to ``embed_tokens``)."""
    d, dt = cfg.n_audio_state, cfg.n_text_state
    shapes = {
        "model.encoder.conv1.weight": (d, cfg.n_mels, 3),
        "model.encoder.conv1.bias": (d,),
        "model.encoder.conv2.weight": (d, d, 3),
        "model.encoder.conv2.bias": (d,),
        "model.encoder.embed_positions.weight": (cfg.n_audio_ctx, d),
    }

    def attn(prefix, w):
        shapes.update({
            f"{prefix}.k_proj.weight": (w, w),
            f"{prefix}.v_proj.weight": (w, w),
            f"{prefix}.v_proj.bias": (w,),
            f"{prefix}.q_proj.weight": (w, w),
            f"{prefix}.q_proj.bias": (w,),
            f"{prefix}.out_proj.weight": (w, w),
            f"{prefix}.out_proj.bias": (w,),
        })

    def layer(prefix, w, cross):
        attn(f"{prefix}.self_attn", w)
        shapes[f"{prefix}.self_attn_layer_norm.weight"] = (w,)
        shapes[f"{prefix}.self_attn_layer_norm.bias"] = (w,)
        if cross:
            attn(f"{prefix}.encoder_attn", w)
            shapes[f"{prefix}.encoder_attn_layer_norm.weight"] = (w,)
            shapes[f"{prefix}.encoder_attn_layer_norm.bias"] = (w,)
        shapes.update({
            f"{prefix}.fc1.weight": (4 * w, w),
            f"{prefix}.fc1.bias": (4 * w,),
            f"{prefix}.fc2.weight": (w, 4 * w),
            f"{prefix}.fc2.bias": (w,),
            f"{prefix}.final_layer_norm.weight": (w,),
            f"{prefix}.final_layer_norm.bias": (w,),
        })

    for i in range(cfg.n_audio_layer):
        layer(f"model.encoder.layers.{i}", d, cross=False)
    shapes["model.encoder.layer_norm.weight"] = (d,)
    shapes["model.encoder.layer_norm.bias"] = (d,)
    shapes["model.decoder.embed_tokens.weight"] = (cfg.n_vocab, dt)
    shapes["model.decoder.embed_positions.weight"] = (cfg.n_text_ctx, dt)
    for i in range(cfg.n_text_layer):
        layer(f"model.decoder.layers.{i}", dt, cross=True)
    shapes["model.decoder.layer_norm.weight"] = (dt,)
    shapes["model.decoder.layer_norm.bias"] = (dt,)
    shapes["proj_out.weight"] = (cfg.n_vocab, dt)
    return shapes


def synthetic_hf_whisper(cfg, device: DeviceLike) -> Dict[str, torch.Tensor]:
    """A zero-filled f32 HF Whisper state dict at cfg's REAL dims, made on
    ``device``, with the key layout transformers serializes (the
    converter's input contract)."""
    sd = {
        name: torch.zeros(shape, dtype=torch.float32, device=device)
        for name, shape in hf_whisper_shapes(cfg).items()
        if name != "proj_out.weight"
    }
    sd["proj_out.weight"] = sd["model.decoder.embed_tokens.weight"]  # tied, as in HF
    return sd


def whisper_selftest(size: str, forward: bool = True, device: DeviceLike = "cuda") -> Dict:
    """Convert a synthetic full-dims HF checkpoint on ``device`` and
    validate the resulting tree (and optionally one forward). Returns the
    JAX package's report keys; raises on any mismatch."""
    from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS, resolve_model_name
    from wis_tpu_torch.models.whisper.weights import params_from_hf, random_params

    device = resolve_device(device)
    cfg = WHISPER_CONFIGS[resolve_model_name(size)]

    def synced():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    t0 = synced()
    tensors = synthetic_hf_whisper(cfg, device)
    t_build = synced() - t0

    t0 = synced()
    params = params_from_hf(tensors, cfg, torch.bfloat16, device)
    t_convert = synced() - t0
    del tensors

    # the converted tree must match the architecture tree exactly — made on
    # the meta device, it holds shapes and dtypes and no memory
    expect = _spec(random_params(cfg, 0, "meta", torch.bfloat16))
    got = _spec(params)
    if got != expect:
        diffs = [f"{k}: got {got.get(k)} want {expect.get(k)}"
                 for k in sorted(set(got) | set(expect)) if got.get(k) != expect.get(k)]
        raise AssertionError(
            f"converted tree diverges from architecture at {len(diffs)} leaves: {diffs[:5]}"
        )

    report = {
        "model": cfg.name,
        "params": int(sum(x.numel() for x in _leaves(params))),
        "param_bytes": int(sum(x.numel() * x.element_size() for x in _leaves(params))),
        "build_s": round(t_build, 1),
        "convert_s": round(t_convert, 1),
    }

    if forward:
        from wis_tpu_torch.models.whisper.model import cross_kv, encode

        t0 = synced()
        with torch.inference_mode():
            mel = torch.zeros((1, cfg.n_mels, 2 * cfg.n_audio_ctx), device=device)
            xa = encode(params, mel, cfg)
            kv = cross_kv(params, xa, cfg)
            ok = bool(torch.isfinite(xa).all()) and all(bool(torch.isfinite(t).all()) for t in kv)
        report["forward_s"] = round(synced() - t0, 1)
        report["encoder_out"] = tuple(xa.shape)
        if not ok:
            raise AssertionError("non-finite encoder output at full dims")
    return report


# --------------------------------------------------------------------------- #
# XTTS
# --------------------------------------------------------------------------- #
def synthetic_coqui_sd(gpt_cfg, voc_cfg, seed=None) -> Dict[str, torch.Tensor]:
    """The published XTTS-v2 ``model.pth`` keys of the GPT and the HiFi-GAN
    at the given dims, f32 on the CPU (the published position tables carry
    +2/+3 start/stop rows over the config maxima; the vocoder's convolutions
    are weight-normed, ``weight_g``/``weight_v``). Zero-filled (``weight_g``
    ones) as the JAX package's ``synthetic_coqui_sd``; with a ``seed``,
    weights ~ N(0, 0.02²) from a ``torch.Generator`` and LayerNorm gains 1."""
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    D, L = gpt_cfg.d_model, gpt_cfg.n_layer

    def w(*shape):
        if gen is None:
            return torch.zeros(shape)
        return torch.randn(shape, generator=gen) * 0.02

    def gain(*shape):
        return torch.ones(shape) if gen is not None else torch.zeros(shape)

    z = torch.zeros
    text_pos = gpt_cfg.max_text_tokens + 2
    mel_pos = gpt_cfg.max_audio_tokens + 3
    sd = {
        "gpt.text_embedding.weight": w(gpt_cfg.n_text_vocab, D),
        "gpt.text_pos_embedding.emb.weight": w(text_pos, D),
        "gpt.mel_embedding.weight": w(gpt_cfg.n_audio_vocab, D),
        "gpt.mel_pos_embedding.emb.weight": w(mel_pos, D),
        "gpt.gpt.ln_f.weight": gain(D),
        "gpt.gpt.ln_f.bias": z(D),
        "gpt.final_norm.weight": gain(D),
        "gpt.final_norm.bias": z(D),
        "gpt.text_head.weight": w(gpt_cfg.n_text_vocab, D),
        "gpt.text_head.bias": z(gpt_cfg.n_text_vocab),
        "gpt.mel_head.weight": w(gpt_cfg.n_audio_vocab, D),
        "gpt.mel_head.bias": z(gpt_cfg.n_audio_vocab),
    }
    for i in range(L):
        p = f"gpt.gpt.h.{i}."
        sd[p + "ln_1.weight"] = gain(D)
        sd[p + "ln_1.bias"] = z(D)
        sd[p + "attn.bias"] = torch.ones((1, 1, mel_pos, mel_pos))
        sd[p + "attn.masked_bias"] = torch.tensor(-1e4)
        sd[p + "attn.c_attn.weight"] = w(D, 3 * D)
        sd[p + "attn.c_attn.bias"] = z(3 * D)
        sd[p + "attn.c_proj.weight"] = w(D, D)
        sd[p + "attn.c_proj.bias"] = z(D)
        sd[p + "ln_2.weight"] = gain(D)
        sd[p + "ln_2.bias"] = z(D)
        sd[p + "mlp.c_fc.weight"] = w(D, 4 * D)
        sd[p + "mlp.c_fc.bias"] = z(4 * D)
        sd[p + "mlp.c_proj.weight"] = w(4 * D, D)
        sd[p + "mlp.c_proj.bias"] = z(D)
    h = "hifigan_decoder.waveform_decoder."

    def wn(prefix, *shape):
        sd[prefix + ".weight_v"] = w(*shape)
        sd[prefix + ".weight_g"] = torch.ones((shape[0],) + (1,) * (len(shape) - 1))

    ch = voc_cfg.upsample_initial
    wn(h + "conv_pre", ch, voc_cfg.in_dim, 7)
    sd[h + "conv_pre.bias"] = z(ch)
    sd[h + "cond_layer.weight"] = w(ch, voc_cfg.cond_dim, 1)
    sd[h + "cond_layer.bias"] = z(ch)
    for i, k in enumerate(voc_cfg.upsample_kernels):
        out = ch // 2
        wn(h + f"ups.{i}", ch, out, k)
        sd[h + f"ups.{i}.bias"] = z(out)
        for j, rk in enumerate(voc_cfg.resblock_kernels):
            ridx = i * len(voc_cfg.resblock_kernels) + j
            for d in range(len(voc_cfg.resblock_dilations[j])):
                for conv in ("convs1", "convs2"):
                    wn(h + f"resblocks.{ridx}.{conv}.{d}", out, out, rk)
                    sd[h + f"resblocks.{ridx}.{conv}.{d}.bias"] = z(out)
        ch = out
    wn(h + "conv_post", 1, ch, 7)
    sd[h + "conv_post.bias"] = z(1)
    return sd
