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

:func:`hf_wavlm_shapes` lists an HF ``WavLMForXVector`` state dict the same
way (``chip_smoke.py`` writes a seeded one and loads it).

:func:`synthetic_coqui_sd` is the JAX package's XTTS v2 ``model.pth`` key
list (the GPT and HiFi-GAN, and with a conditioning config the
conditioning encoder's keys), zero-filled as there or, given a seed,
filled with seeded values so that a stream and a clone from it differ from
those of the seeded random trees (``chip_smoke.py`` loads one at full
width). :func:`xtts_selftest` converts the zero-filled list at XTTS v2's
dims and checks the trees, as ``wis_tpu.utils.selftest.xtts_selftest``
does; it is ``python -m wis_tpu_torch.cli convert-model --selftest xtts``.
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
    elif isinstance(tree, (list, tuple)):
        for v in tree:
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
# WavLM
# --------------------------------------------------------------------------- #
def hf_wavlm_shapes(cfg, weighted_layer_sum: bool = False) -> Dict[str, Tuple[int, ...]]:
    """{key: shape} of an HF ``WavLMForXVector`` state dict at cfg's dims
    (post-LN encoder, group-norm feature extractor, HF's default two labels
    in the classifier's objective; with ``weighted_layer_sum``, the
    ``layer_weights`` of ``use_weighted_layer_sum=True``, else none),
    in transformers' order; written out by hand, as the card's machine has
    no ``transformers`` (a CPU test holds it equal to the package's)."""
    h = cfg.hidden_size
    # the model's own parameter comes before its submodules' in state_dict
    shapes = {"layer_weights": (cfg.num_layers + 1,)} if weighted_layer_sum else {}
    shapes["wavlm.masked_spec_embed"] = (h,)
    c_in = 1
    for i, (c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        p = f"wavlm.feature_extractor.conv_layers.{i}."
        shapes[p + "conv.weight"] = (c, c_in, k)
        if cfg.conv_bias:
            shapes[p + "conv.bias"] = (c,)
        if i == 0:
            shapes[p + "layer_norm.weight"] = (c,)
            shapes[p + "layer_norm.bias"] = (c,)
        c_in = c
    d = cfg.conv_dim[-1]
    pc = "wavlm.encoder.pos_conv_embed.conv."
    shapes.update({
        "wavlm.feature_projection.layer_norm.weight": (d,),
        "wavlm.feature_projection.layer_norm.bias": (d,),
        "wavlm.feature_projection.projection.weight": (h, d),
        "wavlm.feature_projection.projection.bias": (h,),
        pc + "bias": (h,),
        pc + "parametrizations.weight.original0": (1, 1, cfg.num_conv_pos_embeddings),
        pc + "parametrizations.weight.original1": (
            h, h // cfg.num_conv_pos_embedding_groups, cfg.num_conv_pos_embeddings),
        "wavlm.encoder.layer_norm.weight": (h,),
        "wavlm.encoder.layer_norm.bias": (h,),
    })
    for i in range(cfg.num_layers):
        p = f"wavlm.encoder.layers.{i}."
        shapes[p + "attention.gru_rel_pos_const"] = (1, cfg.num_heads, 1, 1)
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            shapes[p + f"attention.{proj}.weight"] = (h, h)
            shapes[p + f"attention.{proj}.bias"] = (h,)
        shapes[p + "attention.gru_rel_pos_linear.weight"] = (8, h // cfg.num_heads)
        shapes[p + "attention.gru_rel_pos_linear.bias"] = (8,)
        if i == 0:
            shapes[p + "attention.rel_attn_embed.weight"] = (cfg.num_buckets, cfg.num_heads)
        shapes.update({
            p + "layer_norm.weight": (h,),
            p + "layer_norm.bias": (h,),
            p + "feed_forward.intermediate_dense.weight": (cfg.intermediate_size, h),
            p + "feed_forward.intermediate_dense.bias": (cfg.intermediate_size,),
            p + "feed_forward.output_dense.weight": (h, cfg.intermediate_size),
            p + "feed_forward.output_dense.bias": (h,),
            p + "final_layer_norm.weight": (h,),
            p + "final_layer_norm.bias": (h,),
        })
    shapes["projector.weight"] = (cfg.tdnn_dim[0], h)
    shapes["projector.bias"] = (cfg.tdnn_dim[0],)
    for i, (c, k) in enumerate(zip(cfg.tdnn_dim, cfg.tdnn_kernel)):
        c_in = cfg.tdnn_dim[i - 1] if i > 0 else cfg.tdnn_dim[0]
        shapes[f"tdnn.{i}.kernel.weight"] = (c, c_in * k)
        shapes[f"tdnn.{i}.kernel.bias"] = (c,)
    out = cfg.xvector_output_dim
    shapes.update({
        "feature_extractor.weight": (out, 2 * cfg.tdnn_dim[-1]),
        "feature_extractor.bias": (out,),
        "classifier.weight": (out, out),
        "classifier.bias": (out,),
        "objective.weight": (out, 2),
    })
    return shapes


# --------------------------------------------------------------------------- #
# XTTS
# --------------------------------------------------------------------------- #
def synthetic_coqui_sd(gpt_cfg, voc_cfg, cond_cfg=None, seed=None) -> Dict[str, torch.Tensor]:
    """The published XTTS-v2 ``model.pth`` keys of the GPT and the HiFi-GAN
    at the given dims, f32 on the CPU (the published position tables carry
    +2/+3 start/stop rows over the config maxima; the vocoder's convolutions
    are weight-normed, ``weight_g``/``weight_v``), and with ``cond_cfg``
    those of the conditioning encoder and ``mel_stats``: the JAX package's
    ``synthetic_coqui_sd(gpt_cfg, voc_cfg, cond_cfg)``. Zero-filled
    (``weight_g`` and ``mel_stats`` ones) as there; with a ``seed``, weights
    ~ N(0, 0.02²) from a ``torch.Generator``, LayerNorm, GroupNorm and RMSNorm
    gains 1 (the conditioning keys drawn after the rest, so the GPT and
    HiFi-GAN values do not depend on ``cond_cfg``)."""
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
    if cond_cfg is None:
        return sd
    sd["mel_stats"] = torch.ones(cond_cfg.n_mels)
    c = "gpt.conditioning_encoder."
    sd[c + "init.weight"] = w(D, cond_cfg.n_mels, 1)
    sd[c + "init.bias"] = z(D)
    for i in range(cond_cfg.n_blocks):
        b = c + f"attn.{i}."
        sd[b + "norm.weight"] = gain(D)
        sd[b + "norm.bias"] = z(D)
        sd[b + "qkv.weight"] = w(3 * D, D, 1)
        sd[b + "qkv.bias"] = z(3 * D)
        sd[b + "proj_out.weight"] = w(D, D, 1)
        sd[b + "proj_out.bias"] = z(D)
    q = "gpt.conditioning_perceiver."
    inner = cond_cfg.perceiver_heads * cond_cfg.perceiver_dim_head
    ff = cond_cfg.ff_mult * D
    sd[q + "latents"] = w(cond_cfg.n_latents, D)
    for i in range(cond_cfg.perceiver_depth):
        a = q + f"layers.{i}.0."
        f = q + f"layers.{i}.1."
        sd[a + "norm.gamma"] = gain(D)
        sd[a + "to_q.weight"] = w(inner, D)
        sd[a + "to_kv.weight"] = w(2 * inner, D)
        sd[a + "to_out.weight"] = w(D, inner)
        sd[f + "0.gamma"] = gain(D)
        sd[f + "1.weight"] = w(ff, D)
        sd[f + "1.bias"] = z(ff)
        sd[f + "3.weight"] = w(D, ff)
        sd[f + "3.bias"] = z(D)
    sd[q + "norm.gamma"] = gain(D)
    return sd


def xtts_selftest(forward: bool = True, device: DeviceLike = "cuda") -> Dict:
    """Convert the zero-filled XTTS v2 ``model.pth`` key list at XTTS v2's
    dims on ``device`` and check the trees:
    every conditioning key read, the GPT and vocoder shapes. With
    ``forward``, one vocoder call, one GPT prefill and one conditioning
    pass over a 30 s log-mel, each finite. Returns the JAX package's report
    keys (and ``cond_out``); raises on any mismatch."""
    from wis_tpu_torch.models.xtts.conditioning import ConditioningConfig, conditioning_forward
    from wis_tpu_torch.models.xtts.convert import (
        conditioning_from_coqui,
        gpt_from_coqui,
        hifigan_from_coqui,
    )
    from wis_tpu_torch.models.xtts.model import XTTSConfig

    device = resolve_device(device)
    cfg = XTTSConfig()
    cond_cfg = ConditioningConfig()

    def synced():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    t0 = synced()
    sd = synthetic_coqui_sd(cfg.gpt, cfg.vocoder, cond_cfg)
    t_build = synced() - t0

    t0 = synced()
    gpt_params = gpt_from_coqui(sd, cfg.gpt, torch.bfloat16, device)
    voc_params = hifigan_from_coqui(sd, cfg.vocoder, torch.bfloat16, device)
    cond_params = conditioning_from_coqui(sd, cond_cfg, torch.float32, device)
    t_convert = synced() - t0
    unmapped = cond_params.pop("_unmapped")
    if unmapped:
        raise AssertionError(f"conditioning keys not converted: {unmapped}")

    L, D, voc = cfg.gpt.n_layer, cfg.gpt.d_model, cfg.vocoder
    checks = {
        "blocks/q_w": (tuple(gpt_params["blocks"]["q_w"].shape), (L, D, D)),
        "blocks/mlp_w1": (tuple(gpt_params["blocks"]["mlp_w1"].shape), (L, D, 4 * D)),
        "text_emb": (tuple(gpt_params["text_emb"].shape), (cfg.gpt.n_text_vocab, D)),
        "head_w": (tuple(gpt_params["head_w"].shape), (D, cfg.gpt.n_audio_vocab)),
        # transposed-conv weights land as (k, out, in)
        "ups/0/w": (tuple(voc_params["ups"][0]["w"].shape[1:]),
                    (voc.upsample_initial // 2, voc.upsample_initial)),
        "cond init_w": (tuple(cond_params["init_w"].shape), (cond_cfg.n_mels, D)),
    }
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    if bad:
        raise AssertionError(f"converted XTTS trees diverge: {bad}")

    trees = (gpt_params, voc_params, cond_params)
    report = {
        "model": "xtts-v2",
        "keys": len(sd),
        "param_bytes": int(sum(x.numel() * x.element_size() for t in trees for x in _leaves(t))),
        "build_s": round(t_build, 1),
        "convert_s": round(t_convert, 1),
    }
    del sd

    if forward:
        from wis_tpu_torch.models.xtts.gpt import build_prefill
        from wis_tpu_torch.models.xtts.hifigan import hifigan_forward

        t0 = synced()
        with torch.inference_mode():
            latents = torch.zeros((1, 8, voc.in_dim), dtype=torch.bfloat16, device=device)
            speaker = torch.zeros((1, voc.cond_dim), dtype=torch.bfloat16, device=device)
            wav = hifigan_forward(voc_params, latents, speaker, voc)
            prefill = build_prefill(cfg.gpt, batch=1, cond_len=cfg.cond_len, text_len=16,
                                    max_len=128)
            hidden, _cache = prefill(
                gpt_params, torch.zeros((1, cfg.cond_len, D), dtype=torch.bfloat16, device=device),
                torch.zeros((1, 16), dtype=torch.long, device=device))
            cond = conditioning_forward(
                cond_params, torch.zeros((1, cond_cfg.n_mels, 3000), device=device), cond_cfg)
            finite = {name: bool(torch.isfinite(t.float()).all())
                      for name, t in (("vocoder", wav), ("prefill", hidden), ("cond", cond))}
        report["forward_s"] = round(synced() - t0, 1)
        report["vocoder_out"] = tuple(wav.shape)
        report["cond_out"] = tuple(cond.shape)
        if not all(finite.values()):
            raise AssertionError(f"non-finite output at full dims: {finite}")
    return report
