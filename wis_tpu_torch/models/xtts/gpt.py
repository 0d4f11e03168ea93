"""XTTS GPT — the conditioned audio-token decoder (port of
``wis_tpu/models/xtts/gpt.py``).

Coqui XTTS v2's core is a GPT-2-style decoder that emits discrete audio
codes conditioned on a speaker prefix and the text:

    [gpt_cond_latent (N_cond, D)] [text tokens] [START_AUDIO] → audio codes

The tree keeps the JAX package's layout (stacked layers with a leading
layer axis, (in, out) matmul weights, int8 leaves as ``{"q", "s"}``). Two
decode paths, as in the JAX package:

- ``run_decode_chunk`` (the CPU, and ``fused="off"``): ``gpt_pass`` per
  token over the whole (L, B, H, T, Dh) cache, attention as a plain masked
  matmul, then the sampling epilogue in plain PyTorch.
- ``run_decode_chunk_fused`` (the card's default): the all-layers step of
  ``ops/fused_gpt.py`` over the flat time-major cache, then either the same
  epilogue or, with ``head_fn``, the fused sampling head of
  ``ops/fused_gpt_head.py``.

Differences from the JAX functions, none of which changes a result:

- The sampling functions take the **gumbel rows** instead of a PRNG key:
  ``jax.random.categorical(key, l)`` is ``argmax(l + gumbel(key, l.shape))``,
  so a test that passes JAX's rows gets JAX's draws. ``gumbel`` holds one
  (B, V) row per step of the chunk.
- The cache position, ``pos`` and ``hist_len`` are host integers: each
  advances by exactly one per step, so the host predicts them and nothing
  syncs per token. A chunk keeps stepping after ``done`` (the tokens are
  forced to stop), as in the JAX scan.
- Caches are updated in place (JAX donates them).

Tensor parallelism: ``gpt_pass``, ``GPTCache.zeros``, ``build_prefill``
and ``run_decode_chunk`` take ``tp``, this rank's model axis
(``parallel/axis.ModelAxis``), with ``params`` this rank's shard
(``parallel/mesh.xtts_gpt_param_specs``): heads are counted from the
local width, proj_w and mlp_w2 are all-reduced in f32 before their
rounding and bias, and the cache holds this rank's heads
(``xtts_cache_spec``). The fused step keeps whole heads of every layer in
one launch, so ``run_decode_chunk_fused`` refuses ``tp``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from wis_tpu_torch.ops.gelu import gelu_tanh
from wis_tpu_torch.ops.quant import qmatmul
from wis_tpu_torch.parallel.axis import ModelAxis, local_heads, row_parallel

NEG = -1e30


@dataclass(frozen=True)
class GPTConfig:
    n_layer: int = 30
    n_head: int = 16
    d_model: int = 1024
    n_text_vocab: int = 6681
    n_audio_vocab: int = 1026  # 1024 codes + start + stop
    max_text_tokens: int = 402
    max_audio_tokens: int = 605
    max_cond_len: int = 32  # gpt_cond_latent rows
    start_audio_token: int = 1024
    stop_audio_token: int = 1025


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LayerNorm with f32 statistics, output in x.dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = torch.square(x32 - mu).mean(-1, keepdim=True)
    return (((x32 - mu) * torch.rsqrt(var + 1e-5)) * g + b).to(x.dtype)


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim f32 tensor on like's device. Dividing by it is an IEEE
    division on the card too (a Python scalar divisor becomes a multiply
    by its reciprocal there)."""
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


class GPTCache(NamedTuple):
    k: torch.Tensor  # (L, B, H, T_max, Dh)
    v: torch.Tensor
    pos: int

    @classmethod
    def zeros(cls, cfg: GPTConfig, batch: int, max_len: int,
              dtype=torch.bfloat16, device="cpu", tp: Optional[ModelAxis] = None):
        shape = (cfg.n_layer, batch, local_heads(cfg.n_head, tp), max_len,
                 cfg.d_model // cfg.n_head)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def _layer(leaf, l: int):
    if isinstance(leaf, dict):
        return {k: v[l] for k, v in leaf.items()}
    return leaf[l]


def gpt_pass(params: Dict, x: torch.Tensor, pos_offset: int, cache: GPTCache,
             cfg: GPTConfig, tp: Optional[ModelAxis] = None):
    """Run T embedded positions (B, T, D) through the decoder, writing their
    K/V into the cache in place at pos_offset. → (final hidden states
    (B, T, D) after both final LayerNorms, the cache)."""
    b, t, d = x.shape
    h = local_heads(cfg.n_head, tp)
    dh = d // cfg.n_head
    max_len = cache.k.shape[3]
    dtype = cache.k.dtype
    key_pos = torch.arange(max_len, device=x.device)[None, :]
    query_pos = (pos_offset + torch.arange(t, device=x.device))[:, None]
    mask = key_pos <= query_pos

    def heads(a):
        return a.reshape(b, t, h, dh).transpose(1, 2)

    for l in range(cfg.n_layer):
        blk = {k: _layer(v, l) for k, v in params["blocks"].items()}
        hdn = _ln(x, blk["ln1_g"], blk["ln1_b"])
        q = heads(qmatmul(hdn, blk["q_w"]) + blk["q_b"])
        k_new = heads(qmatmul(hdn, blk["k_w"]) + blk["k_b"])
        v_new = heads(qmatmul(hdn, blk["v_w"]) + blk["v_b"])
        ck, cv = cache.k[l], cache.v[l]
        ck[:, :, pos_offset:pos_offset + t] = k_new.to(dtype)
        cv[:, :, pos_offset:pos_offset + t] = v_new.to(dtype)
        scores = (q.float() @ ck.float().transpose(-1, -2)) * (dh ** -0.5)
        scores = torch.where(mask, scores, NEG)
        w = torch.softmax(scores, dim=-1).to(cv.dtype)
        ctx = (w @ cv).transpose(1, 2).reshape(b, t, h * dh)
        x = x + (row_parallel(ctx, blk["proj_w"], tp) + blk["proj_b"]).to(x.dtype)
        hdn = _ln(x, blk["ln2_g"], blk["ln2_b"])
        ff = gelu_tanh(qmatmul(hdn, blk["mlp_w1"]) + blk["mlp_b1"])
        x = x + (row_parallel(ff, blk["mlp_w2"], tp) + blk["mlp_b2"]).to(x.dtype)
    # Coqui XTTS applies TWO final LayerNorms: GPT2Model's ln_f and then
    # the model's own final_norm
    x = _ln(x, params["gpt_lnf_g"], params["gpt_lnf_b"])
    x = _ln(x, params["lnf_g"], params["lnf_b"])
    return x, cache


def embed_prompt(params: Dict, cond_latent: torch.Tensor, text_tokens: torch.Tensor,
                 cfg: GPTConfig) -> torch.Tensor:
    """The GPT input prefix: conditioning latents ++ embedded text ++ the
    START_AUDIO embedding (text and audio have their own position tables)."""
    dtype = params["text_emb"].dtype
    bsz, t_text = text_tokens.shape
    text = params["text_emb"][text_tokens]
    text = text + params["text_pos"][:t_text][None].to(dtype)
    start = params["audio_emb"][cfg.start_audio_token].expand(bsz, 1, -1)
    start = start + params["audio_pos"][0][None, None].to(dtype)
    return torch.cat([cond_latent.to(dtype), text, start], dim=1)


def build_prefill(cfg: GPTConfig, batch: int, cond_len: int, text_len: int, max_len: int,
                  tp: Optional[ModelAxis] = None):
    """The prefix pass: embeds conditioning + text, fills a fresh cache,
    returns (last hidden state, cache)."""

    def prefill(params, cond_latent, text_tokens):
        dtype = params["text_emb"].dtype
        cache = GPTCache.zeros(cfg, batch, max_len, dtype, cond_latent.device, tp)
        x = embed_prompt(params, cond_latent, text_tokens, cfg)
        hidden, cache = gpt_pass(params, x, 0, cache, cfg, tp)
        return hidden[:, -1], cache._replace(pos=cond_len + text_len + 1)

    return prefill


def _mask_logits(logits, prev_tokens, temperature, top_k, top_p, repetition_penalty):
    """The HF logits-processor stack Coqui's generate uses —
    RepetitionPenalty → Temperature → TopK → TopP, in that order — with
    masked entries at -1e30. logits (B, V) f32; prev_tokens (B, T_hist)
    int64. A zero-padded history counts token 0 as emitted, as the JAX
    package's one-hot does."""
    v = logits.shape[-1]
    hist = torch.zeros(logits.shape, dtype=torch.bool, device=logits.device)
    hist.scatter_(1, prev_tokens, True)
    rp = _f32(repetition_penalty, logits)
    penalized = torch.where(logits > 0, logits / rp, logits * rp)
    logits = torch.where(hist, penalized, logits)
    logits = logits / _f32(max(float(np.float32(temperature)), 1e-5), logits)

    # top-k: mask everything below the k-th largest logit
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k_idx = min(max(int(top_k) - 1, 0), v - 1)
    kth = sorted_desc[:, k_idx:k_idx + 1]
    logits = torch.where(logits < kth, NEG, logits)

    # top-p (nucleus): mask tokens beyond cumulative probability p
    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    cutoff = (cum - probs_sorted < _f32(top_p, logits)).sum(dim=-1, keepdim=True)
    pth = sorted_desc.gather(1, torch.clamp(cutoff - 1, 0, v - 1))
    return torch.where(logits < pth, NEG, logits)


def _sample_token(logits, prev_tokens, gumbel, temperature, top_k, top_p,
                  repetition_penalty, do_sample: bool):
    """Sampling with the reference's knobs: the categorical draw is
    ``argmax(gumbel + masked)`` (gumbel (B, V) f32), greedy the argmax of
    the masked logits, lowest index on ties. → (B,) int64."""
    masked = _mask_logits(logits, prev_tokens, temperature, top_k, top_p, repetition_penalty)
    if do_sample:
        return torch.argmax(gumbel + masked, dim=-1)
    return torch.argmax(masked, dim=-1)


def _audio_embed(params, tok, audio_pos: int):
    """Token + position embedding, in the table's dtype. The position is
    clamped to the table, as ``jnp.take(mode="clip")`` does at the cap."""
    table = params["audio_pos"]
    return params["audio_emb"][tok] + table[min(max(audio_pos, 0), table.shape[0] - 1)]


def _stop_floor(logits, cfg: GPTConfig, blocked: bool):
    """The stop token at -1e30 while fewer than min_tokens were emitted."""
    if blocked:
        logits[:, cfg.stop_audio_token] = NEG
    return logits


def _finish_step(nxt, done, history, hist_len: int, cfg: GPTConfig):
    """Tokens after stop are forced to stop; the token joins the history."""
    stop = cfg.stop_audio_token
    nxt = torch.where(done, stop, nxt)
    done = done | (nxt == stop)
    history[:, min(hist_len, history.shape[1] - 1)] = nxt
    return nxt, done


def run_decode_chunk(params, last_token, cache: GPTCache, history, hist_len: int, gumbel,
                     temperature, top_k, top_p, repetition_penalty, do_sample: bool,
                     min_tokens: int = 0, *, cfg: GPTConfig, chunk: int, batch: int,
                     tp: Optional[ModelAxis] = None):
    """Emit ``chunk`` audio tokens through ``gpt_pass`` (the eager path;
    tensor-parallel under ``tp``).

    last_token (B,) int64 (START_AUDIO for the first chunk); history
    (B, max_audio) int64, written in place; gumbel (chunk, B, V) f32.
    → (tokens (B, chunk), latents (B, chunk, D) — the final hidden states,
    the vocoder's input — cache, history, hist_len, done (B,) bool)."""
    tok = last_token
    done = torch.zeros(batch, dtype=torch.bool, device=last_token.device)
    tokens, latents = [], []
    for i in range(chunk):
        x = _audio_embed(params, tok, hist_len + 1)[:, None, :]  # start token = pos 0
        hidden, cache = gpt_pass(params, x, cache.pos, cache, cfg, tp)
        cache = cache._replace(pos=cache.pos + 1)
        logits = (hidden[:, 0] @ params["head_w"] + params["head_b"]).float()
        logits = _stop_floor(logits, cfg, hist_len < min_tokens)
        nxt = _sample_token(logits, history, gumbel[i], temperature, top_k, top_p,
                            repetition_penalty, do_sample)
        tok, done = _finish_step(nxt, done, history, hist_len, cfg)
        hist_len += 1
        tokens.append(tok)
        latents.append(hidden[:, 0])
    return (torch.stack(tokens, dim=1), torch.stack(latents, dim=1), cache, history,
            hist_len, done)


def flatten_gpt_cache(cache: GPTCache, t_pad: int):
    """(L, B, H, T, Dh) cache → the fused step's flat time-major
    (L, D, t_pad·B) bf16 layout (flat column t·B + row, heads merged into
    D): truncated to the first t_pad positions when a cache-length bucket
    smaller than the prefill's T is chosen (only that prefix holds data),
    zero-padded otherwise."""
    L, B, H, T, Dh = cache.k.shape
    keep = min(T, t_pad)

    def fl(c):
        flat = c.permute(0, 2, 4, 3, 1).reshape(L, H * Dh, T * B)
        return F.pad(flat[:, :, : keep * B], (0, (t_pad - keep) * B)).to(torch.bfloat16)

    return fl(cache.k), fl(cache.v)


def run_decode_chunk_fused(params, packed, step_fn, last_token, kc, vc, pos: int, history,
                           hist_len: int, gumbel, temperature, top_k, top_p,
                           repetition_penalty, do_sample: bool, min_tokens: int = 0,
                           head_packed=None, *, cfg: GPTConfig, chunk: int, batch: int,
                           head_fn=None, tp: Optional[ModelAxis] = None):
    """``run_decode_chunk`` with the layer loop replaced by the fused step
    (``step_fn``: all layers per call, the flat caches (L, D, B·t_pad)
    updated in place at column pos·B + row). Same sampling staging, so given
    equal gumbel rows the tokens match the eager path.

    With ``head_fn``/``head_packed`` (batch 1), the per-token epilogue —
    double LN, audio head, stop floor, penalty, temperature, top-k/top-p,
    the draw — is the fused head; the penalty then reads a (1, V_pad)
    hit-mask set from ``history`` at chunk entry and updated per token,
    which masks exactly as ``_mask_logits``' one-hot does.
    → (tokens, latents, kc, vc, pos, history, hist_len, done).

    ``tp`` is refused: the fused step runs every layer in one launch on
    one device (the eager ``run_decode_chunk`` takes tensor parallelism)."""
    if tp is not None:
        raise ValueError("the fused GPT step runs on one device: tensor parallelism (tp) "
                         "takes the eager run_decode_chunk")
    dtype = params["text_emb"].dtype
    dev = last_token.device
    bkt = kc.shape[-1]
    col = torch.arange(bkt, device=dev)
    col_t = (col // batch)[None, :]
    own = (col % batch)[None, :] == torch.arange(batch, device=dev)[:, None]
    v = cfg.n_audio_vocab
    if head_fn is not None:
        if batch != 1:
            raise ValueError("the fused sampling head takes one stream (batch 1)")
        ln4, head_w, head_b = head_packed
        vp = head_w.shape[-1]
        hist_mask = torch.zeros((batch, vp), dtype=torch.float32, device=dev)
        hist_mask.scatter_(1, history, 1.0)
        gum = F.pad(gumbel, (0, vp - v))
        knobs = np.zeros((chunk, 1, 8), np.float32)
        knobs[:, 0, :4] = (temperature, float(top_k), top_p, repetition_penalty)
        knobs[:, 0, 4] = [hist_len + i < min_tokens for i in range(chunk)]
        knobs[:, 0, 5] = float(do_sample)
        knobs = torch.from_numpy(knobs).to(dev)
    tok = last_token
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    tokens, latents = [], []
    for i in range(chunk):
        x = _audio_embed(params, tok, hist_len + 1).float()
        sel = ((col_t < pos) & own).float()
        xh, kc, vc = step_fn(packed, x, kc, vc, sel, pos)
        if head_fn is not None:
            tok_out, hidden32, _ = head_fn(xh, ln4, head_w, head_b, hist_mask, gum[i], knobs[i])
            hidden = hidden32.to(dtype)
            nxt = tok_out[:, 0].long()
        else:
            h1 = _ln(xh.to(dtype), params["gpt_lnf_g"], params["gpt_lnf_b"])
            hidden = _ln(h1, params["lnf_g"], params["lnf_b"])
            logits = (hidden @ params["head_w"] + params["head_b"]).float()
            logits = _stop_floor(logits, cfg, hist_len < min_tokens)
            nxt = _sample_token(logits, history, gumbel[i], temperature, top_k, top_p,
                                repetition_penalty, do_sample)
        tok, done = _finish_step(nxt, done, history, hist_len, cfg)
        if head_fn is not None:
            hist_mask.scatter_(1, tok[:, None], 1.0)
        pos += 1
        hist_len += 1
        tokens.append(tok)
        latents.append(hidden)
    return (torch.stack(tokens, dim=1), torch.stack(latents, dim=1), kc, vc, pos, history,
            hist_len, done)


def random_gpt(cfg: GPTConfig, seed: int = 0, dtype=torch.bfloat16, device="cpu") -> Dict:
    """Seeded random weights equal, leaf for leaf and bit for bit, to the JAX
    package's ``random_gpt(cfg, seed, dtype)``: the same numpy draws in the
    same order, made on the host and moved to ``device`` once."""
    rng = np.random.default_rng(seed)
    L, D, Fd = cfg.n_layer, cfg.d_model, 4 * cfg.d_model

    def host(a, dt):
        # numpy f64 → f32 → dt, the rounding path jnp.asarray takes
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dt)

    def dense(*shape, scale=None):
        scale = scale or 1.0 / np.sqrt(shape[-2] if len(shape) > 1 else shape[0])
        return host(rng.standard_normal(shape).astype(np.float32) * scale, dtype)

    def const(fill, *shape, dt=dtype):
        return torch.full(shape, fill, dtype=dt, device=device)

    f32 = torch.float32
    return {
        "text_emb": dense(cfg.n_text_vocab, D, scale=0.02),
        "text_pos": dense(cfg.max_text_tokens, D, scale=0.02),
        "audio_emb": dense(cfg.n_audio_vocab, D, scale=0.02),
        # +2 headroom rows like Coqui's LearnedPositionEmbeddings: the start
        # token takes position 0, so the cap-th token indexes max + 1
        "audio_pos": dense(cfg.max_audio_tokens + 2, D, scale=0.02),
        "blocks": {
            "ln1_g": const(1.0, L, D, dt=f32),
            "ln1_b": const(0.0, L, D, dt=f32),
            "q_w": dense(L, D, D),
            "q_b": const(0.0, L, D),
            "k_w": dense(L, D, D),
            "k_b": const(0.0, L, D),
            "v_w": dense(L, D, D),
            "v_b": const(0.0, L, D),
            "proj_w": dense(L, D, D),
            "proj_b": const(0.0, L, D),
            "ln2_g": const(1.0, L, D, dt=f32),
            "ln2_b": const(0.0, L, D, dt=f32),
            "mlp_w1": dense(L, D, Fd),
            "mlp_b1": const(0.0, L, Fd),
            "mlp_w2": dense(L, Fd, D),
            "mlp_b2": const(0.0, L, D),
        },
        "gpt_lnf_g": const(1.0, D, dt=f32),
        "gpt_lnf_b": const(0.0, D, dt=f32),
        "lnf_g": const(1.0, D, dt=f32),
        "lnf_b": const(0.0, D, dt=f32),
        "head_w": dense(D, cfg.n_audio_vocab),
        "head_b": const(0.0, cfg.n_audio_vocab),
    }
