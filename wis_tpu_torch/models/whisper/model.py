"""Whisper encoder-decoder in PyTorch (port of
``wis_tpu/models/whisper/model.py``).

Plain functions on a parameter tree in the JAX package's layout (every
transformer-block leaf stacked along a leading layer axis; matmul weights
(in, out); int8 leaves ``{"q", "s"}``):

    params["encoder"] = {conv1, conv2, pos (1500, D), blocks{attn_ln, attn,
                         mlp_ln, mlp}, ln_post}
    params["decoder"] = {tok_emb (V, D), pos (448, D), blocks{attn_ln, attn,
                         cross_ln, cross, mlp_ln, mlp}, ln, [tok_emb_q]}

The public layouts are the JAX package's: cross-attention K/V and the
self-attention cache are time-minor ``(L, B, H, Dh, T)``; the decoder
writes its K/V columns into the cache tensors in place.

On a CUDA device the encoder runs the hand-written Hopper kernels under the
JAX package's gates (``wis_tpu/models/whisper/model.py`` ``_attn_block``
and ``_enc_ln``), with the device type standing in for JAX's backend and
the same environment switches, read at each call: every LayerNorm with
D % 128 == 0 goes to ``ops/layernorm.layer_norm_cuda`` unless
``WIS_NO_LN_KERNEL`` is set, and self-attention takes the route
``attention_route`` names — the packed or the head-major flash kernel
(``ops/flash``, bf16 only), or the plain formula. On the CPU everything
takes the plain formulas, as the JAX package does off TPU. The eager
decoder's beam self-attention runs ``ops/decode_attn.ancestry_attention``
(the kernel on a CUDA device, its plain version on the CPU), every
int8 product the ``ops/quant.int8_matmul`` kernel (through ``qmatmul``),
and every biased product's epilogue — bias, then gelu or the residual add
that follows it — ``ops/bias_act.bias_act`` (one kernel launch on a CUDA
device, the plain chain on the CPU).

Tensor parallelism: ``encode``, ``cross_kv``, ``DecoderCache.zeros``,
``prefill`` and ``decode_step`` take ``tp``, this rank's model axis
(``parallel/axis.ModelAxis``), with ``params`` this rank's shard
(``parallel/mesh.shard_params``). Heads are counted from the local
width; each row-parallel product (o_w, w2) is all-reduced in f32 before
its rounding and bias (``parallel/axis.row_parallel``); the conv stem
all-gathers its two column-parallel outputs. ``tp=None`` is the
single-device path, bit for bit.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import torch

from wis_tpu_torch.models.whisper.config import WhisperConfig
from wis_tpu_torch.models.whisper.stem import conv_stem
from wis_tpu_torch.ops.attention import NEG_INF, merge_heads, mha, qkv_heads
from wis_tpu_torch.ops.bias_act import bias_act
from wis_tpu_torch.ops.decode_attn import ancestry_attention, global_rows
from wis_tpu_torch.ops.flash import flash_attention, flash_attention_packed
from wis_tpu_torch.ops.layernorm import layer_norm_cuda
from wis_tpu_torch.ops.layernorm import layer_norm_plain as layer_norm
from wis_tpu_torch.ops.quant import matmul_f32
from wis_tpu_torch.parallel.axis import ModelAxis, local_heads, row_parallel


def _layer(tree: dict, li: int) -> dict:
    """Layer ``li`` of a stacked-layer subtree (views, no copies)."""
    return {
        k: _layer(v, li) if isinstance(v, dict) else v[li] for k, v in tree.items()
    }


def _linear(x, w, b=None, tp: Optional[ModelAxis] = None, *, gelu=False, residual=None):
    # double rounding as in the JAX package: the matmul rounds to x.dtype,
    # then the f32 bias add rounds again. A row-parallel product (``tp``)
    # rounds after the f32 sum across the ranks, and the bias (whole on
    # every rank) is added once, after that. With a bias, the bias, the
    # optional gelu and the optional ``residual +`` run as one epilogue
    # (``ops/bias_act``: one kernel launch on the card).
    y = row_parallel(x, w, tp)
    if b is not None:
        y = bias_act(y, b, gelu=gelu, residual=residual)
    return y


def attention_route(device_type: str, t: int, d: int, n_heads: int) -> str:
    """Which attention the encoder's self-attention over (B, t, d) takes:
    ``"packed"``, ``"head_major"`` or ``"plain"`` — the JAX package's rule
    (``wis_tpu/models/whisper/model.py`` ``_attn_block``), with the device
    type for ``jax.default_backend()``. ``WIS_NO_FLASH`` sends every call to
    the plain formula, ``WIS_NO_PACKED_FLASH`` head widths 64 and 128 to the
    head-major kernel."""
    if device_type == "cpu" or t < 512 or os.environ.get("WIS_NO_FLASH"):
        return "plain"
    dh = d // n_heads
    if dh in (64, 128) and not os.environ.get("WIS_NO_PACKED_FLASH"):
        return "packed"
    return "head_major" if dh % 8 == 0 else "plain"


def _attn_block(x, blk, n_heads, tp=None, residual=None):
    """Encoder self-attention for one layer over this rank's n_heads, plus
    ``residual``. Long sequences on the card run a flash kernel, so the
    (H, T, T) scores never reach device memory: the packed one keeps q/k/v
    (B, T, D) end to end, the head-major one takes them split into heads,
    as the JAX package's does."""
    q = _linear(x, blk["q_w"], blk["q_b"])
    k = _linear(x, blk["k_w"])
    v = _linear(x, blk["v_w"], blk["v_b"])
    route = attention_route(x.device.type, x.shape[-2], x.shape[-1], n_heads)
    if route == "packed":
        return _linear(flash_attention_packed(q, k, v, n_heads), blk["o_w"], blk["o_b"], tp,
                       residual=residual)
    q, k, v = (qkv_heads(t, n_heads) for t in (q, k, v))
    if route == "head_major":
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    else:
        out = mha(q, k, v)
    return _linear(merge_heads(out), blk["o_w"], blk["o_b"], tp, residual=residual)


def _mlp(x, blk, tp=None, residual=None):
    h = _linear(x, blk["w1"], blk["b1"], gelu=True)
    return _linear(h, blk["w2"], blk["b2"], tp, residual=residual)


def layer_norm_route(device_type: str, d: int) -> str:
    """``"kernel"`` or ``"plain"`` for an encoder LayerNorm over rows of d:
    the JAX package's ``_enc_ln`` rule, ``WIS_NO_LN_KERNEL`` included."""
    if device_type != "cpu" and d % 128 == 0 and not os.environ.get("WIS_NO_LN_KERNEL"):
        return "kernel"
    return "plain"


def _enc_ln(x, g, b):
    """Encoder LayerNorm: the CUDA kernel on the card, the plain formula
    elsewhere."""
    if layer_norm_route(x.device.type, x.shape[-1]) == "kernel":
        return layer_norm_cuda(x, g, b)
    return layer_norm(x, g, b)


# --------------------------------------------------------------------------- #
# Encoder
# --------------------------------------------------------------------------- #
def encode(params: dict, mel: torch.Tensor, cfg: WhisperConfig,
           tp: Optional[ModelAxis] = None) -> torch.Tensor:
    """mel (B, n_mels, 3000) → encoder states (B, 1500, D). Under tensor
    parallelism (``tp``, this rank's model axis; ``params`` its shard) the
    states come out whole on every rank."""
    enc = params["encoder"]
    n_heads = local_heads(cfg.n_audio_head, tp)
    x = conv_stem(enc, mel, tp)
    for li in range(cfg.n_audio_layer):
        blk = _layer(enc["blocks"], li)
        x = _attn_block(
            _enc_ln(x, blk["attn_ln"]["g"], blk["attn_ln"]["b"]),
            blk["attn"],
            n_heads,
            tp,
            residual=x,
        )
        x = _mlp(_enc_ln(x, blk["mlp_ln"]["g"], blk["mlp_ln"]["b"]), blk["mlp"], tp, residual=x)
    return _enc_ln(x, enc["ln_post"]["g"], enc["ln_post"]["b"])


def cross_kv(params: dict, xa: torch.Tensor, cfg: WhisperConfig,
             tp: Optional[ModelAxis] = None):
    """Per-layer cross-attention K/V from encoder states: xa (B, 1500, D)
    → (k, v) each (L, B, H, Dh, 1500), time-minor (H this rank's heads
    under ``tp``)."""
    dec = params["decoder"]
    n_heads = local_heads(cfg.n_text_head, tp)
    ks, vs = [], []
    for li in range(cfg.n_text_layer):
        cross = _layer(dec["blocks"], li)["cross"]
        k = qkv_heads(_linear(xa, cross["k_w"]), n_heads)
        v = qkv_heads(_linear(xa, cross["v_w"], cross["v_b"]), n_heads)
        ks.append(k.transpose(-1, -2))
        vs.append(v.transpose(-1, -2))
    return torch.stack(ks), torch.stack(vs)


# --------------------------------------------------------------------------- #
# Decoder
# --------------------------------------------------------------------------- #
class DecoderCache(NamedTuple):
    """Preallocated self-attention KV cache: k, v (L, B, H, Dh, T_max),
    time-minor (H this rank's heads under ``tp``); pos — number of valid
    positions."""

    k: torch.Tensor
    v: torch.Tensor
    pos: int

    @classmethod
    def zeros(
        cls,
        cfg: WhisperConfig,
        batch: int,
        max_len: int,
        dtype: torch.dtype,
        device: torch.device,
        tp: Optional[ModelAxis] = None,
    ) -> "DecoderCache":
        shape = (
            cfg.n_text_layer,
            batch,
            local_heads(cfg.n_text_head, tp),
            cfg.n_text_state // cfg.n_text_head,
            max_len,
        )
        return cls(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
            0,
        )


def _decoder_pass(
    params: dict,
    tokens: torch.Tensor,  # (B, T) int64
    pos_offset: int,  # first token's absolute position
    cache: DecoderCache,
    xa_kv: Tuple[torch.Tensor, torch.Tensor],
    cfg: WhisperConfig,
    anc: Optional[torch.Tensor] = None,  # (Bq, K, T_max) ancestry, or None
    tp: Optional[ModelAxis] = None,
) -> Tuple[torch.Tensor, DecoderCache]:
    """Run T tokens through the decoder, writing self-attention K/V into
    the cache tensors in place at [pos_offset, pos_offset + T). Returns
    (logits (B, T, V) f32, cache advanced by T); under ``tp`` the logits
    are whole (the same bits) on every rank."""
    dec = params["decoder"]
    b, t = tokens.shape
    max_len = cache.k.shape[4]
    dtype = cache.k.dtype
    device = tokens.device

    x = dec["tok_emb"][tokens].to(dtype)
    x = x + dec["pos"][pos_offset : pos_offset + t].to(dtype)

    # attend to absolute positions <= own absolute position
    key_pos = torch.arange(max_len, device=device)[None, :]
    query_pos = torch.arange(pos_offset, pos_offset + t, device=device)[:, None]
    mask = (key_pos <= query_pos)[None, None]  # (1, 1, T, T_max)

    xa_k, xa_v = xa_kv  # (L, Bx, H, Dh, S)
    group = b // xa_k.shape[1]
    n_head = local_heads(cfg.n_text_head, tp)
    dh = cfg.n_text_state // cfg.n_text_head
    scale = dh ** -0.5

    def _self_attn(q, ck, cv):
        # q (B, H, T, Dh); ck/cv (B, H, Dh, T_max) time-minor
        scores = torch.matmul(q.float(), ck.float()) * scale
        scores = torch.where(mask, scores, NEG_INF)
        w = torch.softmax(scores, dim=-1).to(cv.dtype)
        return torch.matmul(w, cv.transpose(-1, -2))

    # Ancestry-indirect beam attention (single-token decode): beams never
    # permute the cache; anc[b, k, s] names the physical row that holds
    # logical beam k's history at position s (-1 = unwritten), and
    # ancestry_attention reads each position's key and value from that row
    # (the kernel on the card, its plain version on the CPU).
    if anc is not None:
        ganc = global_rows(anc)

    def _self_attn_anc(q, ck, cv):
        # q (BK, H, 1, Dh); ck/cv (BK, H, Dh, T_max), rows grouped (Bq, K)
        out = ancestry_attention(q[:, :, 0].contiguous(), ck, cv, ganc, pos_offset)
        return out[:, :, None]

    def _cross_attn(q, xk, xv):
        # q (B, H, T, Dh) → grouped (Bx, G, H, T, Dh); xk/xv (Bx, H, Dh, S)
        qg = q.reshape(q.shape[0] // group, group, *q.shape[1:])
        scores = torch.einsum("bghtd,bhds->bghts", qg.float(), xk.float()) * scale
        w = torch.softmax(scores, dim=-1).to(xv.dtype)
        ctx = torch.einsum("bghts,bhds->bghtd", w, xv)
        return ctx.reshape(q.shape)

    attn_fn = _self_attn_anc if anc is not None else _self_attn
    for li in range(cfg.n_text_layer):
        blk = _layer(dec["blocks"], li)
        h = layer_norm(x, blk["attn_ln"]["g"], blk["attn_ln"]["b"])
        q = qkv_heads(_linear(h, blk["attn"]["q_w"], blk["attn"]["q_b"]), n_head)
        k_new = qkv_heads(_linear(h, blk["attn"]["k_w"]), n_head)
        v_new = qkv_heads(_linear(h, blk["attn"]["v_w"], blk["attn"]["v_b"]), n_head)
        # in-place column write at [li, :, :, :, pos_offset:pos_offset+t)
        cache.k[li, :, :, :, pos_offset : pos_offset + t] = k_new.transpose(-1, -2)
        cache.v[li, :, :, :, pos_offset : pos_offset + t] = v_new.transpose(-1, -2)
        x = _linear(
            merge_heads(attn_fn(q, cache.k[li], cache.v[li])),
            blk["attn"]["o_w"],
            blk["attn"]["o_b"],
            tp,
            residual=x,
        )
        h = layer_norm(x, blk["cross_ln"]["g"], blk["cross_ln"]["b"])
        qc = qkv_heads(_linear(h, blk["cross"]["q_w"], blk["cross"]["q_b"]), n_head)
        x = _linear(
            merge_heads(_cross_attn(qc, xa_k[li], xa_v[li])),
            blk["cross"]["o_w"],
            blk["cross"]["o_b"],
            tp,
            residual=x,
        )
        x = _mlp(layer_norm(x, blk["mlp_ln"]["g"], blk["mlp_ln"]["b"]), blk["mlp"], tp,
                 residual=x)

    x = layer_norm(x, dec["ln"]["g"], dec["ln"]["b"])
    if "tok_emb_q" in dec:
        # per-row int8 logits: the dot runs on the int8 rows (exact in
        # bf16) with an f32 result, and each vocab row's scale applies
        # after the contraction
        eq = dec["tok_emb_q"]
        logits = matmul_f32(x, eq["q"].to(x.dtype).T) * eq["s"][:, 0]
    else:
        logits = matmul_f32(x, dec["tok_emb"].to(x.dtype).T)
    return logits, DecoderCache(cache.k, cache.v, pos_offset + t)


def prefill(
    params: dict,
    prompt: torch.Tensor,  # (B, P)
    cache: DecoderCache,
    xa_kv,
    cfg: WhisperConfig,
    tp: Optional[ModelAxis] = None,
) -> Tuple[torch.Tensor, DecoderCache]:
    """Run the prompt through the decoder → (logits (B, P, V) f32, cache)."""
    return _decoder_pass(params, prompt, 0, cache, xa_kv, cfg, tp=tp)


def decode_step(
    params: dict,
    tokens: torch.Tensor,  # (B,) — last token per sequence
    cache: DecoderCache,
    xa_kv,
    cfg: WhisperConfig,
    anc: Optional[torch.Tensor] = None,  # optional (Bq, K, T_max) ancestry
    tp: Optional[ModelAxis] = None,
) -> Tuple[torch.Tensor, DecoderCache]:
    """One autoregressive step → (logits (B, V) f32, cache). With ``anc``,
    self-attention resolves each logical beam's history through the
    ancestry map instead of assuming contiguous rows."""
    logits, cache = _decoder_pass(
        params, tokens[:, None], cache.pos, cache, xa_kv, cfg, anc=anc, tp=tp
    )
    return logits[:, 0], cache
