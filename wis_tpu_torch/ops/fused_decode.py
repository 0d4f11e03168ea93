"""The fused decode step: one beam-decode token through all decoder layers
(port of ``wis_tpu/ops/fused_decode.py``).

Replaces the TPU kernel ``build_fused_decode_step`` (its ``pallas_call``
runs all L layers in one launch). On the card the step is the
hand-written CUDA of ``csrc/fused_decode.cu``: one C call per token that
launches eight kernels per layer — three int8-weight products with a
LayerNorm prologue (q/k/v, cross-attention q, and the MLP's up-projection
with its tanh gelu), self-attention over the time-major cache with the
step's own K/V column, cross-attention over bf16 or per-column int8 K/V,
and three products that add into the f32 residual (the two output
projections and the MLP's down-projection). It is bound by the bytes it
streams — every int8 weight chunk, the cross-KV and the selected cache
columns once per token; the source says how its design keeps to that.

Host side, as in the JAX package:

- ``pack_decoder`` repacks the decoder tree into 14 (D, D) int8 chunks
  per layer, slot order ``QW..W2_0+3``, f32 per-output-channel scales and
  biases (the four W2 chunks share one deferred scale and bias, stored in
  slot ``W2_0+3``) and the six f32 LayerNorm rows; bit-equal to
  ``jax.jit(pack_decoder)``.
- ``quantize_xa_columns`` quantizes the kernel-layout cross-KV per audio
  position (absmax over Dh, a bf16 scale, quantization against the
  bf16-rounded scale); bit-equal to JAX's under ``jit``.

``fused_decode_step`` launches the kernels for CUDA tensors and counts one
launch per step in ``fused_decode_step.launches``; it takes the plain
version, ``fused_decode_step_plain`` (line for line the JAX oracle
``fused_decode_step_reference``), only for tensors on the CPU. Not
ported: the TPU probe switch ``_skip`` and the VMEM gate
``fused_step_vmem_bytes``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from wis_tpu_torch.models.whisper.config import WhisperConfig
from wis_tpu_torch.ops import _build
from wis_tpu_torch.ops.gelu import gelu_tanh
from wis_tpu_torch.ops.graphs import launched
from wis_tpu_torch.ops.layernorm import layer_norm_plain

NEG = -1e30

# chunk-slot layout along the packed axis
QW, KW, VW, OW, CQW, COW = 0, 1, 2, 3, 4, 5
W1_0, W2_0 = 6, 10
NC = 14

#: the largest BK (rows of one step) the kernels take
MAX_ROWS = 32
#: the longest cross-attention window the kernels take (Whisper's is 1500)
MAX_AUDIO = 2048


class PackedDecoder(NamedTuple):
    """Decoder weights repacked for the fused step (once per model)."""

    w: torch.Tensor  # (L, NC, D, D) int8, [k, n]
    s: torch.Tensor  # (L, NC, 1, D) f32 — per-output-channel scales
    b: torch.Tensor  # (L, NC, 1, D) f32 — biases (zeros where absent)
    ln: torch.Tensor  # (L, 6, D) f32 — attn_ln g,b | cross_ln g,b | mlp_ln g,b


def _get_qs(leaf):
    """(int8 q, f32 per-column scale) from a quantized or plain leaf."""
    if isinstance(leaf, dict) and "q" in leaf:
        return leaf["q"], leaf["s"].float()
    w = leaf.float()
    # XLA folds the division by the constant into a multiply by its f32
    # reciprocal under jit; the port does the same to stay bit-equal
    s = torch.amax(torch.abs(w), dim=-2, keepdim=True) * torch.tensor(
        1.0 / 127.0, dtype=torch.float32
    )
    s = torch.clamp_min(s, 1e-8)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return q, s


def pack_decoder(params: dict, cfg: WhisperConfig) -> PackedDecoder:
    """Repack the decoder block tree into the kernel's chunk layout, on the
    tree's device."""
    dec = params["decoder"]["blocks"]
    L, D = cfg.n_text_layer, cfg.n_text_state
    device = dec["attn_ln"]["g"].device
    w = torch.zeros((L, NC, D, D), dtype=torch.int8, device=device)
    s = torch.zeros((L, NC, D), dtype=torch.float32, device=device)
    b = torch.zeros((L, NC, D), dtype=torch.float32, device=device)

    def put(ci, leaf, bias=None):
        q, sc = _get_qs(leaf)  # q (L, D, D), sc (L, 1, D)
        w[:, ci] = q
        s[:, ci] = sc[:, 0, :]
        if bias is not None:
            b[:, ci] = bias.float()

    attn, cross, mlp = dec["attn"], dec["cross"], dec["mlp"]
    put(QW, attn["q_w"], attn["q_b"])
    put(KW, attn["k_w"])
    put(VW, attn["v_w"], attn["v_b"])
    put(OW, attn["o_w"], attn["o_b"])
    put(CQW, cross["q_w"], cross["q_b"])
    put(COW, cross["o_w"], cross["o_b"])

    q1, s1 = _get_qs(mlp["w1"])  # (L, D, F), (L, 1, F)
    b1 = mlp["b1"].float()  # (L, F)
    for i in range(4):
        sl = slice(i * D, (i + 1) * D)
        w[:, W1_0 + i] = q1[:, :, sl]
        s[:, W1_0 + i] = s1[:, 0, sl]
        b[:, W1_0 + i] = b1[:, sl]

    q2, s2 = _get_qs(mlp["w2"])  # (L, F, D), (L, 1, D)
    for i in range(4):
        w[:, W2_0 + i] = q2[:, i * D : (i + 1) * D, :]
    # w2's per-output scale/bias apply once after the 4 partial sums
    s[:, W2_0 + 3] = s2[:, 0, :]
    b[:, W2_0 + 3] = mlp["b2"].float()

    ln = torch.stack(
        [
            dec["attn_ln"]["g"], dec["attn_ln"]["b"],
            dec["cross_ln"]["g"], dec["cross_ln"]["b"],
            dec["mlp_ln"]["g"], dec["mlp_ln"]["b"],
        ],
        dim=1,
    ).float()
    return PackedDecoder(w=w, s=s[:, :, None, :], b=b[:, :, None, :], ln=ln)


def quantize_xa_columns(xa_k_f: torch.Tensor, xa_v_f: torch.Tensor):
    """Per-column int8 of the kernel-layout cross-KV ((L, H, Dh, SX): each
    audio position's Dh-vector shares one scale). Returns (qk, qv int8,
    xa_s (L, 2H, SX) bf16 — row 2h = K scales, 2h+1 = V scales)."""

    def q_cols(x):
        x32 = x.float()
        absmax = torch.amax(torch.abs(x32), dim=2, keepdim=True)
        scale = (
            torch.clamp_min(absmax, 1e-8) * torch.tensor(1.0 / 127.0, dtype=torch.float32)
        ).to(torch.bfloat16)
        q = torch.clamp(torch.round(x32 / scale.float()), -127, 127).to(torch.int8)
        return q, scale

    qk, ks = q_cols(xa_k_f)
    qv, vs = q_cols(xa_v_f)
    L, H, _, SX = xa_k_f.shape
    xa_s = torch.stack([ks[:, :, 0, :], vs[:, :, 0, :]], dim=2).reshape(L, 2 * H, SX)
    return qk, qv, xa_s


# --------------------------------------------------------------------------- #
# The plain version: line for line fused_decode_step_reference
# --------------------------------------------------------------------------- #
def _bf(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and compute on in f32 (a bf16 operand of an f32 dot)."""
    return x.to(torch.bfloat16).float()


def self_attention_plain(qh, kh, vh, kc_l, vc_l, keep, scale):
    """One layer's self-attention as the fused steps compute it, per head
    (qh, kh, vh (H, BK, Dh) f32; one layer's cache viewed (H, Dh, BK·T);
    keep (BK, BK·T) bool): scores bf16(q)·K in f32 where keep, else -1e30;
    the self column q·k in f32; e rounded to bf16 for P·V while the
    denominator sums the f32 e. → (H, BK, Dh) f32."""
    scores = (_bf(qh) @ kc_l.float()) * scale  # (H, BK, BKT)
    scores = torch.where(keep, scores, NEG)
    s_self = (qh * kh).sum(dim=-1, keepdim=True) * scale  # (H, BK, 1)
    m = torch.maximum(scores.amax(dim=-1, keepdim=True), s_self)
    e = torch.exp(scores - m)
    e_self = torch.exp(s_self - m)
    denom = e.sum(dim=-1, keepdim=True) + e_self
    out = _bf(e) @ vc_l.float().transpose(-1, -2)  # (H, BK, Dh)
    return (out + e_self * vh) / denom


def mlp_residual_plain(x, h, w, s, b):
    """x + the MLP of h (the LN output) over one layer's four W1 and four
    W2 (D, D) int8 chunks w[0:4], w[4:8] with scales and biases s, b:
    g_i = bf16(gelu(h·W1_i·s + b)), then (x + (Σ g_i·W2_i)·s) + b with the
    W2 scale and bias of the last chunk."""
    g = [_bf(gelu_tanh((_bf(h) @ w[i].float()) * s[i] + b[i])) for i in range(4)]
    y = sum(g[i] @ w[4 + i].float() for i in range(4))
    return x + y * s[7] + b[7]


def fused_decode_step_plain(
    cfg: WhisperConfig, packed: PackedDecoder, x_emb, k_cache, v_cache,
    xa_k, xa_v, sel, pos: int, n_seq: int = 1, s_audio: Optional[int] = None,
    xa_s=None,
):
    """The step in plain PyTorch: x_emb (BK, D) f32; caches (L, D, BK·T)
    time-major, written IN PLACE at columns pos·BK + row; xa_k/xa_v
    (L, H, Dh, n_seq·S_pad) bf16, or int8 with xa_s (L, 2H, SX) scales;
    sel (BK, BK·T) f32. → (x_out (BK, D) f32, k_cache, v_cache)."""
    D, H, L = cfg.n_text_state, cfg.n_text_head, cfg.n_text_layer
    Dh = D // H
    bk = x_emb.shape[0]
    bkt = k_cache.shape[-1]
    kcv = k_cache.view(L, H, Dh, bkt)
    vcv = v_cache.view(L, H, Dh, bkt)
    scale = Dh ** -0.5
    sx = xa_k.shape[-1]
    s_pad = sx // n_seq
    s_audio = s_pad if s_audio is None else s_audio
    xa_mask = None
    if n_seq > 1 or s_audio != s_pad:
        col = torch.arange(sx, device=x_emb.device)[None, :]
        ok = col % s_pad < s_audio
        if n_seq > 1:
            row = torch.arange(bk, device=x_emb.device)[:, None] // (bk // n_seq)
            ok = ok & (col // s_pad == row)
        xa_mask = ok
    keep = sel > 0

    def wdot(src, l, ci):
        y = _bf(src) @ packed.w[l, ci].float()
        return y * packed.s[l, ci] + packed.b[l, ci]

    def heads(t):  # (BK, D) → (H, BK, Dh)
        return t.reshape(bk, H, Dh).transpose(0, 1)

    x = x_emb.float()
    for l in range(L):
        h = layer_norm_plain(x, packed.ln[l, 0], packed.ln[l, 1])
        q, k, v = wdot(h, l, QW), wdot(h, l, KW), wdot(h, l, VW)
        out = self_attention_plain(heads(q), heads(k), heads(v), kcv[l], vcv[l], keep, scale)
        attn = out.transpose(0, 1).reshape(bk, D)
        # this step's K/V columns, written where the kernel writes them
        cols = slice(pos * bk, (pos + 1) * bk)
        k_cache[l, :, cols] = k.T.to(k_cache.dtype)
        v_cache[l, :, cols] = v.T.to(v_cache.dtype)
        x = x + wdot(attn, l, OW)

        h = layer_norm_plain(x, packed.ln[l, 2], packed.ln[l, 3])
        qc = heads(wdot(h, l, CQW))
        scores = (_bf(qc) @ xa_k[l].float()) * scale  # (H, BK, SX)
        if xa_s is not None:
            scores = scores * xa_s[l, 0::2, None, :].float()
        if xa_mask is not None:
            scores = torch.where(xa_mask, scores, NEG)
        e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        w_att = e / e.sum(dim=-1, keepdim=True)  # jax.nn.softmax's order
        if xa_s is not None:
            w_att = w_att * xa_s[l, 1::2, None, :].float()
        ctx = (_bf(w_att) @ xa_v[l].float().transpose(-1, -2)).transpose(0, 1)
        x = x + wdot(ctx.reshape(bk, D), l, COW)

        h = layer_norm_plain(x, packed.ln[l, 4], packed.ln[l, 5])
        mlp = slice(W1_0, W2_0 + 4)
        x = mlp_residual_plain(x, h, packed.w[l, mlp], packed.s[l, mlp], packed.b[l, mlp])
    return x, k_cache, v_cache


# --------------------------------------------------------------------------- #
# The kernel's wrapper
# --------------------------------------------------------------------------- #
def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_decode_step: {msg}")


def fused_decode_step(
    cfg: WhisperConfig, packed: PackedDecoder, x_emb, k_cache, v_cache,
    xa_k, xa_v, sel, pos: int, n_seq: int = 1, s_audio: Optional[int] = None,
    xa_s=None,
):
    """One decode token through all layers; arguments and result as
    ``fused_decode_step_plain``. The caches are updated in place at
    columns pos·BK + row (the TPU kernel aliases them the same way).

    CUDA tensors run ``csrc/fused_decode.cu`` (bf16 caches and activations,
    int8 weights, head_dim 64, D a multiple of 64, BK ≤ 32, BK·T a multiple
    of 8, s_audio ≤ 2048); CPU tensors run ``fused_decode_step_plain``."""
    if x_emb.device.type == "cpu":
        return fused_decode_step_plain(
            cfg, packed, x_emb, k_cache, v_cache, xa_k, xa_v, sel, pos,
            n_seq=n_seq, s_audio=s_audio, xa_s=xa_s,
        )
    _check(x_emb.device.type == "cuda", f"unsupported device {x_emb.device}")
    D, H, L = cfg.n_text_state, cfg.n_text_head, cfg.n_text_layer
    dev = x_emb.device
    _check(D % H == 0 and D // H == 64, f"head_dim {D}/{H} is not 64")
    _check(D % 64 == 0, f"D={D} is not a multiple of 64")
    bk = x_emb.shape[0]
    _check(x_emb.shape == (bk, D) and x_emb.dtype == torch.float32,
           f"x_emb must be f32 (BK, {D}), got {x_emb.dtype} {tuple(x_emb.shape)}")
    _check(1 <= bk <= MAX_ROWS and bk % n_seq == 0,
           f"BK={bk} must be 1..{MAX_ROWS} and a multiple of n_seq={n_seq}")
    bkt = k_cache.shape[-1]
    _check(bkt % bk == 0 and 0 <= pos < bkt // bk, f"pos {pos} outside the cache")
    _check(bkt % 8 == 0, f"cache width {bkt} is not a multiple of 8")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check(t.shape == (L, D, bkt) and t.dtype == torch.bfloat16,
               f"{name} must be bf16 ({L}, {D}, {bkt}), got {t.dtype} {tuple(t.shape)}")
    sx = xa_k.shape[-1]
    _check(sx % n_seq == 0, f"cross-KV width {sx} is not n_seq={n_seq} windows")
    s_pad = sx // n_seq
    s_audio = s_pad if s_audio is None else s_audio
    _check(1 <= s_audio <= s_pad, f"s_audio {s_audio} outside the window {s_pad}")
    _check(s_audio <= MAX_AUDIO, f"s_audio {s_audio} above {MAX_AUDIO}")
    xa_dtype = torch.int8 if xa_s is not None else torch.bfloat16
    for name, t in (("xa_k", xa_k), ("xa_v", xa_v)):
        _check(t.shape == (L, H, 64, sx) and t.dtype == xa_dtype,
               f"{name} must be {xa_dtype} ({L}, {H}, 64, {sx}), "
               f"got {t.dtype} {tuple(t.shape)}")
    if xa_s is not None:
        _check(xa_s.shape == (L, 2 * H, sx) and xa_s.dtype == torch.bfloat16,
               f"xa_s must be bf16 ({L}, {2 * H}, {sx}), got {xa_s.dtype} {tuple(xa_s.shape)}")
    _check(sel.shape == (bk, bkt) and sel.dtype == torch.float32,
           f"sel must be f32 ({bk}, {bkt}), got {sel.dtype} {tuple(sel.shape)}")
    expect = {"w": ((L, NC, D, D), torch.int8), "s": ((L, NC, 1, D), torch.float32),
              "b": ((L, NC, 1, D), torch.float32), "ln": ((L, 6, D), torch.float32)}
    for name, (shape, dtype) in expect.items():
        t = getattr(packed, name)
        _check(t.shape == shape and t.dtype == dtype, f"packed.{name} must be {dtype} {shape}")
    tensors = [x_emb, k_cache, v_cache, xa_k, xa_v, sel, *packed]
    if xa_s is not None:
        tensors.append(xa_s)
    for t in tensors:
        _check(t.device == dev, f"every tensor must be on {dev}")
        _check(t.is_contiguous(), "every tensor must be contiguous")
        _check(t.data_ptr() % 16 == 0, "pointers must be 16-byte aligned")

    lib = _build.kernels()
    ws_bytes = lib.wis_fused_decode_workspace_bytes(D, bk)
    _check(ws_bytes > 0, f"no workspace for D={D}, BK={bk}")
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev)
    x = x_emb.clone()
    with torch.cuda.device(dev):
        rc = lib.wis_fused_decode_step(
            packed.w.data_ptr(), packed.s.data_ptr(), packed.b.data_ptr(),
            packed.ln.data_ptr(), x.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            xa_k.data_ptr(), xa_v.data_ptr(), xa_s.data_ptr() if xa_s is not None else None,
            sel.data_ptr(), int(pos), ws.data_ptr(),
            L, D, H, bk, bkt // bk, n_seq, s_pad, s_audio,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "fused_decode_step")
    launched(fused_decode_step)
    return x, k_cache, v_cache


fused_decode_step.launches = 0


def build_fused_decode_step(
    cfg: WhisperConfig,
    *,
    bk: int,
    t_cache: int,
    s_audio: int = 1500,
    n_seq: int = 1,
    xa_int8: bool = False,
):
    """Return step(packed, x_emb, k_cache, v_cache, xa_k, xa_v[, xa_s], sel,
    pos) → (x_out (BK, D) f32, k_cache, v_cache), the JAX package's
    signature (xa_s only with xa_int8).

    k/v_cache (L, D, BK·t_cache) bf16, time-major flat columns (flat index
    t·BK + row, heads merged into D), updated IN PLACE: the step writes its
    K/V at columns pos·BK + row and returns the same tensors. xa_k/xa_v
    (L, H, Dh, n_seq·S_pad): each sequence's window zero-padded to the next
    multiple of 128 past s_audio, the pad columns masked. sel (BK, BK·T)
    f32: 1 where a flat column belongs to the query beam's history (the
    current position excluded; the step's own K/V join as an explicit self
    column). n_seq > 1: row r belongs to sequence r // (bk // n_seq), and
    cross-attention is block-diagonal."""
    if bk % n_seq:
        raise ValueError("bk must be n_seq * beams")
    s_pad = ((s_audio + 127) // 128) * 128

    def run(packed, x_emb, k_cache, v_cache, xa_k, xa_v, sel, pos, xa_s=None):
        if k_cache.shape[-1] != bk * t_cache or xa_k.shape[-1] != n_seq * s_pad:
            raise ValueError(
                f"cache width {k_cache.shape[-1]} / cross-KV width {xa_k.shape[-1]} "
                f"do not match bk={bk}, t_cache={t_cache}, n_seq={n_seq}, s_pad={s_pad}"
            )
        return fused_decode_step(
            cfg, packed, x_emb, k_cache, v_cache, xa_k, xa_v, sel, int(pos),
            n_seq=n_seq, s_audio=s_audio, xa_s=xa_s,
        )

    if xa_int8:
        def step(packed, x_emb, k_cache, v_cache, xa_k, xa_v, xa_s, sel, pos):
            return run(packed, x_emb, k_cache, v_cache, xa_k, xa_v, sel, pos, xa_s)
    else:
        def step(packed, x_emb, k_cache, v_cache, xa_k, xa_v, sel, pos):
            return run(packed, x_emb, k_cache, v_cache, xa_k, xa_v, sel, pos)
    return step
