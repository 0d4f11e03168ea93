"""The fused XTTS GPT step: one audio token through all L GPT-2 layers
(port of ``wis_tpu/ops/fused_gpt.py``).

Replaces the TPU kernel ``build_fused_gpt_step`` (its ``pallas_call`` runs
all layers in one launch). On the card the step is the hand-written CUDA
of ``csrc/fused_gpt.cu``: one C call per token that launches five kernels
per layer on the caller's stream — the q/k/v int8 product with a
LayerNorm prologue, self-attention over the time-major cache with the
step's own K/V column, the Wo product into the f32 residual, W1 with a
LayerNorm prologue and the tanh gelu, and W2 as one (4D, D) product with
its deferred scale. The products and self-attention are the Whisper
step's own kernels (``csrc/decode_step.cuh``): the GPT step is that step
without cross-attention. It is bound by the bytes it streams — 12 int8
(D, D) chunks per layer (377 MB at XTTS v2's width) and the selected
cache columns once per token.

Host side, as in the JAX package: ``pack_gpt`` repacks the block tree into
12 (D, D) int8 chunks per layer, slot order [q k v o | w1 ×4 | w2 ×4], f32
per-output-channel scales and biases (the four W2 chunks share one
deferred scale and bias in slot ``W2_0+3``) and the four f32 LayerNorm
rows; bit-equal to JAX's.

``fused_gpt_step`` launches the kernels for CUDA tensors and counts one
launch per step in ``fused_gpt_step.launches``; it takes the plain
version, ``fused_gpt_step_plain`` (line for line the JAX oracle
``fused_gpt_step_reference``), only for tensors on the CPU. Not ported:
the VMEM gate ``fused_gpt_vmem_bytes``.

``pos``, the cache column the step writes, is a host int or a 0-dim int32
tensor on the card, which the kernels read when they run: one CUDA graph
captured from the step then serves every position (``models/xtts/
slots.py``); a replayed step counts as a launch (``ops/graphs``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from wis_tpu_torch.models.xtts.gpt import GPTConfig
from wis_tpu_torch.ops import _build
from wis_tpu_torch.ops.fused_decode import (
    MAX_ROWS,
    _bf,
    _get_qs,
    mlp_residual_plain,
    self_attention_plain,
)
from wis_tpu_torch.ops.graphs import launched
from wis_tpu_torch.ops.layernorm import layer_norm_plain

# chunk-slot layout along the packed axis
QW, KW, VW, OW = 0, 1, 2, 3
W1_0, W2_0 = 4, 8
NC = 12


class PackedGPT(NamedTuple):
    """GPT block weights repacked for the fused step (once per model)."""

    w: torch.Tensor  # (L, NC, D, D) int8, [k, n]
    s: torch.Tensor  # (L, NC, 1, D) f32 — per-output-channel scales
    b: torch.Tensor  # (L, NC, 1, D) f32 — biases (zeros where absent)
    ln: torch.Tensor  # (L, 4, D) f32 — ln1 g,b | ln2 g,b


def pack_gpt(params: dict, cfg: GPTConfig) -> PackedGPT:
    """Repack the stacked GPT block tree into the kernel's chunk layout, on
    the tree's device. Takes int8 leaves (``quantize_gpt_params``) or plain
    ones, which it quantizes."""
    blk = params["blocks"]
    L, D = cfg.n_layer, cfg.d_model
    device = blk["ln1_g"].device
    w = torch.zeros((L, NC, D, D), dtype=torch.int8, device=device)
    s = torch.zeros((L, NC, D), dtype=torch.float32, device=device)
    b = torch.zeros((L, NC, D), dtype=torch.float32, device=device)

    def put(ci, leaf, bias):
        q, sc = _get_qs(leaf)  # q (L, D, D), sc (L, 1, D)
        w[:, ci] = q
        s[:, ci] = sc[:, 0, :]
        b[:, ci] = bias.float()

    put(QW, blk["q_w"], blk["q_b"])
    put(KW, blk["k_w"], blk["k_b"])
    put(VW, blk["v_w"], blk["v_b"])
    put(OW, blk["proj_w"], blk["proj_b"])

    q1, s1 = _get_qs(blk["mlp_w1"])  # (L, D, F), (L, 1, F)
    b1 = blk["mlp_b1"].float()  # (L, F)
    for i in range(4):
        sl = slice(i * D, (i + 1) * D)
        w[:, W1_0 + i] = q1[:, :, sl]
        s[:, W1_0 + i] = s1[:, 0, sl]
        b[:, W1_0 + i] = b1[:, sl]

    q2, s2 = _get_qs(blk["mlp_w2"])  # (L, F, D), (L, 1, D)
    for i in range(4):
        w[:, W2_0 + i] = q2[:, i * D : (i + 1) * D, :]
    # w2's per-output scale/bias apply once after the 4 partial sums
    s[:, W2_0 + 3] = s2[:, 0, :]
    b[:, W2_0 + 3] = blk["mlp_b2"].float()

    ln = torch.stack([blk["ln1_g"], blk["ln1_b"], blk["ln2_g"], blk["ln2_b"]], dim=1).float()
    return PackedGPT(w=w, s=s[:, :, None, :], b=b[:, :, None, :], ln=ln)


def fused_gpt_step_plain(cfg: GPTConfig, packed: PackedGPT, x_emb, k_cache, v_cache, sel,
                         pos):
    """The step in plain PyTorch: x_emb (bk, D) f32; caches (L, D, bk·T)
    time-major, written IN PLACE at columns pos·bk + row; sel (bk, bk·T)
    f32. → (x_out (bk, D) f32, k_cache, v_cache)."""
    pos = int(pos)
    D, H, L = cfg.d_model, cfg.n_head, cfg.n_layer
    Dh = D // H
    bk = x_emb.shape[0]
    bkt = k_cache.shape[-1]
    kcv = k_cache.view(L, H, Dh, bkt)
    vcv = v_cache.view(L, H, Dh, bkt)
    scale = Dh ** -0.5
    keep = sel > 0

    def wdot(src, l, ci):
        y = _bf(src) @ packed.w[l, ci].float()
        return y * packed.s[l, ci] + packed.b[l, ci]

    def heads(t):  # (bk, D) → (H, bk, Dh)
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
        x = mlp_residual_plain(x, h, packed.w[l, W1_0:], packed.s[l, W1_0:], packed.b[l, W1_0:])
    return x, k_cache, v_cache


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_gpt_step: {msg}")


def fused_gpt_step(cfg: GPTConfig, packed: PackedGPT, x_emb, k_cache, v_cache, sel, pos):
    """One audio token through all layers; arguments and result as
    ``fused_gpt_step_plain``. The caches are updated in place at columns
    pos·bk + row (the TPU kernel aliases them the same way).

    CUDA tensors run ``csrc/fused_gpt.cu`` (bf16 caches, int8 weights, head
    dim 64, D a multiple of 64, bk ≤ 32, bk·T a multiple of 8); CPU tensors run
    ``fused_gpt_step_plain``. A device ``pos`` (0-dim int32 on the card) is
    read by the kernels: its value is the caller's to keep inside the
    cache, and the kernels write no column for one outside it."""
    if x_emb.device.type == "cpu":
        return fused_gpt_step_plain(cfg, packed, x_emb, k_cache, v_cache, sel, pos)
    _check(x_emb.device.type == "cuda", f"unsupported device {x_emb.device}")
    D, H, L = cfg.d_model, cfg.n_head, cfg.n_layer
    dev = x_emb.device
    _check(D % H == 0 and D // H == 64, f"head_dim {D}/{H} is not 64")
    _check(D % 64 == 0, f"D={D} is not a multiple of 64")
    bk = x_emb.shape[0]
    _check(x_emb.shape == (bk, D) and x_emb.dtype == torch.float32,
           f"x_emb must be f32 (bk, {D}), got {x_emb.dtype} {tuple(x_emb.shape)}")
    _check(1 <= bk <= MAX_ROWS, f"bk={bk} must be 1..{MAX_ROWS}")
    bkt = k_cache.shape[-1]
    # a device pos is never formatted or compared here: either would wait
    # for the card, which a stream being captured must not
    on_device = isinstance(pos, torch.Tensor)
    if on_device:
        _check(pos.shape == () and pos.dtype == torch.int32 and pos.device == dev,
               f"a device pos must be a 0-dim int32 tensor on {dev}")
        _check(bkt % bk == 0, f"cache width {bkt} is not a multiple of bk={bk}")
    else:
        _check(bkt % bk == 0 and 0 <= pos < bkt // bk, f"pos {pos} outside the cache")
    _check(bkt % 8 == 0, f"cache width {bkt} is not a multiple of 8")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check(t.shape == (L, D, bkt) and t.dtype == torch.bfloat16,
               f"{name} must be bf16 ({L}, {D}, {bkt}), got {t.dtype} {tuple(t.shape)}")
    _check(sel.shape == (bk, bkt) and sel.dtype == torch.float32,
           f"sel must be f32 ({bk}, {bkt}), got {sel.dtype} {tuple(sel.shape)}")
    expect = {"w": ((L, NC, D, D), torch.int8), "s": ((L, NC, 1, D), torch.float32),
              "b": ((L, NC, 1, D), torch.float32), "ln": ((L, 4, D), torch.float32)}
    for name, (shape, dtype) in expect.items():
        t = getattr(packed, name)
        _check(t.shape == shape and t.dtype == dtype, f"packed.{name} must be {dtype} {shape}")
    for t in (x_emb, k_cache, v_cache, sel, *packed):
        _check(t.device == dev, f"every tensor must be on {dev}")
        _check(t.is_contiguous(), "every tensor must be contiguous")
        _check(t.data_ptr() % 16 == 0, "pointers must be 16-byte aligned")

    lib = _build.kernels()
    ws_bytes = lib.wis_fused_gpt_workspace_bytes(D, bk)
    _check(ws_bytes > 0, f"no workspace for D={D}, bk={bk}")
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev)
    x = x_emb.clone()
    with torch.cuda.device(dev):
        rc = lib.wis_fused_gpt_step(
            packed.w.data_ptr(), packed.s.data_ptr(), packed.b.data_ptr(),
            packed.ln.data_ptr(), x.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            sel.data_ptr(), 0 if on_device else int(pos), ws.data_ptr(), L, D, H, bk,
            bkt // bk, torch.cuda.current_stream(dev).cuda_stream,
            pos.data_ptr() if on_device else None,
        )
    _build.check(rc, "fused_gpt_step")
    launched(fused_gpt_step)
    return x, k_cache, v_cache


fused_gpt_step.launches = 0


def build_fused_gpt_step(cfg: GPTConfig, *, bk: int, t_cache: int):
    """Return step(packed, x_emb, k_cache, v_cache, sel, pos) → (x_out
    (bk, D) f32, k_cache, v_cache), the JAX package's signature.

    k/v_cache (L, D, bk·t_cache) bf16, time-major flat columns (flat index
    t·bk + row, heads merged into D), updated IN PLACE at columns
    pos·bk + row. sel (bk, bk·t_cache) f32: 1 where a flat column belongs to
    the query row's history (t < pos); the step's own K/V join as an
    explicit self column. pos: a host int, or a device one
    (``fused_gpt_step``)."""

    def step(packed, x_emb, k_cache, v_cache, sel, pos):
        if k_cache.shape[-1] != bk * t_cache:
            raise ValueError(
                f"cache width {k_cache.shape[-1]} does not match bk={bk}, t_cache={t_cache}"
            )
        if not isinstance(pos, torch.Tensor):
            pos = int(pos)
        return fused_gpt_step(cfg, packed, x_emb, k_cache, v_cache, sel, pos)

    return step
