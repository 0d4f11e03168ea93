"""The fused XTTS GPT sampling head (port of ``wis_tpu/ops/fused_gpt_head.py``).

Replaces the TPU kernel ``build_fused_gpt_head``: the double final
LayerNorm, the audio-code logits, the stop-token floor, the repetition
penalty, temperature, top-k and top-p, and the categorical draw, for one
row. On the card it is the hand-written CUDA of ``csrc/fused_gpt_head.cu``,
one launch of a thread-block cluster: each block computes the two
LayerNorms and one column strip of the (D, V_pad) bf16 product and writes
its logits into the leader block's shared memory; the leader sorts the
(value, index) pairs from the top down to the k-th (all of them for a
large top_k) and reads the thresholds off the sorted order. Its time is
the strip's stream, one cluster barrier and the selection (the head's
2.4 MB at XTTS v2's width are under a microsecond of bytes).

What it computes, exactly as the TPU kernel:

- LN and logits staging as the eager epilogue: the input rounds to the
  working dtype, each LayerNorm (f32 statistics) rounds to it, and in bf16
  the logits are ``bf16(bf16(dot) + bf16(bias))``; pad lanes are -1e30.
- The penalty reads a hit-mask (1, V_pad) the caller carries, so it masks
  exactly as ``_mask_logits``' one-hot of the history does — token 0
  included, from the zero-padded history.
- top-k and top-p are thresholds: the k-th largest is
  ``min{l(t) : #{l > l(t)} ≤ k−1}``; for top-p each token's prefix mass
  counts the tokens sorted before it, with equal values ordered by
  descending index (``jnp.sort``'s reversed stable order), and the
  p-threshold is the cutoff-th largest. The plain version counts, as the
  TPU kernel does; the CUDA kernel sorts in that order and reads both off
  it, its prefix masses summed in another order.
- The draw takes the caller's gumbel row: ``argmax(l + gumbel)``, or the
  greedy argmax, lowest index on ties.

knobs (1, 8) f32: [temperature, top_k, top_p, repetition_penalty,
stop_blocked, do_sample, 0, 0]. ``fused_gpt_head`` launches the kernels for
CUDA tensors (bf16 head) and counts one launch per call in
``fused_gpt_head.launches``; CPU tensors run ``fused_gpt_head_plain``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wis_tpu_torch.models.xtts.gpt import GPTConfig, _ln
from wis_tpu_torch.ops import _build
from wis_tpu_torch.ops.graphs import launched

NEG = -1e30
BIG = 1e30
#: the largest padded vocabulary the selection block holds in shared memory
MAX_VP = 4096
#: the widest row the kernel stages
MAX_D = 4096


def v_padded(v: int) -> int:
    return ((v + 127) // 128) * 128


def pack_head(params: dict, cfg: GPTConfig, dtype=torch.bfloat16):
    """One-time packing of the head leaves: (ln4 (4, D) f32, head_w
    (D, Vp) dtype, head_b (1, Vp) f32), pad columns zero."""
    vp = v_padded(cfg.n_audio_vocab)
    pad = vp - cfg.n_audio_vocab
    ln4 = torch.stack(
        [params["gpt_lnf_g"], params["gpt_lnf_b"], params["lnf_g"], params["lnf_b"]]
    ).float()
    head_w = F.pad(params["head_w"].to(dtype), (0, pad)).contiguous()
    head_b = F.pad(params["head_b"].float(), (0, pad)).reshape(1, vp)
    return ln4, head_w, head_b


def _argmax_low(vals, col, vp):
    mv = vals.amax(dim=1, keepdim=True)
    return torch.where(vals >= mv, col, vp + 1).amin(dim=1, keepdim=True)


def fused_gpt_head_plain(x, ln4, head_w, head_b, hist, gum, knobs, *, cfg: GPTConfig,
                         dtype=torch.bfloat16):
    """The head in plain PyTorch, line for line the TPU kernel. x (1, D)
    f32; ln4 (4, D) f32; head_w (D, Vp) dtype; head_b, hist, gum (1, Vp)
    f32; knobs (1, 8) f32. → (tok (1, 1) int32, hidden (1, D) f32,
    masked logits (1, Vp) f32)."""
    v = cfg.n_audio_vocab
    vp = head_w.shape[-1]
    h1 = _ln(x.to(dtype), ln4[0:1], ln4[1:2])
    hidden = _ln(h1, ln4[2:3], ln4[3:4])
    dot = hidden.float() @ head_w.float()
    if dtype == torch.bfloat16:
        l = (dot.to(torch.bfloat16) + head_b.to(torch.bfloat16)).float()
    else:
        l = dot + head_b
    col = torch.arange(vp, device=x.device)[None, :]
    l = torch.where(col < v, l, NEG)
    l = torch.where((col == cfg.stop_audio_token) & (knobs[:, 4:5] > 0), NEG, l)
    rp = knobs[:, 3:4]
    pen = torch.where(l > 0, l / rp, l * rp)
    l = torch.where(hist > 0, pen, l)
    l = l / torch.clamp_min(knobs[:, 0:1], 1e-5)

    e = torch.exp(l - l.amax(dim=1, keepdim=True))
    probs = e / e.sum(dim=1, keepdim=True)  # (1, vp)
    # per token t (rows): how many values exceed it, and the probability
    # mass sorted before it (ties: the higher index first)
    a, bc = l, l.T  # a[0, t'] against bc[t, 0]
    idx = torch.arange(vp, device=x.device)
    mgt = a > bc
    tie = (a == bc) & (idx[None, :] > idx[:, None])
    gt = mgt.float().sum(dim=1, keepdim=True)  # (vp, 1)
    prefix = torch.where(mgt | tie, probs, 0.0).sum(dim=1, keepdim=True)
    cnt = (prefix < knobs[:, 2:3]).float().sum(dim=0, keepdim=True)
    kf = torch.clamp_min(knobs[:, 1:2], 1.0)
    kth = torch.where(gt <= kf - 1.0, bc, BIG).amin(dim=0, keepdim=True)
    pth = torch.where(gt <= torch.clamp_min(cnt, 1.0) - 1.0, bc, BIG).amin(dim=0, keepdim=True)
    l = torch.where(l < kth, NEG, l)
    l = torch.where(l < pth, NEG, l)

    idx_s = _argmax_low(l + gum, col, vp)
    idx_g = _argmax_low(l, col, vp)
    tok = torch.where(knobs[:, 5:6] > 0, idx_s, idx_g).to(torch.int32)
    return tok, hidden.float(), l


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_gpt_head: {msg}")


def fused_gpt_head(x, ln4, head_w, head_b, hist, gum, knobs, *, cfg: GPTConfig,
                   dtype=torch.bfloat16):
    """The sampling head of one row; arguments and result as
    ``fused_gpt_head_plain``. CUDA tensors run ``csrc/fused_gpt_head.cu``
    (bf16 head, D a multiple of 8 up to 4096, V_pad a multiple of 128 up to
    4096); CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return fused_gpt_head_plain(x, ln4, head_w, head_b, hist, gum, knobs, cfg=cfg,
                                    dtype=dtype)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    _check(dtype == torch.bfloat16, f"working dtype {dtype} (the kernel takes bf16)")
    dev = x.device
    d = cfg.d_model
    vp = v_padded(cfg.n_audio_vocab)
    _check(d % 8 == 0 and d <= MAX_D, f"D={d} is not a multiple of 8 up to {MAX_D}")
    _check(vp <= MAX_VP, f"V_pad={vp} above {MAX_VP}")
    _check(0 <= cfg.stop_audio_token < cfg.n_audio_vocab, "stop token outside the vocabulary")
    for name, t, shape, dt in (
        ("x", x, (1, d), torch.float32), ("ln4", ln4, (4, d), torch.float32),
        ("head_w", head_w, (d, vp), torch.bfloat16), ("head_b", head_b, (1, vp), torch.float32),
        ("hist", hist, (1, vp), torch.float32), ("gum", gum, (1, vp), torch.float32),
        ("knobs", knobs, (1, 8), torch.float32),
    ):
        _check(t.shape == shape and t.dtype == dt,
               f"{name} must be {dt} {shape}, got {t.dtype} {tuple(t.shape)}")
        _check(t.device == dev, f"every tensor must be on {dev}")
        _check(t.is_contiguous(), "every tensor must be contiguous")
        _check(t.data_ptr() % 16 == 0, "pointers must be 16-byte aligned")

    tok = torch.empty((1, 1), dtype=torch.int32, device=dev)
    hidden = torch.empty((1, d), dtype=torch.float32, device=dev)
    logits = torch.empty((1, vp), dtype=torch.float32, device=dev)
    raw = torch.empty((1, vp), dtype=torch.float32, device=dev)  # the C interface's scratch row
    lib = _build.kernels()
    with torch.cuda.device(dev):
        rc = lib.wis_fused_gpt_head(
            x.data_ptr(), ln4.data_ptr(), head_w.data_ptr(), head_b.data_ptr(),
            hist.data_ptr(), gum.data_ptr(), knobs.data_ptr(), tok.data_ptr(),
            hidden.data_ptr(), logits.data_ptr(), raw.data_ptr(), d, cfg.n_audio_vocab, vp,
            cfg.stop_audio_token, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "fused_gpt_head")
    launched(fused_gpt_head)
    return tok, hidden, logits


fused_gpt_head.launches = 0


def build_fused_gpt_head(cfg: GPTConfig, *, dtype=torch.bfloat16):
    """Return head(x, ln4, head_w, head_b, hist, gum, knobs) → (tok (1, 1)
    int32, hidden (1, D) f32, masked logits (1, V_pad) f32), the JAX
    package's signature. ``dtype`` is the model's working dtype, which sets
    the LayerNorm and logits rounding."""

    def head(x, ln4, head_w, head_b, hist, gum, knobs):
        return fused_gpt_head(x, ln4, head_w, head_b, hist, gum, knobs, cfg=cfg, dtype=dtype)

    return head
