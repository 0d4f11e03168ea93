"""Word-level timestamps: cross-attention alignment + DTW (port of
``wis_tpu/decoding/align.py``).

One extra teacher-forced pass over the final token sequence (batch 1, the
chosen beam): the cross-attention weights of the alignment heads are
normalized per head (mean/std over the valid token axis), median-filtered
over the frame axis (width 7, edge-clamped) and summed across heads into a
(T, S) f32 matrix, layer by layer, so the (L, H, T, S) weights are never
held at once. The matrix is fetched once and the DTW and word grouping run
on the host (numpy), copies of the JAX package's host functions.

On the card the pass runs the encoder's kernels again (``encode``) and
every int8 product through ``ops/quant.int8_matmul``.

Alignment heads: an ``alignment_heads.json`` next to the checkpoint (a list
of [layer, head] pairs) when present, else all heads of the upper half of
the decoder layers.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wis_tpu_torch.audio.mel import log_mel
from wis_tpu_torch.models.whisper.config import WhisperConfig
from wis_tpu_torch.models.whisper.model import _layer, _linear, _mlp, cross_kv, encode, layer_norm
from wis_tpu_torch.models.whisper.tokenizer import EOT, WhisperTokenizer
from wis_tpu_torch.ops.attention import NEG_INF, merge_heads, qkv_heads
from wis_tpu_torch.ops.quant import matmul_f32

FRAME_S = 0.02  # one encoder position = 20 ms of audio
MEDFILT = 7


def default_alignment_heads(cfg: WhisperConfig) -> np.ndarray:
    """(L, H) 0/1 mask — all heads of the upper half of decoder layers."""
    m = np.zeros((cfg.n_text_layer, cfg.n_text_head), np.float32)
    m[cfg.n_text_layer // 2 :] = 1.0
    return m


def load_alignment_heads(cfg: WhisperConfig, model_dir: Optional[str]) -> np.ndarray:
    """Checkpoint-provided head list (``alignment_heads.json``: list of
    [layer, head] pairs) or the default heuristic."""
    if model_dir:
        path = os.path.join(model_dir, "alignment_heads.json")
        if os.path.exists(path):
            pairs = json.loads(open(path).read())
            m = np.zeros((cfg.n_text_layer, cfg.n_text_head), np.float32)
            for l, h in pairs:
                m[int(l), int(h)] = 1.0
            if m.sum():
                return m
    return default_alignment_heads(cfg)


def _median7(x: torch.Tensor) -> torch.Tensor:
    """Width-7 median over the last axis with an edge-clamped window: the
    middle of each sorted window of 7, as ``jnp.median`` takes it."""
    half = MEDFILT // 2
    win = F.pad(x, (half, half), mode="replicate").unfold(-1, MEDFILT, 1)
    return torch.sort(win, dim=-1).values[..., half]


def build_align_program(cfg: WhisperConfig, *, seq_len: int, heads: np.ndarray):
    """(params, xa_kv, tokens (1, seq_len) int, n_text int) → (matrix
    (seq_len, S) f32, probs (seq_len,) f32).

    matrix[t, s]: head-summed normalized cross-attention of token t on
    audio frame s (positions ≥ n_text zeroed). probs[t]: model probability
    of tokens[t+1] given the prefix (teacher-forced)."""
    H = cfg.n_text_head
    Dh = cfg.n_text_state // H
    scale = Dh ** -0.5
    n_sel = max(float(heads.sum()), 1.0)

    @torch.inference_mode()
    def align(params, xa_kv, tokens, n_text):
        dec = params["decoder"]
        device = tokens.device
        dtype = dec["tok_emb"].dtype
        toks = tokens[0].long()
        x = (dec["tok_emb"][toks].to(dtype) + dec["pos"][:seq_len].to(dtype))[None]
        tok_mask = (torch.arange(seq_len, device=device) < n_text).float()
        ar = torch.arange(seq_len, device=device)
        causal = (ar[None, :] <= ar[:, None])[None, None]
        hsel = torch.as_tensor(heads, dtype=torch.float32, device=device)
        xa_k, xa_v = xa_kv  # (L, 1, H, Dh, S)
        cnt = max(float(n_text), 1.0)
        acc = torch.zeros((seq_len, xa_k.shape[-1]), dtype=torch.float32, device=device)
        for li in range(cfg.n_text_layer):
            blk = _layer(dec["blocks"], li)
            h = layer_norm(x, blk["attn_ln"]["g"], blk["attn_ln"]["b"])
            q = qkv_heads(_linear(h, blk["attn"]["q_w"], blk["attn"]["q_b"]), H)
            k = qkv_heads(_linear(h, blk["attn"]["k_w"]), H)
            v = qkv_heads(_linear(h, blk["attn"]["v_w"], blk["attn"]["v_b"]), H)
            scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
            w = torch.softmax(torch.where(causal, scores, NEG_INF), dim=-1).to(v.dtype)
            x = x + _linear(merge_heads(torch.matmul(w, v)), blk["attn"]["o_w"],
                            blk["attn"]["o_b"])

            h = layer_norm(x, blk["cross_ln"]["g"], blk["cross_ln"]["b"])
            qc = qkv_heads(_linear(h, blk["cross"]["q_w"], blk["cross"]["q_b"]), H)
            cs = torch.matmul(qc.float(), xa_k[li].float()) * scale  # (1, H, T, S)
            cw32 = torch.softmax(cs, dim=-1)
            ctx = torch.matmul(cw32.to(xa_v.dtype), xa_v[li].transpose(-1, -2))
            x = x + _linear(merge_heads(ctx), blk["cross"]["o_w"], blk["cross"]["o_b"])
            x = x + _mlp(layer_norm(x, blk["mlp_ln"]["g"], blk["mlp_ln"]["b"]), blk["mlp"])

            # per-head normalization over the valid token axis, median
            # filter over frames, head-masked sum into the accumulator
            wsel = cw32[0] * tok_mask[None, :, None]  # (H, T, S)
            mean = wsel.sum(dim=1, keepdim=True) / cnt
            var = ((wsel - mean) ** 2 * tok_mask[None, :, None]).sum(dim=1, keepdim=True) / cnt
            norm = (wsel - mean) * torch.rsqrt(var + 1e-8)
            acc = acc + torch.einsum("h,hts->ts", hsel[li], _median7(norm))

        x = layer_norm(x, dec["ln"]["g"], dec["ln"]["b"])
        logits = matmul_f32(x, dec["tok_emb"].to(x.dtype).T)[0]
        lp = torch.log_softmax(logits, dim=-1)
        nxt = torch.cat([toks[1:], toks[-1:]])
        probs = torch.exp(torch.gather(lp, 1, nxt[:, None])[:, 0])
        matrix = acc * tok_mask[:, None] / n_sel
        return matrix, probs

    return align


def build_align_from_audio(cfg: WhisperConfig, *, seq_len: int, heads: np.ndarray):
    """(params, audio_i16 (1, N_SAMPLES) int16, tokens (1, seq_len), n_text)
    → (matrix, probs): the log-mel, encoder and cross-KV again, then the
    alignment pass (the request's program does not keep its cross-KV)."""
    inner = build_align_program(cfg, seq_len=seq_len, heads=heads)

    @torch.inference_mode()
    def align(params, audio_i16, tokens, n_text):
        mel = log_mel(audio_i16.float() / 32768.0, n_mels=cfg.n_mels)
        xa_kv = cross_kv(params, encode(params, mel, cfg), cfg)
        return inner(params, xa_kv, tokens, n_text)

    return align


# --------------------------------------------------------------------- #
# Host-side: DTW + word grouping (copies of the JAX package's)
# --------------------------------------------------------------------- #
def dtw_path(matrix: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic alignment path maximizing summed attention (classic DTW
    on -matrix with steps diag/down/right). Returns (text_idx, time_idx)."""
    T, S = matrix.shape
    cost = -matrix.astype(np.float64)
    D = np.full((T + 1, S + 1), np.inf)
    D[0, 0] = 0.0
    trace = np.zeros((T + 1, S + 1), np.int8)
    for i in range(1, T + 1):
        row_prev = D[i - 1]
        row = D[i]
        c = cost[i - 1]
        for j in range(1, S + 1):
            c0 = row_prev[j - 1]  # diag
            c1 = row_prev[j]      # down (next token, same frame)
            c2 = row[j - 1]       # right (same token, next frame)
            best = c0
            t = 0
            if c1 < best:
                best, t = c1, 1
            if c2 < best:
                best, t = c2, 2
            row[j] = c[j - 1] + best
            trace[i, j] = t
    i, j = T, S
    ti, si = [], []
    while i > 0 and j > 0:
        ti.append(i - 1)
        si.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.array(ti[::-1]), np.array(si[::-1])


_NO_SPACE_LANGS = {"zh", "ja", "th", "lo", "my", "yue"}


def split_word_tokens(
    tokenizer: WhisperTokenizer, ids: Sequence[int], language: str = "en"
) -> List[List[int]]:
    """Group text-token ids into word groups. Space-delimited languages
    split on the GPT-2 space marker; no-space languages split per token."""
    groups: List[List[int]] = []
    if language in _NO_SPACE_LANGS:
        return [[int(i)] for i in ids if int(i) < EOT]
    for i in ids:
        i = int(i)
        if i >= EOT:
            continue
        s = tokenizer._token_str(i)
        if not groups or s.startswith("Ġ"):
            groups.append([i])
        else:
            groups[-1].append(i)
    return groups


def words_from_alignment(
    tokenizer: WhisperTokenizer,
    token_ids: Sequence[int],  # generated tokens (no prompt), specials ok
    matrix: np.ndarray,  # (seq_len, S) from the align program
    probs: np.ndarray,  # (seq_len,) teacher-forced next-token probs
    prompt_len: int,
    n_frames: int,  # actual audio frames (duration / 20 ms)
    language: str = "en",
    time_offset: float = 0.0,
) -> List[dict]:
    """→ [{"word", "start", "end", "probability"}]."""
    text_ids = [int(t) for t in token_ids if int(t) < EOT]
    if not text_ids:
        return []
    # rows of `matrix` covering the generated text tokens
    rows = []
    pos = prompt_len
    row_of_tok = {}
    for t in token_ids:
        t = int(t)
        if t == EOT:
            break
        if t < EOT:
            row_of_tok[len(rows)] = pos
            rows.append(pos)
        pos += 1
    if not rows:
        return []
    sub = matrix[rows][:, : max(n_frames, 2)]
    ti, si = dtw_path(sub)
    # first/last frame of each token row on the path
    starts = np.zeros(len(rows), np.int64)
    ends = np.zeros(len(rows), np.int64)
    seen = set()
    for r, f in zip(ti, si):
        if r not in seen:
            starts[r] = f
            seen.add(r)
        ends[r] = f
    # token probability: probs[pos-1] predicts the token at pos
    tok_prob = {
        k: float(probs[v - 1]) if v >= 1 else 0.0 for k, v in row_of_tok.items()
    }
    words = []
    k = 0
    for group in split_word_tokens(tokenizer, text_ids, language):
        idxs = list(range(k, k + len(group)))
        k += len(group)
        if not idxs:
            continue
        word = tokenizer.decode(group)
        p = float(np.mean([tok_prob.get(i, 0.0) for i in idxs]))
        words.append(
            {
                "word": word,
                "start": round(time_offset + starts[idxs[0]] * FRAME_S, 2),
                "end": round(time_offset + (ends[idxs[-1]] + 1) * FRAME_S, 2),
                "probability": round(p, 4),
            }
        )
    return words
