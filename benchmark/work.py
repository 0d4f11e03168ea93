"""The yardstick's arithmetic: the card's peaks, each kernel's least time
from its shapes, and the model FLOPs of a served request.

A least time counts each input byte read once and each output byte written
once against the HBM rate, and the operations against the bf16 tensor-core
rate, and takes the larger. The three step bounds are frozen copies of the
arithmetic that ``chip_smoke.py`` (``_step_bound``, ``head_bound``,
``_gpt_step_bound``) applies to its own inputs, restated over the shapes a
served call has; a test holds them equal at the kernel table's shapes.
"""

from __future__ import annotations

#: NVIDIA H100 SXM, dense: bf16 tensor-core FLOP/s and HBM3 bytes/s
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_ms(n_bytes: float, ops: float) -> float:
    """The least milliseconds the card could take for the bytes and ops."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / BF16_FLOPS) * 1e3


def whisper_step_ms(*, L: int, D: int, H: int, bk: int, n_seq: int, s_audio: int,
                    xa_elem: int, xa_scaled: bool, picked: int, per_row_cols: int,
                    sel_numel: int) -> float:
    """One fused Whisper decode step: every int8 weight chunk, the 11
    scale and bias rows a layer reads, the LayerNorm rows, each window's
    real cross-KV columns (and their scales), the cache columns some row
    selects, the written columns, x in and out and ``sel``; the products
    and attention in bf16."""
    n_bytes = (
        L * 14 * D * D + L * 11 * D * 4 * 2 + L * 6 * D * 4
        + 2 * L * D * s_audio * n_seq * xa_elem
        + (2 * L * 2 * H * s_audio * n_seq if xa_scaled else 0)
        + 2 * L * D * picked * 2 + 2 * L * D * bk * 2
        + 2 * bk * D * 4 + sel_numel * 4
    )
    ops = L * (2 * bk * 14 * D * D + 4 * bk * D * per_row_cols + 4 * bk * D * s_audio)
    return least_ms(n_bytes, ops)


def whisper_head_ms(*, V: int, D: int, bk: int, k: int, int8: bool, grammar: bool) -> float:
    """One fused logits/top-k head call: the table (and its row scales),
    the suppress row, x, the LayerNorm rows (and the grammar state) read
    once, k candidates and the lse written per row; 2·BK·V·D operations."""
    n_bytes = (V * D * (1 if int8 else 2) + (V * 4 if int8 else 0) + V * 4 + bk * D * 4
               + 2 * D * 4 + (bk * 16 if grammar else 0) + bk * (k * 12 + 4))
    return least_ms(n_bytes, 2 * bk * V * D)


def gpt_step_ms(*, L: int, D: int, bk: int, picked: int, per_row_cols: int,
                sel_numel: int) -> float:
    """One fused XTTS GPT step: every int8 weight chunk, the 9 scale and
    bias rows a layer reads, the LayerNorm rows, the selected and the
    written cache columns, x in and out and ``sel``."""
    n_bytes = (L * 12 * D * D + L * 9 * D * 4 * 2 + L * 4 * D * 4
               + 2 * L * D * picked * 2 + 2 * L * D * bk * 2
               + 2 * bk * D * 4 + sel_numel * 4)
    ops = L * (2 * bk * 12 * D * D + 4 * bk * D * per_row_cols)
    return least_ms(n_bytes, ops)


# --------------------------------------------------------------------------- #
# Model FLOPs of the useful work (2 per multiply-add), from shapes
# --------------------------------------------------------------------------- #
def whisper_encoder_flops(*, d: int, layers: int, n_mels: int, frames: int = 3000) -> float:
    """One 30 s window through the conv stem and the encoder."""
    t = frames // 2
    stem = 2 * frames * d * n_mels * 3 + 2 * t * d * d * 3
    per_layer = 2 * t * 4 * d * d + 2 * 2 * t * t * d + 2 * t * 8 * d * d
    return stem + layers * per_layer


def whisper_decoder_token_flops(*, d: int, layers: int, vocab: int, pos: int,
                                s_audio: int = 1500, logits: bool = True) -> float:
    """One decoder row at cache position ``pos``: self-attention
    projections over ``pos + 1`` keys, cross-attention's q and o over
    ``s_audio`` keys, the MLP, and the logits head when asked."""
    per_layer = (2 * 4 * d * d + 2 * 2 * d * (pos + 1)
                 + 2 * 2 * d * d + 2 * 2 * d * s_audio
                 + 2 * 8 * d * d)
    return layers * per_layer + (2 * d * vocab if logits else 0)


def whisper_cross_kv_flops(*, d: int, layers: int, s_audio: int = 1500) -> float:
    return layers * 2 * 2 * s_audio * d * d


def gpt_token_flops(*, d: int, layers: int, vocab: int, pos: int, logits: bool = True) -> float:
    """One XTTS GPT position at ``pos``: the block products and attention
    over ``pos + 1`` keys, and the audio-code head when asked."""
    per_layer = 2 * 12 * d * d + 2 * 2 * d * (pos + 1)
    return layers * per_layer + (2 * d * vocab if logits else 0)


def hifigan_flops(*, n_latents: int, in_dim: int, channels: int, rates, up_kernels,
                  res_kernels, res_dilations, code_stride: int, sample_rate: int,
                  input_sample_rate: int, cond_dim: int) -> float:
    """The HiFi-GAN decoder over ``n_latents`` GPT latents: the two
    stretches to the hop grid, conv_pre, each transposed convolution and
    its three resblocks, conv_post (convolutions as their multiply-adds)."""
    total_up = 1
    for r in rates:
        total_up *= r
    t = n_latents * code_stride // total_up
    t = t * sample_rate // input_sample_rate
    flops = 2 * t * in_dim * channels * 7 + 2 * cond_dim * channels
    ch = channels
    for rate, k in zip(rates, up_kernels):
        out = ch // 2
        t *= rate
        flops += 2 * t * out * ch * k // rate + 2 * cond_dim * out
        for rk, dils in zip(res_kernels, res_dilations):
            flops += len(dils) * 2 * (2 * t * out * out * rk)
        ch = out
    return flops + 2 * t * ch * 7
