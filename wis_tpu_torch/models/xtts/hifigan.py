"""HiFi-GAN vocoder, XTTS decoder variant (port of
``wis_tpu/models/xtts/hifigan.py``).

GPT latents (B, T, 1024) → 24 kHz waveform, conditioned on the 512-dim
speaker embedding at every upsampling stage. Upsample rates (8, 8, 2, 2),
multi-receptive-field resblocks (kernels 3/7/11, dilations 1/3/5), and
Coqui HifiDecoder's two latent-timeline stages in front (half-pixel linear
interpolation ×(1024/256) and ×(24000/22050)): one audio token ≈ 1114.6
output samples (46.4 ms).

The parameter tree keeps the JAX package's layout: convolution weights
(K, C_in, C_out) ("HIO"), transposed-convolution weights (K, C_out, C_in),
activations (B, T, C). The convolutions are ``F.conv1d`` and
``F.conv_transpose1d`` in f32 (the JAX package's
``preferred_element_type=float32``), with XLA's ``"SAME"`` padding
reproduced exactly: for a convolution, the total pad
``(ceil(T/s) − 1)·s + (K−1)·d + 1 − T`` split low-first; for the
transposed one, JAX's ``_conv_transpose_padding`` cut out of the full
transposed output. No kernel of the JAX package is involved: it runs them
as XLA convolutions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class HiFiGANConfig:
    in_dim: int = 1024
    cond_dim: int = 512
    upsample_initial: int = 512
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernels: Tuple[int, ...] = (16, 16, 4, 4)
    resblock_kernels: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    sample_rate: int = 24000
    #: GPT code stride: one audio token covers this many samples at
    #: input_sample_rate (Coqui ar_mel_length_compression)
    gpt_code_stride: int = 1024
    #: the GPT latent timeline's native rate (Coqui input_sample_rate)
    input_sample_rate: int = 22050

    @property
    def total_upsample(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out

    def vocoded_length(self, n_tokens: int) -> int:
        """Output samples produced for n_tokens latent frames."""
        t4 = n_tokens * self.gpt_code_stride // self.total_upsample
        t_out = t4 * self.sample_rate // self.input_sample_rate
        return t_out * self.total_upsample

    @property
    def samples_per_token(self) -> float:
        return self.gpt_code_stride * self.sample_rate / self.input_sample_rate


def _same_pad(n: int, k_eff: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dimension (low side first)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k_eff - n, 0)
    return total // 2, total - total // 2


def _conv1d(x, w, b, stride: int = 1, dilation: int = 1):
    """x (B, T, C_in), w (K, C_in, C_out), "SAME" → (B, ceil(T/s), C_out)."""
    k = w.shape[0]
    lo, hi = _same_pad(x.shape[1], (k - 1) * dilation + 1, stride)
    xt = F.pad(x.float().transpose(1, 2), (lo, hi))
    y = F.conv1d(xt, w.float().permute(2, 1, 0), stride=stride, dilation=dilation)
    return (y.transpose(1, 2) + b.float()).to(x.dtype)


def _conv_transpose1d(x, w, b, stride: int):
    """x (B, T, C_in), w (K, C_out, C_in) as ``lax.conv_transpose(...,
    padding="SAME", transpose_kernel=True)`` → (B, T·stride, C_out)."""
    k = w.shape[0]
    pad_len = k + stride - 2
    pad_a = k - 1 if stride > k - 1 else int(np.ceil(pad_len / 2))
    pad_b = pad_len - pad_a
    # the full transposed output is the lhs-dilated input padded by k-1 on
    # each side; JAX pads by (pad_a, pad_b)
    y = F.conv_transpose1d(x.float().transpose(1, 2), w.float().permute(2, 1, 0), stride=stride)
    lo, hi = k - 1 - pad_a, k - 1 - pad_b
    y = F.pad(y, (-lo, -hi))
    return (y.transpose(1, 2) + b.float()).to(x.dtype)


def _resblock(x, blk, dilations):
    for i, d in enumerate(dilations):
        h = F.leaky_relu(x, 0.1)
        h = _conv1d(h, blk["w1"][i], blk["b1"][i], dilation=d)
        h = F.leaky_relu(h, 0.1)
        h = _conv1d(h, blk["w2"][i], blk["b2"][i], dilation=1)
        x = x + h
    return x


def _linear_interp(x: torch.Tensor, out_len: int, scale: float) -> torch.Tensor:
    """torch ``F.interpolate(mode="linear", align_corners=False)`` on the
    time axis of (B, T, C) with the user scale (output i reads source
    (i + 0.5) / scale − 0.5, edge-clamped), as the JAX package writes it in
    f32. The division runs in f64 and rounds once to f32, which gives the
    f32 quotient exactly (a divisor that is a Python float would otherwise
    become a multiply by its reciprocal on the card)."""
    t = x.shape[1]
    i = torch.arange(out_len, dtype=torch.float64, device=x.device)
    src = ((i + 0.5) / float(np.float32(scale))).float() - 0.5
    src = torch.clamp(src, 0.0, t - 1)
    lo = torch.floor(src).long()
    hi = torch.clamp_max(lo + 1, t - 1)
    w = (src - lo.float())[None, :, None]
    xf = x.float()
    return xf[:, lo] * (1.0 - w) + xf[:, hi] * w


def latent_timeline(latents: torch.Tensor, cfg: HiFiGANConfig) -> torch.Tensor:
    """Coqui HifiDecoder.forward's pre-stages: stretch the GPT latents onto
    the generator's output-rate hop grid (×(code_stride/hop), then
    ×(sample_rate/input_sample_rate)), lengths floored like torch."""
    t = latents.shape[1]
    if cfg.gpt_code_stride % cfg.total_upsample:
        raise ValueError(f"gpt_code_stride {cfg.gpt_code_stride} is not a multiple of the "
                         f"generator upsample {cfg.total_upsample}")
    z = latents
    t4 = t * cfg.gpt_code_stride // cfg.total_upsample
    if t4 != t:
        z = _linear_interp(z, t4, cfg.gpt_code_stride / cfg.total_upsample)
    if cfg.sample_rate != cfg.input_sample_rate:
        t_out = t4 * cfg.sample_rate // cfg.input_sample_rate
        z = _linear_interp(z, t_out, cfg.sample_rate / cfg.input_sample_rate)
    return z.to(latents.dtype)


def hifigan_forward(params: Dict, latents: torch.Tensor, speaker: torch.Tensor,
                    cfg: HiFiGANConfig) -> torch.Tensor:
    """latents (B, T, in_dim), speaker (B, cond_dim) → wav (B,
    cfg.vocoded_length(T)) f32 in (-1, 1)."""
    latents = latent_timeline(latents, cfg)
    x = _conv1d(latents, params["pre_w"], params["pre_b"])
    x = x + (speaker @ params["cond_w"] + params["cond_b"])[:, None, :].to(x.dtype)
    for i, rate in enumerate(cfg.upsample_rates):
        up = params["ups"][i]
        x = F.leaky_relu(x, 0.1)
        x = _conv_transpose1d(x, up["w"], up["b"], rate)
        # speaker conditioning at each upsample stage (cond_in_each_up_layer)
        x = x + (speaker @ up["cond_w"] + up["cond_b"])[:, None, :].to(x.dtype)
        acc = None
        for j in range(len(cfg.resblock_kernels)):
            r = _resblock(x, params["resblocks"][i][j], cfg.resblock_dilations[j])
            acc = r if acc is None else acc + r
        x = acc / len(cfg.resblock_kernels)
    # the original HiFi-GAN calls F.leaky_relu(o) with the DEFAULT slope
    # before conv_post — 0.01, not 0.1 (kept for checkpoint parity)
    x = F.leaky_relu(x, 0.01)
    x = _conv1d(x, params["post_w"], params["post_b"])
    return torch.tanh(x[..., 0])


def random_hifigan(cfg: HiFiGANConfig, seed: int = 0, dtype=torch.bfloat16,
                   device="cpu") -> Dict:
    """Seeded random weights equal, leaf for leaf and bit for bit, to the JAX
    package's ``random_hifigan(cfg, seed, dtype)``: the same numpy draws in
    the same order, moved to ``device`` once."""
    rng = np.random.default_rng(seed)

    def dense(*shape, scale=0.02):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    ch = cfg.upsample_initial
    params = {
        "pre_w": dense(7, cfg.in_dim, ch),
        "pre_b": zeros(ch),
        "cond_w": dense(cfg.cond_dim, ch),
        "cond_b": zeros(ch),
        "ups": [],
        "resblocks": [],
    }
    for k in cfg.upsample_kernels:
        out_ch = ch // 2
        params["ups"].append({
            "w": dense(k, out_ch, ch),  # (K, C_out, C_in) transposed
            "b": zeros(out_ch),
            "cond_w": dense(cfg.cond_dim, out_ch),
            "cond_b": zeros(out_ch),
        })
        stage = []
        for kernel, dils in zip(cfg.resblock_kernels, cfg.resblock_dilations):
            stage.append({
                "w1": [dense(kernel, out_ch, out_ch) for _ in dils],
                "b1": [zeros(out_ch) for _ in dils],
                "w2": [dense(kernel, out_ch, out_ch) for _ in dils],
                "b2": [zeros(out_ch) for _ in dils],
            })
        params["resblocks"].append(stage)
        ch = out_ch
    params["post_w"] = dense(7, ch, 1)
    params["post_b"] = zeros(1)
    return params
