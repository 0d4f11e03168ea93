"""Uni-MoE-2.0-Omni's speech-to-text path as plain PyTorch in float32: one
sequence, no cache, no batching, no kernel of the port. The tests hold the
program (``model.py``, ``moe.py``, ``decoding/omni.py``) to it.

It reads the checkpoint's tensors by name (``weights.hf_shapes``) and
computes, for one clip and a sequence of text tokens after the prompt,

    mel = log-mel (128 bins, openai's ``log_mel_spectrogram``: torch.stft)
    a   = WhisperEncoder(mel)                          (1500, 1280), exact GELU
    a   = Linear(adaptive_avg_pool1d(a over time, 200))   (200, D)      [assumed pooling]
    x   = [embed(head 16)] ‖ a ‖ [embed(tail 8)] ‖ [embed(tokens)]   [assumed framing]
    per layer (Qwen2):
        h = RMSNorm(x)
        q = h Wq + bq, k = h Wk + bk, v = h Wv + bv    [biases: Qwen2's]
        q, k = RoPE(q, k; θ, rotate-half, position = index)  [M-RoPE, one position in
                                                              all three sections: assumed]
        x = x + softmax(q kᵀ/√Dh + causal) v Wo        (query head j reads KV head j // 7)
        h = RMSNorm(x)
        p = softmax(h Wg)                              (5 slots: 4 dynamic, then null) [assumed]
        S = the fewest slots, by descending p (ties to the lower slot), whose sum
            reaches top_p, at most top_k
        x = x + Σ_fixed E(h) + Σ_{i∈S, i<4} p_i E_i(h)   [no renormalisation: assumed]
        E(h) = (silu(h Wgate) ⊙ h Wup) Wdown
    logits = RMSNorm(x) W_headᵀ

``torch.backends.cuda.matmul.allow_tf32`` and ``cudnn.allow_tf32`` are
set False while it runs.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE, N_FFT, HOP, N_SAMPLES = 16000, 400, 160, 480000


def mel_filters(n_mels: int) -> np.ndarray:
    """librosa's slaney mel filterbank at 16 kHz, n_fft 400."""

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        log = 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / (np.log(6.4) / 27.0)
        return np.where(f >= 1000.0, log, lin)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)),
                        m * (200.0 / 3))

    fft = np.linspace(0, SAMPLE_RATE / 2, 1 + N_FFT // 2)
    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(SAMPLE_RATE / 2), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - fft[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    return (w * (2.0 / (pts[2:] - pts[:-2]))[:, None]).astype(np.float32)


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(n,) float32 audio, zero-padded to 30 s → (n_mels, 3000)."""
    audio = F.pad(audio, (0, max(0, N_SAMPLES - audio.shape[-1])))[:N_SAMPLES]
    stft = torch.stft(audio, N_FFT, HOP, window=torch.hann_window(N_FFT, device=audio.device),
                      return_complex=True)
    power = stft[..., :-1].abs() ** 2
    spec = torch.clamp(torch.from_numpy(mel_filters(n_mels)).to(audio.device) @ power,
                       min=1e-10).log10()
    spec = torch.maximum(spec, spec.max() - 8.0)
    return (spec + 4.0) / 4.0


@contextlib.contextmanager
def full_f32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def select(p: torch.Tensor, top_p: float, top_k: int) -> List[int]:
    """The slots a token takes from its float32 router probabilities
    (slots,), the mass summed and compared in float32."""
    order = sorted(range(p.shape[0]), key=lambda i: (-float(p[i]), i))
    taken, mass = [], np.float32(0.0)
    for i in order[:top_k]:
        if taken and mass >= np.float32(top_p):
            break
        taken.append(i)
        mass = np.float32(mass + np.float32(float(p[i])))
    return taken


class Reference:
    """The model over the checkpoint's tensors ``sd`` (any dtype; read as
    float32) and a configuration (``config.OmniConfig``)."""

    def __init__(self, sd: Dict[str, torch.Tensor], cfg):
        self.sd, self.cfg = sd, cfg

    def t(self, name: str) -> torch.Tensor:
        return self.sd[name].float()

    # ------------------------------------------------------------------ #
    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """(n,) float32 audio → the connector's audio tokens (200, D)."""
        e, a = self.cfg.encoder, "model.audio_tower."
        x = log_mel(audio, e.n_mels)[None]
        x = F.gelu(F.conv1d(x, self.t(a + "conv1.weight"), self.t(a + "conv1.bias"), padding=1))
        x = F.gelu(F.conv1d(x, self.t(a + "conv2.weight"), self.t(a + "conv2.bias"), stride=2,
                            padding=1))
        x = x[0].T + self.t(a + "embed_positions.weight")
        d, heads = e.n_audio_state, e.n_audio_head
        for i in range(e.n_audio_layer):
            p = f"{a}layers.{i}."
            h = F.layer_norm(x, (d,), self.t(p + "self_attn_layer_norm.weight"),
                             self.t(p + "self_attn_layer_norm.bias"), 1e-5)
            q = h @ self.t(p + "self_attn.q_proj.weight").T + self.t(p + "self_attn.q_proj.bias")
            k = h @ self.t(p + "self_attn.k_proj.weight").T
            v = h @ self.t(p + "self_attn.v_proj.weight").T + self.t(p + "self_attn.v_proj.bias")
            q, k, v = (z.view(-1, heads, d // heads).transpose(0, 1) for z in (q, k, v))
            o = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d // heads), -1) @ v
            o = o.transpose(0, 1).reshape(-1, d)
            x = x + o @ self.t(p + "self_attn.out_proj.weight").T + self.t(
                p + "self_attn.out_proj.bias")
            h = F.layer_norm(x, (d,), self.t(p + "final_layer_norm.weight"),
                             self.t(p + "final_layer_norm.bias"), 1e-5)
            h = F.gelu(h @ self.t(p + "fc1.weight").T + self.t(p + "fc1.bias"))
            x = x + h @ self.t(p + "fc2.weight").T + self.t(p + "fc2.bias")
        x = F.layer_norm(x, (d,), self.t(a + "layer_norm.weight"), self.t(a + "layer_norm.bias"),
                         1e-5)
        pooled = F.adaptive_avg_pool1d(x.T[None], self.cfg.whisper_query_tokens_size)[0].T
        return pooled @ self.t("model.audio_projector.weight").T + self.t(
            "model.audio_projector.bias")

    def _rms(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.cfg.rms_norm_eps) * self.t(
            name)

    def _rope(self, x: torch.Tensor) -> torch.Tensor:
        """x (T, H, Dh) at positions 0..T-1."""
        dh = x.shape[-1]
        inv = 1.0 / (self.cfg.rope_theta ** (torch.arange(0, dh, 2, dtype=torch.float64) / dh))
        ang = torch.arange(x.shape[0], dtype=torch.float64)[:, None] * inv[None]
        ang = torch.cat([ang, ang], -1).to(x.device)
        cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
        rot = torch.cat([-x[..., dh // 2:], x[..., :dh // 2]], -1)
        return x * cos + rot * sin

    def _expert(self, h: torch.Tensor, prefix: str) -> torch.Tensor:
        g = h @ self.t(prefix + "gate_proj.weight").T
        u = h @ self.t(prefix + "up_proj.weight").T
        return (F.silu(g) * u) @ self.t(prefix + "down_proj.weight").T

    def layer(self, x: torch.Tensor, i: int, routes: Optional[list] = None) -> torch.Tensor:
        """Layer i over x (T, D); each token's taken slots appended to
        ``routes``."""
        cfg = self.cfg
        p = f"model.layers.{i}."
        nh, nkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        t = x.shape[0]
        h = self._rms(x, p + "input_layernorm.weight")
        proj = {n: h @ self.t(p + f"self_attn.{n}_proj.weight").T
                + self.t(p + f"self_attn.{n}_proj.bias") for n in "qkv"}
        q = self._rope(proj["q"].view(t, nh, dh)).transpose(0, 1)
        k = self._rope(proj["k"].view(t, nkv, dh)).transpose(0, 1)
        v = proj["v"].view(t, nkv, dh).transpose(0, 1)
        kv_of = torch.arange(nh, device=x.device) // (nh // nkv)
        s = q @ k[kv_of].transpose(-1, -2) / math.sqrt(dh)
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool, device=x.device).tril(), -math.inf)
        o = (torch.softmax(s, -1) @ v[kv_of]).transpose(0, 1).reshape(t, nh * dh)
        x = x + o @ self.t(p + "self_attn.o_proj.weight").T
        h = self._rms(x, p + "post_attention_layernorm.weight")
        y = sum(self._expert(h, f"{p}mlp.shared_experts.{j}.")
                for j in range(cfg.mlp_fixed_expert_num))
        probs = torch.softmax(h @ self.t(p + "mlp.gate.weight").T, -1)
        for tok in range(t):
            slots = select(probs[tok], cfg.mlp_dynamic_top_p, cfg.mlp_dynamic_top_k)
            if routes is not None:
                routes.append(tuple(slots))
            for e in slots:
                if e < cfg.mlp_dynamic_expert_num:
                    y[tok] = y[tok] + probs[tok, e] * self._expert(
                        h[tok:tok + 1], f"{p}mlp.experts.{e}.")[0]
        return x + y

    def prompt(self, audio_tokens: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
        cfg = self.cfg
        emb = self.t("model.embed_tokens.weight")
        dev = audio_tokens.device

        def ids(seq):
            ids = torch.tensor(list(seq), dtype=torch.long, device=dev)
            return emb[ids].reshape(-1, emb.shape[1])

        return torch.cat([ids(cfg.prompt_head), audio_tokens, ids(cfg.prompt_tail), ids(tokens)])

    def forward(self, audio: torch.Tensor, tokens: Sequence[int] = (),
                routes: Optional[list] = None) -> torch.Tensor:
        """Logits (P + len(tokens), V) of the prompt for ``audio`` followed
        by ``tokens``; ``routes`` gets each (layer, token)'s slots, layer
        by layer."""
        with full_f32():
            return self.decode(self.encode(audio.float()), tokens, routes)

    def decode(self, audio_tokens: torch.Tensor, tokens: Sequence[int] = (),
               routes: Optional[list] = None) -> torch.Tensor:
        """``forward`` from the connector's audio tokens (200, D) on."""
        with full_f32():
            x = self.prompt(audio_tokens.float(), tokens)
            for i in range(self.cfg.num_hidden_layers):
                x = self.layer(x, i, routes)
            return self._rms(x, "model.norm.weight") @ self.t("lm_head.weight").T

    def greedy(self, audio: torch.Tensor, cap: int) -> Tuple[List[int], torch.Tensor]:
        """Greedy decoding without a cache (the whole sequence again each
        token): the reply to its first EOS or its cap, and the logits that
        chose each token."""
        out: List[int] = []
        rows = []
        for _ in range(cap):
            row = self.forward(audio, out)[-1]
            rows.append(row)
            out.append(int(row.argmax()))
            if out[-1] == self.cfg.eos_token_id:
                break
        return out, torch.stack(rows)
