"""Plain XTTS v2 in float32 over Coqui ``model.pth`` tensors: the GPT-2
decoder of audio codes and the HiFi-GAN decoder (Coqui ``gpt.py``,
``hifigan_decoder.py``), with the port's documented request layout.

Departures from Coqui, each the layout the port serves (its
``models/xtts/model.py`` docstring) and noted in PERF.md:

- the prompt is ``[gpt_cond_latent] [text ids, padded with id 0 to the
  text bucket] [START_AUDIO at audio position 0]``, with no start or stop
  text token, and the first decode step feeds START_AUDIO again at audio
  position 1;
- the text ids of a tokenizer-less model are ``7 + byte % (vocab - 10)``
  over ``[lang]`` and the cleaned text (``text_ids``; the cleaning here
  covers the lower-case words, spaces and full stop the traffic sends);
- the history of the repetition penalty always holds token 0.

The GPT's block products are held at int8 per output channel as the
configuration states (int4 at ``mode="control"``, and fp8 for the rest);
the stream's cut into chunks, each vocoded with two latents of left
context, cut to the tokens' boundaries and cross-faded, is the port's
(``stream_audio``).
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import quant

_INT8 = ("attn.c_attn.weight", "attn.c_proj.weight", "mlp.c_fc.weight", "mlp.c_proj.weight")


def text_ids(text: str, language: str, vocab: int, max_tokens: int) -> List[int]:
    """The prompt's text ids without a tokenizer file."""
    clean = re.sub(r"\s+", " ", text.replace('"', "").lower()).strip()
    ids = [7 + (b % (vocab - 10)) for b in f"[{language}]{clean}".encode()]
    return ids[:max_tokens]


def _gelu_new(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


class XTTS:
    def __init__(self, sd: Dict[str, torch.Tensor], cfg: Dict, mode: str = "served"):
        self.sd, self.cfg, self.mode = sd, cfg, mode
        self._w: Dict[str, torch.Tensor] = {}

    def w(self, name: str) -> torch.Tensor:
        """A weight as the configuration holds it, rounded by the mode;
        GPT-2 Conv1D weights are (in, out), the others (out, in, ...)."""
        if name not in self._w:
            x = self.sd[name]
            if name.startswith("gpt.gpt.h.") and name.endswith(_INT8):
                self._w[name] = quant.weight(x, "int8", self.mode, dim=0)
            elif x.dim() >= 2 and not name.endswith(("embedding.weight", "emb.weight")):
                self._w[name] = quant.weight(x, "bf16", self.mode,
                                             dim=tuple(range(1, x.dim())))
            else:
                self._w[name] = x.float()
        return self._w[name]

    def b(self, name: str) -> torch.Tensor:
        return self.sd[name].float()

    # ------------------------------------------------------------------ #
    def gpt(self, x: torch.Tensor) -> torch.Tensor:
        """Causal GPT-2 over embedded positions (T, d) → the final hidden
        states after ``ln_f`` and ``final_norm``."""
        g = self.cfg["gpt"]
        d, heads = g["gpt_n_model_channels"], g["gpt_n_heads"]
        dh = d // heads
        t = x.shape[0]
        mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        for i in range(g["gpt_layers"]):
            p = f"gpt.gpt.h.{i}."
            h = F.layer_norm(x, (d,), self.b(p + "ln_1.weight"), self.b(p + "ln_1.bias"), 1e-5)
            qkv = h @ self.w(p + "attn.c_attn.weight") + self.b(p + "attn.c_attn.bias")
            q, k, v = (a.view(t, heads, dh).transpose(0, 1) for a in qkv.split(d, dim=-1))
            s = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
            o = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1) @ v
            o = o.transpose(0, 1).reshape(t, d)
            x = x + o @ self.w(p + "attn.c_proj.weight") + self.b(p + "attn.c_proj.bias")
            h = F.layer_norm(x, (d,), self.b(p + "ln_2.weight"), self.b(p + "ln_2.bias"), 1e-5)
            h = _gelu_new(h @ self.w(p + "mlp.c_fc.weight") + self.b(p + "mlp.c_fc.bias"))
            x = x + h @ self.w(p + "mlp.c_proj.weight") + self.b(p + "mlp.c_proj.bias")
        x = F.layer_norm(x, (d,), self.b("gpt.gpt.ln_f.weight"), self.b("gpt.gpt.ln_f.bias"), 1e-5)
        return F.layer_norm(x, (d,), self.b("gpt.final_norm.weight"),
                            self.b("gpt.final_norm.bias"), 1e-5)

    def teacher_forced(self, cond: torch.Tensor, text: List[int], bucket: int,
                       tokens: List[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The served audio codes through the GPT at once → (logits (n, V)
        that predict them, latents (n, d), the vocoder's input)."""
        g = self.cfg["gpt"]
        dev = cond.device
        start = g["gpt_start_audio_token"]
        text_pad = torch.zeros(bucket, dtype=torch.long, device=dev)
        text_pad[:len(text)] = torch.tensor(text, device=dev)
        temb = self.w("gpt.text_embedding.weight")[text_pad] + self.w(
            "gpt.text_pos_embedding.emb.weight")[:bucket]
        apos = self.w("gpt.mel_pos_embedding.emb.weight")
        audio_in = torch.tensor([start, start] + list(tokens[:-1]), device=dev)
        rows = torch.clamp(torch.arange(len(audio_in), device=dev), max=apos.shape[0] - 1)
        aemb = self.w("gpt.mel_embedding.weight")[audio_in] + apos[rows]
        x = torch.cat([cond, temb, aemb])
        hidden = self.gpt(x)[-len(tokens):]
        logits = hidden @ self.w("gpt.mel_head.weight").T + self.b("gpt.mel_head.bias")
        return logits, hidden

    # ------------------------------------------------------------------ #
    def vocode(self, latents: torch.Tensor, speaker: torch.Tensor) -> torch.Tensor:
        """HiFi-GAN decoder: latents (T, 1024), speaker (512,) → wav."""
        v = self.cfg["hifigan"]
        p = "hifigan_decoder.waveform_decoder."
        z = latents.T[None]
        z = F.interpolate(z, scale_factor=v["gpt_code_stride_len"] / math.prod(
            v["upsample_rates"]), mode="linear")
        z = F.interpolate(z, scale_factor=v["output_sample_rate"] / v["input_sample_rate"],
                          mode="linear")
        g = speaker[None, :, None]
        x = F.conv1d(z, self.w(p + "conv_pre.weight"), self.b(p + "conv_pre.bias"), padding=3)
        x = x + F.conv1d(g, self.w(p + "cond_layer.weight"), self.b(p + "cond_layer.bias"))
        n_rk = len(v["resblock_kernel_sizes"])
        for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
            x = F.leaky_relu(x, 0.1)
            x = F.conv_transpose1d(x, self.w(p + f"ups.{i}.weight"), self.b(p + f"ups.{i}.bias"),
                                   stride=u, padding=(k - u) // 2)
            x = x + F.conv1d(g, self.w(p + f"conds.{i}.weight"), self.b(p + f"conds.{i}.bias"))
            acc = 0
            for j, (rk, dils) in enumerate(zip(v["resblock_kernel_sizes"],
                                               v["resblock_dilation_sizes"])):
                q = p + f"resblocks.{i * n_rk + j}."
                y = x
                for m, dil in enumerate(dils):
                    h = F.leaky_relu(y, 0.1)
                    h = F.conv1d(h, self.w(q + f"convs1.{m}.weight"), self.b(q + f"convs1.{m}.bias"),
                                 dilation=dil, padding=dil * (rk - 1) // 2)
                    h = F.leaky_relu(h, 0.1)
                    h = F.conv1d(h, self.w(q + f"convs2.{m}.weight"), self.b(q + f"convs2.{m}.bias"),
                                 padding=(rk - 1) // 2)
                    y = y + h
                acc = acc + y
            x = acc / n_rk
        x = F.conv1d(F.leaky_relu(x), self.w(p + "conv_post.weight"),
                     self.b(p + "conv_post.bias"), padding=3)
        return torch.tanh(x)[0, 0]


def chunk_sizes(chunk: int, cap: int) -> List[int]:
    """The stream's schedule: a short first chunk, steady chunks, and a
    remainder at the token cap."""
    sizes = [min(6, chunk)]
    while sum(sizes) + chunk <= cap:
        sizes.append(chunk)
    if cap - sum(sizes) > 0:
        sizes.append(cap - sum(sizes))
    return sizes


def stream_audio(model: XTTS, latents: torch.Tensor, n_valid: int, speaker: torch.Tensor,
                 chunk: int, overlap: int = 1024, left: int = 2) -> List[np.ndarray]:
    """The audio chunks a stream emits for its latents: each chunk vocoded
    with ``left`` latents of context, cut to its valid tokens' boundary and
    cross-faded with the last chunk's tail."""
    v = model.cfg["hifigan"]
    cap = model.cfg["gpt"]["gpt_max_audio_tokens"]

    def target(n: int) -> int:
        return n * v["gpt_code_stride_len"] * v["output_sample_rate"] // v["input_sample_rate"]

    d = latents.shape[1]
    ctx = torch.zeros(left, d, device=latents.device)
    out, prev, emitted, at = [], None, 0, 0
    for c in chunk_sizes(chunk, cap):
        lat = latents[at:at + c]
        if lat.shape[0] < c:  # steps after the stop: the program pads with stop's latents
            break
        valid = min(c, n_valid - at)
        full = model.vocode(torch.cat([ctx, lat]), speaker).cpu().numpy()
        ctx = lat[-left:]
        at += c
        if valid <= 0:
            break
        want = target(emitted + valid) - target(emitted)
        end = round(len(full) * (left + valid) / (left + c))
        wav = full[max(0, end - want):end].copy()
        if prev is not None and overlap > 0:
            n = min(len(prev), overlap, len(wav))
            if n > 0:
                ramp = np.linspace(0.0, 1.0, n, dtype=np.float32)
                wav[:n] = wav[:n] * ramp + prev[:n] * (1 - ramp)
        if overlap > 0 and len(wav) > overlap:
            prev = wav[-overlap:].copy()
        emitted += valid
        out.append(wav)
        if valid < c:
            break
    return out
