"""Plain Whisper in float32 (openai ``whisper/model.py`` and
``whisper/audio.py``), over HF ``WhisperForConditionalGeneration`` tensors.

Departures from the published model, each because the configuration states
it: the decoder's matmul weights are held at int8 per output channel, the
logits table at int8 per row and the cross-attention K/V at int8 per audio
position (``quant.py``); at ``mode="control"`` one step lower (int4, and
fp8 for the bf16 weights). Everything else is float32 with TF32 off; the
GELU is the exact (erf) one the published model uses.

``teacher_forced`` runs a prompt and the served tokens over windows'
cross-attention K/V at once and returns the logits at each served
position; ``beam_search`` decodes a window as the deployment's beam search
does, and ``score`` scores a hypothesis as it ranks them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import quant

SAMPLE_RATE, N_FFT, HOP, N_SAMPLES = 16000, 400, 160, 480000
#: the decoder weights the configuration holds at int8
_INT8_LEAVES = ("q_proj.weight", "k_proj.weight", "v_proj.weight", "out_proj.weight",
                "fc1.weight", "fc2.weight")


def mel_filters(n_mels: int, sr: int = SAMPLE_RATE, n_fft: int = N_FFT) -> np.ndarray:
    """librosa's slaney-normalized mel filterbank (``librosa.filters.mel``),
    the table openai ships as ``mel_filters.npz``."""

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        f_sp, min_log_hz = 200.0 / 3, 1000.0
        logstep = np.log(6.4) / 27.0
        return np.where(f >= min_log_hz,
                        min_log_hz / f_sp + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
                        f / f_sp)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        f_sp, min_log_hz = 200.0 / 3, 1000.0
        min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        m * f_sp)

    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - fft_freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (pts[2:n_mels + 2] - pts[:n_mels]))[:, None]
    return w.astype(np.float32)


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """openai ``log_mel_spectrogram``: (B, 480000) float32 → (B, n_mels, 3000)."""
    window = torch.hann_window(N_FFT, device=audio.device)
    stft = torch.stft(audio, N_FFT, HOP, window=window, return_complex=True)
    power = stft[..., :-1].abs() ** 2
    filters = torch.from_numpy(mel_filters(n_mels)).to(audio.device)
    spec = torch.clamp(filters @ power, min=1e-10).log10()
    spec = torch.maximum(spec, spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (spec + 4.0) / 4.0


class Whisper:
    """The model's float32 weights, rounded as ``mode`` asks."""

    def __init__(self, sd: Dict[str, torch.Tensor], cfg: Dict, mode: str = "served"):
        self.cfg, self.mode = cfg, mode
        self.t = {k.removeprefix("model."): v for k, v in sd.items()}
        self.d = cfg["d_model"]
        self._w: Dict[str, torch.Tensor] = {}

    def w(self, name: str) -> torch.Tensor:
        """A weight as the configuration holds it (the decoder's matmul
        weights and the logits table int8, the rest bf16 as given), rounded
        as the mode asks, in float32; reduced over every axis but the
        output channel (the table: per row)."""
        if name not in self._w:
            x = self.t[name]
            stated = "int8" if name.startswith("decoder.layers.") and name.endswith(
                _INT8_LEAVES) or name == "decoder.embed_tokens.weight" else "bf16"
            self._w[name] = quant.weight(x, stated, self.mode, dim=tuple(range(1, x.dim())))
        return self._w[name]

    # ------------------------------------------------------------------ #
    def _ln(self, x, name):
        return F.layer_norm(x, (self.d,), self.t[name + ".weight"].float(),
                            self.t[name + ".bias"].float(), 1e-5)

    def _lin(self, x, name, bias=True):
        y = x @ self.w(name + ".weight").T
        return y + self.t[name + ".bias"].float() if bias else y

    def _attn(self, x, kv, prefix, heads, causal, cross_kv=None, past=None):
        """Attention of x over kv (or over ``cross_kv``). ``past``, a
        one-entry list holding this layer's self-attention K/V so far (or
        None), continues those rows: x's positions follow them, and the
        entry is replaced by the K/V grown by x's."""
        b, t, d = x.shape
        dh = d // heads
        q = self._lin(x, prefix + ".q_proj").view(b, t, heads, dh).transpose(1, 2)
        if cross_kv is None:
            k = self._lin(kv, prefix + ".k_proj", bias=False)
            v = self._lin(kv, prefix + ".v_proj")
            k = k.view(b, -1, heads, dh).transpose(1, 2)
            v = v.view(b, -1, heads, dh).transpose(1, 2)
            if past is not None:
                if past[0] is not None:
                    k = torch.cat([past[0][0], k], dim=-2)
                    v = torch.cat([past[0][1], v], dim=-2)
                past[0] = (k, v)
        else:
            k, v = cross_kv
        s = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
        if causal:
            t0 = k.shape[-2] - t
            mask = torch.ones(t, k.shape[-2], dtype=torch.bool, device=x.device).tril(t0)
            s = s.masked_fill(~mask, float("-inf"))
        o = torch.softmax(s, dim=-1) @ v
        return self._lin(o.transpose(1, 2).reshape(b, t, d), prefix + ".out_proj")

    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, 480000) float32 audio → encoder states (B, 1500, d)."""
        cfg = self.cfg
        x = log_mel(audio, cfg["num_mel_bins"])
        x = F.gelu(F.conv1d(x, self.w("encoder.conv1.weight"),
                            self.t["encoder.conv1.bias"].float(), padding=1))
        x = F.gelu(F.conv1d(x, self.w("encoder.conv2.weight"),
                            self.t["encoder.conv2.bias"].float(), stride=2, padding=1))
        x = x.transpose(1, 2) + self.t["encoder.embed_positions.weight"].float()
        for i in range(cfg["encoder_layers"]):
            p = f"encoder.layers.{i}"
            h = self._ln(x, p + ".self_attn_layer_norm")
            x = x + self._attn(h, h, p + ".self_attn", cfg["encoder_attention_heads"], False)
            h = self._ln(x, p + ".final_layer_norm")
            x = x + self._lin(F.gelu(self._lin(h, p + ".fc1")), p + ".fc2")
        return self._ln(x, "encoder.layer_norm")

    def cross_kv(self, xa: torch.Tensor) -> List:
        """Each decoder layer's cross-attention K and V, heads split, with
        the configuration's per-position rounding."""
        cfg = self.cfg
        heads = cfg["decoder_attention_heads"]
        b, s, d = xa.shape
        out = []
        for i in range(cfg["decoder_layers"]):
            p = f"decoder.layers.{i}.encoder_attn"
            k = self._lin(xa, p + ".k_proj", bias=False).view(b, s, heads, d // heads)
            v = self._lin(xa, p + ".v_proj").view(b, s, heads, d // heads)
            out.append((quant.kv(k, -1, self.mode).transpose(1, 2),
                        quant.kv(v, -1, self.mode).transpose(1, 2)))
        return out

    def decode(self, tokens: torch.Tensor, xkv: List, cache: Optional[List] = None
               ) -> torch.Tensor:
        """Decoder: tokens (B, T) → logits (B, T, V). ``cache`` (from
        ``new_cache``, grown in place) holds the rows' self-attention K/V
        so far; the tokens continue those rows."""
        cfg = self.cfg
        heads = cfg["decoder_attention_heads"]
        t = tokens.shape[1]
        t0 = 0 if cache is None or cache[0][0] is None else cache[0][0][0].shape[-2]
        x = (self.t["decoder.embed_tokens.weight"].float()[tokens]
             + self.t["decoder.embed_positions.weight"].float()[t0:t0 + t])
        for i in range(cfg["decoder_layers"]):
            p = f"decoder.layers.{i}"
            h = self._ln(x, p + ".self_attn_layer_norm")
            x = x + self._attn(h, h, p + ".self_attn", heads, True,
                               past=None if cache is None else cache[i])
            h = self._ln(x, p + ".encoder_attn_layer_norm")
            x = x + self._attn(h, None, p + ".encoder_attn", heads, False, cross_kv=xkv[i])
            h = self._ln(x, p + ".final_layer_norm")
            x = x + self._lin(F.gelu(self._lin(h, p + ".fc1")), p + ".fc2")
        x = self._ln(x, "decoder.layer_norm")
        # the logits table, held per row at int8; the lookup above reads it
        # as given
        return x @ self.w("decoder.embed_tokens.weight").T

    def new_cache(self) -> List:
        return [[None] for _ in range(self.cfg["decoder_layers"])]

    def beam_search(self, xkv: List, prompt: List[int], beam: int, cap: int, suppress,
                    begin_suppress, eot: int) -> Tuple[List[int], float]:
        """One window's best hypothesis under whisper's beam search as the
        deployment runs it (openai ``BeamSearchDecoder`` with HF's
        hypothesis store), and its score: each running beam offers its
        ``beam + 1`` best tokens; of the best ``2·beam`` offers the best
        ``beam`` that neither end in EOT nor reach the cap run on; those
        that do, among the best ``beam``, join a store of ``beam``
        hypotheses scored by their summed log-probability over their
        length (EOT counted); decoding stops at the cap, or once the store
        is full and the best running beam, over the current length, cannot
        beat its worst. Log-probabilities are renormalised over the tokens
        the masks leave (the first step masks ``begin_suppress`` too).
        ``beam`` 1 is greedy. ``xkv`` holds one window."""
        vocab = self.cfg["vocab_size"]
        dev = xkv[0][0].device
        sup = suppress_mask(vocab, suppress, dev)
        cap = max(int(cap), 1)
        cache = self.new_cache()
        logits = self.decode(torch.tensor([list(prompt)], device=dev), xkv, cache)[0, -1]
        lp = torch.log_softmax(logits + sup + suppress_mask(vocab, begin_suppress, dev), -1)
        kc = 1 if beam == 1 else beam + 1
        # offers: (summed log-probability, tokens, parent row), best first
        vals, toks = _top(lp, kc)
        offers = [(v, [t], 0) for v, t in zip(vals, toks)]
        store: List[Tuple[float, List[int]]] = []
        step = 0
        while True:
            hits = [o for o in offers[:beam] if o[1][-1] == eot or step + 1 >= cap]
            store = sorted(store + [(o[0] / (step + 1), o[1]) for o in hits],
                           key=lambda h: -h[0])[:beam]
            running = [o for o in offers if not (o[1][-1] == eot or step + 1 >= cap)][:beam]
            if beam == 1 and hits:
                break
            if not running or (len(store) == beam
                               and running[0][0] / (step + 1) <= store[-1][0]):
                break
            rows = torch.tensor([o[2] for o in running], device=dev)
            for entry in cache:
                entry[0] = (entry[0][0][rows], entry[0][1][rows])
            last = torch.tensor([[o[1][-1]] for o in running], device=dev)
            logits = self.decode(last, xkv, cache)[:, -1]
            lp = torch.log_softmax(logits + sup, -1)
            offers = []
            for r, o in enumerate(running):
                vals, toks = _top(lp[r], kc)
                offers += [(o[0] + v, o[1] + [t], r) for v, t in zip(vals, toks)]
            offers = sorted(offers, key=lambda o: -o[0])[:2 * beam]
            step += 1
        score, tokens = store[0]
        return tokens, score

    def teacher_forced(self, xkv: List, prompt: List[int], served: List[List[int]]
                       ) -> List[torch.Tensor]:
        """Windows' cross-attention K/V (``cross_kv``), a shared prompt and
        each window's served tokens → per window the logits (n_i, V) that
        predict its n_i served tokens."""
        n = max(len(s) for s in served)
        seq = torch.full((len(served), len(prompt) + max(n - 1, 0)), 0, dtype=torch.long)
        for i, s in enumerate(served):
            row = list(prompt) + list(s[:-1])
            seq[i, :len(row)] = torch.tensor(row)
        logits = self.decode(seq.to(xkv[0][0].device), xkv)
        p = len(prompt)
        return [logits[i, p - 1: p - 1 + len(s)] for i, s in enumerate(served)]


def _top(x: torch.Tensor, k: int) -> Tuple[List[float], List[int]]:
    """The k largest of a row, best first, ties to the lower index."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k].tolist(), idx[:k].tolist()


def score(logits: torch.Tensor, tokens: List[int], suppress, begin_suppress) -> float:
    """A hypothesis's score as the beam search ranks it: the summed
    log-probability of its tokens (renormalised over the masked logits,
    as ``beam_search``) over their number."""
    masked = logits + suppress_mask(logits.shape[-1], suppress, logits.device)
    masked[0] += suppress_mask(logits.shape[-1], begin_suppress, logits.device)
    lp = torch.log_softmax(masked, -1)
    got = lp[torch.arange(len(tokens)), torch.tensor(tokens, device=logits.device)]
    return float(got.sum()) / len(tokens)


def suppress_mask(vocab: int, suppress, device) -> torch.Tensor:
    m = torch.zeros(vocab, device=device)
    m[list(suppress)] = float("-inf")
    return m


def rank_gaps(logits: torch.Tensor, tokens: List[int], kc: int, suppress, begin_suppress
              ) -> torch.Tensor:
    """How far each served token's logit lies below the kc-th best of the
    reference's masked logits at its position (0 when it is among them):
    a beam of width kc - 1 keeps kc candidates per row, so a sound program
    serves from the reference's top kc but for rounding near ties."""
    masked = logits + suppress_mask(logits.shape[-1], suppress, logits.device)
    masked[0] += suppress_mask(logits.shape[-1], begin_suppress, logits.device)
    thr = torch.topk(masked, kc, dim=-1).values[:, -1]
    got = masked[torch.arange(len(tokens)), torch.tensor(tokens, device=logits.device)]
    return torch.clamp_min(thr - got, 0.0)


def windows_of(pcm: np.ndarray, n_windows: Optional[int], chunk_s: int, step_s: int
               ) -> np.ndarray:
    """A request's 30 s windows as int16: the whole clip padded, or for a
    long recording ``n_windows`` windows of ``chunk_s`` seconds every
    ``step_s`` seconds, each padded to 30 s."""
    if n_windows is None:
        out = np.zeros((1, N_SAMPLES), np.int16)
        out[0, :min(len(pcm), N_SAMPLES)] = pcm[:N_SAMPLES]
        return out
    out = np.zeros((n_windows, N_SAMPLES), np.int16)
    for w in range(n_windows):
        seg = pcm[w * step_s * SAMPLE_RATE: w * step_s * SAMPLE_RATE + chunk_s * SAMPLE_RATE]
        out[w, :len(seg)] = seg
    return out
