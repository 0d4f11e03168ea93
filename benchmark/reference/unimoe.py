"""Plain Uni-MoE-2.0-Omni (speech to text) in float32 over the checkpoint's
tensors (``weights_omni.py``), for the check of the ``omni-commands`` cell.

The audio tower is ``whisper.Whisper.encode`` (openai's encoder, exact
GELU); the rest follows the layer equations the configuration states:

    a = Linear(adaptive_avg_pool1d(encoder(log-mel) over time, 200))
    x = [embed(prompt_head)] ‖ a ‖ [embed(prompt_tail)] ‖ [embed(tokens)]
    per layer: h = RMSNorm(x); q, k, v = h W + b; q, k = RoPE (rotate-half, θ,
               position = index); x += softmax(q kᵀ/√Dh + causal) v Wo, query head j
               reading KV head j // (heads / KV heads);
               h = RMSNorm(x); p = softmax(h Wg) in float32 over the dynamic experts
               then the null one; S = the fewest slots by descending p (ties to the
               lower slot) whose sum reaches top_p, at most top_k;
               x += Σ_fixed E(h) + Σ_{i∈S, dynamic} p_i E_i(h),
               E(h) = (silu(h Wgate) ⊙ h Wup) Wdown
    logits = RMSNorm(x) W_headᵀ

It computes a layer at a time over every sequence of a batch, reading each
weight in float32 as it goes, so the 26 B parameters stay in bf16 on the
card. ``mode="control"`` holds every Linear weight at fp8 e4m3 with a
per-output-channel scale (``quant.fp8``), the step below the bf16 the
configuration states. Each layer's routing is returned as, per token, the
bit mask of the slots it took.

``teacher_forced`` may be handed the routing another side took (``forced``,
the same masks): the judge then runs each token's layers through the
experts that side took, weighted by the judge's own probabilities, and
still returns its own choice at every (token, layer). So one flip under
rounding near a tie does not carry into the later layers and tokens: the
logits read the other side's path at float32, and the routes compare the
judge's choice with that side's on the same path.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import quant
from benchmark.reference import whisper as wref

AUDIO = "model.audio_tower."


class UniMoE:
    def __init__(self, sd: Dict[str, torch.Tensor], cfg: Dict, mode: str = "served"):
        self.sd, self.cfg, self.mode = sd, cfg, mode
        e = cfg["audio_encoder"]
        enc_cfg = {"d_model": e["d_model"], "encoder_layers": e["encoder_layers"],
                   "encoder_attention_heads": e["encoder_attention_heads"],
                   "num_mel_bins": e["num_mel_bins"]}
        self.encoder = wref.Whisper({"model.encoder." + k[len(AUDIO):]: v for k, v in sd.items()
                                     if k.startswith(AUDIO)}, enc_cfg, mode)
        gen = cfg["generation"]
        self.head, self.tail = list(gen["prompt_head"]), list(gen["prompt_tail"])
        self.eos = gen["eos_token_id"]
        self.p_len = len(self.head) + cfg["whisper_query_tokens_size"] + len(self.tail)

    def t(self, name: str) -> torch.Tensor:
        return self.sd[name].float()

    def w(self, name: str) -> torch.Tensor:
        """A Linear weight (out, in) in float32 as the mode holds it."""
        return quant.weight(self.sd[name], "bf16", self.mode, dim=1)

    # ------------------------------------------------------------------ #
    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, 480000) float32 audio → the audio tokens (B, 200, D)."""
        xa = self.encoder.encode(audio)
        pooled = F.adaptive_avg_pool1d(xa.transpose(1, 2), self.cfg["whisper_query_tokens_size"])
        return pooled.transpose(1, 2) @ self.w("model.audio_projector.weight").T + self.t(
            "model.audio_projector.bias")

    def _rms(self, x: torch.Tensor, name: str) -> torch.Tensor:
        eps = self.cfg["rms_norm_eps"]
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * self.t(name)

    def _rope(self, x: torch.Tensor, pos0: int) -> torch.Tensor:
        """x (B, H, T, Dh) at positions pos0...; float64 angles."""
        dh, t = x.shape[-1], x.shape[-2]
        inv = 1.0 / (self.cfg["rope_theta"] ** (torch.arange(0, dh, 2, dtype=torch.float64) / dh))
        ang = torch.arange(pos0, pos0 + t, dtype=torch.float64)[:, None] * inv[None]
        ang = torch.cat([ang, ang], -1).to(x.device)
        rot = torch.cat([-x[..., dh // 2:], x[..., :dh // 2]], -1)
        return x * ang.cos().float() + rot * ang.sin().float()

    def _expert(self, h: torch.Tensor, prefix: str) -> torch.Tensor:
        g = h @ self.w(prefix + "gate_proj.weight").T
        u = h @ self.w(prefix + "up_proj.weight").T
        return (F.silu(g) * u) @ self.w(prefix + "down_proj.weight").T

    def _route(self, h: torch.Tensor, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """h (N, D) → probabilities (N, slots) and the taken slots' mask
        (N, slots) bool."""
        cfg = self.cfg
        p = torch.softmax(h @ self.w(name).T, -1)
        vals, order = torch.sort(p, dim=-1, descending=True, stable=True)
        k = cfg["mlp_dynamic_top_k"]
        before = torch.cat([torch.zeros_like(vals[:, :1]), torch.cumsum(vals, -1)[:, :-1]], -1)
        keep = (before < cfg["mlp_dynamic_top_p"]) & (torch.arange(p.shape[1], device=h.device) < k)
        taken = torch.zeros_like(keep).scatter_(1, order, keep)
        return p, taken

    def _layer(self, x: torch.Tensor, i: int, pos0: int, past: Optional[list],
               forced: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer i over x (B, T, D) at positions pos0...; ``past`` (a
        one-entry list, or None) holds the layer's K/V before x's and is
        grown; ``forced`` (B, T) route masks, −1 where the layer's own
        choice is taken, sets the experts each token runs. → (x, the
        layer's own route masks (B, T) int64)."""
        cfg = self.cfg
        b, t, d = x.shape
        nh, nkv, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
        p = f"model.layers.{i}."
        a = p + "self_attn."
        h = self._rms(x, p + "input_layernorm.weight")
        q = (h @ self.w(a + "q_proj.weight").T + self.t(a + "q_proj.bias")).view(b, t, nh, dh)
        k = (h @ self.w(a + "k_proj.weight").T + self.t(a + "k_proj.bias")).view(b, t, nkv, dh)
        v = (h @ self.w(a + "v_proj.weight").T + self.t(a + "v_proj.bias")).view(b, t, nkv, dh)
        q = self._rope(q.transpose(1, 2), pos0)
        k = self._rope(k.transpose(1, 2), pos0)
        v = v.transpose(1, 2)
        if past is not None:
            if past[0] is not None:
                k = torch.cat([past[0][0], k], 2)
                v = torch.cat([past[0][1], v], 2)
            past[0] = (k, v)
        kv_of = torch.arange(nh, device=x.device) // (nh // nkv)
        s = q @ k[:, kv_of].transpose(-1, -2) / math.sqrt(dh)
        n_keys = k.shape[2]
        causal = torch.ones(t, n_keys, dtype=torch.bool, device=x.device).tril(n_keys - t)
        s = s.masked_fill(~causal, -math.inf)
        o = (torch.softmax(s, -1) @ v[:, kv_of]).transpose(1, 2).reshape(b, t, nh * dh)
        x = x + o @ self.w(a + "o_proj.weight").T
        h = self._rms(x, p + "post_attention_layernorm.weight").reshape(b * t, d)
        y = sum(self._expert(h, f"{p}mlp.shared_experts.{j}.")
                for j in range(cfg["mlp_fixed_expert_num"]))
        probs, taken = self._route(h, p + "mlp.gate.weight")
        masks = (taken.long() << torch.arange(taken.shape[1], device=x.device)).sum(-1)
        run = taken
        if forced is not None:
            f = forced.reshape(-1, 1).to(x.device)
            bits = (f >> torch.arange(taken.shape[1], device=x.device)) & 1
            run = torch.where(f >= 0, bits.bool(), taken)
        for e in range(cfg["mlp_dynamic_expert_num"]):
            rows = torch.nonzero(run[:, e]).flatten()
            if rows.numel():
                out = self._expert(h[rows], f"{p}mlp.experts.{e}.") * probs[rows, e, None]
                y = y.index_add(0, rows, out)
        return x + y.view(b, t, d), masks.view(b, t)

    def _run(self, x: torch.Tensor, pos0: int = 0, cache: Optional[List] = None,
             forced: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every layer (``forced`` (L, B, T): each layer's routing, as
        ``_layer`` takes it) → (final norm's output (B, T, D), the judge's
        own routes (L, B, T))."""
        routes = []
        for i in range(self.cfg["num_hidden_layers"]):
            x, m = self._layer(x, i, pos0, None if cache is None else cache[i],
                               None if forced is None else forced[i])
            routes.append(m)
        return self._rms(x, "model.norm.weight"), torch.stack(routes)

    def _embed(self, ids: Sequence[Sequence[int]], device) -> torch.Tensor:
        return self.t("model.embed_tokens.weight")[torch.tensor(ids, device=device)]

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self.w("lm_head.weight").T

    def prompt(self, audio_tokens: torch.Tensor) -> torch.Tensor:
        b = audio_tokens.shape[0]
        dev = audio_tokens.device
        return torch.cat([self._embed([self.head] * b, dev), audio_tokens,
                          self._embed([self.tail] * b, dev)], 1)

    # ------------------------------------------------------------------ #
    def teacher_forced(self, audio_tokens: torch.Tensor, replies: List[List[int]],
                       forced: Optional[List[torch.Tensor]] = None
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Each row's prompt and its reply at once → per row the logits
        (n_i, V) that predict its n_i reply tokens, and the routes (L, B, T)
        over the prompt and the reply but its last token. ``forced``: per
        row the routes (L, ≥ T_i) the other side took over those T_i
        positions, which the judge's experts then follow (its own choice
        past them)."""
        dev = audio_tokens.device
        n = max(len(r) for r in replies)
        ids = [list(r[:-1]) + [0] * (n - len(r)) for r in replies]
        x = torch.cat([self.prompt(audio_tokens), self._embed(ids, dev)[:, :n - 1]], 1)
        plan = None
        if forced is not None:
            t = x.shape[1]
            plan = torch.full((self.cfg["num_hidden_layers"], len(replies), t), -1,
                              dtype=torch.long, device=dev)
            for i, (r, m) in enumerate(zip(replies, forced)):
                own = self.p_len + len(r) - 1
                plan[:, i, :own] = m[:, :own].to(dev)
        h, routes = self._run(x, forced=plan)
        p = self.p_len
        logits = [self._logits(h[i, p - 1: p - 1 + len(r)]) for i, r in enumerate(replies)]
        return logits, routes

    def greedy(self, audio_tokens: torch.Tensor, caps: List[int]
               ) -> Tuple[List[List[int]], torch.Tensor]:
        """Greedy decoding through a KV cache, each row to its first EOS or
        its cap → the replies and the routes (L, B, T) of the prompt and
        each fed token."""
        cache = [[None] for _ in range(self.cfg["num_hidden_layers"])]
        h, routes = self._run(self.prompt(audio_tokens), 0, cache)
        tok = self._logits(h[:, -1]).argmax(-1)
        out = [[] for _ in caps]
        done = [False] * len(caps)
        steps = [routes]
        for i in range(max(caps)):
            for r, t in enumerate(tok.tolist()):
                if not done[r]:
                    out[r].append(t)
                    done[r] = t == self.eos or len(out[r]) >= caps[r]
            if all(done):
                break
            h, routes = self._run(self._embed([[t] for t in tok.tolist()], tok.device),
                                  self.p_len + i, cache)
            steps.append(routes)
            tok = self._logits(h[:, -1]).argmax(-1)
        return out, torch.cat(steps, 2)
