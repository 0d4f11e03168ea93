"""Uni-MoE-2.0-Omni served below HTTP: each clip's bytes through
``audio/ingest.load_audio`` and ``runtime/batcher.InferenceExecutor`` (the
dynamic batcher) over one engine on the card, which sends a coalesced
batch of ``ASRRequest(model="uni-moe-2.0-omni")`` to the omni program
(``decoding/omni.py``). The traffic, the request path and the window are
``systems/whisper.py``'s; this module adds the model's set-up, warm-up and
check.

The engine handed to the executor is ``RecordingEngine``, a subclass that
only forwards: it stamps each omni call and keeps its served replies and
a copy of the routing codes the program left in its step slot's cache,
for the check.

Weights: seeded tensors under the checkpoint's names
(``benchmark/weights_omni.py``) converted by the port's
``models/unimoe/weights.params_from_hf`` inside the registry's own ``get``,
which takes them out of the dict as it converts, so 52 GB never stand twice
on the card.
"""

from __future__ import annotations

import time
from typing import Dict, List
from unittest import mock

import numpy as np
import torch

from benchmark import weights_omni
from benchmark.reference import unimoe as ref
from benchmark.systems import whisper as asr

#: the configuration's keys that the port's ``OmniConfig`` holds
_WIDTHS = ("hidden_size", "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
           "head_dim", "vocab_size", "rms_norm_eps", "rope_theta", "mlp_fixed_expert_num",
           "shared_intermediate_size", "mlp_dynamic_expert_num", "dynamic_intermediate_size",
           "mlp_dynamic_null_expert_num", "mlp_dynamic_top_p", "mlp_dynamic_top_k",
           "whisper_hidden_size", "whisper_query_tokens_size")


def port_config(cfg: Dict):
    """The port's ``OmniConfig`` at the configuration file's widths."""
    from wis_tpu_torch.models.unimoe.config import omni_config
    from wis_tpu_torch.models.whisper.config import WhisperConfig

    e, gen = cfg["audio_encoder"], cfg["generation"]
    enc = WhisperConfig(name="audio_tower", n_mels=e["num_mel_bins"],
                        n_audio_ctx=e["max_source_positions"], n_audio_state=e["d_model"],
                        n_audio_head=e["encoder_attention_heads"],
                        n_audio_layer=e["encoder_layers"])
    return omni_config(cfg["served_model"], encoder=enc, prompt_head=tuple(gen["prompt_head"]),
                       prompt_tail=tuple(gen["prompt_tail"]),
                       eos_token_id=gen["eos_token_id"], **{k: cfg[k] for k in _WIDTHS})


def _engine_class():
    from wis_tpu_torch.runtime.engine import WhisperEngine

    class RecordingEngine(WhisperEngine):
        """``WhisperEngine`` with each omni call's stamps, replies and
        routing kept."""

        def __init__(self, registry):
            super().__init__(registry)
            self.calls: List[Dict] = []
            self.rid_by_audio: Dict[int, int] = {}

        def transcribe_omni(self, items, model):
            call = {"rids": [self.rid_by_audio.get(id(a)) for a, _ in items],
                    "t0": time.perf_counter()}
            out = super().transcribe_omni(items, model)
            call["t1"] = time.perf_counter()
            call["infer_ms"] = out[0].infer_time_ms
            call["timings"] = dict(out[0].timings)
            call["served"] = [r.tokens for r in out]
            slot = self.registry.get(model).slots[self._bucket(len(items))]
            call["routes"] = slot.cache.routes.clone()
            self.calls.append(call)
            return out

    return RecordingEngine


class System(asr.System):
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device: torch.device, requests):
        from wis_tpu_torch.models.unimoe import config as omni_cfg
        from wis_tpu_torch.models.unimoe.weights import params_from_hf
        from wis_tpu_torch.runtime import residency
        from wis_tpu_torch.runtime.batcher import InferenceExecutor
        from wis_tpu_torch.settings import APISettings

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.settings = APISettings(**cfg["deployment"])
        self.model = cfg["served_model"]
        self.port_cfg = port_config(cfg)
        hf = weights_omni.omni_hf(cfg, seed, device)
        self.registry = residency.ModelRegistry(self.settings, device)

        def load(c, model_dir, s, dev, dtype):
            return params_from_hf(hf, c, dtype, dev)

        with asr._patched(residency, "load_or_init_omni", load), \
                mock.patch.dict(omni_cfg.OMNI_CONFIGS, {self.model: self.port_cfg}):
            self.registry.get(self.model)
        del hf
        self.engine = _engine_class()(self.registry)

        self.prepare(requests)
        self._warm()
        self.engine.calls.clear()
        self.calls = self.engine.calls
        self.executor = InferenceExecutor(self.engine, self.settings)
        self.executor.start()

    def _warm(self) -> None:
        """Each batch bucket once (its prefill's shapes, its step's graph),
        at the longest clip."""
        longest = max(r["audio_s"] for r in self.requests)
        audio = asr.make_pcm(longest, 1)
        for n in self.settings.batch_bucket_list():
            self.engine.transcribe_omni([(audio, 3)] * n, self.model)
        torch.cuda.synchronize(self.device) if self.device.type == "cuda" else None

    # ------------------------------------------------------------------ #
    def served(self) -> Dict[int, Dict]:
        """Each answered request's reply, its dispatch's routing codes and
        its row there."""
        return {rid: {"tokens": call["served"][b], "routes": call["routes"], "row": b}
                for call in self.calls for b, rid in enumerate(call["rids"])}

    def check(self, modes=("served",)) -> Dict[str, Dict[str, float]]:
        """Over ``check.requests`` answered requests drawn from the seed,
        each reply run teacher-forced through the float32 reference at its
        served prefix, each token's experts those the program ran (its
        routing, so that one flip near a tie does not carry into the later
        layers and tokens). Readings: the widest gap of a served token's
        logit below the reference's largest logit there (greedy serves the
        largest but for rounding near ties); and the share of (token,
        layer) routing sets, over the prompt and every token fed back,
        where the reference on that path chooses other slots than the
        program took. With "control" in ``modes`` the reference at fp8 is
        put in the program's place: its own greedy replies, to the same
        lengths, and its own routing, read in the same way."""
        cfg = self.cfg
        served = self.served()
        done = [r for r in self.requests if r["ok"] and served.get(r["id"], {}).get("tokens")]
        rng = np.random.default_rng(self.seed)
        sample = [done[i] for i in rng.permutation(len(done))[:cfg["check"]["requests"]]]
        out = {m: {"gap_max": 0.0, "route_mismatch_share": 0.0, "tokens": 0, "routes": 0}
               for m in modes}
        out["served"]["requests"] = len(sample)
        if not sample:
            return out
        sd = weights_omni.omni_hf(cfg, self.seed, self.device)
        judge = ref.UniMoE(sd, cfg, "served")
        replies = [served[r["id"]]["tokens"] for r in sample]
        program_routes = [_masks(served[r["id"]]["routes"][:, served[r["id"]]["row"]])
                          for r in sample]
        audio = np.zeros((len(sample), ref.wref.N_SAMPLES), np.float32)
        for i, r in enumerate(sample):
            pcm = r["pcm"][:audio.shape[1]]
            audio[i, :len(pcm)] = pcm.astype(np.float32) / 32768.0
        with asr._full_f32():
            audio = torch.from_numpy(audio).to(self.device)
            tokens = judge.encode(audio)
            logits, routes = judge.teacher_forced(tokens, replies, program_routes)
            _readings(out["served"], logits, replies, routes, program_routes, judge.p_len)
            if "control" in modes:
                ctrl = ref.UniMoE(sd, cfg, "control")
                c_replies, c_routes = ctrl.greedy(ctrl.encode(audio), [len(x) for x in replies])
                c_routes = [c_routes[:, i] for i in range(len(sample))]
                logits, routes = judge.teacher_forced(tokens, c_replies, c_routes)
                _readings(out["control"], logits, c_replies, routes, c_routes, judge.p_len)
        return out


def _masks(codes: torch.Tensor) -> torch.Tensor:
    """A row's routing codes (L, T, top_k) → the bit mask of the slots
    each (layer, token) took (L, T); codes past the null expert (a slot
    not taken, a token not served) add nothing."""
    from wis_tpu_torch.models.unimoe.moe import NULL

    c = codes.long()
    return torch.where(c <= NULL, 1 << c.clamp(0, NULL), 0).sum(-1)


def _readings(o: Dict, logits: List[torch.Tensor], replies: List[List[int]],
              routes: torch.Tensor, theirs: List[torch.Tensor], p_len: int) -> None:
    """Gap and routing readings of replies (and the routing their side
    took) against the judge's teacher-forced logits and routing."""
    mismatched = compared = 0
    for i, (lg, reply) in enumerate(zip(logits, replies)):
        picked = lg[torch.arange(len(reply)), torch.tensor(reply, device=lg.device)]
        o["gap_max"] = max(o["gap_max"], float((lg.max(-1).values - picked).max()))
        o["tokens"] += len(reply)
        n = p_len + len(reply) - 1
        mine = theirs[i][:, :n].to(routes.device)
        mismatched += int((mine != routes[:, i, :n]).sum())
        compared += mine.numel()
    o["routes"] = compared
    o["route_mismatch_share"] = mismatched / max(compared, 1)
