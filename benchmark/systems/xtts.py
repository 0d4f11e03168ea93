"""TTS served as Willow asks for it: the TTS core ``server/tts_app.tts_get``
(GET /api/tts) over ``build_tts_state`` on the card, the reply read as
Willow reads it: the WAV header, then one int16 chunk per model chunk.

Weights: seeded Coqui tensors (``benchmark/weights.py``) converted by the
port's ``models/xtts/convert.gpt_from_coqui`` and ``hifigan_from_coqui``
in place of a ``model.pth`` (``BenchXTTS._load_checkpoint``); the model
then quantizes and packs them as it would a checkpoint's. The ``default``
voice is a seeded voice written to the speaker store at set-up, as an
enrolled voice is kept, so the reference needs no conditioning encoder.

``BenchXTTS`` only forwards: it marks each stream with a ``bench.tts_stream``
range, and while the window runs the model module's
``run_decode_chunk_fused`` and ``hifigan_forward`` are wrapped to mark
``bench.gpt_chunk`` and ``bench.vocoder`` ranges with their shapes and to
keep each chunk's audio codes for the correctness check.
"""

from __future__ import annotations

import asyncio
import gc
import math
import shutil
import tempfile
import threading
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import weights
from benchmark.reference import xtts as ref

#: words of the replies: lower-case, no abbreviation the cleaner expands
WORDS = (
    "the light in the kitchen is now on and the door to the garden is locked it will be "
    "sunny today with a high near warm afternoon breeze your timer for the pasta is set "
    "to ring soon playing some quiet music in the living room there are three items on "
    "your shopping list bread milk and apples the next train leaves from platform two "
    "the meeting with the design team starts after lunch remember to water the plants "
    "tonight the thermostat is set a little lower while you sleep good morning here is "
    "the news from around the world"
).split()


def make_text(chars: int, seed: int) -> str:
    """A reply of about ``chars`` characters from the seeded word list."""
    rng = np.random.default_rng(seed)
    words: List[str] = []
    while len(" ".join(words)) + 1 < chars:
        words.append(WORDS[int(rng.integers(len(WORDS)))])
    text = " ".join(words)[: max(chars - 1, 1)].rstrip()
    return text[0].upper() + text[1:] + "."


_tls = threading.local()


def _model_class():
    from wis_tpu_torch.models.xtts.model import XTTSModel

    class BenchXTTS(XTTSModel):
        """``XTTSModel`` over in-memory Coqui tensors, with its streams
        marked and their audio codes kept."""

        def __init__(self, sd, *args, **kwargs):
            self._sd = sd
            self.rid_by_text: Dict[int, int] = {}
            self.codes: Dict[int, List[torch.Tensor]] = {}
            super().__init__(*args, **kwargs)

        def _load_checkpoint(self, model_dir):
            from wis_tpu_torch.models.xtts.convert import gpt_from_coqui, hifigan_from_coqui

            sd, self._sd = self._sd, None
            return (gpt_from_coqui(sd, self.cfg.gpt, self.dtype, self.device),
                    hifigan_from_coqui(sd, self.cfg.vocoder, self.dtype, self.device))

        def inference_stream_split(self, text, language, *args, **kwargs):
            rid = self.rid_by_text.get(id(text), -1)
            _tls.codes = self.codes.setdefault(rid, [])
            try:
                with record_function(f"bench.tts_stream id={rid}"):
                    yield from super().inference_stream_split(text, language, *args, **kwargs)
            finally:
                _tls.codes = None

    return BenchXTTS


def _wrapped_chunk(fn):
    def run(*args, **kwargs):
        kc, pos, chunk = args[4], args[6], kwargs["chunk"]
        with record_function(f"bench.gpt_chunk pos={pos} n={chunk} t={kc.shape[-1]}"):
            out = fn(*args, **kwargs)
        codes = getattr(_tls, "codes", None)
        if codes is not None:
            codes.append(out[0])
        return out
    return run


def _wrapped_vocoder(fn):
    def run(params, latents, *args, **kwargs):
        with record_function(f"bench.vocoder T={latents.shape[1]}"):
            return fn(params, latents, *args, **kwargs)
    return run


def port_config(cfg: Dict):
    """The port's ``XTTSConfig`` with the configuration file's sizes."""
    from wis_tpu_torch.models.xtts.gpt import GPTConfig
    from wis_tpu_torch.models.xtts.hifigan import HiFiGANConfig
    from wis_tpu_torch.models.xtts.model import XTTSConfig

    g, v = cfg["gpt"], cfg["hifigan"]
    return XTTSConfig(
        gpt=GPTConfig(n_layer=g["gpt_layers"], n_head=g["gpt_n_heads"],
                      d_model=g["gpt_n_model_channels"], n_text_vocab=g["gpt_number_text_tokens"],
                      n_audio_vocab=g["gpt_num_audio_tokens"],
                      max_text_tokens=g["gpt_max_text_tokens"],
                      max_audio_tokens=g["gpt_max_audio_tokens"], max_cond_len=g["cond_len"],
                      start_audio_token=g["gpt_start_audio_token"],
                      stop_audio_token=g["gpt_stop_audio_token"]),
        vocoder=HiFiGANConfig(in_dim=v["input_dim"], cond_dim=v["cond_dim"],
                              upsample_initial=v["upsample_initial_channel"],
                              upsample_rates=tuple(v["upsample_rates"]),
                              upsample_kernels=tuple(v["upsample_kernel_sizes"]),
                              resblock_kernels=tuple(v["resblock_kernel_sizes"]),
                              resblock_dilations=tuple(map(tuple, v["resblock_dilation_sizes"])),
                              sample_rate=v["output_sample_rate"],
                              gpt_code_stride=v["gpt_code_stride_len"],
                              input_sample_rate=v["input_sample_rate"]),
        text_buckets=tuple(cfg["text_buckets"]), cond_len=g["cond_len"],
        left_context_frames=cfg["left_context"])


class System:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device: torch.device, requests):
        from wis_tpu_torch.models.xtts import model as xmodel
        from wis_tpu_torch.server.tts_app import SpeakerStore, build_tts_state
        from wis_tpu_torch.settings import APISettings

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.voice_dir = tempfile.mkdtemp(prefix="bench-voices-")
        self.settings = APISettings(**cfg["deployment"], xtts_speaker_dir=self.voice_dir)
        sd = weights.xtts_coqui(cfg, seed, device)
        self.model = _model_class()(sd, device, cfg=port_config(cfg),
                                    quant=self.settings.xtts_quant, fused=cfg["fused"])
        del sd
        self.voice = weights.xtts_voice(cfg, seed)
        SpeakerStore(self.voice_dir).save("default", self.voice)
        self.state = build_tts_state(self.settings, model=self.model)
        self._xmodel = xmodel
        self._orig = (xmodel.run_decode_chunk_fused, xmodel.hifigan_forward)
        xmodel.run_decode_chunk_fused = _wrapped_chunk(self._orig[0])
        xmodel.hifigan_forward = _wrapped_vocoder(self._orig[1])

        self.prepare(requests)
        self._warm()
        self.model.codes.clear()

    def prepare(self, requests) -> None:
        """Each reply's text, code floor and query."""
        self.requests = requests
        for r in requests:
            r["text"] = make_text(int(round(r["chars"])), r["content_seed"])
            r["text_bucket"] = self._bucket(r)
            r["min_audio_tokens"] = int(math.ceil(r["tokens_per_char"] * len(r["text"])))
            r["query"] = {"text": r["text"], "language": r["language"],
                          "speaker": r["speaker"], "stream_chunk_size": str(r["chunk"]),
                          "min_audio_tokens": str(r["min_audio_tokens"])}

    # ------------------------------------------------------------------ #
    def _bucket(self, r) -> int:
        g = self.cfg["gpt"]
        n = len(ref.text_ids(r["text"], r["language"], g["gpt_number_text_tokens"],
                             g["gpt_max_text_tokens"]))
        return next(b for b in self.cfg["text_buckets"] if n <= b)

    def _warm(self) -> None:
        """One stream per text bucket the replies fall in, as long as the
        longest of them, so every cache bucket they grow into is met."""
        longest: Dict[int, Dict] = {}
        for r in self.requests:
            b = self._bucket(r)
            if b not in longest or r["min_audio_tokens"] > longest[b]["min_audio_tokens"]:
                longest[b] = r

        async def warm():
            for r in longest.values():
                await self._stream(dict(r, id=-1))

        asyncio.run(warm())

    async def _stream(self, r: Dict) -> None:
        from wis_tpu_torch.server.tts_app import tts_get

        r["sent"] = time.perf_counter()
        self.model.rid_by_text[id(r["text"])] = r["id"]
        r["chunks"], r["audio"] = [], []
        try:
            reply = await tts_get(self.state, r["query"])
            first = True
            async for piece in reply.stream:
                if first:  # the WAV header
                    first = False
                    continue
                r["chunks"].append(time.perf_counter())
                r["audio"].append(np.frombuffer(piece, "<i2"))
            r["ok"] = bool(r["chunks"])
        except Exception:  # noqa: BLE001 — a failed reply counts as failed
            r["ok"] = False
        r["end"] = time.perf_counter()

    def drive(self, t0: float, seconds: float, drain_s: float) -> None:
        """Open loop: each reply is asked for at its due time; every reply
        is read to its end or until ``drain_s`` past the close."""

        async def main():
            tasks = []
            for r in self.requests:
                r["due_abs"] = t0 + r["due"]
                delay = r["due_abs"] - time.perf_counter()
                if delay > 0:
                    await asyncio.sleep(delay)
                tasks.append(asyncio.ensure_future(self._stream(r)))
            limit = t0 + seconds + drain_s - time.perf_counter()
            await asyncio.wait(tasks, timeout=max(0.0, limit))
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        asyncio.run(main())
        for r in self.requests:
            r.setdefault("ok", False)

    def summary(self, run) -> Dict:
        """Counts and medians behind the end-to-end metrics."""
        from benchmark import stats

        ok = [r for r in self.requests if r["ok"]]
        first = [(r["chunks"][0] - r["due_abs"]) * 1e3 for r in ok]
        gaps = [(b - a) * 1e3 for r in ok for a, b in zip(r["chunks"], r["chunks"][1:])]
        return {"first_audio_ms": {"p50": stats.percentile(first, 50), "n": len(first)},
                "chunk_gap_ms": {"p50": stats.percentile(gaps, 50), "n": len(gaps)},
                "codes": sum(r["min_audio_tokens"] for r in ok)}

    def release(self) -> None:
        self._xmodel.run_decode_chunk_fused, self._xmodel.hifigan_forward = self._orig
        self.codes = {rid: [c.cpu() for c in cs] for rid, cs in self.model.codes.items()}
        self.state = self.model = None
        shutil.rmtree(self.voice_dir, ignore_errors=True)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------ #
    def check(self, modes=("served",)) -> Dict[str, Dict[str, float]]:
        """Over a sample drawn from the seed (the longest reply, then others
        until ``check.tokens`` codes), each reply's codes run through the
        float32 reference, and two readings are kept: the widest gap by
        which a served code's logit lies below the least logit of the
        reference's sampling support at its position (the stop floor and
        the repetition penalty applied, then temperature, top-k and top-p
        as ``tts_get`` samples by default), and the widest relative L2
        distance of a reply's audio from the reference's audio for its
        codes. With "control" the reference one precision step below is
        put in the program's place: the code it puts first at each position
        and its audio are read in the same way."""
        cfg, g = self.cfg, self.cfg["gpt"]
        knobs = cfg["sampling"]
        done = [r for r in self.requests if r["ok"] and self.codes.get(r["id"])]
        rng = np.random.default_rng(self.seed)
        done.sort(key=lambda r: -r["min_audio_tokens"])
        sample, total = [], 0
        for r in done[:1] + [done[i] for i in 1 + rng.permutation(max(len(done) - 1, 0))]:
            if total >= cfg["check"]["tokens"]:
                break
            sample.append(r)
            total += r["min_audio_tokens"]
        sd = weights.xtts_coqui(cfg, self.seed, self.device)
        models = {m: ref.XTTS(sd, cfg, m) for m in ("served",) + tuple(
            x for x in modes if x != "served")}
        out = {m: {"gap_max": 0.0, "audio_err_max": 0.0} for m in modes}
        out["served"].update(tokens=0, replies=len(sample))
        stop = g["gpt_stop_audio_token"]
        cond = torch.tensor(self.voice["gpt_cond_latent"], dtype=torch.float32,
                            device=self.device).to(torch.bfloat16).float()
        speaker = torch.tensor(self.voice["speaker_embedding"], dtype=torch.float32,
                               device=self.device).to(torch.bfloat16).float()
        with torch.inference_mode():
            for r in sample:
                codes = torch.cat(self.codes[r["id"]], dim=1)[0].tolist()
                n_valid = codes.index(stop) if stop in codes else len(codes)
                text = ref.text_ids(r["text"], r["language"], g["gpt_number_text_tokens"],
                                    g["gpt_max_text_tokens"])
                runs = {m: x.teacher_forced(cond, text, self._bucket(r), codes)
                        for m, x in models.items()}
                logits, hidden = runs["served"]
                n = min(n_valid + 1, len(codes))
                pen = _penalized(logits[:n], codes[:n], r["min_audio_tokens"], stop,
                                 knobs["repetition_penalty"])
                floor = _support_floor(pen, knobs)
                got = pen[torch.arange(n), torch.tensor(codes[:n], device=pen.device)]
                out["served"]["gap_max"] = max(out["served"]["gap_max"],
                                               float((floor - got).clamp_min(0).max()))
                out["served"]["tokens"] += n
                want = np.concatenate(ref.stream_audio(models["served"], hidden, n_valid,
                                                       speaker, r["chunk"]))
                got_audio = np.concatenate(r["audio"]).astype(np.float32) / 32767.0
                out["served"]["audio_err_max"] = max(out["served"]["audio_err_max"],
                                                     _rel(got_audio, want))
                if "control" in models:
                    c_logits, c_hidden = runs["control"]
                    c_pen = _penalized(c_logits[:n], codes[:n], r["min_audio_tokens"], stop,
                                       knobs["repetition_penalty"])
                    pick = c_pen.argmax(dim=-1)
                    gap = (floor - pen.gather(1, pick[:, None])[:, 0]).clamp_min(0)
                    out["control"]["gap_max"] = max(out["control"]["gap_max"], float(gap.max()))
                    c_audio = np.concatenate(ref.stream_audio(models["control"], c_hidden,
                                                              n_valid, speaker, r["chunk"]))
                    out["control"]["audio_err_max"] = max(out["control"]["audio_err_max"],
                                                          _rel(c_audio, want))
        return out


def _support_floor(pen: torch.Tensor, knobs: Dict) -> torch.Tensor:
    """Each position's least penalized logit that sampling may still draw:
    HF's processors in Coqui's order after the penalty, temperature, then
    top-k (the k best), then top-p (the best codes whose mass, renormalised
    over the top k, reaches p: a code stays while the mass above it is
    under p)."""
    z = pen / knobs["temperature"]
    kth = torch.topk(z, knobs["top_k"], dim=-1).values[:, -1:]
    z = torch.where(z < kth, float("-inf"), z)
    probs, order = torch.sort(torch.softmax(z, dim=-1), dim=-1, descending=True, stable=True)
    keep = (probs.cumsum(dim=-1) - probs) < knobs["top_p"]
    keep[:, 0] = True
    kept = torch.where(keep, pen.gather(1, order), float("inf"))
    return kept.amin(dim=-1)


def _penalized(logits: torch.Tensor, codes: List[int], floor: int, stop: int,
               penalty: float) -> torch.Tensor:
    """Each position's logits with the stop floor and the repetition
    penalty over the codes before it (and code 0, which the history buffer
    always holds)."""
    n = logits.shape[0]
    x = logits.clone()
    x[:min(floor, n), stop] = float("-inf")
    seen = torch.zeros_like(x, dtype=torch.bool)
    seen[:, 0] = True
    for i in range(1, n):
        seen[i] = seen[i - 1]
        seen[i, codes[i - 1]] = True
    pen = torch.where(x > 0, x / penalty, x * penalty)
    return torch.where(seen, pen, x)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return math.inf
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))
