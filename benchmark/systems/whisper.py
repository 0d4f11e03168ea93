"""ASR served below HTTP: the request's bytes through ``audio/ingest.
load_audio`` and ``runtime/batcher.InferenceExecutor`` (the dynamic batcher
the HTTP cores call) over one ``WhisperEngine`` on the card.

The HTTP cores are left out: ``server/app.asr`` and ``willow`` take no
token cap, and under seeded weights EOT never comes, so every request
would decode its whole 96- or 224-token bucket; ``ASRRequest.max_tokens``
stands in for a transcript's real length. Their query parsing and JSON are
outside the window.

The engine handed to the executor is ``RecordingEngine``, a subclass that
only forwards: it stamps the start of each engine call, marks a
``bench.windows`` range with the dispatch's shapes for the trace, and keeps
each window's served tokens, with the beam and the token cap it ran at,
for the correctness check.

Weights: seeded HF tensors (``benchmark/weights.py``) converted by the
port's ``models/whisper/weights.params_from_hf`` inside the registry's own
``get`` (which then applies its int8 step), so the registry serves them as
it would a checkpoint from disk, and nothing is written to disk.
"""

from __future__ import annotations

import contextlib
import gc
import io
import threading
import time
import wave
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import weights
from benchmark.reference import whisper as ref

SR = 16000


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _engine_class():
    from wis_tpu_torch.runtime.engine import WhisperEngine

    class RecordingEngine(WhisperEngine):
        """``WhisperEngine`` with stamps and the served tokens kept."""

        def __init__(self, registry):
            super().__init__(registry)
            self.calls: List[Dict] = []
            self.rid_by_audio: Dict[int, int] = {}
            self._call: Optional[Dict] = None

        def _record(self, rids, fn):
            call = {"rids": rids, "t0": time.perf_counter(), "groups": []}
            self._call = call
            out = fn()
            call["t1"] = time.perf_counter()
            first = out[0] if isinstance(out, list) else out
            call["infer_ms"] = first.infer_time_ms
            call["timings"] = dict(first.timings)
            self.calls.append(call)
            return out

        def transcribe(self, audio, *args, **kwargs):
            rid = self.rid_by_audio.get(id(audio))
            return self._record([rid], lambda: super(RecordingEngine, self).transcribe(
                audio, *args, **kwargs))

        def transcribe_coalesced(self, requests):
            rids = [getattr(r, "bench_id", None) for r in requests]
            return self._record(rids, lambda: super(RecordingEngine, self)
                                .transcribe_coalesced(requests))

        def _run_windows(self, loaded, windows_i16, prompts, beam, detect, translate,
                         token_cap, timer, *args, **kwargs):
            long_audio = kwargs.get("long_audio") is not None
            n = kwargs["n_windows"] if long_audio else windows_i16.shape[0]
            bucket = self._bucket(min(n, max(1, self.settings.concurrent_gpu_chunks)))
            name = (f"bench.windows n={n} B={bucket} K={beam} P={prompts.shape[1]} "
                    f"cap={token_cap} M={kwargs.get('max_new')}")
            with record_function(name):
                out = super()._run_windows(loaded, windows_i16, prompts, beam, detect,
                                           translate, token_cap, timer, *args, **kwargs)
            self._call["groups"].append({"n": n, "B": bucket, "K": beam,
                                         "P": int(prompts.shape[1]), "cap": int(token_cap),
                                         "M": kwargs.get("max_new")})
            self._call["served"] = [
                ([int(t) for t in e["tokens"][: e["length"]]], beam, int(token_cap))
                for e in out]
            return out

    return RecordingEngine


def _wav_bytes(pcm: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.astype("<i2").tobytes())
    return buf.getvalue()


def make_pcm(seconds: float, seed: int) -> np.ndarray:
    """A request's audio: seeded noise at a speaking level (int16)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(int(round(seconds * SR))) * 0.05 * 32768
    return np.clip(x, -32768, 32767).astype(np.int16)


class System:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device: torch.device, requests):
        from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS, resolve_model_name
        from wis_tpu_torch.models.whisper.weights import params_from_hf
        from wis_tpu_torch.runtime import residency
        from wis_tpu_torch.runtime.batcher import InferenceExecutor
        from wis_tpu_torch.settings import APISettings

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.settings = APISettings(**cfg["deployment"])
        self.model = cfg["served_model"]
        wcfg = WHISPER_CONFIGS[resolve_model_name(self.model)]
        for ours, theirs in (("d_model", "n_audio_state"), ("encoder_layers", "n_audio_layer"),
                             ("decoder_layers", "n_text_layer"), ("vocab_size", "n_vocab"),
                             ("encoder_attention_heads", "n_audio_head"),
                             ("num_mel_bins", "n_mels")):
            if cfg[ours] != getattr(wcfg, theirs):
                raise ValueError(f"{ours} {cfg[ours]} is not the port's {theirs} "
                                 f"{getattr(wcfg, theirs)} for {self.model}")
        hf = weights.whisper_hf(cfg, seed, device)
        self.registry = residency.ModelRegistry(self.settings, device)

        def load(c, model_dir, s, dev, dtype):
            return params_from_hf(hf, c, dtype, dev)

        with _patched(residency, "load_or_init_params", load):
            self.registry.get(self.model)
        del hf
        self.engine = _engine_class()(self.registry)

        self.prepare(requests)
        self._warm()
        self.engine.calls.clear()
        self.calls = self.engine.calls
        self.executor = InferenceExecutor(self.engine, self.settings)
        self.executor.start()

    def prepare(self, requests) -> None:
        """Each request's audio and the bytes it is sent as."""
        self.requests = requests
        fmt = self.mix.get("format", "pcm")
        for r in requests:
            r["pcm"] = make_pcm(r["audio_s"], r["content_seed"])
            r["bytes"] = r["pcm"].tobytes() if fmt == "pcm" else _wav_bytes(r["pcm"])
            r["format"] = fmt

    # ------------------------------------------------------------------ #
    def _warm(self) -> None:
        """Each shape the cell's requests reach: for clips, every batch
        bucket at each audio-length bucket they fall in; for recordings over
        30 s, one chunked group."""
        from wis_tpu_torch.runtime.batcher import ASRRequest

        s = self.settings
        beam = self.requests[0]["beam_size"]
        secs = sorted({min((b for b in s.audio_second_bucket_list() if r["audio_s"] <= b),
                           default=30) for r in self.requests if r["audio_s"] <= 30})
        for sec in secs:
            audio = make_pcm(min(sec, 30) - 0.5, sec)
            self.engine.transcribe(audio, model=self.model, beam_size=beam, max_tokens=3)
            for n in s.batch_bucket_list():
                if n > 1:
                    self.engine.transcribe_coalesced([
                        ASRRequest(audio=audio, model=self.model, beam_size=beam, max_tokens=3)
                        for _ in range(n)])
        longest = max(r["audio_s"] for r in self.requests)
        if longest > 30:
            self.engine.transcribe(make_pcm(min(longest, 60.0), 1), model=self.model,
                                   beam_size=beam, max_tokens=3)
        torch.cuda.synchronize(self.device) if self.device.type == "cuda" else None

    def _submit(self, r: Dict):
        from wis_tpu_torch.audio.ingest import load_audio
        from wis_tpu_torch.runtime.batcher import ASRRequest

        r["sent"] = time.perf_counter()
        if r["format"] == "pcm":
            audio = load_audio(r["bytes"], codec="pcm", sample_rate=SR, bits=16, channels=1)
        else:
            audio = load_audio(r["bytes"])
        req = ASRRequest(audio=audio, model=self.model, beam_size=r["beam_size"],
                         max_tokens=r["max_tokens"])
        req.bench_id = r["id"]
        self.engine.rid_by_audio[id(audio)] = r["id"]
        r["audio_ref"] = audio  # keeps the id above unique while in flight

        def done(fut, r=r):
            r["end"] = time.perf_counter()
            r["ok"] = fut.exception() is None

        req.future.add_done_callback(done)
        r["submitted"] = time.perf_counter()
        return self.executor.submit(req)

    def drive(self, t0: float, seconds: float, drain_s: float) -> None:
        """The window [t0, t0 + seconds] and its drain: an open loop sends
        each request at its due time; a closed loop runs its clients until
        the window closes. Every request sent is waited for until
        ``drain_s`` past the close."""
        close = t0 + seconds
        futures = []
        if self.mix["loop"] == "open":
            for r in self.requests:
                r["due_abs"] = t0 + r["due"]
                delay = r["due_abs"] - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                futures.append(self._submit(r))
        else:
            lock = threading.Lock()
            pool = iter(range(10**9))

            def client():
                while True:
                    with lock:
                        k = next(pool)
                        r = dict(self.requests[k % len(self.requests)], id=k)
                        self.sent.append(r)
                    if time.perf_counter() >= close:
                        with lock:
                            self.sent.remove(r)
                        return
                    r["due_abs"] = time.perf_counter()
                    fut = self._submit(r)
                    try:
                        fut.result(timeout=max(0.0, close + drain_s - time.perf_counter()))
                    except Exception:  # noqa: BLE001 — counted as failed below
                        return

            self.sent: List[Dict] = []
            threads = [threading.Thread(target=client, name=f"bench-client-{i}")
                       for i in range(int(self.mix["clients"]))]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        for fut in futures:
            try:
                fut.result(timeout=max(0.0, close + drain_s - time.perf_counter()))
            except Exception:  # noqa: BLE001 — counted as failed below
                pass
        if self.mix["loop"] != "open":
            self.requests = self.sent
        for r in self.requests:
            r.setdefault("ok", False)
            r.pop("audio_ref", None)

    def summary(self, run) -> Dict:
        """Counts and medians behind the end-to-end metrics."""
        from benchmark import stats

        lat = [(r["end"] - r["due_abs"]) * 1e3 for r in self.requests if r["ok"]]
        return {"latency_ms": {"p50": stats.percentile(lat, 50), "p95": stats.percentile(lat, 95),
                               "n": len(lat)},
                "engine_calls": len(self.calls),
                "audio_s": sum(r["audio_s"] for r in self.requests if r["ok"])}

    # ------------------------------------------------------------------ #
    def served(self) -> Dict[int, List]:
        """Each finished request's windows: (served tokens, beam, cap)."""
        out = {}
        for call in self.calls:
            if len(call["rids"]) == 1:
                out[call["rids"][0]] = call["served"]
            else:
                for rid, win in zip(call["rids"], call["served"]):
                    out[rid] = [win]
        return out

    def release(self) -> None:
        self.executor.shutdown()
        self.executor = self.engine = self.registry = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, modes=("served",)) -> Dict[str, Dict[str, float]]:
        """Over ``check.windows`` windows drawn from the seed (those of the
        request with the most served tokens, then of others, each request's
        in a seeded order), each window's served tokens run through the
        float32 reference. Readings: the widest gap by which a served
        token's logit lies below the reference's (K+1)-th best at its
        position; and, against the best hypothesis of the reference's own
        beam search at the beam K and the token cap the window ran at, how
        far the served hypothesis's score falls short, the mean over the
        windows (compared: near-ties send sound runs' hypotheses either
        way, a beam fault pulls every window down) and the widest. With
        "control" in ``modes`` the reference one precision step below is
        put in the program's place: its own beam search's hypotheses are
        read in the same way."""
        cfg = self.cfg
        gen = cfg["generation"]
        masks = (gen["suppress_tokens"], gen["begin_suppress_tokens"])
        served = self.served()
        done = [r for r in self.requests if r["ok"] and r["id"] in served]
        rng = np.random.default_rng(self.seed)
        done.sort(key=lambda r: -sum(len(w[0]) for w in served[r["id"]]))
        sample, total = [], 0
        for r in done[:1] + [done[i] for i in 1 + rng.permutation(max(len(done) - 1, 0))]:
            n = min(len(served[r["id"]]), cfg["check"]["windows"] - total)
            if n <= 0:
                break
            sample.append((r, sorted(int(w) for w in rng.permutation(len(served[r["id"]]))[:n])))
            total += n
        sd = weights.whisper_hf(cfg, self.seed, self.device)
        judge = ref.Whisper(sd, cfg, "served")
        stand_ins = {m: ref.Whisper(sd, cfg, m) for m in modes if m != "served"}
        out = {m: {"gap_max": 0.0, "score_gap_max": 0.0, "tokens": 0} for m in modes}
        shortfalls: Dict[str, List[float]] = {m: [] for m in modes}
        with _full_f32():
            for r, picked in sample:
                wins = served[r["id"]]
                pcm = ref.windows_of(r["pcm"], len(wins) if r["audio_s"] > 30 else None,
                                     cfg["chunk_s"], cfg["step_s"])
                for lo in range(0, len(picked), 4):
                    block = [wins[w] for w in picked[lo:lo + 4]]
                    audio = pcm[picked[lo:lo + 4]].astype(np.float32) / 32768.0
                    audio = torch.from_numpy(audio).to(self.device)
                    xkv = judge.cross_kv(judge.encode(audio))
                    best = [judge.beam_search(_window(xkv, i), gen["prompt"], k, cap, *masks,
                                              gen["eot"])[1]
                            for i, (_, k, cap) in enumerate(block)]
                    hyps = {"served": [w[0] for w in block]}
                    for m, model in stand_ins.items():
                        own = model.cross_kv(model.encode(audio))
                        hyps[m] = [model.beam_search(_window(own, i), gen["prompt"], k, cap,
                                                     *masks, gen["eot"])[0]
                                   for i, (_, k, cap) in enumerate(block)]
                    for m, hs in hyps.items():
                        logits = judge.teacher_forced(xkv, gen["prompt"], hs)
                        for i, toks in enumerate(hs):
                            if not toks:
                                continue
                            k = block[i][1]
                            g = ref.rank_gaps(logits[i], toks, 1 if k == 1 else k + 1, *masks)
                            short = best[i] - ref.score(logits[i], toks, *masks)
                            o = out[m]
                            o["gap_max"] = max(o["gap_max"], float(g.max()))
                            o["score_gap_max"] = max(o["score_gap_max"], short)
                            o["tokens"] += len(toks)
                            shortfalls[m].append(short)
        for m in modes:
            out[m]["score_gap_mean"] = float(np.mean(shortfalls[m])) if shortfalls[m] else 0.0
            out[m]["windows"] = len(shortfalls[m])
        out["served"]["requests"] = len(sample)
        return out


def _window(xkv, i):
    """Window i's cross-attention K/V of a block's."""
    return [(k[i:i + 1], v[i:i + 1]) for k, v in xkv]


@contextlib.contextmanager
def _full_f32():
    """float32 products at full precision (TF32 off) for the reference."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
