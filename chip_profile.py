#!/usr/bin/env python3
"""Where a large-v2 beam-5 int8 request's time goes in the PyTorch/CUDA port
(``wis_tpu_torch``), on one NVIDIA GPU.

Run from the repository root, with one card visible:

    python3 chip_profile.py [--out build/profile]

Prints, each on its own line, with the card's name and power limit first:

1. per-phase device-synchronised host times (medians) for one 30 s window:
   log-mel, encoder, cross-KV; one beam-5 decode step (BK=5) of the eager
   decoder (ancestry) and of the fused path (the step over a 128-position
   cache with int8 cross-KV, and the int8 head); beam-5 generate to caps
   of 32 and 100 tokens and greedy to 100, eager and fused;
2. for each decode path — ``eager`` (``fused_decode="off"``) and ``fused``
   (``"auto"``, the card's default) — unprofiled request latency
   (``infer_time_ms``, medians of repeats) for the bench's three large-v2
   beam-5 shapes, then one 3.84 s / 32-token request under
   ``torch.profiler``: kernel launches, summed kernel time on the device,
   and the device's busy share two ways — the union of kernel intervals
   over the profiled ``asr_dispatch`` span, and summed kernel time over the
   unprofiled request's median latency (the profiler slows the host, so
   the first understates the share).

Each path's operator table by device time goes to
``<out>/profile_ops_<path>.txt``. The last line is one JSON object with
every number above, each path's keys prefixed with its name.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

from chip_smoke import REQUESTS, _audio_i16, _step_inputs

#: settings.fused_decode for each decode path
PATHS = {"eager": "off", "fused": "auto"}


def _median_s(torch, fn, reps):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1000.0


def phase_times(torch, engine, loaded):
    from wis_tpu_torch.audio.mel import log_mel
    from wis_tpu_torch.decoding.beam import build_generate_xa
    from wis_tpu_torch.models.whisper import model as m
    from wis_tpu_torch.models.whisper.tokenizer import EOT, build_prompt

    dev, cfg, params = engine.device, loaded.cfg, loaded.params
    tok = loaded.tokenizer
    audio = torch.from_numpy(_audio_i16(30000, 5)).to(dev).float()[None] / 32768.0
    prompt = torch.tensor(
        build_prompt("en", "transcribe", notimestamps=True, layout=tok.layout), device=dev
    )
    out = {}
    with torch.inference_mode():
        mel = log_mel(audio, cfg.n_mels)
        xa = m.encode(params, mel, cfg)
        xa_kv = m.cross_kv(params, xa, cfg)
        out["log_mel_ms"] = _median_s(torch, lambda: log_mel(audio, cfg.n_mels), 5)
        out["encode_ms"] = _median_s(torch, lambda: m.encode(params, mel, cfg), 5)
        out["cross_kv_ms"] = _median_s(torch, lambda: m.cross_kv(params, xa, cfg), 5)

        k, cache_len = 5, prompt.shape[0] + 100
        cache = m.DecoderCache.zeros(cfg, k, cache_len, xa.dtype, dev)
        _, cache = m.prefill(params, prompt.expand(k, -1), cache, xa_kv, cfg)
        anc = torch.arange(k, device=dev)[None, :, None].expand(1, k, cache_len).clone()
        tokens = torch.full((k,), EOT, dtype=torch.long, device=dev)
        out["decode_step_bk5_ms"] = _median_s(
            torch, lambda: m.decode_step(params, tokens, cache, xa_kv, cfg, anc=anc), 10
        )

        out.update(fused_step_times(torch, engine, loaded))

        packed, xa_int8 = engine._packed_decoder(loaded), engine._xa_int8()
        for fused in (False, True):
            for beam, cap in ((5, 32), (5, 100), (1, 100)):
                gen = build_generate_xa(
                    cfg, beam_size=beam, batch=1, max_new_tokens=cap,
                    prompt_len=prompt.shape[0], suppress_tokens=tok.suppress_tokens,
                    begin_suppress_tokens=tok.begin_suppress_tokens,
                    fused=fused, xa_int8=fused and xa_int8,
                )
                weights = (params, packed) if fused else (params,)
                res = gen(*weights, xa_kv, prompt, cap)
                steps = int(res.lengths[0, int(res.best[0])])
                ms = _median_s(torch, lambda: gen(*weights, xa_kv, prompt, cap), 3)
                name = f"{'fused_' if fused else ''}generate_beam{beam}_cap{cap}"
                out[f"{name}_ms"] = ms
                out[f"{name}_best_len"] = steps
    return out


def fused_step_times(torch, engine, loaded):
    """One fused decode step (BK=5, 128-position cache, int8 cross-KV) and
    one int8 head call, timed like the eager step above."""
    from wis_tpu_torch.ops.fused_decode import fused_decode_step
    from wis_tpu_torch.ops.fused_logits import fused_logits_topk

    cfg, dec = loaded.cfg, loaded.params["decoder"]
    packed = engine._packed_decoder(loaded)
    inp = _step_inputs(torch, engine.device, cfg, 128, True, False, seed=0)
    x = fused_decode_step(cfg, packed, **inp)[0]
    sup = torch.zeros(cfg.n_vocab, device=engine.device)
    return {
        "fused_step_bk5_t128_ms": _median_s(
            torch, lambda: fused_decode_step(cfg, packed, **inp), 10),
        "fused_head_bk5_int8_ms": _median_s(
            torch, lambda: fused_logits_topk(x, dec["ln"]["g"], dec["ln"]["b"],
                                             dec["tok_emb_q"], sup, k=6), 10),
    }


def request_latency(engine, reps=3):
    out = {}
    for i, (ms, cap) in enumerate(REQUESTS):
        audio = _audio_i16(ms, i)
        times = [
            engine.transcribe(audio, beam_size=5, max_tokens=cap).infer_time_ms
            for _ in range(reps)
        ]
        out[f"request_{ms}ms_cap{cap}_infer_ms"] = statistics.median(times)
        out[f"request_{ms}ms_cap{cap}_infer_ms_all"] = times
    return out


def _union_us(intervals):
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profiled_request(torch, engine, out_dir, unprofiled_ms, tag):
    from torch.profiler import ProfilerActivity, profile

    ms, cap = REQUESTS[0]
    audio = _audio_i16(ms, 0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = engine.transcribe(audio, beam_size=5, max_tokens=cap)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [
        (e["ts"], e["ts"] + e["dur"]) for e in events
        if e.get("cat") == "kernel" and e.get("ph") == "X"
    ]
    spans = [
        (e["ts"], e["ts"] + e["dur"]) for e in events
        if e.get("name") == "asr_dispatch" and e.get("ph") == "X"
        and e.get("cat") in ("user_annotation", "cpu_op")
    ]
    if not kernels or not spans:
        raise RuntimeError(f"trace holds {len(kernels)} kernels, {len(spans)} dispatch spans")
    a, b = min(s[0] for s in spans), max(s[1] for s in spans)
    inside = [(max(x, a), min(y, b)) for x, y in kernels if y > a and x < b]
    kernel_ms = sum(y - x for x, y in kernels) / 1000.0
    table = prof.key_averages().table(sort_by="device_time_total", row_limit=40)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_ops_{tag}.txt"), "w") as f:
        f.write(table)
    return {
        "profiled_request_infer_ms": res.infer_time_ms,
        "profiled_asr_dispatch_ms": (b - a) / 1000.0,
        "kernel_launches": len(kernels),
        "kernel_ms_sum": kernel_ms,
        "busy_share_of_profiled_dispatch": _union_us(inside) / (b - a),
        "busy_share_of_unprofiled_request": kernel_ms / unprofiled_ms,
    }


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/profile", help="directory for the ops table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device available", file=sys.stderr)
        return 1
    from wis_tpu_torch.runtime.engine import WhisperEngine
    from wis_tpu_torch.runtime.residency import ModelRegistry
    from wis_tpu_torch.settings import APISettings

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    settings = APISettings(whisper_model_default="large", beam_size=5,
                           long_beam_size=5, quant="int8")
    engine = WhisperEngine(ModelRegistry(settings, "cuda"))
    loaded = engine.registry.get("large")

    result = {"device": smi}

    def report(part, prefix=""):
        for key, val in part.items():
            print(f"{prefix}{key}: {val}")
            result[prefix + key] = val

    report(phase_times(torch, engine, loaded))
    ms, cap = REQUESTS[0]
    for path, mode in PATHS.items():
        settings.fused_decode = mode
        engine.transcribe(_audio_i16(1000, 99), beam_size=5, max_tokens=4)  # warm-up
        latency = request_latency(engine)
        report(latency, f"{path}_")
        report(profiled_request(torch, engine, args.out,
                                latency[f"request_{ms}ms_cap{cap}_infer_ms"], path),
               f"{path}_")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
