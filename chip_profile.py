#!/usr/bin/env python3
"""Where a large-v2 beam-5 int8 request's time, and an XTTS stream's, goes
in the PyTorch/CUDA port (``wis_tpu_torch``), on one NVIDIA GPU.

Run from the repository root, with one card visible:

    python3 chip_profile.py [--out build/profile]
    python3 chip_profile.py --parent DIR [--eager] [--out build/profile]
    python3 chip_profile.py --heads [--parent DIR]

Prints, each on its own line, with the card's name and power limit first:

0. the two vocabulary heads' device time per call by kernel, from the
   kernel intervals of ten calls under ``torch.profiler``: the Whisper
   logits head at large-v2's shapes (BK 5 and 20, int8 and bf16 table,
   plain and grammar mode, k 6) beside its bound, and the XTTS sampling
   head at XTTS v2's width (``--heads`` stops here); then one fused decode step's device time by kernel kind (the five int8
   products, self- and cross-attention, told apart by their launch order
   in a layer) from the kernel intervals of five steps under
   ``torch.profiler``, at BK 5 over a 128-position cache and at BK 20 over
   four windows and 256 positions, int8 cross-KV; then ``int8_matmul`` at
   the step's product shapes as a reference point;

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
   the first understates the share);
3. on the fused path, the request kinds beyond the bench shapes — a
   language-detect, a timestamps and a word-timestamps request (3.84 s,
   32 tokens), a 180 s long-form request (64 tokens per window) and a
   coalesced batch of four 3.84 s requests: unprofiled latency (medians
   of repeats) and one profiled request (launches, kernel time, busy
   share of the whole call, unprofiled and profiled);
4. XTTS v2 at full width (``chip_smoke.py``'s seeded model and 605-token
   stream): the prefill, one 20-token chunk of the fused decode (plain
   epilogue and fused head) and one vocoder call, timed like the phases
   above; then for the default path and the fused head, unprofiled
   stream times (first chunk and total, medians of 3) and one stream
   under ``torch.profiler`` (launches, summed kernel time, busy share of
   the profiled stream and of the unprofiled median).

``--parent DIR`` compares this tree with another checkout of the repo
instead: it loads that checkout's kernel library, built from its own
sources (``chip_smoke._parent_library``), breaks both trees' heads and
steps down as in part 0 on the same inputs, then times the eager 3.84 s
request (unprofiled latency, then one profiled request's summed kernel
time and ``ancestry_attention``'s share of it), part 2's and 3's
unprofiled requests on the fused path, and part 4's streams both ways, in
turns parent / change / change / parent, the parent's library standing in
for this tree's behind the same wrappers (the kernels' C interfaces are
the same; a C function may take one more trailing argument, which an
older library ignores). ``--eager`` keeps only the eager request's turns.

Each path's operator table by device time goes to
``<out>/profile_ops_<path>.txt``. The last line is one JSON object with
every number above, each path's keys prefixed with its name.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

from chip_smoke import REQUESTS, TTS_CHUNK, TTS_MIN_TOKENS, TTS_TEXT, _audio_i16, _step_inputs

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


#: the eight launches of one decoder layer of the fused step, in launch
#: order (csrc/fused_decode.cu)
STEP_KINDS = ("qkv product (LN1)", "self-attention", "Wo product (+x)", "Wcq product (LN2)",
              "cross-attention", "Wco product (+x)", "W1 product (LN3, gelu)",
              "W2 product (+x, deferred scale)")
#: the step's breakdown cases: (BK, t_cache, n_seq), int8 cross-KV
STEP_CASES = ((5, 128, 1), (20, 256, 4))
#: the step's five int8 products at BK 5, as (M, K, N) of one int8_matmul
STEP_PRODUCTS = ((5, 1280, 3840), (5, 1280, 1280), (5, 1280, 5120), (5, 5120, 1280))


def step_breakdown(torch, dev, cfg, packed, trees, steps=5):
    """Device time of one fused step by kernel kind, from the kernel
    intervals of ``steps`` steps under ``torch.profiler``: each layer's
    eight launches are told apart by their order, checked against the
    attention kernels' names. ``trees`` maps a label to a kernel library
    and its check (this tree's, a parent checkout's). Also times
    ``int8_matmul`` at the step's product shapes as a reference point."""
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _median_ms, lib_decode_step
    from wis_tpu_torch.ops.quant import int8_matmul, quantize_weight

    out = {}
    L = cfg.n_text_layer
    for bk, t_cache, n_seq in STEP_CASES:
        inp = _step_inputs(torch, dev, cfg, t_cache, True, False, seed=t_cache, n_seq=n_seq)
        for label, (lib, check) in trees.items():
            fn = lib_decode_step(torch, lib, check, cfg, packed, inp)
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    fn()
                torch.cuda.synchronize()
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
            kernels = sorted((e["ts"], e["dur"], e["name"]) for e in events
                             if e.get("cat") == "kernel" and e.get("ph") == "X")
            # the x_emb copy before each step is one more kernel
            layer = [k for k in kernels if "elementwise" not in k[2] and "copy" not in k[2]]
            if len(layer) != steps * L * len(STEP_KINDS):
                raise RuntimeError(f"{label}: {len(layer)} step kernels in the trace, want "
                                   f"{steps * L * len(STEP_KINDS)}")
            us = [0.0] * len(STEP_KINDS)
            for i, (_, dur, name) in enumerate(layer):
                kind = i % len(STEP_KINDS)
                want = {1: "self_attention", 4: "cross_attention"}.get(kind)
                if want and want not in name:
                    raise RuntimeError(f"{label}: launch {i} is {name}, want {want}")
                us[kind] += dur / steps
            case = f"step_bk{bk}_t{t_cache}_nseq{n_seq}_{label}"
            total = sum(us)
            print(f"{case}: kernels {total / 1000:.4f} ms per step; " + ", ".join(
                f"{k} {u / 1000:.4f} ms ({u / total:.1%})" for k, u in zip(STEP_KINDS, us)))
            out[f"{case}_kernel_ms"] = total / 1000
            out[f"{case}_by_kind_ms"] = dict(zip(STEP_KINDS, (u / 1000 for u in us)))
            out[f"{case}_graph_ms"] = _median_ms(fn)
            print(f"{case}: graph-replayed step {out[f'{case}_graph_ms']:.4f} ms")
    for m, k, n in STEP_PRODUCTS:
        g = torch.Generator(device=dev).manual_seed(m + k + n)
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        leaf = quantize_weight(torch.randn((k, n), generator=g, device=dev) * 0.05)
        ms = _median_ms(lambda: int8_matmul(x, leaf["q"], leaf["s"]))
        print(f"int8_matmul M={m} K={k} N={n}: {ms:.4f} ms")
        out[f"int8_matmul_{m}x{k}x{n}_ms"] = ms
    return out


def _kernel_ms_by_name(torch, fn, calls=10):
    """{kernel name: device ms per fn() call} from the kernel intervals of
    ``calls`` calls under ``torch.profiler`` (template arguments and
    namespaces dropped from the names)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel" and e.get("ph") == "X":
            name = re.sub(r"^void ", "", e["name"].replace("(anonymous namespace)::", ""))
            name = re.match(r"[\w:]+", name).group()
            out[name] = out.get(name, 0.0) + e["dur"] / 1000.0 / calls
    return out


def head_breakdown(torch, dev, cfg, trees):
    """Both vocabulary heads' device time per call by kernel, for each tree
    in ``trees`` (label → (kernel library, check)): the logits head at
    every ``chip_smoke.HEAD_CASES`` case on large-v2's shapes, beside its
    bound, and the XTTS sampling head at XTTS v2's width with the
    production knobs. Each call's result is held to the plain version
    first."""
    from chip_smoke import (
        gpt_head_case,
        head_agrees,
        head_bound,
        head_case,
        HEAD_CASES,
        lib_gpt_head,
        lib_logits_head,
    )
    from wis_tpu_torch.models.xtts.gpt import GPTConfig
    from wis_tpu_torch.ops.fused_gpt_head import fused_gpt_head_plain
    from wis_tpu_torch.ops.fused_logits import fused_logits_topk_plain

    out = {}

    def report(name, label, by_kernel, bound=None):
        total = sum(by_kernel.values())
        print(f"{name} [{label}]: {total:.4f} ms per call"
              + (f" (bound {bound[0]:.4f} ms, {bound[1]})" if bound else "") + "; "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in by_kernel.items()))
        out[f"{name} [{label}]"] = dict(total_ms=total, by_kernel_ms=by_kernel)

    for bk, int8, grammar in HEAD_CASES:
        case = head_case(torch, dev, cfg, bk, int8, grammar)
        want = fused_logits_topk_plain(*case["args"], **case["kw"])
        for label, (lib, check) in trees.items():
            fn = lib_logits_head(torch, lib, check, case)
            if not head_agrees(fn(), want, case["exact"]):
                raise AssertionError(f"{case['name']} [{label}]: disagrees with plain")
            report(case["name"], label, _kernel_ms_by_name(torch, fn),
                   head_bound(cfg, bk, int8, grammar))
    g = GPTConfig()
    inputs = gpt_head_case(torch, dev, g)
    want = fused_gpt_head_plain(*inputs, cfg=g)
    for label, (lib, check) in trees.items():
        fn = lib_gpt_head(torch, lib, check, g, inputs)
        got = fn()
        if not (int(got[0]) == int(want[0]) and torch.equal(got[2] > -1e29, want[2] > -1e29)):
            raise AssertionError(f"fused_gpt_head [{label}]: disagrees with plain")
        report(f"fused_gpt_head D={g.d_model} V_pad={inputs[2].shape[-1]}", label,
               _kernel_ms_by_name(torch, fn))
    return out


def request_turns(torch, engine, settings, parent_lib, out_dir):
    """Part 2's and 3's unprofiled request latencies on the fused path, in
    turns parent / change / change / parent: for a parent turn the
    parent's kernel library takes this tree's place in ``_build``, so
    every wrapper launches the parent's kernels. Keys are prefixed
    ``turn<i>_<tree>_``."""
    from wis_tpu_torch.ops import _build

    own = _build.kernels()
    settings.fused_decode = PATHS["fused"]
    out = {}
    for i, (label, lib) in enumerate((("parent", parent_lib), ("change", own),
                                      ("change", own), ("parent", parent_lib))):
        _build._lib = lib
        try:
            engine.transcribe(_audio_i16(1000, 99), beam_size=5, max_tokens=4)  # warm-up
            part = request_latency(engine)
            part.update(request_kinds(torch, engine, out_dir, profiled=False))
        finally:
            _build._lib = own
        out.update({f"turn{i}_{label}_{k}": v for k, v in part.items()})
    return out


def eager_turns(torch, engine, settings, parent_lib, out_dir, reps=3):
    """The eager decoder's 3.84 s / 32-token request (``fused_decode="off"``)
    in turns parent / change / change / parent as ``request_turns``: per
    turn the median of ``reps`` unprofiled latencies, then one profiled
    request's kernel launches, summed kernel time and busy shares, and the
    ``ancestry_attention`` kernel's launches and summed time. Keys are
    prefixed ``turn<i>_<tree>_eager_``."""
    from torch.profiler import ProfilerActivity, profile

    from wis_tpu_torch.ops import _build

    own = _build.kernels()
    settings.fused_decode = PATHS["eager"]
    ms, cap = REQUESTS[0]
    audio = _audio_i16(ms, 0)
    out = {}
    try:
        for i, (label, lib) in enumerate((("parent", parent_lib), ("change", own),
                                          ("change", own), ("parent", parent_lib))):
            _build._lib = lib
            try:
                engine.transcribe(_audio_i16(1000, 99), beam_size=5, max_tokens=4)  # warm-up
                times = [engine.transcribe(audio, beam_size=5, max_tokens=cap).infer_time_ms
                         for _ in range(reps)]
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    engine.transcribe(audio, beam_size=5, max_tokens=cap)
                torch.cuda.synchronize()
                stats = _trace_stats(prof, "asr_dispatch", out_dir, f"eager_turn{i}",
                                     statistics.median(times), ("dispatch", "request"),
                                     named=("ancestry_attention",))
            finally:
                _build._lib = own
            key = f"turn{i}_{label}_eager_request_{ms}ms_cap{cap}"
            out[f"{key}_infer_ms"], out[f"{key}_infer_ms_all"] = statistics.median(times), times
            out.update({f"{key}_{k}": v for k, v in stats.items()})
    finally:
        settings.fused_decode = PATHS["fused"]
    return out


def stream_turns(torch, parent_lib, reps=3):
    """The XTTS stream both ways — the default path (fused step, plain
    epilogue) and the fused sampling head — in turns parent / change /
    change / parent as ``request_turns``: per turn and path the medians of
    ``reps`` streams' first chunk and total (ms). Keys are prefixed
    ``turn<i>_<tree>_xtts_<path>_``."""
    from wis_tpu_torch.models.xtts.model import XTTSModel
    from wis_tpu_torch.ops import _build

    own = _build.kernels()
    model = XTTSModel("cuda")
    out = {}
    for i, (label, lib) in enumerate((("parent", parent_lib), ("change", own),
                                      ("change", own), ("parent", parent_lib))):
        _build._lib = lib
        try:
            for path, head in (("default", False), ("fused_head", True)):
                model.fused_head = head
                _stream(torch, model)  # warm-up
                runs = [_stream(torch, model) for _ in range(reps)]
                key = f"turn{i}_{label}_xtts_{path}"
                out[f"{key}_first_chunk_ms"] = statistics.median(r[0] for r in runs)
                out[f"{key}_total_ms"] = statistics.median(r[1] for r in runs)
                out[f"{key}_total_ms_all"] = [r[1] for r in runs]
        finally:
            _build._lib = own
    return out


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


def _trace_stats(prof, span, out_dir, tag, unprofiled_ms, unit, named=()):
    """Kernel launches, summed kernel time and the busy shares of the
    annotated ``span`` in a profile (keys ``busy_share_of_profiled_<what>``
    and ``busy_share_of_unprofiled_<of>`` for ``unit`` = (what, of)), and
    for each name in ``named`` the launches and summed time of the kernels
    whose names hold it; the ops table to ``out_dir``."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernel_events = [e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in kernel_events]
    spans = [
        (e["ts"], e["ts"] + e["dur"]) for e in events
        if e.get("name") == span and e.get("ph") == "X"
        and e.get("cat") in ("user_annotation", "cpu_op")
    ]
    if not kernels or not spans:
        raise RuntimeError(f"trace holds {len(kernels)} kernels, {len(spans)} {span} spans")
    a, b = min(s[0] for s in spans), max(s[1] for s in spans)
    inside = [(max(x, a), min(y, b)) for x, y in kernels if y > a and x < b]
    kernel_ms = sum(y - x for x, y in kernels) / 1000.0
    table = prof.key_averages().table(sort_by="device_time_total", row_limit=40)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_ops_{tag}.txt"), "w") as f:
        f.write(table)
    out = {
        f"profiled_{span}_ms": (b - a) / 1000.0,
        "kernel_launches": len(kernels),
        "kernel_ms_sum": kernel_ms,
        f"busy_share_of_profiled_{unit[0]}": _union_us(inside) / (b - a),
        f"busy_share_of_unprofiled_{unit[1]}": kernel_ms / unprofiled_ms,
    }
    for name in named:
        mine = [e["dur"] for e in kernel_events if name in e["name"]]
        out[f"{name}_launches"] = len(mine)
        out[f"{name}_ms_sum"] = sum(mine) / 1000.0
    return out


def profiled_request(torch, engine, out_dir, unprofiled_ms, tag):
    from torch.profiler import ProfilerActivity, profile

    ms, cap = REQUESTS[0]
    audio = _audio_i16(ms, 0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = engine.transcribe(audio, beam_size=5, max_tokens=cap)
    torch.cuda.synchronize()
    return {"profiled_request_infer_ms": res.infer_time_ms,
            **_trace_stats(prof, "asr_dispatch", out_dir, tag, unprofiled_ms,
                           ("dispatch", "request"))}


def _kinds(engine):
    """The request kinds of part 3 → {name: call}."""
    from wis_tpu_torch.runtime.engine import ASRRequest

    def transcribe(ms, seed, **kw):
        return lambda: engine.transcribe(_audio_i16(ms, seed), beam_size=5, **kw)

    return {
        "detect_3840ms_cap32": transcribe(3840, 3, max_tokens=32, detect_language=True),
        "timestamps_3840ms_cap32": transcribe(3840, 10, max_tokens=32, timestamps=True),
        "words_3840ms_cap32": transcribe(3840, 11, max_tokens=32, word_timestamps=True),
        "longform_180000ms_cap64": transcribe(180000, 12, max_tokens=64),
        "coalesced4_3840ms_cap32": lambda: engine.transcribe_coalesced([
            ASRRequest(audio=_audio_i16(3840, 300 + i), model="large", beam_size=5,
                       max_tokens=32) for i in range(4)]),
    }


def request_kinds(torch, engine, out_dir, reps=3, profiled=True):
    """Each kind once to warm it, ``reps`` unprofiled calls (host clock
    around the call and a device sync), then one profiled call (unless
    ``profiled`` is false)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out = {}
    for name, call in _kinds(engine).items():
        call()
        ms = [_median_s(torch, call, 1) for _ in range(reps)]
        med = statistics.median(ms)
        out[f"{name}_ms"], out[f"{name}_ms_all"] = med, ms
        if not profiled:
            continue
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("request"):
                call()
        torch.cuda.synchronize()
        stats = _trace_stats(prof, "request", out_dir, f"fused_{name}", med, ("call", "call"))
        out.update({f"{name}_{k}": v for k, v in stats.items()})
    return out


def _stream(torch, model):
    """TTS_TEXT streamed as chip_smoke.py streams it → (first chunk ms,
    total ms), the total after a device sync."""
    cfg = model.cfg
    voice = [[0.0] * cfg.gpt.d_model] * cfg.cond_len
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = None
    for _ in model.inference_stream(TTS_TEXT, "en", voice, [0.0] * cfg.vocoder.cond_dim,
                                    stream_chunk_size=TTS_CHUNK,
                                    min_audio_tokens=TTS_MIN_TOKENS):
        first = first or (time.perf_counter() - t0) * 1000.0
    torch.cuda.synchronize()
    return first, (time.perf_counter() - t0) * 1000.0


def xtts_phase_times(torch, model):
    """The stream's parts at its shapes: the prefill of TTS_TEXT's prefix,
    one 20-token chunk of the fused decode from the prefix (512-column
    cache; plain epilogue, then the fused head) and one vocoder call on
    22 latents (2 of left context + 20)."""
    from wis_tpu_torch.models.xtts.gpt import (
        build_prefill,
        flatten_gpt_cache,
        run_decode_chunk_fused,
    )
    from wis_tpu_torch.models.xtts.hifigan import hifigan_forward
    from wis_tpu_torch.ops.fused_gpt import build_fused_gpt_step
    from wis_tpu_torch.ops.fused_gpt_head import build_fused_gpt_head

    cfg, g, dev = model.cfg, model.cfg.gpt, model.device
    ids = model.tokenize(TTS_TEXT, "en")
    bucket = model._text_bucket(len(ids))
    text = torch.zeros((1, bucket), dtype=torch.long, device=dev)
    text[0, : len(ids)] = torch.from_numpy(ids).to(dev)
    cond = torch.zeros((1, cfg.cond_len, g.d_model), dtype=model.dtype, device=dev)
    prefill = build_prefill(g, 1, cfg.cond_len, bucket,
                            cfg.cond_len + bucket + 1 + g.max_audio_tokens)
    out = {"xtts_prefill_ms": _median_s(torch, lambda: prefill(model.gpt_params, cond, text), 3)}
    _, cache = prefill(model.gpt_params, cond, text)
    kc, vc = flatten_gpt_cache(cache, 512)
    step = build_fused_gpt_step(g, bk=1, t_cache=512)
    gen = torch.Generator(device=dev).manual_seed(0)
    gum = model._gumbel(gen, TTS_CHUNK)
    start = torch.full((1,), g.start_audio_token, dtype=torch.long, device=dev)
    history = torch.zeros((1, g.max_audio_tokens), dtype=torch.long, device=dev)
    for name, head in (("xtts_chunk20_ms", None),
                       ("xtts_chunk20_fused_head_ms", build_fused_gpt_head(g, dtype=model.dtype))):
        out[name] = _median_s(torch, lambda: run_decode_chunk_fused(
            model.gpt_params, model.gpt_packed, step, start, kc.clone(), vc.clone(), cache.pos,
            history.clone(), 0, gum, 0.1, 50, 0.8, 7.0, True, TTS_MIN_TOKENS,
            head_packed=model.gpt_head_packed, cfg=g, chunk=TTS_CHUNK, batch=1, head_fn=head), 3)
    lat = torch.randn((1, 22, g.d_model), generator=gen, device=dev).to(model.dtype)
    spk = torch.zeros((1, cfg.vocoder.cond_dim), dtype=model.dtype, device=dev)
    out["xtts_vocoder_22_latents_ms"] = _median_s(
        torch, lambda: hifigan_forward(model.vocoder_params, lat, spk, cfg.vocoder), 5)
    return out


def xtts_stream_profile(torch, model, out_dir, tag, reps=3):
    """Unprofiled stream times (medians of ``reps``), then one profiled
    stream's launches, kernel time and busy shares."""
    from torch.profiler import ProfilerActivity, profile, record_function

    runs = [_stream(torch, model) for _ in range(reps)]
    out = {"stream_first_chunk_ms": statistics.median(r[0] for r in runs),
           "stream_total_ms": statistics.median(r[1] for r in runs),
           "stream_total_ms_all": [r[1] for r in runs]}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("xtts_stream"):
            _stream(torch, model)
    torch.cuda.synchronize()
    out.update(_trace_stats(prof, "xtts_stream", out_dir, tag, out["stream_total_ms"],
                            ("stream", "stream")))
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/profile", help="directory for the ops table")
    ap.add_argument("--parent", help="another checkout of this repo: compare its kernels "
                    "with this tree's (the step by kernel kind, then the requests in turns) "
                    "instead of the full profile")
    ap.add_argument("--heads", action="store_true", help="only the two vocabulary heads by "
                    "kernel (with --parent, both trees'), no model load")
    ap.add_argument("--eager", action="store_true", help="with --parent: only the eager "
                    "request's turns")
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
    result = {"device": smi}

    def report(part, prefix=""):
        for key, val in part.items():
            print(f"{prefix}{key}: {val}")
            result[prefix + key] = val

    from chip_smoke import _parent_library
    from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS
    from wis_tpu_torch.ops import _build

    parent = _parent_library(args.parent) if args.parent else None
    trees = {"parent": parent} if parent else {}
    trees["change" if parent else "tree"] = (_build.kernels(), _build.check)
    eager_only = bool(parent and args.eager)
    if not eager_only:
        result.update(head_breakdown(torch, torch.device("cuda"), WHISPER_CONFIGS["large"],
                                     trees))
    if args.heads:
        print(json.dumps(result))
        return 0
    settings = APISettings(whisper_model_default="large", beam_size=5,
                           long_beam_size=5, quant="int8")
    engine = WhisperEngine(ModelRegistry(settings, "cuda"))
    loaded = engine.registry.get("large")
    if not eager_only:
        report(step_breakdown(torch, engine.device, loaded.cfg,
                              engine._packed_decoder(loaded), trees))
    if parent:
        report(eager_turns(torch, engine, settings, parent[0], args.out))
        if not eager_only:
            report(request_turns(torch, engine, settings, parent[0], args.out), "fused_")
            report(stream_turns(torch, parent[0]))
        print(json.dumps(result))
        return 0

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
    report(request_kinds(torch, engine, args.out), "fused_")
    del engine, loaded

    from wis_tpu_torch.models.xtts.model import XTTSModel

    xtts = XTTSModel("cuda")
    _stream(torch, xtts)  # warm-up
    report(xtts_phase_times(torch, xtts))
    for path, head in (("xtts_default", False), ("xtts_fused_head", True)):
        xtts.fused_head = head
        report(xtts_stream_profile(torch, xtts, args.out, path), f"{path}_")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
