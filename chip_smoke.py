#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``wis_tpu_torch``) once on one NVIDIA GPU.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without printing a result:

1. require a CUDA device; print the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit``);
2. build the hand-written kernels from ``wis_tpu_torch/csrc`` (nvcc, into
   ``build/wis_tpu_torch/``) and print the build seconds;
3. hold each kernel against its plain PyTorch version on the card, in
   bf16, at the encoder's shapes (flash also on inputs that expose an
   unmasked ragged key tile), and time both with CUDA events;
4. serve large-v2 beam-5 int8 requests (seeded random weights) through the
   engine's ``transcribe`` — the bench shapes 3.84 s / 10.7 s / 29.2 s with
   32 / 64 / 100 tokens, plus one language-detect request — with every
   kernel launch counter set to 0 just before and read just after;
5. run the large-v2 encoder with the kernels and again with the plain
   functions, and compare.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np

SAMPLE_RATE = 16000
#: (audio ms, max_tokens) — the bench's large-v2 beam-5 rows
REQUESTS = ((3840, 32), (10688, 64), (29248, 100))
#: LayerNorm and flash launches one large-v2 request must make
#: (2 per encoder layer + ln_post; 1 attention per encoder layer)
MIN_LN, MIN_FLASH = 65, 32


def _bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    import torch

    mag = torch.clamp_min(x.abs().float(), 2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _median_ms(fn, reps=20, replays=15):
    """Median device time of one fn() call: `reps` calls captured in a CUDA
    graph, the graph replayed between CUDA events. Replaying keeps the
    host's per-call Python overhead out of the interval, which would
    otherwise dominate a kernel of a few microseconds."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _audio_i16(ms: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pcm = rng.standard_normal(ms * SAMPLE_RATE // 1000) * 0.05
    return np.clip(pcm * 32768.0, -32768, 32767).astype(np.int16)


def check_layer_norm(torch, dev):
    from wis_tpu_torch.ops.layernorm import layer_norm_cuda, layer_norm_plain

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 1500, 1280), dtype=np.float32) * 3 + 0.5)
    x = x.to(dev, torch.bfloat16)
    g = torch.from_numpy(1 + 0.1 * rng.standard_normal(1280, dtype=np.float32)).to(dev)
    b = torch.from_numpy(0.1 * rng.standard_normal(1280, dtype=np.float32)).to(dev)
    got = layer_norm_cuda(x, g, b)
    ref = layer_norm_plain(x, g, b)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    # tolerance: one bf16 ulp of the reference plus 1e-6 — both compute the
    # same f32 statistics (in another summation order) and round once to
    # bf16; near zero the output is the difference of two O(0.1) terms,
    # (x-μ)·rstd·γ and β, whose f32 rounding (~1e-8: the kernel fuses the
    # multiply-add) can be several bf16 ulps of a ~1e-6 result
    over = err > _bf16_ulp(ref) + 1e-6
    bad = int(over.sum())
    if bad:
        i = int(over.flatten().nonzero()[0])
        print(f"layer_norm first disagreement at {i}: kernel "
              f"{float(got.flatten()[i])!r} plain {float(ref.flatten()[i])!r}")
    ms = _median_ms(lambda: layer_norm_cuda(x, g, b))
    plain_ms = _median_ms(lambda: layer_norm_plain(x, g, b))
    print(
        f"layer_norm (1,1500,1280) bf16: max|Δ| {float(err.max()):.3e} "
        f"(tolerance 1 bf16 ulp of the reference + 1e-6, {bad} elements over); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
    )
    if bad:
        raise AssertionError(f"layer_norm kernel disagrees with plain on {bad} elements")
    return float(err.max()), ms, plain_ms


#: flash kernel vs plain: bound on ‖Δ‖ / ‖plain‖ over the whole output
FLASH_REL_NORM = 6e-3


def flash_disagreement(got, ref):
    """(elements over the elementwise bound, max|Δ|, ‖Δ‖/‖ref‖) of a flash
    result against its plain version.

    Tolerances: each element within 2 bf16 ulps of the reference element
    plus 2⁻⁸ of the output's largest magnitude, and the whole output
    within FLASH_REL_NORM in relative norm. The kernel rounds the
    unnormalized probabilities to bf16 and divides at the end, the plain
    version rounds the normalized ones; each side then rounds once to
    bf16. On standard-normal inputs at (1, 1500, 1280) an emulation of
    both roundings in numpy-seeded torch on the CPU gives a relative
    norm of 3.1e-3 and at most 1.5e-3 of the largest magnitude past
    2 ulps; the same emulation with the ragged last key tile left
    unmasked (28 zero keys in the softmax) gives 1.46e-2 and 6.2e-3."""
    import torch

    d = (got.float() - ref.float()).abs()
    r = ref.float()
    over = d > 2 * _bf16_ulp(r) + 2.0 ** -8 * float(r.abs().max())
    return int(over.sum()), float(d.max()), float(d.norm() / r.norm())


def _flash_inputs(torch, dev, heads, trap, seed):
    """Packed (1, 1500, 1280) bf16 q, k, v. With ``trap`` the real keys
    score 8 below the zeros the kernel fills the ragged tile with (one
    column of each head carries +c in q and -c in k, c² / √Dh = 8; a
    constant shift leaves each softmax unchanged), and the 36 rows past
    T=1500 in the same allocation hold keys scoring 16 above the real
    ones with values of 50: a kernel that leaves the ragged tile unmasked,
    or reads keys at or past T, moves every output far off."""
    t, d, alloc = 1500, 1280, 1536
    dh = d // heads
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, alloc, d), dtype=np.float32) for _ in range(3))
    if trap:
        c = (8 * dh ** 0.5) ** 0.5
        q[..., ::dh] = c
        k[:, :t, ::dh] = -c
        k[:, t:, ::dh] = c
        v[:, t:] = 50.0
    # views of the first 1500 rows: contiguous, the trap rows right behind
    return tuple(torch.from_numpy(x).to(dev, torch.bfloat16)[:, :t] for x in (q, k, v))


def check_flash(torch, dev):
    from wis_tpu_torch.ops.flash import (
        flash_attention_packed,
        flash_attention_packed_plain,
    )

    rows = []
    for heads in (20, 10):  # head_dim 64 (large-v2) and 128
        for trap in (False, True):
            q, k, v = _flash_inputs(torch, dev, heads, trap, 2 + heads)
            got = flash_attention_packed(q, k, v, heads)
            ref = flash_attention_packed_plain(q, k, v, heads)
            torch.cuda.synchronize()
            bad, err, rel = flash_disagreement(got, ref)
            case = (f"flash_attention_packed (1,1500,1280) H={heads} "
                    f"Dh={1280 // heads} bf16{' masked-key trap' if trap else ''}")
            print(
                f"{case}: max|Δ| {err:.3e}, ‖Δ‖/‖plain‖ {rel:.3e} (tolerance "
                f"{FLASH_REL_NORM:.1e}), {bad} elements over 2 bf16 ulps + "
                f"2^-8·max|plain|"
            )
            if bad or not rel <= FLASH_REL_NORM:
                raise AssertionError(
                    f"{case}: kernel disagrees with plain ({bad} elements over, "
                    f"relative norm {rel})"
                )
            rows.append(err)
            if trap:
                continue
            ms = _median_ms(lambda: flash_attention_packed(q, k, v, heads))
            plain_ms = _median_ms(lambda: flash_attention_packed_plain(q, k, v, heads))
            print(f"{case}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if heads == 20:
                times = ms, plain_ms
    return max(rows), times[0], times[1]


def serve_requests(torch, dev, counters):
    from wis_tpu_torch.runtime.engine import WhisperEngine
    from wis_tpu_torch.runtime.residency import ModelRegistry
    from wis_tpu_torch.settings import APISettings

    settings = APISettings(
        whisper_model_default="large",
        beam_size=5,
        long_beam_size=5,  # the bench rows fix the beam per row
        quant="int8",
    )
    engine = WhisperEngine(ModelRegistry(settings, dev))
    t0 = time.perf_counter()
    loaded = engine.registry.get("large")
    torch.cuda.synchronize()
    print(
        f"large-v2 seeded random int8 weights on {dev}: "
        f"{loaded.param_bytes / 2**30:.3f} GiB in {time.perf_counter() - t0:.2f} s"
    )
    engine.transcribe(_audio_i16(1000, 99), beam_size=5, max_tokens=4)  # warm-up

    for c in counters:
        c.launches = 0
    requests = [(ms, cap, False) for ms, cap in REQUESTS] + [(3840, 32, True)]
    for i, (ms, cap, detect) in enumerate(requests):
        before = [c.launches for c in counters]
        torch.cuda.reset_peak_memory_stats(dev)
        res = engine.transcribe(
            _audio_i16(ms, i), beam_size=5, max_tokens=cap, detect_language=detect
        )
        ln, fl = (c.launches - b for c, b in zip(counters, before))
        # the seeded-random model has no vocabulary files: its text is the
        # placeholder rendering, one "t<id>" piece per emitted token
        n_tok = len(re.findall(r"t\d+", res.text))
        print(
            f"request {ms / 1000:.2f}s beam5 cap{cap} detect={detect}: "
            f"infer {res.infer_time_ms:.2f} ms (asr_dispatch "
            f"{res.timings['asr_dispatch']:.2f} ms), tokens {n_tok}, "
            f"language {res.language}, layer_norm launches {ln}, "
            f"flash launches {fl}, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB"
        )
        if ln < MIN_LN or fl < MIN_FLASH:
            raise AssertionError(f"request ran {ln} LN / {fl} flash launches")
        if not 1 <= n_tok <= cap or res.audio_duration_ms != ms:
            raise AssertionError(f"bad result: {n_tok} tokens, {res.audio_duration_ms} ms")
    launches = [c.launches for c in counters]
    return engine, loaded, launches


def check_encode(torch, dev, loaded):
    """The large-v2 encoder with the kernels, with the plain functions, and
    in f32 with the plain functions (the reference)."""
    from wis_tpu_torch.audio.mel import log_mel
    from wis_tpu_torch.models.whisper import model as model_mod
    from wis_tpu_torch.ops.flash import flash_attention_packed_plain
    from wis_tpu_torch.ops.layernorm import layer_norm_plain

    def f32(tree):
        return {k: f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}

    audio = torch.from_numpy(_audio_i16(30000, 7)).to(dev).float()[None] / 32768.0
    cfg = loaded.cfg
    plain_ln = mock.patch.object(model_mod, "layer_norm_cuda", layer_norm_plain)
    plain_attn = mock.patch.object(
        model_mod, "flash_attention_packed", flash_attention_packed_plain
    )
    with torch.inference_mode():
        mel = log_mel(audio, cfg.n_mels)
        got = model_mod.encode(loaded.params, mel, cfg).float()
        with plain_ln, plain_attn:
            ref = model_mod.encode(loaded.params, mel, cfg).float()
            exact = model_mod.encode({"encoder": f32(loaded.params["encoder"])}, mel, cfg)
    torch.cuda.synchronize()
    if got.shape != (1, 1500, 1280) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"encoder output {tuple(got.shape)} not finite")

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    floor = rel(ref, exact)
    err = rel(got, exact)
    # tolerance: with the kernels the bf16 encoder may sit at most 1.5× as
    # far from the f32 encoder as the plain bf16 encoder does — after 32
    # bf16 layers that distance is the rounding floor, and a kernel that
    # merely rounds in another order lands at the floor, not above it
    print(
        f"encode large-v2 (1,1500,1280): kernels vs plain max|Δ| "
        f"{float((got - ref).abs().max()):.3e}; relative ‖Δ‖ to the f32 encoder: "
        f"kernels {err:.3e}, plain bf16 {floor:.3e} (tolerance 1.5 × plain)"
    )
    if not err <= 1.5 * floor:
        raise AssertionError(f"encoder with kernels off the f32 reference: {err} > 1.5 × {floor}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from wis_tpu_torch.device import resolve_device
    from wis_tpu_torch.ops import _build
    from wis_tpu_torch.ops.flash import flash_attention_packed
    from wis_tpu_torch.ops.layernorm import layer_norm_cuda

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}"
    )

    t0 = time.perf_counter()
    _build.kernels()
    print(f"kernels built/loaded from {_build.library_path()} in "
          f"{time.perf_counter() - t0:.2f} s")

    ln_err, ln_ms, ln_plain = check_layer_norm(torch, dev)
    fl_err, fl_ms, fl_plain = check_flash(torch, dev)
    counters = (layer_norm_cuda, flash_attention_packed)
    _, loaded, (ln_n, fl_n) = serve_requests(torch, dev, counters)
    check_encode(torch, dev, loaded)

    print(json.dumps({"kernels": [
        {"name": "layer_norm", "route": "cuda",
         "source": "wis_tpu_torch/csrc/layernorm.cu",
         "replaces": "wis_tpu/ops/layernorm.py:38", "launches": ln_n,
         "max_abs_err": ln_err, "ms": ln_ms, "plain_ms": ln_plain},
        {"name": "flash_attention_packed", "route": "cuda",
         "source": "wis_tpu_torch/csrc/flash_attention.cu",
         "replaces": "wis_tpu/ops/flash.py:121", "launches": fl_n,
         "max_abs_err": fl_err, "ms": fl_ms, "plain_ms": fl_plain},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
