#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``wis_tpu_torch``) once on one NVIDIA GPU.

Run from the repository root, with one card visible:

    python3 chip_smoke.py [--parent <another checkout>]

With ``--parent`` (an unpacked archive of the parent commit's files, say)
the script also builds that checkout's kernels and times them beside this
tree's on the same inputs, in turns parent / change / change / parent,
each side held to its plain version first: in phase 3 ``int8_matmul``,
``layer_norm`` (beside ``F.layer_norm``), the flash kernels and
``ancestry_attention`` (BK 5 and 20), in phase 4
the fused decode step at each non-trap case and the fused logits head at
BK 5 and 20, int8 and bf16 table, plain and grammar mode, in phase 7 the
GPT step at its three cache buckets and the GPT sampling head.

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without printing a result:

1. require a CUDA device; print the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit``);
2. build the hand-written kernels from ``wis_tpu_torch/csrc`` (one nvcc per
   source, in parallel, into ``build/wis_tpu_torch/``) and print the build
   seconds and, from ``-Xptxas -v``, the registers and spills of the
   ``int8_matmul``, Hopper flash (every instance), LayerNorm, decode-step,
   head and ``ancestry_attention`` kernels, and any warning that ptxas
   serialised a ``wgmma``;
3. hold each encoder kernel against its plain PyTorch version on the card,
   in bf16, at the encoder's shapes (flash also on inputs that expose an
   unmasked ragged key tile; the head-major flash kernel also at head
   widths 32, 80, 72, 136 and 256, and bit-identical to the packed one at
   64 and 128; the packed kernel on a batch of two whose second batch's first
   values are Inf, batch 0 finite and equal to its plain version; one
   and two consumer warpgroups per block timed), and time kernel, plain
   version and the PyTorch library call that computes the same function;
   the same for
   ``int8_matmul`` (the cross-KV products of one and four windows, a
   decode step's MLP products at 5 and 15 rows, the XTTS prefill; the
   library call ``torch.mm`` on a bf16-dequantized weight) and
   ``ancestry_attention`` (BK 5, 20 and 40, H=20, Dh=64, a map scrambled
   within groups of five rows or across all 40, T=100 read to pos 99, a
   trap past pos, two calls giving the same bits);
4. load large-v2 with seeded random int8 weights; hold the fused decode
   step (all 32 layers, BK=5 with caches of 128 and 256 positions, int8
   and bf16 cross-KV, and BK=20 over four windows) and the fused logits
   head (V=51865, bf16 and int8 embedding, and its grammar mode at BK 5
   and 20 on exact inputs) against their plain versions, on standard
   inputs and on trap inputs that a kernel reading a masked column or
   another window's cross-KV, ignoring the suppress or a grammar mask,
   letting a masked timestamp region add to its sum, or breaking a tie or
   the min_ts floor the wrong way fails; time the head at BK 5 and 20 (one
   window's beams and the long-form groups of four windows), int8 and
   bf16 table, plain and grammar mode, beside its plain version and bound;
5. serve every ASR request kind through the engine, every kernel launch
   counter set to 0 just before each and read just after, each kind's
   launches checked: a large-v2 beam-5 request on the eager decoder
   (``fused_decode="off"``: ancestry_attention 32 and int8_matmul 256 per
   decode step), then with ``fused_decode="auto"`` (the fused path on the
   card) the main path — the bench shapes 3.84 s / 10.7 s / 29.2 s with
   32 / 64 / 100 tokens plus one language-detect request — then a
   timestamps request (the grammar head at every step), a word-timestamps
   request (the alignment call), a 180 s long-form request (13 windows in
   4 groups, the fused step at BK=20) and a coalesced batch of four;
6. run the large-v2 encoder with the kernels and again with the plain
   functions, and compare; then under ``WIS_NO_PACKED_FLASH`` (the
   head-major kernel in every layer: bit-identical); serve one 3.84 s
   request by the default route and under each of the JAX package's
   switches (``WIS_NO_PACKED_FLASH``: the head-major kernel 32 times, the
   same tokens; ``WIS_NO_FLASH``: no flash kernel; ``WIS_NO_LN_KERNEL``: no
   LayerNorm kernel); run the converter self-test at large-v2 in this
   process and as ``python -m wis_tpu_torch.cli convert-model --selftest
   large-v2``; write a seeded large-v2 HF checkpoint (F16, two shards,
   ~3.1 GB) under ``build/``, load it through the registry (every leaf
   bit-equal to the conversion in memory), serve a request from it, load
   it again from ``_converted_torch``, and delete it;
7. build XTTS v2 at full width (30-layer GPT, D=1024, int8; HiFi-GAN) from
   seeded numpy weights on the card; hold the fused GPT step (bk=1, caches
   of 256 and 1152 positions, standard and trap inputs) and the fused
   sampling head (V_pad=1152, the knob grid, a tie) against their plain
   versions and time both;
8. stream one ~200-character English utterance to the 605-token cap
   (``stream_chunk_size=20``, ``min_audio_tokens=605``, a zero voice)
   three ways — the default path (fused step, eager epilogue), the fused
   head, and the eager ``gpt_pass`` path for its first three chunks — each
   with the counters set to 0 just before and read just after; time the
   per-token sampling epilogue both ways;
9. write a seeded full-width Coqui XTTS v2 ``model.pth`` under ``build/``
   (GPT, HiFi-GAN and conditioning encoder), serve it from an ``XTTSModel``
   whose model_dir holds it (every GPT, vocoder and conditioning leaf equal
   to the state dict's conversion, three chunks streamed and a clone that
   differ from the seeded model's), print the load seconds, delete it;
10. voice cloning and speaker verification at full width: the XTTS v2
   conditioning encoder (D 1024, 16 heads, 6 blocks, 32 latents, perceiver
   8×64, depth 2, seeded) on the log-mel of 6 s of seeded audio, the card's
   latents held to the same module on the CPU, its device ms (graph replay)
   and its ms launched eagerly; WavLM base-plus-sv (seeded) embedding 2.5 s
   and 10 s on the card, each held to the CPU, timed the same two ways; a
   seeded HF-layout WavLM checkpoint in two BF16
   shards under ``build/`` loaded through ``load_or_init_wavlm`` (every leaf
   equal), the load seconds, deleted; ``clone_speaker`` on phase 7's model
   (median of 3), then phase 8's utterance streamed in the cloned voice to
   the cap with the counters set to 0 just before and read just after (the
   fused GPT step once a token, ``int8_matmul`` in the prefill); ``python
   -m wis_tpu_torch.cli convert-model --selftest xtts``; two seeded voices
   enrolled in a temporary store through the port's ``SpeakerVerifier``
   and one verified, the enrol and verify ms;
11. the serving layers below HTTP on phase 5's engine, with no JAX,
   pydantic or aiohttp: the wisaudio library built with g++ from
   ``native/wisaudio`` into ``build/wis_tpu_torch/wisaudio/`` (the build
   seconds; Python decoding is a failure here); seeded 3.84 s audio as a
   16-bit WAV at 44.1 kHz stereo, raw s16le at 16 kHz mono and a float
   WAV at 48 kHz through ``load_audio`` (ms per decode); an
   ``InferenceExecutor`` taking four large-v2 beam-5 requests from four
   threads as one dispatch (the same launches as phase 5's coalesced four
   and the same tokens as the direct ``transcribe_coalesced``, counters
   set to 0 just before and read once the executor is idle), eight as two
   dispatches of four (requests/s on the host clock), a lone request
   beside the direct ``transcribe`` (the ms the executor adds) and a
   word-timestamps request alone; a ``StreamingSession`` fed 20 ms PCM
   frames (the text equal to ``engine.transcribe`` on the same audio),
   one VAD-gated at 48 kHz stereo ending on 1.5 s of silence, and a
   v3-only ``force_language`` refused with no launch and nothing queued;
   a ``ReplicaPool`` over every visible CUDA device serving one request;
   ``get_api_settings()``'s batch fields.
12. the HTTP apps' cores (``wis_tpu_torch/server/app.py``, ``tts_app.py``)
   on phase 5's engine and phase 7's XTTS v2, with no aiohttp, under one
   event loop, the counters set to 0 just before each request and read once
   it is answered: ``/api/asr`` on phase 11's 44.1 kHz stereo WAV (the
   direct call's text; timestamps with the grammar head at every step,
   word timestamps, detect; the core's ms over ``executor.submit_sync`` in
   turns, beside ``/api/willow`` on the same samples as PCM and the WAV's
   decode; four at once through ``asyncio.gather`` as one dispatch with the
   direct ``transcribe_coalesced``'s launches and tokens; a beam of 99,
   ``yue`` on large-v2, ``xx`` and bytes that are no audio refused with no
   launch and nothing queued), ``/api/willow`` (raw PCM with the
   ``x-audio-*`` headers and stats; a WAV with ``save_audio`` into a
   temporary static root; ``voice_auth`` 406 with no voice enrolled, then
   alice's reply after ``/api/sv`` enrolled two voices and refused
   ``enroll=../x``), the WebSocket loop on phase 11's frames (its text),
   ``/api/status``, ping, OpenAPI and docs; ``GET /api/tts`` for an unknown
   speaker with an empty store (the built-in voices cloned, then the
   196-character text streamed to the 605-token cap: 605 fused GPT steps,
   ``int8_matmul`` 180, the fused head 0), five streams in the default
   voice (time to the first chunk and stream ms, host clock), two greedy
   streams at once equal to their lone runs, voice enrolment,
   ``/clone_speaker``, ``/tts_stream`` and the speakers list; the CLI's
   ``run --help`` and ``run-tts --help``.
13. every further Whisper size (tiny, base, small, medium, large-v3,
   large-v3-turbo, distil-large-v2, distil-large-v3) at its published
   widths, one at a time, with the production settings (bf16, int8
   weights, cross-KV and logits table, the fused decode path) and seeded
   weights through ``ModelRegistry``, evicted after: its kernels held to
   their plain versions at its shapes (LayerNorm and packed flash at D,
   int8_matmul at its products, the fused step at BK 1 and 5 and 13
   windows of one beam, standard and trap inputs, the logits head at BK 1
   and 5 in both tables and its grammar mode), its encoder held to the f32
   one as phase 6 holds large-v2's, and a 3.84 s request at beam 1, beam 5
   and with detection, each with the counters set to 0 just before and
   read just after: LayerNorm 2·L_enc+1, packed flash L_enc, int8_matmul
   10·L_dec (+8·L_dec with detection), the fused step and head once per
   decode step; one line per size;
14. the port's bench (``wis_tpu_torch/bench.py``, ``bench.py``'s rows) in
   this process at fewer repeats: eight rows and the summary with the
   card's name and power limit, every value finite and positive, the
   180 s long-form row one dispatch of 13 windows through the fused step
   at BK 13, the TTS row through the fused GPT step;
15. ``wis_tpu_torch.entry.entry()`` (large-v2's forward step: finite
   (1, 51865) logits, 65 LayerNorm and 32 packed flash launches), then
   ``python -m wis_tpu_torch.cli check`` and ``check-edge``, each exit 0;
16. tensor and data parallelism: ``wis_tpu_torch.entry.dryrun_multichip(2)``,
   two ranks of a ``torch.distributed`` world on the one card over gloo (a
   1×2 mesh; every STAGE OK line), then per rank for the 2-way large-v2
   3.84 s beam-5 request (and medium's, and XTTS v2's GPT prefill and
   20-token chunk): each kernel's launches, counted from 0 just before and
   read just after in the rank, against the single-rank eager request's
   and the prediction; the ranks' tokens equal; the host ms beside the
   single-rank request's; a teacher-forced pass's logits within
   ``entry.TF_REL_TOL`` of the single rank's at every position; layer 0's
   row-parallel products bit-equal to the single rank's but for at most
   ``entry.ROW_MISMATCH_MAX`` of the elements, where partial sums rounded
   to bf16 before the reduce (the control) move more; the
   vocabulary-sharded heads' ids equal to the whole head's; then each
   kernel on that path held to its plain version at a rank's shapes and
   timed (``check_shard_kernels``).

Each phase prints its seconds as it ends. The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np

SAMPLE_RATE = 16000
REPO = os.path.dirname(os.path.abspath(__file__))
#: the JAX package's environment switches of the encoder's gates
SWITCHES = ("WIS_NO_FLASH", "WIS_NO_PACKED_FLASH", "WIS_NO_LN_KERNEL")
#: the H100's published peaks (SXM, dense, at 700 W): device memory, bf16
#: tensor cores, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
#: (audio ms, max_tokens) — the bench's large-v2 beam-5 rows
REQUESTS = ((3840, 32), (10688, 64), (29248, 100))
#: LayerNorm and flash launches one large-v2 encoder call makes (2 per
#: encoder layer + ln_post; 1 attention per encoder layer)
MIN_LN, MIN_FLASH = 65, 32
#: int8_matmul launches of one ASR program call (the 64 cross-KV products
#: and the prompt prefill's 8 per decoder layer), and of one more decoder
#: pass (language detection, an eager decode step, the alignment pass)
INT8_CALL, INT8_PASS = 320, 256
#: the XTTS stream: ~200 characters of English, the reference's chunk size,
#: and a token floor at the 605-token cap, so the random-weight GPT runs to
#: the cap whatever it samples (below the cap, whether it stops in the last
#: few tokens turns on the last bits of its products)
TTS_TEXT = (
    "Willow streams speech back while the words are still being generated: "
    "the first audio arrives after six tokens, then every twenty tokens bring "
    "almost a second more, until the sentence is complete."
)
TTS_CHUNK, TTS_MIN_TOKENS = 20, 605


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


def _bound(n_bytes, ops, flops_per_s):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _audio_i16(ms: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pcm = rng.standard_normal(ms * SAMPLE_RATE // 1000) * 0.05
    return np.clip(pcm * 32768.0, -32768, 32767).astype(np.int16)


def layer_norm_case(torch, dev, d, seed=1):
    """layer_norm_cuda against layer_norm_plain at (1, 1500, d) bf16 →
    (x, g, b, max|Δ|); raises where an element is past the tolerance."""
    from wis_tpu_torch.ops.layernorm import layer_norm_cuda, layer_norm_plain

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, 1500, d), dtype=np.float32) * 3 + 0.5)
    x = x.to(dev, torch.bfloat16)
    g = torch.from_numpy(1 + 0.1 * rng.standard_normal(d, dtype=np.float32)).to(dev)
    b = torch.from_numpy(0.1 * rng.standard_normal(d, dtype=np.float32)).to(dev)
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
    print(f"layer_norm (1,1500,{d}) bf16: max|Δ| {float(err.max()):.3e} "
          f"(tolerance 1 bf16 ulp of the reference + 1e-6, {bad} elements over)")
    if bad:
        i = int(over.flatten().nonzero()[0])
        print(f"layer_norm first disagreement at {i}: kernel "
              f"{float(got.flatten()[i])!r} plain {float(ref.flatten()[i])!r}")
        raise AssertionError(f"layer_norm kernel disagrees with plain on {bad} elements")
    return x, g, b, float(err.max())


def check_layer_norm(torch, dev):
    from wis_tpu_torch.ops.layernorm import layer_norm_cuda, layer_norm_plain

    x, g, b, err = layer_norm_case(torch, dev, 1280)
    ms = _median_ms(lambda: layer_norm_cuda(x, g, b))
    plain_ms = _median_ms(lambda: layer_norm_plain(x, g, b))
    gb, bb = g.bfloat16(), b.bfloat16()
    library_ms = _median_ms(lambda: torch.nn.functional.layer_norm(x, (1280,), gb, bb))
    bound_ms, bound_by = _bound(2 * x.numel() * 2 + 2 * 1280 * 4, 8 * x.numel(), F32_FLOPS)
    print(
        f"layer_norm (1,1500,1280) bf16: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, F.layer_norm {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})"
    )
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


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


def _flash_inputs(torch, dev, heads, trap, seed, d=1280):
    """Packed (1, 1500, d) bf16 q, k, v. With ``trap`` the real keys
    score 8 below the zeros the kernel fills the ragged tile with (one
    column of each head carries +c in q and -c in k, c² / √Dh = 8; a
    constant shift leaves each softmax unchanged), and the 36 rows past
    T=1500 in the same allocation hold keys scoring 16 above the real
    ones with values of 50: a kernel that leaves the ragged tile unmasked,
    or reads keys at or past T, moves every output far off."""
    t, alloc = 1500, 1536
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


def flash_case(torch, dev, heads, trap, seed, d=1280):
    """flash_attention_packed against its plain version on _flash_inputs
    → (q, k, v, max|Δ|); raises past the flash tolerances."""
    from wis_tpu_torch.ops.flash import (
        flash_attention_packed,
        flash_attention_packed_plain,
    )

    q, k, v = _flash_inputs(torch, dev, heads, trap, seed, d)
    got = flash_attention_packed(q, k, v, heads)
    ref = flash_attention_packed_plain(q, k, v, heads)
    torch.cuda.synchronize()
    bad, err, rel = flash_disagreement(got, ref)
    case = (f"flash_attention_packed (1,1500,{d}) H={heads} "
            f"Dh={d // heads} bf16{' masked-key trap' if trap else ''}")
    print(
        f"{case}: max|Δ| {err:.3e}, ‖Δ‖/‖plain‖ {rel:.3e} (tolerance "
        f"{FLASH_REL_NORM:.1e}), {bad} elements over 2 bf16 ulps + "
        f"2^-8·max|plain|"
    )
    if bad or not rel <= FLASH_REL_NORM or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{case}: kernel disagrees with plain ({bad} elements over, "
            f"relative norm {rel})"
        )
    return q, k, v, err


def check_flash(torch, dev):
    from wis_tpu_torch.ops.flash import (
        flash_attention_packed,
        flash_attention_packed_plain,
    )

    rows = []
    for heads in (20, 10):  # head_dim 64 (large-v2) and 128
        for trap in (False, True):
            q, k, v, err = flash_case(torch, dev, heads, trap, 2 + heads)
            case = (f"flash_attention_packed (1,1500,1280) H={heads} "
                    f"Dh={1280 // heads} bf16")
            rows.append(err)
            if trap:
                continue
            ms = _median_ms(lambda: flash_attention_packed(q, k, v, heads))
            plain_ms = _median_ms(lambda: flash_attention_packed_plain(q, k, v, heads))
            dh = 1280 // heads
            qh, kh, vh = (t.view(1, 1500, heads, dh).transpose(1, 2) for t in (q, k, v))
            library_ms = _median_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh)
            )
            bound_ms, bound_by = _bound(4 * q.numel() * 2, 4 * 1500 * 1500 * 1280, BF16_FLOPS)
            print(f"{case}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"scaled_dot_product_attention {library_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by})")
            # wave quantization: one or two consumer warpgroups per block,
            # asked of the C function (the wrapper leaves it to the kernel)
            lib, out = _build_lib(), torch.empty_like(q)

            def with_wgs(w):
                rc = lib.wis_flash_attention_packed(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, 1500, 1280,
                    heads, float((1280 // heads) ** -0.5), w,
                    torch.cuda.current_stream(dev).cuda_stream)
                if rc:
                    raise AssertionError(f"flash with {w} warpgroups: cudaError {rc}")

            by_wgs = {w: _median_ms(lambda w=w: with_wgs(w)) for w in (1, 2)}
            blocks = {w: -(-1500 // (64 * w)) * heads for w in (1, 2)}
            print(f"{case}: one warpgroup per block {by_wgs[1]:.4f} ms ({blocks[1]} blocks), "
                  f"two {by_wgs[2]:.4f} ms ({blocks[2]} blocks), the kernel's choice {ms:.4f} ms "
                  f"({torch.cuda.get_device_properties(dev).multi_processor_count} SMs)")
            if heads == 20:
                times = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=library_ms)
        rows.append(check_cross_batch_trap(torch, dev, heads))
    return dict(max_abs_err=max(rows), **times)


def cross_batch_inputs(torch, dev, heads, seed, t=1500, d=1280):
    """Packed (2, t, d) bf16 q, k, v with Inf in the values of batch 1's
    first 64 rows: the rows a kernel would read, past batch 0's last key,
    if its ragged last key tile ran on into the next batch (0 × Inf is NaN)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, t, d), dtype=np.float32) for _ in range(3))
    v[1, :64] = np.inf
    return tuple(torch.from_numpy(x).to(dev, torch.bfloat16) for x in (q, k, v))


def check_cross_batch_trap(torch, dev, heads):
    """flash_attention_packed on cross_batch_inputs: batch 0 must be finite
    and agree with its plain version (the packed rule's tolerances)."""
    from wis_tpu_torch.ops.flash import flash_attention_packed, flash_attention_packed_plain

    q, k, v = cross_batch_inputs(torch, dev, heads, seed=40 + heads)
    got = flash_attention_packed(q, k, v, heads)[:1]
    ref = flash_attention_packed_plain(q[:1], k[:1], v[:1], heads)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(got).all())
    bad, err, rel = flash_disagreement(got, ref)
    case = f"flash_attention_packed (2,1500,1280) H={heads} cross-batch trap"
    print(f"{case}: batch 0 finite {finite}, max|Δ| {err:.3e}, ‖Δ‖/‖plain‖ {rel:.3e}, "
          f"{bad} elements over")
    if not finite or bad or not rel <= FLASH_REL_NORM:
        raise AssertionError(f"{case}: batch 0 read batch 1's rows or disagrees with plain")
    return err


#: head-major flash cases (B, H, T, Dh): large-v2's encoder and the other
#: head widths the JAX gate sends to the head-major kernel — the micro
#: configs' 32, 80, 72 (Dh % 16 == 8), and 136 and 256 (padded to three
#: and four 64-column blocks)
HEAD_MAJOR_CASES = ((1, 20, 1500, 64), (1, 10, 1500, 128), (2, 2, 700, 32),
                    (1, 16, 1500, 80), (1, 18, 600, 72), (1, 10, 1500, 136),
                    (1, 5, 1500, 256))


def _head_major_inputs(torch, dev, b, h, t, dh, trap, seed, tail=64):
    """Contiguous head-major (b, h, t, dh) bf16 q, k, v at the start of
    allocations that run on for ``tail`` rows past the last head. With
    ``trap``, _flash_inputs' trap in this layout: every real key scores 8
    below the zeros the kernel fills a ragged key tile with, and the rows
    past the last head hold keys 16 above the real ones with values of 50."""
    rng = np.random.default_rng(seed)
    n = b * h * t * dh
    q, k, v = (rng.standard_normal(n + tail * dh, dtype=np.float32) for _ in range(3))
    if trap:
        c = (8 * dh ** 0.5) ** 0.5
        q[:n].reshape(b, h, t, dh)[..., 0] = c
        k[:n].reshape(b, h, t, dh)[..., 0] = -c
        k[n:].reshape(tail, dh)[:, 0] = c
        v[n:] = 50.0
    return tuple(torch.from_numpy(x).to(dev, torch.bfloat16)[:n].view(b, h, t, dh)
                 for x in (q, k, v))


def check_head_major_flash(torch, dev):
    """flash_attention against flash_attention_plain at HEAD_MAJOR_CASES
    (the packed rule's tolerances), on standard inputs and, at large-v2's
    shape and Dh=128, on the masked-key trap; at Dh 64 and 128 the output
    after merge_heads must be bit-identical to the packed kernel's on the
    same numbers (one kernel body for both layouts). Timed beside the
    plain version and F.scaled_dot_product_attention on the same tensors."""
    from wis_tpu_torch.ops.attention import merge_heads
    from wis_tpu_torch.ops.flash import (
        flash_attention,
        flash_attention_packed,
        flash_attention_plain,
    )

    rows, errs = {}, []
    for b, h, t, dh in HEAD_MAJOR_CASES:
        for trap in (False, True) if t == 1500 and dh in (64, 128) else (False,):
            q, k, v = _head_major_inputs(torch, dev, b, h, t, dh, trap, seed=h + dh + trap)
            got = flash_attention(q, k, v)
            ref = flash_attention_plain(q, k, v)
            same = None
            if dh in (64, 128):
                packed = flash_attention_packed(*(merge_heads(x) for x in (q, k, v)), h)
                same = torch.equal(merge_heads(got), packed)
            torch.cuda.synchronize()
            bad, err, rel = flash_disagreement(got, ref)
            case = f"flash_attention ({b},{h},{t},{dh}) bf16{' masked-key trap' if trap else ''}"
            print(f"{case}: max|Δ| {err:.3e}, ‖Δ‖/‖plain‖ {rel:.3e} (tolerance "
                  f"{FLASH_REL_NORM:.1e}), {bad} elements over 2 bf16 ulps + 2^-8·max|plain|"
                  + ("" if same is None else f"; equal to packed: {same}"))
            if bad or not rel <= FLASH_REL_NORM or same is False:
                raise AssertionError(f"{case}: kernel disagrees with plain or with packed")
            errs.append(err)
            if trap:
                continue
            ms = _median_ms(lambda: flash_attention(q, k, v))
            plain_ms = _median_ms(lambda: flash_attention_plain(q, k, v))
            library_ms = _median_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
            bound_ms, bound_by = _bound(4 * q.numel() * 2, 4 * b * h * t * t * dh, BF16_FLOPS)
            print(f"{case}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"scaled_dot_product_attention {library_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by})")
            rows[(h, dh)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, library_ms=library_ms)
    return dict(max_abs_err=max(errs), **rows[(20, 64)])


#: fused step vs plain at full width: bound on ‖Δ‖/‖plain‖ of x_out and of
#: the written K/V columns
STEP_REL_NORM = 2e-2
#: the value at which a trap column's key scores and its value sits
TRAP_KEY, TRAP_VALUE = 30.0, 100.0


def _step_inputs(torch, dev, cfg, t_cache, xa_int8, trap, seed, n_seq=1, beams=5):
    """Decode-step inputs of ``cfg`` at ``beams`` rows per window (n_seq
    windows, BK = beams·n_seq), the step at position t_cache // 2 with
    random beam ancestry inside each window's rows before it. With ``trap`` every cache column
    that no row's ``sel`` picks (the stale column at pos, the unwritten
    positions after it, the beams no row descends from) holds keys of
    ±TRAP_KEY and values of TRAP_VALUE — some score ~10× above the real
    keys — and so do the cross-KV pad columns 1500..1535 and, with several
    windows, every real cross-KV column of the odd windows. A kernel that
    reads a column sel excludes, double-counts the self column, reads a pad
    column or lets a row read another window's cross-KV moves the outputs
    far off."""
    from wis_tpu_torch.ops.fused_decode import quantize_xa_columns

    L, D, H = cfg.n_text_layer, cfg.n_text_state, cfg.n_text_head
    bk, s_audio = beams * n_seq, cfg.n_audio_ctx
    s_pad = ((s_audio + 127) // 128) * 128
    pos = t_cache // 2
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    rng = np.random.default_rng(seed)
    anc = rng.integers(0, beams, (bk, pos)) + (np.arange(bk) // beams * beams)[:, None]
    sel = np.zeros((bk, t_cache, bk), np.float32)
    for r in range(bk):
        sel[r, np.arange(pos), anc[r]] = 1.0
    sel = torch.from_numpy(sel.reshape(bk, t_cache * bk)).to(dev)
    kc = randn(L, D, bk * t_cache, scale=0.5)
    vc = randn(L, D, bk * t_cache, scale=0.5)
    xk = randn(L, H, D // H, n_seq * s_pad, scale=0.5)
    xv = randn(L, H, D // H, n_seq * s_pad, scale=0.5)
    col = torch.arange(n_seq * s_pad, device=dev)
    pad = (col % s_pad) >= s_audio
    xk[..., pad] = 0.0
    xv[..., pad] = 0.0
    if trap:
        excluded = sel.sum(dim=0) == 0
        kc[:, :, excluded] = TRAP_KEY * torch.sign(randn(L, D, int(excluded.sum())))
        vc[:, :, excluded] = TRAP_VALUE
        hot = pad | ((col // s_pad) % 2 == 1)
        xk[..., hot] = TRAP_KEY * torch.sign(randn(L, H, D // H, int(hot.sum())))
        xv[..., hot] = TRAP_VALUE
    kc, vc, xk, xv = (t.to(torch.bfloat16) for t in (kc, vc, xk, xv))
    xs = None
    if xa_int8:
        xk, xv, xs = quantize_xa_columns(xk, xv)
    x_emb = randn(bk, D, scale=0.5)
    return dict(x_emb=x_emb, k_cache=kc, v_cache=vc, xa_k=xk, xa_v=xv, sel=sel,
                pos=pos, s_audio=s_audio, xa_s=xs, n_seq=n_seq)


def _step_bound(inp, cfg):
    """The least time of one step: every int8 weight chunk, the scale and
    bias rows the step reads (11 of 14 per layer: the four W2 chunks share
    the deferred scale and bias of the last), every LayerNorm row, each
    window's real cross-KV columns (and their scales), the cache columns
    some row selects, the step's written columns, x in and out and sel,
    each moved once; the products and attention in bf16."""
    L, D, H = cfg.n_text_layer, cfg.n_text_state, cfg.n_text_head
    bk, s_audio, n_seq = inp["x_emb"].shape[0], inp["s_audio"], inp["n_seq"]
    xa_elem = inp["xa_k"].element_size()
    picked = int((inp["sel"].sum(dim=0) > 0).sum())
    n_bytes = (
        L * 14 * D * D + L * 11 * D * 4 * 2 + L * 6 * D * 4
        + 2 * L * D * s_audio * n_seq * xa_elem
        + (2 * L * 2 * H * s_audio * n_seq if inp["xa_s"] is not None else 0)
        + 2 * L * D * picked * 2 + 2 * L * D * bk * 2
        + 2 * bk * D * 4 + inp["sel"].numel() * 4
    )
    per_row_cols = int(inp["sel"][0].sum()) + 1
    ops = L * (2 * bk * 14 * D * D + 4 * bk * D * per_row_cols + 4 * bk * D * s_audio)
    return _bound(n_bytes, ops, BF16_FLOPS)


#: phase 4's fused-step cases at large-v2 (t_cache, int8 cross-KV, trap,
#: windows, beams): one window's five beams, and four windows (BK=20,
#: block-diagonal cross-attention, as long-form groups and coalesced
#: batches run it)
STEP_CASES = ((128, True, False, 1, 5), (128, True, True, 1, 5), (128, False, True, 1, 5),
              (256, True, False, 1, 5), (256, False, True, 1, 5), (256, True, False, 4, 5),
              (256, True, True, 4, 5))


def check_fused_step(torch, dev, cfg, packed, cases=STEP_CASES, timed=True):
    """The fused step against its plain version at ``cfg``'s full width, on
    each case's standard or trap inputs; the standard cases timed beside
    the plain version and the bound when ``timed`` → ({(t_cache, n_seq):
    row numbers}, the largest relative norm of any case's difference)."""
    from wis_tpu_torch.ops.fused_decode import fused_decode_step, fused_decode_step_plain

    rows, worst = {}, 0.0
    for t_cache, xa_int8, trap, n_seq, beams in cases:
        inp = _step_inputs(torch, dev, cfg, t_cache, xa_int8, trap, seed=t_cache + trap,
                           n_seq=n_seq, beams=beams)
        kc0, vc0 = inp["k_cache"], inp["v_cache"]
        args = dict(inp)
        run = {}
        for name, fn in (("kernel", fused_decode_step), ("plain", fused_decode_step_plain)):
            args["k_cache"], args["v_cache"] = kc0.clone(), vc0.clone()
            run[name] = fn(cfg, packed, **args)
        torch.cuda.synchronize()
        (xk, kk, vk), (xp, kp, vp) = run["kernel"], run["plain"]
        bk, pos = xk.shape[0], inp["pos"]
        cols = slice(pos * bk, (pos + 1) * bk)
        other = torch.ones(kc0.shape[-1], dtype=torch.bool, device=dev)
        other[cols] = False

        def rel(a, b):
            return float((a.float() - b.float()).norm() / b.float().norm())

        err = float((xk - xp).abs().max())
        rels = (rel(xk, xp), rel(kk[..., cols], kp[..., cols]), rel(vk[..., cols], vp[..., cols]))
        kept = torch.equal(kk[..., other], kc0[..., other]) and torch.equal(vk[..., other], vc0[..., other])
        case = (f"fused_decode_step L={cfg.n_text_layer} D={cfg.n_text_state} BK={bk} "
                f"n_seq={n_seq} t_cache={t_cache} "
                f"xa {'int8' if xa_int8 else 'bf16'}{' trap' if trap else ''}")
        print(f"{case}: x_out max|Δ| {err:.3e}, ‖Δ‖/‖plain‖ x_out {rels[0]:.3e}, "
              f"written K {rels[1]:.3e}, V {rels[2]:.3e} (tolerance {STEP_REL_NORM:.0e}); "
              f"other cache columns bit-identical: {kept}")
        if not (max(rels) <= STEP_REL_NORM and kept and bool(torch.isfinite(xk).all())):
            raise AssertionError(f"{case}: kernel disagrees with plain")
        worst = max(worst, *rels)
        if trap or not timed:
            continue
        args["k_cache"], args["v_cache"] = kc0.clone(), vc0.clone()
        ms = _median_ms(lambda: fused_decode_step(cfg, packed, **args))
        plain_ms = _median_ms(lambda: fused_decode_step_plain(cfg, packed, **args),
                              reps=2, replays=5)
        bound_ms, bound_by = _step_bound(inp, cfg)
        print(f"{case}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})")
        rows[(t_cache, n_seq)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return rows, worst


def lib_decode_step(torch, lib, check, cfg, packed, inp):
    """fn() → x_out: one step of ``lib``'s ``wis_fused_decode_step`` (this
    tree's library or another checkout's) on ``_step_inputs``, called as
    the wrapper calls it: x_emb copied into the step's buffer first, the
    caches written in place, the library's own workspace size."""
    L, D, H = cfg.n_text_layer, cfg.n_text_state, cfg.n_text_head
    dev, bk = inp["x_emb"].device, inp["x_emb"].shape[0]
    bkt, sx = inp["k_cache"].shape[-1], inp["xa_k"].shape[-1]
    ws = torch.empty(lib.wis_fused_decode_workspace_bytes(D, bk), dtype=torch.uint8, device=dev)
    x = torch.empty_like(inp["x_emb"])
    xs = inp["xa_s"]

    def fn():
        x.copy_(inp["x_emb"])
        check(lib.wis_fused_decode_step(
            packed.w.data_ptr(), packed.s.data_ptr(), packed.b.data_ptr(), packed.ln.data_ptr(),
            x.data_ptr(), inp["k_cache"].data_ptr(), inp["v_cache"].data_ptr(),
            inp["xa_k"].data_ptr(), inp["xa_v"].data_ptr(),
            xs.data_ptr() if xs is not None else None, inp["sel"].data_ptr(), inp["pos"],
            ws.data_ptr(), L, D, H, bk, bkt // bk, inp["n_seq"], sx // inp["n_seq"],
            inp["s_audio"], torch.cuda.current_stream(dev).cuda_stream), "fused_decode_step")
        return x

    return fn


#: fused head vs plain: |Δ| bound on the candidates' values and on lse.
#: Both compute f32 dots of the same bf16 operands in another order
#: (~1e-5 at these magnitudes), but the LayerNorm's statistics too, and an
#: LN output that lands on a bf16 rounding boundary rounds apart by one
#: ulp: 2⁻⁸·|xn|·|e| ≤ ~0.05 for one element at these N(0, 1) inputs.
HEAD_ATOL = 0.05


def check_fused_head(torch, dev, cfg, bk=5, k=6):
    """The fused head against its plain version at ``cfg``'s V and D, BK
    rows and k candidates, on a numpy-seeded N(0, 1) table; returns the
    largest value error. The table is drawn after x and the LN rows from
    seed 6; where the plain version's top-(k+1) gaps on those rows do not
    all clear twice the tolerance in both tables (narrow D packs the top
    logits closer) or row 0's tie below is not among its candidates in
    both tables, x and the LN rows are drawn again from seed 7, 8, ...
    until they do, so equal ids are a real check. Traps:
    each row's two largest raw logits are suppressed, and a duplicated
    embedding row makes row 0's best id tie with a lower id — the lower id
    must win."""
    from wis_tpu_torch.models.whisper.tokenizer import DEFAULT_SUPPRESS_TOKENS
    from wis_tpu_torch.ops.fused_logits import fused_logits_topk, fused_logits_topk_plain
    from wis_tpu_torch.ops.quant import quantize_rows

    V, D = cfg.n_vocab, cfg.n_text_state

    def host(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    def rows(rng):
        x = host(rng.standard_normal((bk, D)) * 2 + 0.3)
        ln_g = host(1 + 0.1 * rng.standard_normal(D))
        ln_b = host(0.1 * rng.standard_normal(D))
        return x, ln_g, ln_b

    def inputs(x, ln_g, ln_b, emb):
        emb = emb.clone()
        sup = torch.zeros(V, device=dev)
        sup[list(DEFAULT_SUPPRESS_TOKENS)] = -1e30
        raw = fused_logits_topk_plain(x, ln_g, ln_b, emb, torch.zeros_like(sup), k=2)[1]
        sup[raw.flatten()] = -1e30  # trap: the largest raw logits are suppressed
        best = fused_logits_topk_plain(x, ln_g, ln_b, emb, sup, k=1)[1][0, 0]
        low = int(best) // 2
        while float(sup[low]) != 0.0:  # an id neither suppressed nor trapped
            low -= 1
        emb[low] = emb[best]  # trap: row 0's best id now ties with a lower id
        margins, tied = {}, True
        for int8 in (False, True):
            table = quantize_rows(emb) if int8 else emb
            for full in (False, True):
                top, ids = fused_logits_topk_plain(x, ln_g, ln_b, table, sup, k=k + 1,
                                                   full_lse=full)[:2]
                gaps = (top[:, :-1] - top[:, 1:]).flatten()
                gaps = gaps[gaps > 0]  # the tie trap's zero gap is no decision
                margins[(int8, full)] = float(gaps.min()) if gaps.numel() else float("inf")
                # the tie is among row 0's candidates in this table too
                tied = tied and low in ids[0, :k].tolist()
        return emb, sup, raw, int(best), low, margins, tied

    rng = np.random.default_rng(6)
    x, ln_g, ln_b = rows(rng)
    emb0 = host(rng.standard_normal((V, D), dtype=np.float32)).to(torch.bfloat16)
    for seed in range(6, 1006):
        if seed > 6:
            x, ln_g, ln_b = rows(np.random.default_rng(seed))
        emb, sup, raw, best, low, margins, tied = inputs(x, ln_g, ln_b, emb0)
        if min(margins.values()) > 2 * HEAD_ATOL and tied:
            break
    else:
        raise AssertionError(f"fused_logits_topk V={V} D={D} BK={bk}: no rows from seeds "
                             f"6..1005 whose decisions clear twice the tolerance with the tie")
    worst = 0.0
    for int8 in (False, True):
        table = quantize_rows(emb) if int8 else emb
        for full in (False, True):
            want = fused_logits_topk_plain(x, ln_g, ln_b, table, sup, k=k, full_lse=full)
            got = fused_logits_topk(x, ln_g, ln_b, table, sup, k=k, full_lse=full)
            torch.cuda.synchronize()
            margin = margins[(int8, full)]
            ids_equal = torch.equal(got[1], want[1])
            err = float((got[0] - want[0]).abs().max())
            lse_err = float((got[2] - want[2]).abs().max())
            # row 0: low, then best right after it unless k ends between them
            row = got[1][0].tolist()
            i = row.index(low) if low in row else -1
            tie = i >= 0 and best not in row[:i] and (i == k - 1 or row[i + 1] == best)
            hidden = not bool(torch.isin(got[1], raw.reshape(-1)).any())
            case = (f"fused_logits_topk V={V} D={D} BK={bk} k={k} emb "
                    f"{'int8' if int8 else 'bf16'} full_lse={full}")
            print(f"{case}: ids equal {ids_equal}, values max|Δ| {err:.3e}, lse max|Δ| "
                  f"{lse_err:.3e} (tolerance {HEAD_ATOL}); smallest non-tie gap {margin:.3e} "
                  f"(seed {seed}); tie to the lower id {tie}; suppressed ids kept out {hidden}")
            if not (ids_equal and err <= HEAD_ATOL and lse_err <= HEAD_ATOL and tie and hidden):
                raise AssertionError(f"{case}: kernel disagrees with plain")
            worst = max(worst, err)
    return worst


#: the logits head's timed cases (BK, int8 table, grammar mode) at k 6:
#: one window's five beams, and the four windows × five beams of the 180 s
#: long-form groups and the coalesced batch of four
HEAD_CASES = tuple((bk, int8, gr) for bk in (5, 20) for int8 in (True, False)
                   for gr in (False, True))
HEAD_K = 6


def head_case(torch, dev, cfg, bk, int8, grammar):
    """One timed head call at large-v2's shapes: {"args": (x, g, b, table,
    sup), "kw": wrapper keywords, "exact": the logits are exact (grammar
    mode, grammar_head_case's inputs), "name"}."""
    from wis_tpu_torch.models.whisper.tokenizer import EOT, layout_for_vocab
    from wis_tpu_torch.ops.quant import quantize_rows

    V, D = cfg.n_vocab, cfg.n_text_state
    kw = dict(k=HEAD_K)
    if grammar:
        ts_base = layout_for_vocab(V).timestamp_base
        x, g, b, emb, sup, ts = (torch.from_numpy(a).to(dev) for a in
                                 grammar_head_case(bk, D, V, ts_base, EOT, seed=bk))
        kw.update(ts_state=ts, ts_base=ts_base, eot=EOT)
    else:
        gen = torch.Generator(device=dev).manual_seed(bk)
        x = torch.randn((bk, D), generator=gen, device=dev) * 2 + 0.3
        g = 1 + 0.1 * torch.randn(D, generator=gen, device=dev)
        b = 0.1 * torch.randn(D, generator=gen, device=dev)
        emb = torch.randn((V, D), generator=gen, device=dev)
        sup = torch.zeros(V, device=dev)
    emb = emb.to(torch.bfloat16)
    table = quantize_rows(emb) if int8 else emb
    name = (f"fused_logits_topk{'(grammar)' if grammar else ''} V={V} BK={bk} k={HEAD_K} emb "
            f"{'int8' if int8 else 'bf16'}")
    return dict(args=(x, g, b, table, sup), kw=kw, exact=grammar, name=name)


def head_bound(cfg, bk, int8, grammar):
    """(ms, "bytes" or "operations") of one head call: the table (and its
    row scales), sup, x, the LN rows and ts_state read once, the candidates
    and lse written once; 2·BK·V·D operations at the bf16 peak."""
    V, D = cfg.n_vocab, cfg.n_text_state
    n_bytes = (V * D * (1 if int8 else 2) + (V * 4 if int8 else 0) + V * 4 + bk * D * 4
               + 2 * D * 4 + (bk * 16 if grammar else 0) + bk * (HEAD_K * 12 + 4))
    return _bound(n_bytes, 2 * bk * V * D, BF16_FLOPS)


def head_agrees(got, want, exact):
    """A head's result against the plain version's: on exact inputs ids and
    values equal and lse within 1e-5 relative; else values and lse within
    HEAD_ATOL (random tables hold near-ties, so ids are not compared)."""
    import torch

    if exact:
        lse_rel = float(((got[2] - want[2]).abs() / want[2].abs().clamp_min(1.0)).max())
        return torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]) and lse_rel <= 1e-5
    return (float((got[0] - want[0]).abs().max()) <= HEAD_ATOL
            and float((got[2] - want[2]).abs().max()) <= HEAD_ATOL)


def time_heads(torch, dev, cfg):
    """The head at every HEAD_CASES case through its wrapper, held to the
    plain version (``head_agrees``), then timed beside the plain version
    and its bound → {(bk, int8, grammar): row numbers}."""
    from wis_tpu_torch.ops.fused_logits import fused_logits_topk, fused_logits_topk_plain

    out = {}
    for bk, int8, grammar in HEAD_CASES:
        case = head_case(torch, dev, cfg, bk, int8, grammar)
        args, kw = case["args"], case["kw"]
        got = fused_logits_topk(*args, **kw)
        want = fused_logits_topk_plain(*args, **kw)
        if not head_agrees(got, want, case["exact"]):
            raise AssertionError(f"{case['name']}: kernel disagrees with plain")
        err = float((got[0] - want[0]).abs().max())
        ms = _median_ms(lambda: fused_logits_topk(*args, **kw))
        plain_ms = _median_ms(lambda: fused_logits_topk_plain(*args, **kw), reps=5, replays=5)
        bound_ms, bound_by = head_bound(cfg, bk, int8, grammar)
        print(f"{case['name']}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); kernel/bound {ms / bound_ms:.2f}")
        out[(bk, int8, grammar)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return out


def lib_logits_head(torch, lib, check, case):
    """fn() → (val, tok, lse): one call of ``lib``'s ``wis_fused_logits_topk``
    (this tree's library or another checkout's) on ``head_case``'s inputs,
    as the wrapper calls it, with the library's own workspace size. A
    library whose C function takes the split counter (20 arguments) gets
    the wrapper's; an older one (19) is called without it."""
    from wis_tpu_torch.ops.quant import _split_counters

    x, g, b, table, sup = case["args"]
    kw = case["kw"]
    dev, (bk, d) = x.device, x.shape
    int8 = isinstance(table, dict)
    q, s = (table["q"], table["s"]) if int8 else (table, None)
    v, k, ts = q.shape[0], kw["k"], kw.get("ts_state")
    ln = torch.stack([g, b]).float()
    ws = torch.empty(lib.wis_fused_logits_workspace_bytes(bk, v, k, int(ts is not None)),
                     dtype=torch.uint8, device=dev)
    val = torch.empty((bk, k), dtype=torch.float32, device=dev)
    tok = torch.empty((bk, k), dtype=torch.int64, device=dev)
    lse = torch.empty((bk, 1), dtype=torch.float32, device=dev)
    sem = (_split_counters(dev, 1).data_ptr(),) if len(lib.wis_fused_logits_topk.argtypes) == 20 else ()

    def fn():
        check(lib.wis_fused_logits_topk(
            x.data_ptr(), ln.data_ptr(), q.data_ptr(), s.data_ptr() if int8 else None,
            sup.data_ptr(), ts.data_ptr() if ts is not None else None, bk, d, v, k,
            int(kw.get("full_lse", False)), int(int8), int(kw.get("ts_base", 0)),
            int(kw.get("eot", 0)), ws.data_ptr(), val.data_ptr(), tok.data_ptr(),
            lse.data_ptr(), torch.cuda.current_stream(dev).cuda_stream, *sem),
            "fused_logits_topk")
        return val, tok, lse

    return fn


def gpt_head_case(torch, dev, cfg, head_packed=None):
    """The XTTS head's timed call at the model's width with the production
    knobs (sampled): (x, ln4, head_w, head_b, hist, gum, knobs). Without
    ``head_packed`` a random head of the model's shape."""
    from wis_tpu_torch.ops.fused_gpt_head import v_padded

    D, vp = cfg.d_model, v_padded(cfg.n_audio_vocab)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((1, D), generator=gen, device=dev) * 2 + 0.3
    ln4 = torch.cat([1 + 0.1 * torch.randn((1, D), generator=gen, device=dev),
                     0.1 * torch.randn((1, D), generator=gen, device=dev)] * 2)
    if head_packed is None:
        head_w = torch.randn((D, vp), generator=gen, device=dev) * D ** -0.5
        head_w[:, cfg.n_audio_vocab:] = 0
        head_w, head_b = head_w.to(torch.bfloat16), torch.zeros((1, vp), device=dev)
    else:
        head_w, head_b = head_packed[1], head_packed[2]
    hist = torch.zeros((1, vp), device=dev)
    hist[0, :40] = 1.0
    u = torch.rand((1, vp), generator=gen, device=dev).clamp_min(1e-6)
    gum = -torch.log(-torch.log(u))
    knobs = torch.tensor([[0.1, 50, 0.8, 7.0, 0.0, 1.0, 0.0, 0.0]], device=dev)
    return x, ln4, head_w, head_b, hist, gum, knobs


def lib_gpt_head(torch, lib, check, cfg, inputs):
    """fn() → (tok, hidden, logits): one call of ``lib``'s
    ``wis_fused_gpt_head`` on ``gpt_head_case``'s inputs, as the wrapper
    calls it."""
    x, ln4, head_w, head_b, hist, gum, knobs = inputs
    dev, d, vp = x.device, cfg.d_model, head_w.shape[-1]
    tok = torch.empty((1, 1), dtype=torch.int32, device=dev)
    hidden = torch.empty((1, d), dtype=torch.float32, device=dev)
    logits = torch.empty((1, vp), dtype=torch.float32, device=dev)
    raw = torch.empty((1, vp), dtype=torch.float32, device=dev)

    def fn():
        check(lib.wis_fused_gpt_head(
            x.data_ptr(), ln4.data_ptr(), head_w.data_ptr(), head_b.data_ptr(), hist.data_ptr(),
            gum.data_ptr(), knobs.data_ptr(), tok.data_ptr(), hidden.data_ptr(),
            logits.data_ptr(), raw.data_ptr(), d, cfg.n_audio_vocab, vp, cfg.stop_audio_token,
            torch.cuda.current_stream(dev).cuda_stream), "fused_gpt_head")
        return tok, hidden, logits

    return fn


#: int8_matmul shapes (M, K, N): one window's cross-KV projection and a
#: four-window group's, a decode step's MLP products at 5 and 15 rows, the
#: XTTS prefill's first MLP product
INT8_SHAPES = ((1500, 1280, 1280), (6000, 1280, 1280), (5, 1280, 5120), (5, 5120, 1280),
               (15, 1280, 5120), (15, 5120, 1280), (289, 1024, 4096))


def int8_case(torch, dev, m, k, n, out_dtype=None):
    """int8_matmul against its plain version at (M, K, N) on bf16 x. With a
    bf16 output each element within 2 bf16 ulps plus 2⁻⁸·max|plain| (the
    flash rule: f32 sums of the same bf16 products in another order, each
    side rounded once to bf16); with ``out_dtype`` f32 (the f32 store a
    row-parallel product's partial sums take) within 1e-5·max|plain|, the
    two differing only by the order of the f32 sums. → (x, q, s, max|Δ|);
    raises past it."""
    from wis_tpu_torch.ops.quant import int8_matmul, int8_matmul_plain, quantize_weight

    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32) * 0.05).to(dev)
    leaf = quantize_weight(w)
    q, sc = leaf["q"], leaf["s"]
    got = int8_matmul(x, q, sc, out_dtype)
    want = int8_matmul_plain(x, q, sc, out_dtype)
    torch.cuda.synchronize()
    r = want.float()
    d = (got.float() - r).abs()
    f32 = out_dtype == torch.float32
    if f32:
        bad = int((d > 1e-5 * float(r.abs().max())).sum())
        rule = "1e-5·max|plain|"
    else:
        bad = int((d > 2 * _bf16_ulp(r) + 2.0 ** -8 * float(r.abs().max())).sum())
        rule = "2 bf16 ulps + 2^-8·max|plain|"
    store = "f32" if f32 else "bf16"
    print(f"int8_matmul M={m} K={k} N={n} {store} store: max|Δ| {float(d.max()):.3e} "
          f"({bad} elements over {rule})")
    if bad or got.dtype != want.dtype or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"int8_matmul M={m} K={k} N={n} {store} store: kernel "
                             f"disagrees with plain")
    return x, q, sc, float(d.max())


def check_int8_matmul(torch, dev):
    """int8_matmul against its plain version at the main path's shapes,
    each element within 2 bf16 ulps plus 2⁻⁸·max|plain| (the flash rule:
    f32 sums of the same bf16 products in another order, each side rounded
    once to bf16); timed beside the plain version and ``torch.mm`` on a
    weight dequantized to bf16 beforehand (the library yardstick: it reads
    twice the weight bytes and rounds the effective weight)."""
    from wis_tpu_torch.ops.quant import int8_matmul, int8_matmul_plain

    rows = {}
    for m, k, n in INT8_SHAPES:
        x, q, sc, err = int8_case(torch, dev, m, k, n)
        ms = _median_ms(lambda: int8_matmul(x, q, sc))
        plain_ms = _median_ms(lambda: int8_matmul_plain(x, q, sc), reps=5, replays=5)
        wb = q.to(torch.bfloat16) * sc.to(torch.bfloat16)
        library_ms = _median_ms(lambda: torch.mm(x, wb))
        bound_ms, bound_by = _bound(m * k * 2 + k * n + n * 4 + m * n * 2, 2 * m * k * n,
                                    BF16_FLOPS)
        print(f"int8_matmul M={m} K={k} N={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.mm on a bf16 weight {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        rows[(m, k, n)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    return rows


def _parent_library(parent):
    """The kernel library of another checkout of this repo (its own
    ``_build``, so its own sources, built into its own ``build/``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "parent_wis_build", os.path.join(parent, "wis_tpu_torch", "ops", "_build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    lib = mod.kernels()
    print(f"parent kernels from {parent} built/loaded in {time.perf_counter() - t0:.2f} s")
    return lib, mod.check


def compare_with_parent(torch, dev, parent):
    """Rows 6, 1, 2, 3 and 9 against the parent checkout's kernels on the
    same inputs, timed in turns parent / change / change / parent at every
    int8_matmul shape, the encoder's LayerNorm (beside ``F.layer_norm``),
    every packed and head-major flash shape and the first two
    ``ANC_CASES``; each side's output held to its plain version first.
    Returns {shape: times}."""
    from wis_tpu_torch.ops.flash import (
        flash_attention,
        flash_attention_packed,
        flash_attention_packed_plain,
        flash_attention_plain,
    )
    from wis_tpu_torch.ops.quant import int8_matmul, int8_matmul_plain, quantize_weight

    lib, check = _parent_library(parent)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}

    def turns(name, parent_fn, change_fn, want):
        for label, fn in (("parent", parent_fn), ("change", change_fn)):
            got = fn()
            torch.cuda.synchronize()
            r = want.float()
            d = (got.float() - r).abs()
            bad = int((d > 2 * _bf16_ulp(r) + 2.0 ** -8 * float(r.abs().max())).sum())
            if bad or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name}: the {label} kernel disagrees with plain")
        t = [_median_ms(f) for f in (parent_fn, change_fn, change_fn, parent_fn)]
        slower = min(t[1], t[2]) / min(t[0], t[3]) - 1
        print(f"{name}: parent {t[0]:.4f}, change {t[1]:.4f}, change {t[2]:.4f}, parent "
              f"{t[3]:.4f} ms; change/parent {min(t[1], t[2]) / min(t[0], t[3]):.3f}"
              + (" — SLOWER than the parent by more than 5%" if slower > 0.05 else ""))
        out[name] = t

    for m, k, n in INT8_SHAPES:
        rng = np.random.default_rng(m + k + n)
        x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(dev, torch.bfloat16)
        leaf = quantize_weight(torch.from_numpy(
            rng.standard_normal((k, n), dtype=np.float32) * 0.05).to(dev))
        q, sc = leaf["q"], leaf["s"]
        splits = lib.wis_int8_matmul_splits(m, k, n, sms)
        part = torch.empty(max(splits, 1) * m * n, dtype=torch.float32, device=dev)
        y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
        # a parent with split counters (12 arguments) takes them after part
        sem = (torch.zeros(lib.wis_int8_matmul_counters(n), dtype=torch.int32, device=dev)
               if len(lib.wis_int8_matmul.argtypes) == 12 else None)

        def parent_fn(x=x, q=q, sc=sc, y=y, part=part, sem=sem, splits=splits, m=m, k=k, n=n):
            ptrs = (part.data_ptr(),) + (() if sem is None else (sem.data_ptr(),))
            check(lib.wis_int8_matmul(x.data_ptr(), q.data_ptr(), sc.data_ptr(), y.data_ptr(),
                                      *ptrs, m, k, n, splits, 0, stream()), "parent int8_matmul")
            return y

        turns(f"int8_matmul M={m} K={k} N={n}", parent_fn,
              lambda x=x, q=q, sc=sc: int8_matmul(x, q, sc), int8_matmul_plain(x, q, sc))
        if (m, k, n) == (5, 1280, 5120):
            # host time per call: this tree's C call encodes two tensor maps
            # before it launches, the parent's launches at once
            mine = _build_lib()
            msplits = mine.wis_int8_matmul_splits(m, k, n, sms)
            mpart = torch.empty(msplits * m * n, dtype=torch.float32, device=dev)
            msem = torch.zeros(mine.wis_int8_matmul_counters(n), dtype=torch.int32, device=dev)

            def bare():
                return mine.wis_int8_matmul(x.data_ptr(), q.data_ptr(), sc.data_ptr(),
                                            y.data_ptr(), mpart.data_ptr(), msem.data_ptr(),
                                            m, k, n, msplits, 0, stream())

            host = {name: _host_us(torch, fn) for name, fn in (
                ("parent C call", parent_fn), ("C call", bare),
                ("int8_matmul wrapper", lambda: int8_matmul(x, q, sc)))}
            print("int8_matmul M=5 K=1280 N=5120 host time per call: " + ", ".join(
                f"{name} {us:.2f} µs" for name, us in host.items()))

    def parent_flash(fn, q, k, v, o, *dims):
        # the parent's C functions may predate the warpgroups argument
        extra = (0,) if len(fn.argtypes) == 11 else ()
        check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *dims, *extra,
                 stream()), "parent flash")
        return o

    from wis_tpu_torch.ops.layernorm import layer_norm_cuda, layer_norm_plain

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 1500, 1280), dtype=np.float32) * 3 + 0.5)
    x = x.to(dev, torch.bfloat16)
    g = torch.from_numpy(1 + 0.1 * rng.standard_normal(1280, dtype=np.float32)).to(dev)
    b = torch.from_numpy(0.1 * rng.standard_normal(1280, dtype=np.float32)).to(dev)
    y = torch.empty_like(x)

    def parent_ln():
        check(lib.wis_layer_norm(x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), 1500,
                                 1280, 1e-5, 1, stream()), "parent layer_norm")
        return y

    turns("layer_norm (1,1500,1280) bf16", parent_ln, lambda: layer_norm_cuda(x, g, b),
          layer_norm_plain(x, g, b))
    gb, bb = g.to(torch.bfloat16), b.to(torch.bfloat16)  # F.layer_norm's affine in x's dtype
    lib_ms = _median_ms(lambda: torch.nn.functional.layer_norm(x, (1280,), gb, bb))
    print(f"layer_norm (1,1500,1280) bf16: F.layer_norm {lib_ms:.4f} ms; change/F.layer_norm "
          f"{min(out['layer_norm (1,1500,1280) bf16'][1:3]) / lib_ms:.3f}")
    for heads in (20, 10):
        q, k, v = _flash_inputs(torch, dev, heads, False, 2 + heads)
        o = torch.empty_like(q)
        turns(f"flash_attention_packed (1,1500,1280) H={heads}",
              lambda q=q, k=k, v=v, o=o, h=heads: parent_flash(
                  lib.wis_flash_attention_packed, q, k, v, o, 1, 1500, 1280, h,
                  float((1280 // h) ** -0.5)),
              lambda q=q, k=k, v=v, h=heads: flash_attention_packed(q, k, v, h),
              flash_attention_packed_plain(q, k, v, heads))
    for b, h, t, dh in HEAD_MAJOR_CASES:
        q, k, v = _head_major_inputs(torch, dev, b, h, t, dh, False, seed=h + dh)
        o = torch.empty_like(q)
        turns(f"flash_attention ({b},{h},{t},{dh})",
              lambda q=q, k=k, v=v, o=o, b=b, h=h, t=t, dh=dh: parent_flash(
                  lib.wis_flash_attention, q, k, v, o, b, h, t, dh, float(dh ** -0.5)),
              lambda q=q, k=k, v=v: flash_attention(q, k, v), flash_attention_plain(q, k, v))
    from wis_tpu_torch.ops.decode_attn import ancestry_attention, ancestry_attention_plain

    for bk, t, pos, beams in ANC_CASES[:2]:
        q, kc, vc, anc = _anc_inputs(torch, dev, bk, t, pos, False, seed=bk + t, beams=beams)
        o = torch.empty_like(q)

        def parent_anc(q=q, kc=kc, vc=vc, anc=anc, o=o, bk=bk, t=t, pos=pos):
            check(lib.wis_ancestry_attention(q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                                             anc.data_ptr(), bk, 20, 64, t, pos, 64 ** -0.5,
                                             o.data_ptr(), stream()), "parent ancestry_attention")
            return o

        turns(f"ancestry_attention BK={bk} H=20 Dh=64 T={t} pos={pos}", parent_anc,
              lambda q=q, kc=kc, vc=vc, anc=anc, pos=pos: ancestry_attention(q, kc, vc, anc, pos),
              ancestry_attention_plain(q, kc, vc, anc, pos))
    return out


def _turns_rel(torch, name, parent_fn, change_fn, want, tol):
    """Both sides held to the plain result ``want`` in relative norm (and
    finite), then timed parent / change / change / parent."""
    def agrees(got):
        err = float((got.float() - want.float()).norm() / want.float().norm())
        return err <= tol and bool(torch.isfinite(got).all())

    return _turns_by(torch, name, parent_fn, change_fn, agrees)


def _turns_by(torch, name, parent_fn, change_fn, agrees, reps=5, replays=7):
    """Both sides' results held by ``agrees`` (to their plain version),
    then timed parent / change / change / parent."""
    for label, fn in (("parent", parent_fn), ("change", change_fn)):
        got = fn()
        torch.cuda.synchronize()
        if not agrees(got):
            raise AssertionError(f"{name}: the {label} kernel disagrees with plain")
    t = [_median_ms(f, reps=reps, replays=replays)
         for f in (parent_fn, change_fn, change_fn, parent_fn)]
    ratio = min(t[1], t[2]) / min(t[0], t[3])
    print(f"{name}: parent {t[0]:.4f}, change {t[1]:.4f}, change {t[2]:.4f}, parent "
          f"{t[3]:.4f} ms; change/parent {ratio:.3f}"
          + (" — SLOWER than the parent by more than 5%" if ratio > 1.05 else ""))
    return t


def compare_steps_with_parent(torch, dev, parent, cfg, packed):
    """Row 4 against the parent checkout's step at every non-trap case of
    ``check_fused_step``, both sides through their C functions with their
    own workspace sizes, each held to the plain step first."""
    from wis_tpu_torch.ops.fused_decode import fused_decode_step_plain

    lib, check = _parent_library(parent)
    mine = _build_lib()
    from wis_tpu_torch.ops import _build

    out = {}
    for t_cache, n_seq in ((128, 1), (256, 1), (256, 4)):
        inp = _step_inputs(torch, dev, cfg, t_cache, True, False, seed=t_cache, n_seq=n_seq)
        want = fused_decode_step_plain(cfg, packed, **dict(
            inp, k_cache=inp["k_cache"].clone(), v_cache=inp["v_cache"].clone()))[0]
        bk = inp["x_emb"].shape[0]
        name = f"fused_decode_step BK={bk} n_seq={n_seq} t_cache={t_cache} xa int8"
        out[(t_cache, n_seq)] = _turns_rel(
            torch, name, lib_decode_step(torch, lib, check, cfg, packed, inp),
            lib_decode_step(torch, mine, _build.check, cfg, packed, inp), want, STEP_REL_NORM)
    return out


def compare_heads_with_parent(torch, dev, parent, cfg):
    """Row 5 against the parent checkout's head at every ``HEAD_CASES``
    case, both sides through their C functions (``lib_logits_head``), each
    held to the plain version first (``head_agrees``)."""
    from wis_tpu_torch.ops import _build
    from wis_tpu_torch.ops.fused_logits import fused_logits_topk_plain

    lib, check = _parent_library(parent)
    mine = _build_lib()
    out = {}
    for bk, int8, grammar in HEAD_CASES:
        case = head_case(torch, dev, cfg, bk, int8, grammar)
        want = fused_logits_topk_plain(*case["args"], **case["kw"])
        out[(bk, int8, grammar)] = _turns_by(
            torch, case["name"], lib_logits_head(torch, lib, check, case),
            lib_logits_head(torch, mine, _build.check, case),
            lambda got: head_agrees(got, want, case["exact"]), reps=20, replays=15)
    return out


def compare_gpt_head_with_parent(torch, dev, parent, cfg, head_packed):
    """Row 8 against the parent checkout's head on the model's head with
    the production knobs (``gpt_head_case``): each side's token and kept
    set equal to the plain version's, its kept values within
    GPT_HEAD_REL."""
    from wis_tpu_torch.ops import _build
    from wis_tpu_torch.ops.fused_gpt_head import fused_gpt_head_plain

    lib, check = _parent_library(parent)
    inputs = gpt_head_case(torch, dev, cfg, head_packed)
    tp, _, lp = fused_gpt_head_plain(*inputs, cfg=cfg)
    kept = lp > -1e29

    def agrees(got):
        return (int(got[0]) == int(tp) and torch.equal(got[2] > -1e29, kept)
                and bool((got[2][kept] - lp[kept]).abs().le(
                    GPT_HEAD_REL * lp[kept].abs() + 1e-6).all()))

    name = f"fused_gpt_head D={cfg.d_model} V_pad={inputs[2].shape[-1]} production knobs"
    return _turns_by(torch, name, lib_gpt_head(torch, lib, check, cfg, inputs),
                     lib_gpt_head(torch, _build_lib(), _build.check, cfg, inputs), agrees,
                     reps=20, replays=15)


def compare_gpt_steps_with_parent(torch, dev, parent, cfg, packed, t_full):
    """Row 7 against the parent checkout's GPT step at the three non-trap
    cases of ``check_fused_gpt_step``, as ``compare_steps_with_parent``."""
    from wis_tpu_torch.ops import _build
    from wis_tpu_torch.ops.fused_gpt import fused_gpt_step_plain

    lib, check = _parent_library(parent)
    mine = _build_lib()
    out = {}
    for t_pad in (256, 512, t_full):
        inp = _gpt_step_inputs(torch, dev, cfg, t_pad, False, seed=t_pad)
        want = fused_gpt_step_plain(cfg, packed, **dict(
            inp, k_cache=inp["k_cache"].clone(), v_cache=inp["v_cache"].clone()))[0]
        name = f"fused_gpt_step L={cfg.n_layer} D={cfg.d_model} t_pad={t_pad} pos={inp['pos']}"
        out[t_pad] = _turns_rel(
            torch, name, lib_gpt_step(torch, lib, check, cfg, packed, inp),
            lib_gpt_step(torch, mine, _build.check, cfg, packed, inp), want, STEP_REL_NORM)
    return out


def _build_lib():
    from wis_tpu_torch.ops import _build

    return _build.kernels()


def _host_us(torch, fn, calls=200):
    """Host microseconds per fn() call: `calls` calls queued behind a spin
    kernel of ~50 ms, so the card is never what the host waits for; the
    median of five rounds."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(5):
        torch.cuda._sleep(100_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        rounds.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(rounds)


def print_ptxas(names=("int8_matmul_kernel", "flash_wgmma_kernel", "int8_product_kernel",
                       "self_attention_kernel", "cross_attention_kernel", "layer_norm_kernel",
                       "logits_topk_kernel", "gpt_head_kernel", "ancestry_attention_kernel")):
    """Registers and spills of the kernels named, one line per instance,
    from the build's -Xptxas -v output."""
    from wis_tpu_torch.ops import _build

    for log in sorted(_build.library_path().parent.glob("*.ptxas.txt")):
        fn, spill = None, ""
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = next((n for n in names if n in m.group(1)), None)
                if fn:
                    tail = m.group(1).split(fn, 1)[1]
                    fn = fn + (re.sub(r"E+v.*$", "", tail).replace("I", "<", 1) + ">"
                               if tail.startswith("I") else "")
            elif "warning" in line and "wgmma" in line:
                print(f"ptxas {log.name.split('.')[0]}: {line.strip()}")
            elif fn and "spill" in line:
                spill = line.strip()
            elif fn and "Used" in line:
                regs = re.search(r"Used (\d+) registers", line)
                print(f"ptxas {log.name.split('.')[0]} {fn}: {regs.group(1) if regs else '?'} "
                      f"registers; {spill}")
                fn = None


#: ancestry_attention cases (BK, T, pos, beams per group): one window's
#: beams and four windows', early and late in a cache (the two timed
#: beside the parent's kernel), eight windows (beyond the fused step's 32
#: rows), a map across all 40 rows, and T % 8 != 0 read to its last column
ANC_CASES = ((5, 128, 64, 5), (20, 256, 200, 5), (40, 256, 200, 5), (40, 256, 200, 40),
             (5, 100, 99, 5))


def _anc_inputs(torch, dev, bk, t, pos, trap, seed, beams=5, heads=20):
    """Large-v2 self-attention shapes (H=20 or ``heads``, Dh=64) with an ancestry map
    scrambled inside each group of ``beams`` rows up to pos and -1 after;
    with ``trap`` the cache columns past pos hold keys of ±1e4 and values
    of 1e4, which a kernel reading them cannot hide."""
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(dev)

    q = randn(bk, heads, 64).to(torch.bfloat16)
    kc, vc = randn(bk, heads, 64, t, scale=0.5), randn(bk, heads, 64, t)
    if trap:
        kc[..., pos + 1:] = 1e4 * torch.sign(kc[..., pos + 1:])
        vc[..., pos + 1:] = 1e4
    anc = np.full((bk, t), -1, np.int32)
    anc[:, : pos + 1] = (rng.integers(0, beams, (bk, pos + 1))
                         + (np.arange(bk) // beams * beams)[:, None])
    return q, kc.to(torch.bfloat16), vc.to(torch.bfloat16), torch.from_numpy(anc).to(dev)


def check_ancestry_attention(torch, dev):
    """ancestry_attention against its plain version at every ANC_CASES
    case (the flash rule: each element within 2 bf16 ulps plus
    2⁻⁸·max|plain|; both take f32 scores, softmax and sums in another
    order and round once), on standard and trap inputs, two calls giving
    the same bits; timed at the standard ones. No single PyTorch call
    computes it (the rows must be gathered first). Returns {(BK, T, pos,
    beams): row}."""
    from wis_tpu_torch.ops.decode_attn import ancestry_attention, ancestry_attention_plain

    rows = {}
    for bk, t, pos, beams in ANC_CASES:
        for trap in (False, True):
            q, kc, vc, anc = _anc_inputs(torch, dev, bk, t, pos, trap, seed=bk + t + trap,
                                         beams=beams)
            got = ancestry_attention(q, kc, vc, anc, pos)
            again = ancestry_attention(q, kc, vc, anc, pos)
            want = ancestry_attention_plain(q, kc, vc, anc, pos)
            torch.cuda.synchronize()
            r = want.float()
            d = (got.float() - r).abs()
            bad = int((d > 2 * _bf16_ulp(r) + 2.0 ** -8 * float(r.abs().max())).sum())
            err = float(d.max())
            same = torch.equal(got, again)
            case = (f"ancestry_attention BK={bk} H=20 Dh=64 T={t} pos={pos} groups of "
                    f"{beams}{' trap' if trap else ''}")
            print(f"{case}: max|Δ| {err:.3e}, max|plain| {float(want.float().abs().max()):.3e} "
                  f"({bad} elements over 2 bf16 ulps + 2^-8·max|plain|); two calls equal {same}")
            if bad or not same or not float(got.float().abs().max()) < 100:
                raise AssertionError(f"{case}: kernel disagrees with plain or with itself")
            if trap:
                continue
            ms = _median_ms(lambda: ancestry_attention(q, kc, vc, anc, pos))
            plain_ms = _median_ms(lambda: ancestry_attention_plain(q, kc, vc, anc, pos),
                                  reps=5, replays=5)
            n = pos + 1
            bound_ms, bound_by = _bound(2 * bk * 20 * 64 * n * 2 + bk * n * 4 + 2 * bk * 20 * 64 * 2,
                                        4 * bk * 20 * 64 * n, F32_FLOPS)
            print(f"{case}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by})")
            rows[(bk, t, pos, beams)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                             bound_ms=bound_ms, bound_by=bound_by,
                                             library_ms=None)
    return rows


def check_grammar_head(torch, dev, cfg, cases=((5, 6), (20, 6)), int8s=(True, False)):
    """The fused head's grammar mode against its plain version at ``cfg``'s
    V and D, at each (BK, k) of ``cases``, on grammar_head_case's exact
    inputs: ids and candidate values equal, lse within 1e-5 relative (f32
    sums in another order), and every grammar decision held — so a kernel
    that ignores a mask, lets a masked region add to the timestamp sum, or
    breaks the tie or the min_ts floor the wrong way fails. Returns the
    largest value error (0 here)."""
    from wis_tpu_torch.models.whisper.tokenizer import EOT, layout_for_vocab
    from wis_tpu_torch.ops.fused_logits import fused_logits_topk, fused_logits_topk_plain
    from wis_tpu_torch.ops.quant import quantize_rows

    V, D = cfg.n_vocab, cfg.n_text_state
    ts_base = layout_for_vocab(V).timestamp_base
    for bk, k in cases:
        x, g, b, emb, sup, ts = (torch.from_numpy(a).to(dev) for a in
                                 grammar_head_case(bk, D, V, ts_base, EOT, seed=bk))
        emb = emb.to(torch.bfloat16)
        for int8 in int8s:
            table = quantize_rows(emb) if int8 else emb
            for full in (False, True):
                kw = dict(k=k, full_lse=full, ts_state=ts, ts_base=ts_base, eot=EOT)
                val, tok, lse = fused_logits_topk(x, g, b, table, sup, **kw)
                wv, wt, wl = fused_logits_topk_plain(x, g, b, table, sup, **kw)
                torch.cuda.synchronize()
                held = grammar_decisions(val.cpu().numpy(), tok.cpu().numpy(), ts_base, EOT)
                ids_equal, err = torch.equal(tok, wt), float((val - wv).abs().max())
                lse_rel = float(((lse - wl).abs() / wl.abs().clamp_min(1.0)).max())
                case = (f"fused_logits_topk grammar V={V} D={D} BK={bk} k={k} emb "
                        f"{'int8' if int8 else 'bf16'} full_lse={full}")
                print(f"{case}: ids equal {ids_equal}, values max|Δ| {err:.3e} (exact inputs: "
                      f"tolerance 0), lse relative |Δ| {lse_rel:.3e} (tolerance 1e-5); "
                      + ", ".join(f"{rule} {ok}" for rule, ok in held.items()))
                if not (ids_equal and err == 0.0 and lse_rel <= 1e-5 and all(held.values())):
                    raise AssertionError(f"{case}: kernel disagrees with plain")
    return 0.0


#: the grammar head's boosted ids (grammar_head_case): four timestamps
#: ts_base + 10.. and four text ids 1000..
GRAMMAR_TS_OFF, GRAMMAR_TEXT = 10, 1000


def grammar_head_case(bk, d, v, ts_base, eot, seed):
    """numpy inputs of the fused head's grammar mode whose logits are exact
    in any summation order: x rows are ±1 patterns of zero mean (the
    LayerNorm, γ = 1 and β = 0, returns them exactly in bf16) and the table
    holds multiples of 1/8, so every dot is an exact f32 sum and equal
    logits are real ties. Rows (the first ``bk`` of them):

    0. free; four timestamp rows aligned with its pattern score d/2 each,
       far above any text logit: the grammar forces a timestamp, and the
       four tie — the lower id first;
    1. need_ts; four text rows aligned with its pattern score d/2, and the
       mask bans them (a kernel that ignores it returns them);
    2. need_text, with row 0's pattern: the boosted timestamps are banned;
    3. min_ts one past the first boosted timestamp, row 0's pattern: the
       three above it are forced, the one below is banned (a kernel that
       puts the floor one off keeps it or drops the next);
    4. min_ts = V, every timestamp masked, row 0's pattern: the masked
       boosted timestamps must add nothing to the region's sum, so the row
       is not forced;
    5+. random patterns and kinds.

    → (x (bk, d), ln_g, ln_b, emb (v, d) as f32 values of bf16 elements,
    sup (v,), ts_state (bk, 4) int32)."""
    rng = np.random.default_rng(seed)

    def pattern():
        return np.where(rng.permutation(d) % 2 == 0, 1.0, -1.0)

    a, b = pattern(), pattern()
    x = np.stack(([a, b, a, a, a] + [pattern() for _ in range(bk - 5)])[:bk])
    emb = np.clip(np.round(rng.standard_normal((v, d)) * 8), -32, 32) / 8
    emb[ts_base + GRAMMAR_TS_OFF + np.arange(4)] = a * 0.5
    emb[GRAMMAR_TEXT + np.arange(4)] = b * 0.5
    sup = np.zeros(v)
    sup[rng.choice(np.arange(GRAMMAR_TEXT + 4, eot), 200, replace=False)] = -1e30
    ts = np.zeros((bk, 4), np.int64)
    ts[:, 2] = ts_base
    for r, col, value in ((1, 0, 1), (2, 1, 1), (3, 2, ts_base + GRAMMAR_TS_OFF + 1),
                          (4, 2, v)):
        if r < bk:
            ts[r, col] = value
    for r in range(5, bk):
        kind = r % 4
        if kind < 2:
            ts[r, kind] = 1
        elif kind == 2:
            ts[r, 2] = rng.integers(ts_base, v)
    f32 = np.float32
    return (x.astype(f32), np.ones(d, f32), np.zeros(d, f32), emb.astype(f32), sup.astype(f32),
            ts.astype(np.int32))


def grammar_decisions(val, tok, ts_base, eot):
    """The rules grammar_head_case's first rows must show in their
    candidates (numpy (bk, k) values and ids; the rules of rows 1-4 where
    bk ≥ 5, which need k ≥ 4) → {rule: held}."""
    boosted = ts_base + GRAMMAR_TS_OFF + np.arange(4)
    bk, k = tok.shape
    n = min(k, 4)
    rules = {"forced timestamps, tie to the lower id": list(tok[0, :n]) == list(boosted[:n])}
    if bk >= 5:
        rules.update({
            "need_ts bans text": bool((tok[1] >= eot).all()),
            "need_text bans timestamps": bool((tok[2] < ts_base).all()),
            "min_ts floor": list(tok[3, :3]) == list(boosted[1:]) and boosted[0] not in tok[3],
            "masked region adds nothing": bool((tok[4] < ts_base).all()),
        })
    rules["every candidate live"] = bool((val[:5] > -1e29).all())
    return rules


def _gpt_step_inputs(torch, dev, cfg, t_pad, trap, seed):
    """XTTS GPT step inputs at bk=1: the step at position pos = t_pad - 56
    (late in its bucket, as the stream's last token of a bucket), the
    causal sel over the written columns before it. With ``trap`` every
    column sel excludes (the stale one at pos, the unwritten ones after it)
    holds keys of ±TRAP_KEY and values of TRAP_VALUE."""
    L, D = cfg.n_layer, cfg.d_model
    pos = t_pad - 56
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    sel = (torch.arange(t_pad, device=dev) < pos).float()[None, :]
    kc = randn(L, D, t_pad, scale=0.5)
    vc = randn(L, D, t_pad, scale=0.5)
    if trap:
        excluded = sel[0] == 0
        kc[:, :, excluded] = TRAP_KEY * torch.sign(randn(L, D, int(excluded.sum())))
        vc[:, :, excluded] = TRAP_VALUE
    return dict(x_emb=randn(1, D, scale=0.5), k_cache=kc.to(torch.bfloat16),
                v_cache=vc.to(torch.bfloat16), sel=sel, pos=pos)


def _gpt_step_bound(inp, cfg):
    """The least time of one GPT step: every int8 weight chunk, the scale
    and bias rows the step reads (9 of 12 per layer: the four W2 chunks
    share the deferred scale and bias of the last), every LayerNorm row,
    the selected cache columns and the written ones, x in and out and sel,
    each moved once; the products and attention in bf16."""
    L, D = cfg.n_layer, cfg.d_model
    bk = inp["x_emb"].shape[0]
    picked = int((inp["sel"].sum(dim=0) > 0).sum())
    n_bytes = (L * 12 * D * D + L * 9 * D * 4 * 2 + L * 4 * D * 4
               + 2 * L * D * picked * 2 + 2 * L * D * bk * 2
               + 2 * bk * D * 4 + inp["sel"].numel() * 4)
    per_row_cols = int(inp["sel"][0].sum()) + 1
    ops = L * (2 * bk * 12 * D * D + 4 * bk * D * per_row_cols)
    return _bound(n_bytes, ops, BF16_FLOPS)


def check_fused_gpt_step(torch, dev, cfg, packed, t_full):
    """The fused GPT step against its plain version at full XTTS width (30
    layers, D=1024, bk=1, int8) in the first cache bucket (256 positions),
    the 512 one and the full one (the buckets TTS_TEXT's stream runs), on
    standard and trap inputs."""
    from wis_tpu_torch.ops.fused_gpt import fused_gpt_step, fused_gpt_step_plain

    rows = {}
    for t_pad, trap in ((256, False), (256, True), (512, False), (512, True),
                        (t_full, False), (t_full, True)):
        inp = _gpt_step_inputs(torch, dev, cfg, t_pad, trap, seed=t_pad + trap)
        kc0, vc0 = inp["k_cache"], inp["v_cache"]
        args = dict(inp)
        run = {}
        for name, fn in (("kernel", fused_gpt_step), ("plain", fused_gpt_step_plain)):
            args["k_cache"], args["v_cache"] = kc0.clone(), vc0.clone()
            run[name] = fn(cfg, packed, **args)
        torch.cuda.synchronize()
        (xk, kk, vk), (xp, kp, vp) = run["kernel"], run["plain"]
        pos = inp["pos"]
        other = torch.ones(t_pad, dtype=torch.bool, device=dev)
        other[pos] = False

        def rel(a, b):
            return float((a.float() - b.float()).norm() / b.float().norm())

        err = float((xk - xp).abs().max())
        rels = (rel(xk, xp), rel(kk[..., pos], kp[..., pos]), rel(vk[..., pos], vp[..., pos]))
        kept = torch.equal(kk[..., other], kc0[..., other]) and torch.equal(vk[..., other], vc0[..., other])
        case = (f"fused_gpt_step L={cfg.n_layer} D={cfg.d_model} bk=1 t_pad={t_pad} pos={pos} "
                f"int8{' trap' if trap else ''}")
        print(f"{case}: x_out max|Δ| {err:.3e}, ‖Δ‖/‖plain‖ x_out {rels[0]:.3e}, "
              f"written K {rels[1]:.3e}, V {rels[2]:.3e} (tolerance {STEP_REL_NORM:.0e}); "
              f"other cache columns bit-identical: {kept}")
        if not (max(rels) <= STEP_REL_NORM and kept and bool(torch.isfinite(xk).all())):
            raise AssertionError(f"{case}: kernel disagrees with plain")
        if trap:
            continue
        args["k_cache"], args["v_cache"] = kc0.clone(), vc0.clone()
        ms = _median_ms(lambda: fused_gpt_step(cfg, packed, **args))
        plain_ms = _median_ms(lambda: fused_gpt_step_plain(cfg, packed, **args),
                              reps=2, replays=5)
        bound_ms, bound_by = _gpt_step_bound(inp, cfg)
        print(f"{case}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})")
        rows[t_pad] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return rows


def lib_gpt_step(torch, lib, check, cfg, packed, inp):
    """fn() → x_out: one step of ``lib``'s ``wis_fused_gpt_step`` on
    ``_gpt_step_inputs``, called as the wrapper calls it (see
    ``lib_decode_step``)."""
    L, D = cfg.n_layer, cfg.d_model
    dev, bk = inp["x_emb"].device, inp["x_emb"].shape[0]
    bkt = inp["k_cache"].shape[-1]
    ws = torch.empty(lib.wis_fused_gpt_workspace_bytes(D, bk), dtype=torch.uint8, device=dev)
    x = torch.empty_like(inp["x_emb"])

    def fn():
        x.copy_(inp["x_emb"])
        check(lib.wis_fused_gpt_step(
            packed.w.data_ptr(), packed.s.data_ptr(), packed.b.data_ptr(), packed.ln.data_ptr(),
            x.data_ptr(), inp["k_cache"].data_ptr(), inp["v_cache"].data_ptr(),
            inp["sel"].data_ptr(), inp["pos"], ws.data_ptr(), L, D, cfg.n_head, bk, bkt // bk,
            torch.cuda.current_stream(dev).cuda_stream), "fused_gpt_step")
        return x

    return fn


#: the GPT head's knob grid: (temperature, top_k, top_p, repetition_penalty,
#: stop_blocked, do_sample) — the production defaults sampled and greedy,
#: top_k 1, top_p 1.0, and a mild penalty
GPT_HEAD_KNOBS = (
    (0.1, 50, 0.8, 7.0, 1.0, 1.0),
    (0.1, 50, 0.8, 7.0, 0.0, 0.0),
    (1.0, 1, 1.0, 1.0, 0.0, 1.0),
    (0.7, 50, 1.0, 2.0, 0.0, 1.0),
    (1.0, 200, 0.95, 1.0, 1.0, 1.0),
)
#: the head's values against the plain version's: two bf16 ulps of the
#: value — both round the LayerNorm outputs and the logits to bf16, and a
#: summation order that lands an f32 result on the other side of a bf16
#: rounding boundary moves it by one ulp (then ÷ temperature)
GPT_HEAD_REL = 2.0 ** -7
#: smallest allowed distance of a top-p prefix mass from p in the
#: decision cases (their logits are equal on both sides; only the order of
#: the probability sums differs, ~1e-7)
GPT_HEAD_P_MARGIN = 1e-4


def _gpt_head_decision_case(torch, dev, cfg, seed):
    """Inputs whose decisions the two versions must take identically: x a
    ±1 pattern of zero mean (both LayerNorms return it exactly), unit
    LayerNorm rows, and a head with one nonzero per column, so each logit
    is one exact product. The top 64 logits sit 4 bf16 ulps or more apart;
    the stop token is among the best (the floor must remove it); the hit
    mask holds token 0 and some of the best (the penalty must demote them);
    one column duplicates the best one at a lower id (the tie must go to
    the lower id)."""
    from wis_tpu_torch.ops.fused_gpt_head import v_padded

    D, V = cfg.d_model, cfg.n_audio_vocab
    vp = v_padded(V)
    rng = np.random.default_rng(seed)
    x = np.where(rng.permutation(D) % 2 == 0, 1.0, -1.0).astype(np.float32)[None]
    ln4 = np.stack([np.ones(D), np.zeros(D), np.ones(D), np.zeros(D)]).astype(np.float32)
    target = np.round(rng.standard_normal(V) * 0.6, 2)
    order = rng.permutation(V)
    target[order[:64]] = 4.0 - 0.0625 * np.arange(64)  # the best, well apart
    target[cfg.stop_audio_token] = 4.0 + 0.0625
    hit = [0, *order[2:8]]
    best = int(order[0])
    low = max(t for t in range(1, best) if t not in hit)
    rows = rng.integers(0, D, V)
    w = np.zeros((D, vp), np.float32)
    w[rows, np.arange(V)] = target * x[0, rows]  # logit = x[row]·w = target
    w[:, low] = w[:, best]
    hist = np.zeros((1, vp), np.float32)
    hist[0, hit] = 1.0
    gum = np.zeros((1, vp), np.float32)
    gum[0, :V] = -np.log(-np.log(rng.uniform(1e-6, 1.0, V)))

    def host(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    return (host(x), host(ln4), host(w, torch.bfloat16), host(np.zeros((1, vp), np.float32)),
            host(hist), host(gum)), best, low


def _prefix_margin(logits_plain, knob_row):
    """Smallest |prefix mass − p| over the top-k tokens (only there can
    the p-threshold change the kept set), from the plain version's
    pre-threshold logits, in f64 on the host."""
    l = logits_plain[0].double().cpu().numpy()
    l = l[l > -1e29]
    p = np.exp(l - l.max())
    p = p / p.sum()
    s = np.sort(p)[::-1][: max(int(knob_row[1]), 1)]
    return float(np.abs(np.cumsum(s) - s - knob_row[2]).min())


def check_fused_gpt_head(torch, dev, cfg, head_packed):
    """The fused GPT head against its plain version at D=1024, V_pad=1152:
    values on the model's head with random LayerNorm rows, then every
    decision of the knob grid on constructed inputs (see
    _gpt_head_decision_case), where ids and the kept set must be equal."""
    from wis_tpu_torch.ops.fused_gpt_head import fused_gpt_head, fused_gpt_head_plain

    D = cfg.d_model
    ln4_m, head_w, head_b = head_packed
    vp = head_w.shape[-1]
    rng = np.random.default_rng(11)

    def host(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    x = host(rng.standard_normal((1, D)) * 2 + 0.3)
    ln4 = host(np.concatenate([1 + 0.1 * rng.standard_normal((1, D)), 0.1 * rng.standard_normal((1, D))] * 2))
    hist = torch.zeros((1, vp), device=dev)
    hist[0, :40] = 1.0
    gum = host(-np.log(-np.log(rng.uniform(1e-6, 1.0, (1, vp)))))
    kw = dict(cfg=cfg, dtype=torch.bfloat16)
    keep_all = host([[1.0, vp, 1.0, 2.0, 0.0, 0.0, 0.0, 0.0]])
    got = fused_gpt_head(x, ln4, head_w, head_b, hist, gum, keep_all, **kw)
    want = fused_gpt_head_plain(x, ln4, head_w, head_b, hist, gum, keep_all, **kw)
    torch.cuda.synchronize()
    hid_err = float((got[1] - want[1]).abs().max())
    hid_ok = bool(((got[1] - want[1]).abs() <= _bf16_ulp(want[1])).all())
    val_err = (got[2] - want[2]).abs()
    val_ok = bool((val_err <= GPT_HEAD_REL * want[2].abs() + 1e-6).all())
    print(f"fused_gpt_head D={D} V_pad={vp} model head, all kept: hidden max|Δ| {hid_err:.3e} "
          f"(tolerance 1 bf16 ulp: {hid_ok}), logits max|Δ| {float(val_err.max()):.3e} "
          f"(tolerance 2⁻⁷·|plain|: {val_ok})")
    if not (hid_ok and val_ok):
        raise AssertionError("fused_gpt_head: values disagree with plain")
    err = float(val_err.max())

    inputs, best, low = _gpt_head_decision_case(torch, dev, cfg, seed=5)
    for knob in GPT_HEAD_KNOBS:
        k = host([list(knob) + [0.0, 0.0]])
        tk, hk, lk = fused_gpt_head(*inputs, k, **kw)
        tp, hp, lp = fused_gpt_head_plain(*inputs, k, **kw)
        pre = fused_gpt_head_plain(*inputs, host([[knob[0], vp, 1.0, knob[3], knob[4], 0, 0, 0]]), **kw)[2]
        torch.cuda.synchronize()
        margin = _prefix_margin(pre, knob)
        kept_k, kept_p = lk > -1e29, lp > -1e29
        same_set = torch.equal(kept_k, kept_p)
        vals = float((lk[kept_p] - lp[kept_p]).abs().max()) if bool(kept_p.any()) else 0.0
        ids = int(tk) == int(tp)
        print(f"fused_gpt_head knobs {knob}: token kernel {int(tk)} plain {int(tp)} (equal {ids}), "
              f"kept {int(kept_k.sum())} / {int(kept_p.sum())} (same set {same_set}), kept values "
              f"max|Δ| {vals:.3e}, hidden equal {torch.equal(hk, hp)}, top-p margin {margin:.2e}")
        if margin <= GPT_HEAD_P_MARGIN:
            raise AssertionError(f"knobs {knob}: a prefix mass is within {margin} of top_p")
        if not (ids and same_set and vals <= 1e-5 and torch.equal(hk, hp)):
            raise AssertionError(f"fused_gpt_head knobs {knob}: kernel disagrees with plain")
        err = max(err, vals)
    # the duplicated best column: greedy, stop floored, nothing else masked,
    # picks the lower id
    k = host([[1.0, vp, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0]])
    tie = int(fused_gpt_head(*inputs, k, **kw)[0])
    print(f"fused_gpt_head tie: token {tie}, columns {low} and {best} equal (lower id wins: "
          f"{tie == low})")
    if tie != low:
        raise AssertionError(f"fused_gpt_head tie went to {tie}, not the lower id {low}")

    knobs = host([[0.1, 50, 0.8, 7.0, 0.0, 1.0, 0.0, 0.0]])
    ms = _median_ms(lambda: fused_gpt_head(x, ln4, head_w, head_b, hist, gum, knobs, **kw))
    plain_ms = _median_ms(
        lambda: fused_gpt_head_plain(x, ln4, head_w, head_b, hist, gum, knobs, **kw),
        reps=5, replays=5)
    n_bytes = D * vp * 2 + 5 * D * 4 + 3 * vp * 4 + 8 * 4 + 4 + D * 4 + vp * 4
    bound_ms, bound_by = _bound(n_bytes, 2 * D * vp, BF16_FLOPS)
    print(f"fused_gpt_head D={D} V_pad={vp}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def tts_full_bucket(model) -> int:
    """The full cache length of TTS_TEXT's stream (the last bucket)."""
    g = model.cfg.gpt
    prefix = model.cfg.cond_len + model._text_bucket(len(model.tokenize(TTS_TEXT, "en"))) + 1
    return ((prefix + g.max_audio_tokens + 127) // 128) * 128


def time_xtts_epilogue(torch, dev, model):
    """Device ms of one token's sampling epilogue at the stream's shapes and
    default knobs, both ways: the plain PyTorch ops of the default path
    (two LayerNorms, the head, the stop floor, ``_sample_token``) and the
    fused head."""
    import torch.nn.functional as F

    from wis_tpu_torch.models.xtts.gpt import _ln, _sample_token, _stop_floor
    from wis_tpu_torch.ops.fused_gpt_head import fused_gpt_head

    g, p, dtype = model.cfg.gpt, model.gpt_params, model.dtype
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((1, g.d_model), generator=gen, device=dev)
    history = torch.randint(0, g.n_audio_vocab - 2, (1, g.max_audio_tokens), generator=gen,
                            device=dev)
    gum = model._gumbel(gen, 1)[0]
    ln4, head_w, head_b = model.gpt_head_packed
    vp = head_w.shape[-1]
    hit = torch.zeros((1, vp), device=dev).scatter_(1, history, 1.0)
    gum_p = F.pad(gum, (0, vp - g.n_audio_vocab))
    knobs = torch.tensor([[0.1, 50, 0.8, 7.0, 0.0, 1.0, 0.0, 0.0]], device=dev)

    def eager():
        h1 = _ln(x.to(dtype), p["gpt_lnf_g"], p["gpt_lnf_b"])
        logits = (_ln(h1, p["lnf_g"], p["lnf_b"]) @ p["head_w"] + p["head_b"]).float()
        return _sample_token(_stop_floor(logits, g, False), history, gum, 0.1, 50, 0.8, 7.0,
                             True)

    eager_ms = _median_ms(eager, reps=10, replays=10)
    fused_ms = _median_ms(lambda: fused_gpt_head(x, ln4, head_w, head_b, hit, gum_p, knobs,
                                                 cfg=g, dtype=dtype))
    print(f"xtts sampling epilogue per token: plain PyTorch ops {eager_ms:.4f} ms, "
          f"fused head {fused_ms:.4f} ms (device time, CUDA-graph replay)")
    return eager_ms, fused_ms


def stream_xtts(torch, dev, model, counters, path, max_chunks=None, chunks_out=None,
                voice=None):
    """TTS_TEXT through ``model.inference_stream`` (a zero voice unless
    ``voice``, a ``clone_speaker`` result, is given; default knobs, the
    token floor) with every counter set to 0 just before; →
    (the counts just after, (second chunk, worst slack, total) in ms).
    Prints the time to the first and second chunk
    and the worst slack to playback: playback starts when the first chunk
    arrives, chunk i is due when the audio before it has played, and the
    slack is due minus arrival (negative: the listener hears a gap).
    Checks the audio: finite, in [-1, 1], and for a whole stream exactly
    the cap's samples. ``chunks_out``, a list, receives the chunks."""
    cfg = model.cfg
    voc, cap = cfg.vocoder, cfg.gpt.max_audio_tokens
    if voice is None:
        latent = np.zeros((cfg.cond_len, cfg.gpt.d_model), np.float32)
        speaker = np.zeros(cfg.vocoder.cond_dim, np.float32)
    else:
        latent = np.asarray(voice["gpt_cond_latent"], np.float32)
        speaker = np.asarray(voice["speaker_embedding"], np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    arrivals, chunks = [], []
    stream = model.inference_stream(TTS_TEXT, "en", latent, speaker,
                                    stream_chunk_size=TTS_CHUNK, min_audio_tokens=TTS_MIN_TOKENS)
    for chunk in stream:
        arrivals.append(time.perf_counter() - t0)
        chunks.append(chunk)
        if max_chunks and len(chunks) >= max_chunks:
            break
    stream.close()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    if chunks_out is not None:
        chunks_out.extend(chunks)
    counts = [c.launches for c in counters]
    wav = np.concatenate(chunks)
    tokens = round(len(wav) * voc.input_sample_rate / (voc.gpt_code_stride * voc.sample_rate))
    exact = tokens * voc.gpt_code_stride * voc.sample_rate // voc.input_sample_rate
    audio_s = len(wav) / voc.sample_rate
    names = ", ".join(f"{c.__name__} {n}" for c, n in zip(counters, counts))
    played = np.cumsum([0] + [len(c) for c in chunks[:-1]]) / voc.sample_rate
    slack = arrivals[0] + played - np.asarray(arrivals)
    worst = int(np.argmin(slack[1:])) + 1 if len(chunks) > 1 else 0
    second = f"{arrivals[1] * 1e3:.2f} ms" if len(chunks) > 1 else "none"
    print(f"xtts {path} stream: {len(chunks)} chunks, {tokens} tokens, {audio_s:.3f} s of audio; "
          f"first chunk {arrivals[0] * 1e3:.2f} ms, second chunk {second}, worst slack to "
          f"playback {slack[worst] * 1e3:.2f} ms (chunk {worst}), total {total * 1e3:.2f} ms, "
          f"realtime factor {audio_s / total:.2f}; launches: {names}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    if not (np.isfinite(wav).all() and np.abs(wav).max() <= 1.0 and len(wav) == exact):
        raise AssertionError(f"xtts {path}: bad audio ({len(wav)} samples, {exact} expected)")
    if max_chunks is None and tokens != cap:
        raise AssertionError(f"xtts {path}: {tokens} tokens, the floor asks for the cap {cap}")
    return counts, (arrivals[min(1, len(chunks) - 1)] * 1e3, slack[worst] * 1e3, total * 1e3)


#: rounds of the pipeline-depth comparison; each round streams every depth
#: once, the order rotating from round to round
DEPTH_ROUNDS = 4


def compare_pipeline_depths(torch, dev, model, counters, depths=(1, 2, 3)):
    """The default stream at each ``pipeline_depth``, DEPTH_ROUNDS times in
    rotating order; prints each depth's medians of the second chunk's
    arrival, the worst slack to playback and the total. A chunk queued
    behind another holds that one's fetch on the card, so deeper queues
    deliver later; the totals say whether they buy stream time."""
    default = model.pipeline_depth
    runs = {d: [] for d in depths}
    for r in range(DEPTH_ROUNDS):
        for d in depths[r % len(depths):] + depths[:r % len(depths)]:
            model.pipeline_depth = d
            runs[d].append(stream_xtts(torch, dev, model, counters,
                                       f"default, pipeline_depth={d}")[1])
    model.pipeline_depth = default
    for d in depths:
        second, slack, total = (statistics.median(v) for v in zip(*runs[d]))
        print(f"xtts pipeline_depth={d}, medians of {DEPTH_ROUNDS}: second chunk {second:.2f} ms, "
              f"worst slack {slack:.2f} ms, total {total:.2f} ms "
              f"(totals {', '.join(f'{t[2]:.2f}' for t in runs[d])})")


class GrammarLaunches:
    """``fused_logits_topk``'s grammar-mode launches as a counter."""

    __name__ = "fused_logits_topk(grammar)"

    @property
    def launches(self):
        from wis_tpu_torch.ops.fused_logits import fused_logits_topk

        return fused_logits_topk.grammar_launches

    @launches.setter
    def launches(self, n):
        from wis_tpu_torch.ops.fused_logits import fused_logits_topk

        fused_logits_topk.grammar_launches = n


def request(torch, dev, counters, path, call):
    """call() → a TranscriptionResult or a list of them, with every counter
    set to 0 just before; prints one line; → (results, {counter: launches
    just after}, emitted text tokens per result)."""
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    results = call()
    n = {c.__name__: c.launches for c in counters}
    results = results if isinstance(results, list) else [results]
    # the seeded-random model has no vocabulary files: its text is the
    # placeholder rendering, one "t<id>" piece per emitted token
    n_tok = [len(re.findall(r"t\d+", r.text)) for r in results]
    res = results[0]
    print(
        f"{path}: infer {res.infer_time_ms:.2f} ms (asr_dispatch "
        f"{res.timings['asr_dispatch']:.2f} ms), tokens {n_tok}, language {res.language}, "
        f"launches: {', '.join(f'{k} {v}' for k, v in n.items())}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB"
    )
    return results, n, n_tok


def expect(what, cond):
    if not cond:
        raise AssertionError(what)


@contextlib.contextmanager
def switched(*names):
    """The JAX package's environment switches ``names`` set to 1 for the
    block, every switch restored after it."""
    old = {n: os.environ.get(n) for n in SWITCHES}
    for n in SWITCHES:
        os.environ.pop(n, None)
    os.environ.update({n: "1" for n in names})
    try:
        yield
    finally:
        for n, v in old.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v


def serve(torch, dev, engine, counters):
    """Every ASR request kind through the engine, each with the counters
    set to 0 just before it and read just after; each kind's launches
    checked against what its path must run. → {kind: launches}."""
    from wis_tpu_torch.runtime.engine import ASRRequest

    s = engine.settings
    out = {}

    def transcribe(ms, seed, **kw):
        return lambda: engine.transcribe(_audio_i16(ms, seed), beam_size=5, **kw)

    def encoder_runs(n, groups=1):
        expect(f"{groups} encoder calls: {n}",
               n["layer_norm_cuda"] == MIN_LN * groups and n["flash_attention_packed"] == MIN_FLASH * groups
               and n["flash_attention"] == 0)

    # the eager decoder: ancestry_attention once per layer and step,
    # int8_matmul for the 64 cross-KV, the 256 prefill and 256 per step
    s.fused_decode = "off"
    engine.transcribe(_audio_i16(1000, 99), beam_size=5, max_tokens=4)  # warm-up
    res, n, tok = request(torch, dev, counters, "eager request 3.84s beam5 cap32",
                          transcribe(3840, 0, max_tokens=32))
    steps = n["ancestry_attention"] // 32
    encoder_runs(n)
    expect(f"eager launches {n}", n["ancestry_attention"] == 32 * steps and steps >= tok[0] - 1
           and n["int8_matmul"] == INT8_CALL + INT8_PASS * steps
           and n["fused_decode_step"] == n["fused_logits_topk"] == 0)
    print(f"eager request: {steps} decode steps, ancestry_attention {n['ancestry_attention']} "
          f"(32 per step), int8_matmul {n['int8_matmul']} ({INT8_CALL} + {INT8_PASS} per step)")
    out["eager"] = n

    # the main path: the fused step and head once per decode step each,
    # int8_matmul 320 per request and 256 more with detection
    s.fused_decode = "auto"
    engine.transcribe(_audio_i16(1000, 99), beam_size=5, max_tokens=4)  # warm-up
    total = {}
    for i, (ms, cap, detect) in enumerate([r + (False,) for r in REQUESTS] + [(3840, 32, True)]):
        res, n, tok = request(
            torch, dev, counters, f"fused request {ms / 1000:.2f}s beam5 cap{cap} detect={detect}",
            transcribe(ms, i, max_tokens=cap, detect_language=detect))
        encoder_runs(n)
        expect(f"fused launches {n}", n["fused_decode_step"] == n["fused_logits_topk"] >= max(1, tok[0] - 1)
               and n["int8_matmul"] == INT8_CALL + INT8_PASS * detect
               and n["ancestry_attention"] == n["fused_logits_topk(grammar)"] == 0)
        expect(f"bad result: {tok} tokens, {res[0].audio_duration_ms} ms",
               1 <= tok[0] <= cap and res[0].audio_duration_ms == ms)
        total = {k: total.get(k, 0) + v for k, v in n.items()}
    out["fused"] = total

    # timestamps: the head runs its grammar mode at every step
    engine.transcribe(_audio_i16(1000, 98), beam_size=5, max_tokens=4, timestamps=True)
    res, n, tok = request(torch, dev, counters, "timestamps request 3.84s beam5 cap32",
                          transcribe(3840, 10, max_tokens=32, timestamps=True))
    encoder_runs(n)
    expect(f"timestamp launches {n}", n["fused_logits_topk(grammar)"] == n["fused_logits_topk"]
           == n["fused_decode_step"] >= 1 and n["int8_matmul"] == INT8_CALL)
    expect(f"segments {res[0].segments}", res[0].segments is not None and all(
        0.0 <= g["start"] <= g["end"] <= 30.0 for g in res[0].segments))
    print(f"timestamps request: {len(res[0].segments)} segments {res[0].segments[:2]}")
    out["timestamps"] = n

    # word timestamps: the alignment call encodes again and runs its own
    # cross-KV and teacher-forced pass
    engine.transcribe(_audio_i16(1000, 97), beam_size=5, max_tokens=4, word_timestamps=True)
    res, n, tok = request(torch, dev, counters, "word-timestamps request 3.84s beam5 cap32",
                          transcribe(3840, 11, max_tokens=32, word_timestamps=True))
    encoder_runs(n, groups=2)
    expect(f"word-timestamp launches {n}", n["int8_matmul"] == 2 * INT8_CALL)
    expect(f"words {res[0].words}", bool(res[0].words))
    print(f"word-timestamps request: alignment pass int8_matmul {n['int8_matmul'] - INT8_CALL} "
          f"launches, word_align {res[0].timings['word_align']:.2f} ms, {len(res[0].words)} "
          f"words {res[0].words[:2]}")
    out["words"] = n

    # long-form: 13 windows of 22 s in 4 groups of concurrent_gpu_chunks=4
    # (the last padded), the fused step at BK = 4 · 5 = 20
    engine.transcribe(_audio_i16(45000, 96), beam_size=5, max_tokens=4)  # warm-up
    res, n, tok = request(torch, dev, counters, "long-form request 180s beam5 cap64",
                          transcribe(180000, 12, max_tokens=64))
    groups = -(-13 // s.concurrent_gpu_chunks)
    encoder_runs(n, groups)
    expect(f"long-form launches {n}", n["int8_matmul"] == INT8_CALL * groups
           and n["fused_decode_step"] == n["fused_logits_topk"] >= groups)
    keys = [k for k in engine._programs if k[-1] is True]  # (…, n_samples, chunked)
    expect(f"long-form programs {keys}", keys and all(k[2] == 4 and k[8] for k in keys))
    print(f"long-form request: 13 windows, {groups} groups of 4, fused step at BK="
          f"{4 * keys[0][1]}, {n['fused_decode_step']} steps, text of {tok[0]} tokens")
    out["long"] = n

    # four coalesced requests: one program call, BK = 20
    def batch(seed, cap):
        return [ASRRequest(audio=_audio_i16(3840, seed + i), model="large", beam_size=5,
                           max_tokens=cap) for i in range(4)]

    engine.transcribe_coalesced(batch(200, 4))  # warm-up
    res, n, tok = request(torch, dev, counters, "coalesced batch 4 × 3.84s beam5 cap32",
                          lambda: engine.transcribe_coalesced(batch(300, 32)))
    encoder_runs(n)
    expect(f"coalesced launches {n}", n["int8_matmul"] == INT8_CALL
           and n["fused_decode_step"] == n["fused_logits_topk"] >= 1
           and len(res) == 4 and all(1 <= t <= 32 for t in tok))
    out["coalesced"] = n
    return out


def encode_three_ways(torch, dev, loaded, counters=()):
    """30 s of seeded audio through ``loaded``'s encoder with the kernels
    (the counters set to 0 just before and read just after), with the
    plain functions, and in f32 with the plain functions (the reference)
    → (mel, kernels, plain bf16, f32 reference, [launches])."""
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
        for c in counters:
            c.launches = 0
        got = model_mod.encode(loaded.params, mel, cfg).float()
        launched = [c.launches for c in counters]
        with plain_ln, plain_attn:
            ref = model_mod.encode(loaded.params, mel, cfg).float()
            exact = model_mod.encode({"encoder": f32(loaded.params["encoder"])}, mel, cfg)
    torch.cuda.synchronize()
    d = cfg.n_audio_state
    if got.shape != (1, 1500, d) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"encoder output {tuple(got.shape)} not finite")
    return mel, got, ref, exact, launched


def encoder_rel(got, ref, exact):
    """(relative ‖Δ‖ of the kernels' encoder to the f32 one, the plain bf16
    encoder's). Tolerance: with the kernels the bf16 encoder may sit at
    most 1.5× as far from the f32 encoder as the plain bf16 encoder does —
    after the bf16 layers that distance is the rounding floor, and a kernel
    that merely rounds in another order lands at the floor, not above it."""

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    return rel(got, exact), rel(ref, exact)


def check_encode(torch, dev, loaded):
    """The large-v2 encoder with the kernels, with the plain functions, and
    in f32 with the plain functions (the reference); then under
    ``WIS_NO_PACKED_FLASH``, where every layer's attention takes the
    head-major kernel: 32 launches of it, none of the packed one, the
    same bits as the default route."""
    from wis_tpu_torch.models.whisper import model as model_mod
    from wis_tpu_torch.ops.flash import flash_attention, flash_attention_packed
    from wis_tpu_torch.ops.layernorm import layer_norm_cuda

    mel, got, ref, exact, _ = encode_three_ways(torch, dev, loaded)
    cfg = loaded.cfg
    counters = (flash_attention, flash_attention_packed, layer_norm_cuda)
    with torch.inference_mode():
        for c in counters:
            c.launches = 0
        with switched("WIS_NO_PACKED_FLASH"):
            head_major = model_mod.encode(loaded.params, mel, cfg).float()
        launched = [c.launches for c in counters]
    torch.cuda.synchronize()
    err, floor = encoder_rel(got, ref, exact)
    print(
        f"encode large-v2 (1,1500,1280): kernels vs plain max|Δ| "
        f"{float((got - ref).abs().max()):.3e}; relative ‖Δ‖ to the f32 encoder: "
        f"kernels {err:.3e}, plain bf16 {floor:.3e} (tolerance 1.5 × plain)"
    )
    if not err <= 1.5 * floor:
        raise AssertionError(f"encoder with kernels off the f32 reference: {err} > 1.5 × {floor}")
    err_hm = encoder_rel(head_major, ref, exact)[0]
    same = torch.equal(head_major, got)
    print(f"encode large-v2 under WIS_NO_PACKED_FLASH=1: launches flash_attention {launched[0]}, "
          f"flash_attention_packed {launched[1]}, layer_norm_cuda {launched[2]}; relative ‖Δ‖ "
          f"to the f32 encoder {err_hm:.3e} (tolerance 1.5 × {floor:.3e}); bit-identical to "
          f"the default route: {same}")
    if launched != [MIN_FLASH, 0, MIN_LN] or not err_hm <= 1.5 * floor or not same:
        raise AssertionError(f"head-major encoder: launches {launched}, {err_hm}, same {same}")


def serve_switched(torch, dev, engine, counters):
    """One 3.84 s large-v2 beam-5 request on the fused path by the default
    route, then under each of the JAX package's switches, each with the
    counters set to 0 just before and read just after: WIS_NO_PACKED_FLASH
    runs the head-major kernel 32 times and gives the default route's
    tokens; WIS_NO_FLASH runs neither flash kernel (the plain attention,
    the JAX package's XLA route); WIS_NO_LN_KERNEL no LayerNorm kernel.
    → {switch: launches}."""
    engine.settings.fused_decode = "auto"
    audio = _audio_i16(3840, 20)

    def call():
        return engine.transcribe(audio, beam_size=5, max_tokens=32)

    base = request(torch, dev, counters, "default route request 3.84s beam5 cap32", call)[0]
    want = {
        "WIS_NO_PACKED_FLASH": dict(flash_attention=MIN_FLASH, flash_attention_packed=0,
                                    layer_norm_cuda=MIN_LN),
        "WIS_NO_FLASH": dict(flash_attention=0, flash_attention_packed=0, layer_norm_cuda=MIN_LN),
        "WIS_NO_LN_KERNEL": dict(flash_attention=0, flash_attention_packed=MIN_FLASH,
                                 layer_norm_cuda=0),
    }
    out = {}
    for switch, counts in want.items():
        with switched(switch):
            res, n, tok = request(torch, dev, counters, f"{switch}=1 request 3.84s beam5 cap32",
                                  call)
        same = res[0].text == base[0].text
        print(f"{switch}=1: {', '.join(f'{k} {n[k]}' for k in counts)}; tokens equal to the "
              f"default route's: {same}")
        expect(f"{switch} launches {n}", all(n[k] == v for k, v in counts.items())
               and n["fused_decode_step"] >= 1 and 1 <= tok[0] <= 32)
        if switch == "WIS_NO_PACKED_FLASH":
            expect("the head-major route changed the tokens", same)
        out[switch] = n
    expect(f"switches left set: {[n for n in SWITCHES if n in os.environ]}",
           not any(n in os.environ for n in SWITCHES))
    return out


def check_selftest(torch, dev):
    """The converter self-test at large-v2 in this process, then its entry
    point as a user runs it: ``python -m wis_tpu_torch.cli convert-model
    --selftest large-v2`` (on the card, the port's default)."""
    from wis_tpu_torch.utils.selftest import whisper_selftest

    torch.cuda.empty_cache()
    report = whisper_selftest("large-v2", device=dev)
    print(f"whisper_selftest large-v2 on {dev}: {json.dumps(report)}")
    expect(f"selftest report {report}", report["encoder_out"] == (1, 1500, 1280)
           and report["params"] > 1.5e9)
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "wis_tpu_torch.cli", "convert-model", "--selftest", "large-v2"]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    line = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else ""
    print(f"{' '.join(cmd[1:])}: exit {res.returncode}, {line}")
    if res.returncode != 0 or json.loads(line).get("selftest") != "ok":
        raise AssertionError(f"convert-model --selftest failed: {res.stderr[-3000:]}")


def _seeded_hf_checkpoint(torch, dev, cfg, seed):
    """A seeded HF state dict of ``cfg`` as numpy float16 (``proj_out``
    left out: tied to the token embedding, HF does not save it). Linear
    and conv weights at 1/sqrt(fan_in), small biases, LayerNorm gains near
    1; drawn on the card."""
    from wis_tpu_torch.utils.selftest import hf_whisper_shapes

    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, shape in hf_whisper_shapes(cfg).items():
        if name == "proj_out.weight":
            continue
        a = torch.randn(shape, generator=g, device=dev)
        if "layer_norm" in name:
            a = a * 0.1 + (1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            a = a * 0.02
        else:
            a = a / (shape[0] if "embed" in name else shape[1]) ** 0.5
        out[name] = a.half().cpu().numpy()
    return out


def _write_safetensors(path, tensors, dtype="F16"):
    """numpy tensors holding ``dtype``'s bits (float16 for F16, uint16 for
    BF16) as one safetensors file — the format in a few lines (the card's
    machine has no ``safetensors``): an 8-byte little-endian header length,
    the JSON header padded to 8 bytes, then each tensor's bytes in order."""
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, a in tensors.items():
        header[name] = {"dtype": dtype, "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for a in tensors.values():
            np.ascontiguousarray(a).tofile(f)


def _tree_equal(a, b):
    """(leaves, leaves bit-equal) of two parameter trees."""
    if isinstance(a, (dict, list, tuple)):
        if isinstance(a, dict):
            if a.keys() != b.keys():
                return 1, 0
            counts = [_tree_equal(a[k], b[k]) for k in a]
        else:
            if len(a) != len(b):
                return 1, 0
            counts = [_tree_equal(x, y) for x, y in zip(a, b)]
        return sum(n for n, _ in counts), sum(e for _, e in counts)
    return 1, int(a.dtype == b.dtype and a.shape == b.shape and bool((a == b).all()))


def check_checkpoint_round_trip(torch, dev, settings):
    """A seeded large-v2 checkpoint in HF's key layout (F16, two shards)
    written under build/, loaded through a registry whose model_dir points
    there: every leaf bit-equal to params_from_hf of the same arrays in
    memory (quantized as the registry does), one 3.84 s request served
    from it, then a second load that reads ``_converted_torch`` and not the
    safetensors. The directory is deleted at the end."""
    from wis_tpu_torch.models.whisper import weights as wmod
    from wis_tpu_torch.models.whisper.checkpoint import converted_path
    from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS
    from wis_tpu_torch.ops.quant import quantize_whisper_params
    from wis_tpu_torch.runtime.engine import WhisperEngine
    from wis_tpu_torch.runtime.residency import ModelRegistry

    cfg = WHISPER_CONFIGS["large"]
    root = os.path.join(REPO, "build", "checkpoint_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "large"))
    try:
        tensors = _seeded_hf_checkpoint(torch, dev, cfg, seed=13)
        names = list(tensors)
        n_bytes = sum(a.nbytes for a in tensors.values())
        print(f"checkpoint round trip: large-v2, {len(names)} tensors, {n_bytes / 1e9:.3f} GB "
              f"of F16 in 2 shards; {shutil.disk_usage(root).free / 1e9:.1f} GB free under build/")
        t0 = time.perf_counter()
        for i, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
            _write_safetensors(os.path.join(root, "large", f"model-{i + 1:05d}-of-00002.safetensors"),
                               {n: tensors[n] for n in part})
        write_s = time.perf_counter() - t0

        local = dataclasses.replace(settings, model_dir=root)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine = WhisperEngine(ModelRegistry(local, dev))
        loaded = engine.registry.get("large")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        want = quantize_whisper_params(wmod.params_from_hf(
            {n: torch.from_numpy(a) for n, a in tensors.items()}, cfg, engine.registry.dtype, dev))
        leaves, equal = _tree_equal(loaded.params, want)
        del want, tensors
        res = engine.transcribe(_audio_i16(3840, 21), beam_size=5, max_tokens=32)
        n_tok = len(re.findall(r"t\d+", res.text))
        cache = converted_path(os.path.join(root, "large"), engine.registry.dtype)

        refuse = mock.patch.object(wmod, "_hf_tensors",
                                   side_effect=AssertionError("the second load read safetensors"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with refuse:
            again = ModelRegistry(local, dev).get("large")
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        leaves2, equal2 = _tree_equal(again.params, loaded.params)
        print(f"checkpoint round trip: written in {write_s:.2f} s; first load (safetensors → "
              f"params_from_hf on {dev} → int8) {first_s:.2f} s, {equal} of {leaves} leaves "
              f"bit-equal to params_from_hf in memory; request 3.84s beam5 cap32 from it: "
              f"{n_tok} tokens, infer {res.infer_time_ms:.2f} ms; second load from "
              f"_converted_torch ({os.path.getsize(cache) / 1e9:.3f} GB) {second_s:.2f} s, "
              f"{equal2} of {leaves2} leaves equal to the first")
        expect("checkpoint leaves differ", equal == leaves and equal2 == leaves2 == leaves)
        expect(f"checkpoint request: {n_tok} tokens", 1 <= n_tok <= 32)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def check_xtts_checkpoint(torch, dev, seeded_chunks, counters, seeded):
    """A seeded Coqui XTTS v2 ``model.pth`` at full width (30 layers,
    D = 1024, weight-normed HiFi-GAN, the conditioning encoder) written
    under build/, served by an ``XTTSModel`` whose model_dir holds it: every
    GPT and vocoder leaf on the device equal to the state dict's host
    conversion (the int8 leaves to its quantization on the device, as the
    model quantizes; the token embedding and the head also to the state
    dict's own values rounded to bf16), every conditioning leaf equal to
    ``conditioning_from_coqui`` on the host, three chunks streamed and a
    clone of CLONE_AUDIO that differ from the ``seeded`` model's."""
    from wis_tpu_torch.models.xtts.convert import (
        conditioning_from_coqui,
        gpt_from_coqui,
        hifigan_from_coqui,
    )
    from wis_tpu_torch.models.xtts.model import XTTSConfig, XTTSModel
    from wis_tpu_torch.ops.quant import is_quantized, quantize_weight
    from wis_tpu_torch.utils.selftest import synthetic_coqui_sd

    cfg = XTTSConfig()
    cond_cfg = seeded._cond_cfg()
    root = os.path.join(REPO, "build", "xtts_checkpoint_smoke")
    os.makedirs(root, exist_ok=True)
    try:
        t0 = time.perf_counter()
        sd = synthetic_coqui_sd(cfg.gpt, cfg.vocoder, cond_cfg, seed=1234)
        t_make = time.perf_counter() - t0
        t0 = time.perf_counter()
        torch.save({"model": sd}, os.path.join(root, "model.pth"))
        t_write = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(root, "model.pth"))
        # the seeded model's clone first: it builds the embedder both share
        seeded_clone = np.asarray(seeded.clone_speaker(CLONE_AUDIO)["gpt_cond_latent"],
                                  np.float32)
        t0 = time.perf_counter()
        model = XTTSModel(dev, model_dir=root, embed_fn=seeded._embed_fn)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        print(f"xtts checkpoint: {len(sd)} tensors, {size / 1e9:.3f} GB f32 made in {t_make:.2f} s, "
              f"written under build/ in {t_write:.2f} s; XTTSModel(model_dir=...) loaded, "
              f"converted, quantized and packed it in {t_load:.2f} s")

        def leaves(tree, path=""):
            if isinstance(tree, dict) and not is_quantized(tree):
                for k, v in tree.items():
                    yield from leaves(v, f"{path}/{k}")
            elif isinstance(tree, (list, tuple)):
                for i, v in enumerate(tree):
                    yield from leaves(v, f"{path}/{i}")
            else:
                yield path, tree

        want = dict(leaves(gpt_from_coqui(sd, cfg.gpt, torch.bfloat16, "cpu"), "gpt"))
        want.update(leaves(hifigan_from_coqui(sd, cfg.vocoder, torch.bfloat16, "cpu"), "vocoder"))
        got = dict(leaves(model.gpt_params, "gpt"))
        got.update(leaves(model.vocoder_params, "vocoder"))
        equal = 0
        for name, leaf in got.items():
            if is_quantized(leaf):
                ref = quantize_weight(want[name].to(dev))
                equal += torch.equal(leaf["q"], ref["q"]) and torch.equal(leaf["s"], ref["s"])
            else:
                equal += leaf.device == dev and torch.equal(leaf.cpu(), want[name])
        own = (torch.equal(model.gpt_params["text_emb"].cpu(),
                           sd["gpt.text_embedding.weight"].bfloat16())
               and torch.equal(model.gpt_params["head_w"].cpu(),
                               sd["gpt.mel_head.weight"].t().bfloat16()))
        cond_tree = conditioning_from_coqui(sd, cond_cfg, torch.float32, "cpu")
        unmapped = cond_tree.pop("_unmapped")
        cond_want = dict(leaves(cond_tree, "cond"))
        cond_got = dict(leaves(model._cond_params or {}, "cond"))
        cond_equal = sum(leaf.device == dev and torch.equal(leaf.cpu(), cond_want[name])
                         for name, leaf in cond_got.items() if name in cond_want)
        chunks = []
        stream_xtts(torch, dev, model, counters, "checkpoint (first 3 chunks)", max_chunks=3,
                    chunks_out=chunks)
        differs = any(a.shape != b.shape or not np.array_equal(a, b)
                      for a, b in zip(chunks, seeded_chunks))
        clone = np.asarray(model.clone_speaker(CLONE_AUDIO)["gpt_cond_latent"], np.float32)
        clone_differs = clone.shape == seeded_clone.shape and not np.array_equal(clone,
                                                                                 seeded_clone)
        print(f"xtts checkpoint: {equal} of {len(got)} leaves equal to the state dict's "
              f"conversion (set {len(want)}); token embedding and head equal to the state "
              f"dict's values: {own}; conditioning: {cond_equal} of {len(cond_got)} leaves "
              f"equal to conditioning_from_coqui (set {len(cond_want)}, unmapped {unmapped}); "
              f"stream differs from the seeded weights': {differs}; clone differs: "
              f"{clone_differs}")
        if not (equal == len(got) == len(want) and own and differs):
            raise AssertionError("xtts checkpoint: the model does not serve the checkpoint")
        if not (cond_equal == len(cond_got) == len(cond_want) and not unmapped
                and clone_differs):
            raise AssertionError("xtts checkpoint: the model does not clone from the checkpoint")
        del model
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------------- #
# Phase 10: voice cloning and speaker verification
# --------------------------------------------------------------------------- #
def _voice_audio(seconds: float, f0: float, seed: int) -> np.ndarray:
    """A seeded voiced signal at 16 kHz: a harmonic stack on f0 with seeded
    phases, a syllable envelope and a little seeded noise, peak 0.2."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
    wav = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi)) / k for k in range(1, 20))
    wav = wav * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) + 0.01 * rng.standard_normal(t.shape)
    return (0.2 * wav / np.abs(wav).max()).astype(np.float32)


#: the reference audio every clone of this script is made from
CLONE_AUDIO = _voice_audio(6.0, 140.0, seed=61)
#: relative L2 bounds of the card's f32 results against the CPU's (TF32 is
#: off on the card, so only the order of the f32 sums differs)
COND_REL, WAVLM_REL = 1e-4, 1e-4


def _event_ms(torch, fn, reps=5):
    """Median ms of one fn() call launched eagerly, each of `reps` calls
    between CUDA events after a warm-up call: the card's stream time with
    the gaps where it waits for the host's launches (``_median_ms``, a
    graph replay, leaves them out)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def _rel_l2(torch, got, want) -> float:
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def check_conditioning(torch, dev):
    """The XTTS v2 conditioning encoder at full width (seeded) on the log-mel
    of CLONE_AUDIO (padded to 30 s, as ``clone_speaker`` does), on the card
    and on the CPU: the latents within COND_REL, the card's device ms."""
    from wis_tpu_torch.audio.mel import log_mel, pad_or_trim
    from wis_tpu_torch.models.xtts.conditioning import (
        ConditioningConfig,
        conditioning_forward,
        random_conditioning,
    )

    cfg = ConditioningConfig()
    host = random_conditioning(cfg, seed=0)
    params = _tree_to(host, dev)
    with torch.inference_mode():
        mel = log_mel(torch.from_numpy(pad_or_trim(CLONE_AUDIO)).to(dev))[None]
        got = conditioning_forward(params, mel, cfg)
        ms = _median_ms(lambda: conditioning_forward(params, mel, cfg), reps=2, replays=5)
        eager_ms = _event_ms(torch, lambda: conditioning_forward(params, mel, cfg))
        t0 = time.perf_counter()
        want = conditioning_forward(host, mel.cpu(), cfg)
        cpu_s = time.perf_counter() - t0
    err = _rel_l2(torch, got, want)
    print(f"conditioning encoder (D {cfg.d_model}, {cfg.n_heads} heads, {cfg.n_blocks} blocks, "
          f"{cfg.n_latents} latents, perceiver {cfg.perceiver_heads}x{cfg.perceiver_dim_head} "
          f"depth {cfg.perceiver_depth}) on mel {tuple(mel.shape)} of 6 s: latents "
          f"{tuple(got.shape)}, relative L2 to the CPU {err:.3e} (bound {COND_REL:g}), finite "
          f"{bool(torch.isfinite(got).all())}; a clone's conditioning: device {ms:.3f} ms "
          f"(CUDA-graph replay), {eager_ms:.3f} ms launched eagerly (between CUDA events, "
          f"median of 5); CPU {cpu_s:.2f} s")
    expect(f"conditioning latents {err:.3e} off the CPU's",
           err <= COND_REL and bool(torch.isfinite(got).all()))


def _seeded_hf_wavlm(torch, dev, cfg, seed):
    """A seeded HF ``WavLMForXVector`` state dict of ``cfg`` in bf16 on the
    CPU, drawn on the card: weights at 1/sqrt(fan_in), biases 0.02, vector
    gains near 1."""
    from wis_tpu_torch.utils.selftest import hf_wavlm_shapes

    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, shape in hf_wavlm_shapes(cfg).items():
        a = torch.randn(shape, generator=g, device=dev)
        if name.endswith("bias"):
            a = a * 0.02
        elif len(shape) == 1 or name.endswith(("original0", "gru_rel_pos_const")):
            a = a * 0.1 + 1.0
        else:
            a = a / float(np.prod(shape[1:])) ** 0.5
        out[name] = a.to(torch.bfloat16).cpu()
    return out


def check_wavlm(torch, dev):
    """WavLM base-plus-sv (seeded) embeds 2.5 s and 10 s on the card and on
    the CPU (within WAVLM_REL, the card's device ms); then a seeded
    HF-layout checkpoint in two BF16 shards under build/ loads through
    ``load_or_init_wavlm`` with every leaf equal to ``params_from_hf_wavlm``
    of the same tensors in memory, and is deleted."""
    from wis_tpu_torch.models.wavlm.model import (
        BASE_PLUS_SV,
        load_or_init_wavlm,
        params_from_hf_wavlm,
        random_wavlm,
        xvector_embed,
    )
    from wis_tpu_torch.utils.selftest import _leaves

    cfg = BASE_PLUS_SV
    host = random_wavlm(cfg, seed=0)
    params = _tree_to(host, dev)
    n_params = sum(t.numel() for t in _leaves(host))
    for seconds, seed in ((2.5, 81), (10.0, 82)):
        audio = torch.from_numpy(_voice_audio(seconds, 120.0, seed))[None]
        a_dev = audio.to(dev)
        with torch.inference_mode():
            got = xvector_embed(params, a_dev, cfg)
            ms = _median_ms(lambda: xvector_embed(params, a_dev, cfg), reps=3, replays=5)
            eager_ms = _event_ms(torch, lambda: xvector_embed(params, a_dev, cfg))
            t0 = time.perf_counter()
            want = xvector_embed(host, audio, cfg)
            cpu_s = time.perf_counter() - t0
        err = _rel_l2(torch, got, want)
        print(f"wavlm base-plus-sv ({n_params:,} parameters, seeded) embeds {seconds} s: "
              f"{tuple(got.shape)}, relative L2 to the CPU {err:.3e} (bound {WAVLM_REL:g}); "
              f"an embedding: device {ms:.3f} ms (CUDA-graph replay), {eager_ms:.3f} ms "
              f"launched eagerly (between CUDA events, median of 5); CPU {cpu_s:.2f} s")
        expect(f"wavlm embedding of {seconds} s {err:.3e} off the CPU's",
               err <= WAVLM_REL and bool(torch.isfinite(got).all()))

    root = os.path.join(REPO, "build", "wavlm_checkpoint_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        sd = _seeded_hf_wavlm(torch, dev, cfg, seed=19)
        names = list(sd)
        for i, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
            _write_safetensors(os.path.join(root, f"model-{i + 1:05d}-of-00002.safetensors"),
                               {n: sd[n].view(torch.int16).numpy() for n in part}, "BF16")
        n_bytes = sum(t.numel() * 2 for t in sd.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load_or_init_wavlm(root, cfg, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        want = params_from_hf_wavlm(sd, cfg, device=dev)
        leaves, equal = _tree_equal(loaded, want)
        print(f"wavlm checkpoint: {len(names)} tensors, {n_bytes / 1e6:.1f} MB of BF16 in 2 "
              f"shards under build/; load_or_init_wavlm on {dev} {load_s:.2f} s, {equal} of "
              f"{leaves} leaves equal to params_from_hf_wavlm in memory")
        expect("wavlm checkpoint leaves differ", equal == leaves)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def check_clone(torch, dev, xtts, counters):
    """``clone_speaker`` of CLONE_AUDIO on phase 7's model (median of 3; the
    embedder was built by phase 9's clone), then TTS_TEXT streamed in the
    cloned voice to the cap with the counters set to 0 just before:
    → the counts just after."""
    times, voice = [], None
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        voice = xtts.clone_speaker(CLONE_AUDIO)
        times.append((time.perf_counter() - t0) * 1e3)
    lat = np.asarray(voice["gpt_cond_latent"], np.float32)
    emb = np.asarray(voice["speaker_embedding"], np.float32)
    print(f"clone_speaker (6 s, XTTS v2 conditioning + WavLM x-vector on {dev}): median "
          f"{statistics.median(times):.2f} ms ({', '.join(f'{t:.2f}' for t in times)}); "
          f"latents {lat.shape}, embedding {emb.shape}, norm {np.linalg.norm(emb):.4f}")
    expect("clone shapes", lat.shape == (xtts.cfg.cond_len, xtts.cfg.gpt.d_model)
           and emb.shape == (xtts.cfg.vocoder.cond_dim,) and np.isfinite(lat).all()
           and abs(np.linalg.norm(emb) - 1.0) < 1e-2)
    counts = stream_xtts(torch, dev, xtts, counters, "cloned voice (fused step)", voice=voice)[0]
    return counts


def check_xtts_selftest_cli():
    """``python -m wis_tpu_torch.cli convert-model --selftest xtts`` (on the
    card, the port's default): the XTTS v2 key list converted, every
    conditioning key read, one vocoder call, prefill and conditioning pass."""
    cmd = [sys.executable, "-m", "wis_tpu_torch.cli", "convert-model", "--selftest", "xtts"]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    line = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else ""
    print(f"{' '.join(cmd[1:])}: exit {res.returncode}, {line}")
    if res.returncode != 0 or json.loads(line).get("selftest") != "ok":
        raise AssertionError(f"convert-model --selftest xtts failed: {res.stderr[-3000:]}")


def check_sv(torch, dev):
    """Two seeded voices enrolled through the port's ``SpeakerVerifier`` (its
    default embedder: WavLM base-plus-sv on the card, seeded as no checkpoint
    is there) in a store under build/, then one verified; the store is
    deleted."""
    from wis_tpu_torch.server.sv import SpeakerVerifier
    from wis_tpu_torch.settings import APISettings

    root = os.path.join(REPO, "build", "sv_smoke")
    shutil.rmtree(root, ignore_errors=True)
    try:
        verifier = SpeakerVerifier(APISettings(sv_speaker_dir=root), device=dev)
        voices = {"alice": _voice_audio(4.0, 210.0, 91), "bob": _voice_audio(4.0, 105.0, 92)}
        t0 = time.perf_counter()
        verifier._embed(voices["bob"])
        first_s = time.perf_counter() - t0
        enrol = {}
        for name, audio in voices.items():
            t0 = time.perf_counter()
            verifier.enroll(name, audio)
            enrol[name] = (time.perf_counter() - t0) * 1e3
        verify = []
        for _ in range(3):
            t0 = time.perf_counter()
            hits = verifier.verify(voices["alice"])
            verify.append((time.perf_counter() - t0) * 1e3)
        print(f"speaker verification on {dev}: embedder built and first embedding in "
              f"{first_s:.2f} s; enrol {', '.join(f'{n} {t:.2f} ms' for n, t in enrol.items())}; "
              f"verify alice median {statistics.median(verify):.2f} ms "
              f"({', '.join(f'{t:.2f}' for t in verify)}): {hits}")
        expect(f"verify {hits}", sorted(os.listdir(root)) == ["alice.npy", "bob.npy"]
               and hits.get("alice", 0.0) >= 0.99)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _counted(counters, call):
    """call() with every counter set to 0 just before; → (its result,
    {counter: launches just after})."""
    for c in counters:
        c.launches = 0
    out = call()
    return out, {c.__name__: c.launches for c in counters}


def _concurrently(n, fn):
    """fn(i) for i < n, each on its own thread, all released at once;
    → (results in order, host seconds from the release to the last)."""
    import threading

    barrier = threading.Barrier(n + 1)
    results = [None] * n
    errors = []

    def run(i):
        barrier.wait()
        try:
            results[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results, time.perf_counter() - t0


def _ingest_inputs(seed):
    """Seeded 3.84 s of audio as a 16-bit WAV at 44.1 kHz stereo, raw
    s16le at 16 kHz mono (the Willow headers' parameters) and a 32-bit
    float WAV at 48 kHz; → {name: (bytes, load_audio keyword arguments)}."""
    import io
    import struct
    import wave

    rng = np.random.default_rng(seed)

    def signal(sr, channels):
        t = np.arange(int(3.84 * sr)) / sr
        tone = 0.3 * np.sin(2 * np.pi * 220 * t)
        return np.stack([tone + 0.05 * rng.standard_normal(t.shape[0])
                         for _ in range(channels)], axis=1).astype(np.float32)

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(44100)
        w.writeframes((np.clip(signal(44100, 2), -1, 1) * 32767).astype("<i2").tobytes())
    raw = (np.clip(signal(16000, 1), -1, 1) * 32767).astype("<i2").tobytes()
    f32 = signal(48000, 1).astype("<f4").tobytes()
    float_wav = b"".join([
        b"RIFF", struct.pack("<I", 36 + len(f32)), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 3, 1, 48000, 48000 * 4, 4, 32),
        b"data", struct.pack("<I", len(f32)), f32,
    ])
    return {
        "wav 16-bit 44.1 kHz stereo": (buf.getvalue(), {}),
        "raw s16le 16 kHz mono": (raw, dict(codec="pcm", sample_rate=16000, bits=16,
                                            channels=1)),
        "wav float 48 kHz mono": (float_wav, {}),
    }


def _vad_pcm(seed):
    """3.84 s of voiced audio then 1.5 s of near-silence at 48 kHz, as
    interleaved s16le stereo."""
    rng = np.random.default_rng(seed)
    sr = 48000
    t = np.arange(int(3.84 * sr)) / sr
    speech = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.shape[0])
    quiet = 0.001 * rng.standard_normal(int(1.5 * sr))
    mono = np.concatenate([speech, quiet])
    return (np.clip(np.stack([mono, 0.5 * mono], axis=1), -1, 1) * 32767).astype("<i2")


def check_serving(torch, dev, engine, counters, served, card):
    """Phase 11: the serving layers below HTTP on the card — the wisaudio
    library built with g++ from ``native/wisaudio``, ingest of three
    formats, the dynamic batcher on phase 5's engine (a coalesced four,
    eight requests, a lone request, word timestamps), a streaming session
    (PCM frames, VAD-gated at 48 kHz stereo, a refused v3-only language),
    a replica pool over every visible CUDA device and the settings from
    the environment. Every check raises. → the session's text."""
    import asyncio

    from wis_tpu_torch.audio import codecs
    from wis_tpu_torch.audio.ingest import load_audio
    from wis_tpu_torch.parallel.replicas import ReplicaPool
    from wis_tpu_torch.runtime.batcher import ASRRequest, InferenceExecutor
    from wis_tpu_torch.server.session import DataChannelMessage, StreamingSession
    from wis_tpu_torch.settings import APISettings, get_api_settings

    s = engine.settings
    s.fused_decode = "auto"

    # (a) the native library, built here from the repo's sources
    path = codecs.library_path()
    existed = path.is_file()
    t0 = time.perf_counter()
    expect("the native wisaudio library", codecs.native_available())
    print(f"wisaudio: {'loaded' if existed else 'built with g++'} {path} in "
          f"{time.perf_counter() - t0:.2f} s ({card})")

    # (b) ingest: three encodings of 3.84 s to 16 kHz mono float32
    for name, (data, kw) in _ingest_inputs(40).items():
        audio = load_audio(data, **kw)
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            load_audio(data, **kw)
            ms.append((time.perf_counter() - t0) * 1e3)
        expect(f"{name}: {audio.shape} {audio.dtype}", audio.dtype == np.float32
               and audio.ndim == 1 and abs(audio.shape[0] - 61440) <= 1
               and bool(np.isfinite(audio).all()))
        print(f"ingest {name} ({len(data)} bytes) → {audio.shape[0]} samples at 16 kHz: "
              f"median {statistics.median(ms):.3f} ms per decode ({card})")

    # (c) the dynamic batcher on phase 5's engine
    executor = InferenceExecutor(engine)
    dispatches = []
    direct_coalesced = engine.transcribe_coalesced

    def spy(reqs):
        dispatches.append(len(reqs))
        return direct_coalesced(reqs)

    def req(seed, cap=32, **kw):
        return ASRRequest(audio=_audio_i16(3840, seed), model="large", beam_size=5,
                          max_tokens=cap, **kw)

    engine.transcribe_coalesced = spy
    try:
        executor.start()
        (four, _), n = _counted(counters, lambda: _concurrently(
            4, lambda i: executor.submit_sync(req(300 + i))))
        expect(f"four requests from four threads: dispatches {dispatches}", dispatches == [4])
        expect(f"coalesced launches {n} against phase 5's {served['coalesced']}",
               n == served["coalesced"])
        keys = [k for k in engine._programs if k[2] == 4 and k[1] == 5 and k[8]]
        expect(f"a fused program at batch 4 × beam 5 {list(engine._programs)}", bool(keys))
        direct, n_direct = _counted(counters, lambda: direct_coalesced(
            [req(300 + i) for i in range(4)]))
        expect(f"executor results equal to the direct call: "
               f"{[r.text for r in four]} {[r.text for r in direct]}",
               [r.text for r in four] == [r.text for r in direct] and n_direct == n)
        print(f"executor: 4 requests from 4 threads in one dispatch of 4 (fused step at "
              f"BK=20, {n['fused_decode_step']} steps, int8_matmul {n['int8_matmul']}, "
              f"layer_norm_cuda {n['layer_norm_cuda']}), tokens equal to the direct "
              f"transcribe_coalesced: True")

        dispatches.clear()
        rates = []
        for _ in range(3):
            dispatches.clear()
            eight, secs = _concurrently(8, lambda i: executor.submit_sync(req(310 + i)))
            expect(f"eight requests: dispatches {dispatches}", dispatches == [4, 4])
            rates.append(8 / secs)
        print(f"executor: 8 requests from 8 threads in 2 dispatches of 4: "
              f"{', '.join(f'{r:.2f}' for r in rates)} requests/s on the host clock "
              f"(median {statistics.median(rates):.2f}; {card})")

        dispatches.clear()
        lone, direct_ms = [], []
        for i in range(6):  # in turns, each side first every other round
            audio = _audio_i16(3840, 320 + i)
            sides = [
                (lone, lambda: executor.submit_sync(ASRRequest(
                    audio=audio, model="large", beam_size=5, max_tokens=32))),
                (direct_ms, lambda: engine.transcribe(audio, beam_size=5, max_tokens=32)),
            ]
            texts = []
            for times, call in sides[i % 2:] + sides[:i % 2]:
                t0 = time.perf_counter()
                texts.append(call().text)
                times.append((time.perf_counter() - t0) * 1e3)
            expect(f"lone request {texts}", texts[0] == texts[1])
        expect(f"lone requests dispatched alone: {dispatches}", dispatches == [])
        gap = statistics.median(lone) - statistics.median(direct_ms)
        print(f"executor: lone 3.84 s request median {statistics.median(lone):.2f} ms "
              f"({', '.join(f'{t:.2f}' for t in lone)}) against the direct transcribe "
              f"{statistics.median(direct_ms):.2f} ms ({', '.join(f'{t:.2f}' for t in direct_ms)})"
              f": {gap:.2f} ms added (batch window {s.batch_window_s * 1e3:.0f} ms + queue; "
              f"{card})")

        words, n = _counted(counters, lambda: executor.submit_sync(
            req(11, word_timestamps=True)))
        expect(f"word timestamps ran alone: {dispatches}", dispatches == [])
        expect(f"word-timestamp launches {n} against phase 5's {served['words']}",
               n == served["words"] and n["int8_matmul"] == 2 * INT8_CALL
               and n["layer_norm_cuda"] == 2 * MIN_LN and bool(words.words))
        print(f"executor: word-timestamps request alone, {len(words.words)} words, infer "
              f"{words.infer_time_ms:.2f} ms ({card}), int8_matmul {n['int8_matmul']}, "
              f"layer_norm_cuda {n['layer_norm_cuda']}")

        # (d) a streaming session on the same executor
        session = StreamingSession(executor, s)
        pcm = _audio_i16(3840, 330)

        async def pcm_session():
            out = await session.handle(DataChannelMessage(
                "start", {"sample_rate": 16000, "bits": 16, "channel": 1}))
            for i in range(0, pcm.shape[0], 320):  # 20 ms frames
                session.feed_pcm(pcm[i:i + 320].astype("<i2").tobytes())
            return out + await session.handle(DataChannelMessage("stop", {}))

        t0 = time.perf_counter()
        replies, n = _counted(counters, lambda: asyncio.run(pcm_session()))
        stop_ms = (time.perf_counter() - t0) * 1e3
        types = [json.loads(m)["type"] for m in replies]
        infer = json.loads(replies[1])["obj"]
        want = engine.transcribe(pcm, beam_size=s.beam_size)
        expect(f"session replies {types}", types == ["log", "infer", "log"])
        expect(f"session text {infer['text']!r} against {want.text!r}",
               infer["text"] == want.text and infer["audio_duration"] == 3840)
        expect(f"session launches {n}", n["fused_decode_step"] == n["fused_logits_topk"] >= 1
               and n["int8_matmul"] == INT8_CALL and n["layer_norm_cuda"] == MIN_LN
               and n["flash_attention_packed"] == MIN_FLASH)
        session_text = infer["text"]
        print(f"session: start, 192 frames of 20 ms, stop → infer in {infer['time']:.2f} ms "
              f"(session {stop_ms:.2f} ms; {card}), text equal to engine.transcribe on the "
              f"same int16 audio: True; launches: {', '.join(f'{k} {v}' for k, v in n.items())}")

        stereo = _vad_pcm(331)

        async def vad_session():
            await session.handle(DataChannelMessage(
                "start", {"vad": True, "sample_rate": 48000, "bits": 16, "channels": 2}))
            for i in range(0, stereo.shape[0], 960):
                session.feed_pcm(stereo[i:i + 960].tobytes())
                if session.vad_triggered:
                    return i / 48000, await session.vad_stop()
            return None, []

        (at, replies), n = _counted(counters, lambda: asyncio.run(vad_session()))
        types = [json.loads(m)["type"] for m in replies]
        expect(f"VAD endpoint at {at}: {types} {n}", at is not None
               and types == ["log", "infer", "log"] and not session.recording
               and n["fused_decode_step"] >= 1 and n["int8_matmul"] == INT8_CALL)
        print(f"session (VAD, 48 kHz stereo): end of utterance detected at {at:.2f} s "
              f"(speech ends at 3.84 s) → {types}: "
              f"{json.loads(replies[1])['obj']['audio_duration']} ms of audio, infer "
              f"{json.loads(replies[1])['obj']['time']:.2f} ms ({card}), fused_decode_step "
              f"{n['fused_decode_step']}")

        async def refused():
            await session.handle(DataChannelMessage("start", {}))
            session.feed_pcm(pcm[:16000].astype("<i2").tobytes())
            return await session.handle(DataChannelMessage("stop", {"force_language": "yue"}))

        dispatches.clear()
        replies, n = _counted(counters, lambda: asyncio.run(refused()))
        reply = json.loads(replies[0])
        expect(f"yue on large-v2: {replies} {n} depth {executor.queue_depth}",
               len(replies) == 1 and reply["type"] == "error" and "large-v3" in reply["obj"]["msg"]
               and not any(n.values()) and executor.queue_depth == 0 and dispatches == [])
        print(f"session: force_language yue on large-v2 refused before enqueue "
              f"({reply['obj']['msg']!r}), 0 launches, queue depth 0")
    finally:
        executor.shutdown()
        del engine.transcribe_coalesced

    # (e) a replica pool over every visible CUDA device
    t0 = time.perf_counter()
    pool = ReplicaPool(APISettings(whisper_model_default="large", beam_size=5,
                                   long_beam_size=5))
    try:
        devices = [str(e.device) for e in pool.engines]
        expect(f"pool devices {devices}",
               devices == [f"cuda:{i}" for i in range(torch.cuda.device_count())])
        audio = _audio_i16(3840, 340)
        got = pool.submit_sync(ASRRequest(audio=audio, model="large", beam_size=5,
                                          max_tokens=32))
        pool_s = time.perf_counter() - t0
        want = engine.transcribe(audio, beam_size=5, max_tokens=32)
        expect(f"pool result {got.text!r} against {want.text!r}", got.text == want.text)
        print(f"replica pool: {len(devices)} replica(s) on {devices}, large-v2 loaded and one "
              f"request served in {pool_s:.2f} s (infer {got.infer_time_ms:.2f} ms; {card}), "
              f"tokens equal to phase 5's engine: True")
    finally:
        pool.shutdown()
        del pool
        torch.cuda.empty_cache()

    # (f) the settings, from this process's environment
    get_api_settings.cache_clear()
    env = get_api_settings()
    expect("pydantic imported", "pydantic" not in sys.modules)
    print(f"get_api_settings() without pydantic: batch_window_s {env.batch_window_s}, "
          f"batch_admit_s {env.batch_admit_s}, batch_admit_max_s {env.batch_admit_max_s}, "
          f"batch_buckets {env.batch_buckets}, replica_pool {env.replica_pool!r}")
    return session_text


# --------------------------------------------------------------------------- #
# Phase 12: the HTTP apps' cores
# --------------------------------------------------------------------------- #
#: the fields of an ASR reply with stats (schemas.ASR without translation)
ASR_FIELDS = {"infer_time", "infer_speedup", "audio_duration", "language", "text"}


async def _counted_async(counters, awaitable):
    """awaitable with every counter set to 0 just before; → (its result,
    {counter: launches once it is done}, host ms)."""
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    out = await awaitable
    return out, {c.__name__: c.launches for c in counters}, (time.perf_counter() - t0) * 1e3


async def _collect(reply):
    """A core's streamed reply (awaited here) → (its chunks, ms to the first
    audio chunk, total ms), both from the call."""
    t0 = time.perf_counter()
    chunks, first = [], None
    async for chunk in (await reply).stream:
        chunks.append(chunk)
        if len(chunks) == 2:  # the WAV header comes first
            first = (time.perf_counter() - t0) * 1e3
    return chunks, first, (time.perf_counter() - t0) * 1e3


def _launches(n):
    return ", ".join(f"{k} {v}" for k, v in n.items() if v)


def check_apps(torch, dev, engine, counters, xtts, session_text, card):
    """Phase 12: the cores of the port's ASR and TTS apps
    (``server/app.py``, ``server/tts_app.py``) on phase 5's engine and phase
    7's XTTS v2, under one event loop, with no aiohttp: the state of
    ``build_state`` (SV on, stores and the static root in a temporary
    directory), every route's core with its launches checked (the counters
    set to 0 just before each request and read once it is answered), the
    refusals with no launch and nothing queued, the WebSocket loop, the TTS
    routes with their streams, two concurrent streams against their lone
    runs, and the CLI's help. Every check raises."""
    import asyncio
    import tempfile

    from wis_tpu_torch.audio.ingest import load_audio, pcm_to_wav_bytes, wav_stream_header
    from wis_tpu_torch.ops.fused_gpt import fused_gpt_step
    from wis_tpu_torch.ops.fused_gpt_head import fused_gpt_head
    from wis_tpu_torch.runtime.batcher import ASRRequest
    from wis_tpu_torch.server import app, tts_app

    every = tuple(counters) + (fused_gpt_step, fused_gpt_head)
    root = tempfile.mkdtemp(prefix="wis_apps_")
    s = dataclasses.replace(engine.settings, support_sv=True, sv_speaker_dir=f"{root}/sv",
                            xtts_speaker_dir=f"{root}/voices")
    model, beam = s.whisper_model_default, s.beam_size
    state = app.build_state(s, engine=engine, static_root=root)
    tts = tts_app.build_tts_state(s, model=xtts)
    expect(f"state {state.registry.device} {type(state.executor).__name__} sv "
           f"{state.sv_enabled} {state.save_audio_path}",
           state.registry.device == dev and state.sv_enabled
           and state.save_audio_path.startswith(root))
    dispatches = []
    direct_one, direct_many = engine.transcribe, engine.transcribe_coalesced

    def one(*a, **kw):
        dispatches.append(1)
        return direct_one(*a, **kw)

    def many(reqs):
        dispatches.append(len(reqs))
        return direct_many(reqs)

    def expect_asr(what, n, encoders=1, int8=INT8_CALL, grammar=False, steps=True):
        expect(f"{what} launches {n}", n["layer_norm_cuda"] == MIN_LN * encoders
               and n["flash_attention_packed"] == MIN_FLASH * encoders
               and n["flash_attention"] == n["ancestry_attention"] == 0
               and n["int8_matmul"] == int8
               and n["fused_gpt_step"] == n["fused_gpt_head"] == 0
               and (not steps or n["fused_decode_step"] == n["fused_logits_topk"] >= 1)
               and n["fused_logits_topk(grammar)"] == (n["fused_logits_topk"] if grammar else 0))

    inputs = _ingest_inputs(40)
    wav44 = inputs["wav 16-bit 44.1 kHz stereo"][0]
    raw, raw_kw = inputs["raw s16le 16 kHz mono"]
    audio44 = load_audio(wav44)
    want44 = direct_one(audio44, beam_size=beam)
    pcm_headers = {"X-Audio-Codec": "pcm", "X-Audio-Sample-Rate": "16000",
                   "X-Audio-Bits": "16", "X-Audio-Channel": "1"}

    async def asr_routes():
        loop = asyncio.get_running_loop()
        rep, n, ms = await _counted_async(every, app.asr(state, {}, wav44))
        expect(f"/api/asr {rep.status} {rep.json}", rep.status == 200
               and set(rep.json) == ASR_FIELDS and rep.json["text"] == want44.text
               and rep.json["audio_duration"] == 3840)
        expect_asr("/api/asr", n)
        print(f"/api/asr (3.84 s WAV, 44.1 kHz stereo, large-v2 beam 5): {ms:.2f} ms ({card}), "
              f"text equal to engine.transcribe on the decoded audio: True; launches: "
              f"{_launches(n)}")

        # the ms a core adds over executor.submit_sync, in turns: /api/asr on
        # the 44.1 kHz WAV, /api/willow on the same samples as 16 kHz PCM
        # (no resampling), and the decode of the WAV alone
        pcm44 = (np.clip(audio44, -1, 1) * 32767).astype("<i2").tobytes()
        want_pcm = direct_one(load_audio(pcm44, **raw_kw), beam_size=beam)
        times = {"asr core": [], "willow core (PCM)": [], "submit_sync": [], "decode": []}
        sides = [
            ("asr core", lambda: app.asr(state, {}, wav44), want44.text),
            ("willow core (PCM)", lambda: app.willow(state, {}, pcm_headers, pcm44),
             want_pcm.text),
            ("submit_sync", lambda: loop.run_in_executor(
                None, state.executor.submit_sync,
                ASRRequest(audio=audio44, model=model, beam_size=beam)), want44.text),
        ]
        for i in range(6):
            for name, call, text in sides[i % 3:] + sides[:i % 3]:
                t0 = time.perf_counter()
                out = await call()
                times[name].append((time.perf_counter() - t0) * 1e3)
                got = out.json["text"] if isinstance(out, app.Reply) else out.text
                expect(f"timed request {name} text {got!r}", got == text)
            t0 = time.perf_counter()
            load_audio(wav44)
            times["decode"].append((time.perf_counter() - t0) * 1e3)
        med = {k: statistics.median(v) for k, v in times.items()}
        added = {k: med[k] - med["submit_sync"] for k in ("asr core", "willow core (PCM)")}
        print(f"core ms over executor.submit_sync, 6 turns ({card}): " + "; ".join(
            f"{k} median {med[k]:.2f} ({', '.join(f'{t:.2f}' for t in v)})"
            for k, v in times.items()) + f" → /api/asr adds {added['asr core']:.2f} ms, "
            f"/api/willow PCM {added['willow core (PCM)']:.2f} ms")

        rep, n, ms = await _counted_async(every, app.asr(state, {"timestamps": "true"}, wav44))
        expect(f"timestamps {rep.status} {rep.json}", rep.status == 200
               and set(rep.json) == ASR_FIELDS | {"segments"} and all(
                   0.0 <= g["start"] <= g["end"] <= 30.0 for g in rep.json["segments"]))
        expect_asr("timestamps", n, grammar=True)
        print(f"/api/asr?timestamps=true: {ms:.2f} ms, {len(rep.json['segments'])} segments; "
              f"launches: {_launches(n)}")

        rep, n, ms = await _counted_async(every, app.asr(state, {"word_timestamps": "1"}, wav44))
        expect(f"word timestamps {rep.status} {sorted(rep.json)}", rep.status == 200
               and set(rep.json) == ASR_FIELDS | {"words"} and bool(rep.json["words"]))
        # phase 11's word-timestamps launches: the alignment call encodes again
        expect_asr("word timestamps", n, encoders=2, int8=2 * INT8_CALL, steps=False)
        print(f"/api/asr?word_timestamps=true: {ms:.2f} ms, {len(rep.json['words'])} words; "
              f"launches: {_launches(n)}")

        rep, n, ms = await _counted_async(every, app.asr(state, {"detect_language": "true"},
                                                         wav44))
        expect(f"detect {rep.status} {rep.json}", rep.status == 200
               and set(rep.json) == ASR_FIELDS and rep.json["language"])
        expect_asr("detect", n, int8=INT8_CALL + INT8_PASS)
        print(f"/api/asr?detect_language=true: {ms:.2f} ms, language {rep.json['language']!r}; "
              f"launches: {_launches(n)}")

        # four at once: 16 kHz WAVs, whose decode (~0.1 ms) lets all four
        # reach the batcher inside its 4 ms window
        bodies = [pcm_to_wav_bytes(_audio_i16(3840, 300 + i) / 32768.0) for i in range(4)]
        dispatches.clear()
        replies, n, ms = await _counted_async(every, asyncio.gather(
            *(app.asr(state, {}, b) for b in bodies)))
        expect(f"four at once: dispatches {dispatches}", dispatches == [4])
        (direct, n_direct, _) = await _counted_async(every, loop.run_in_executor(
            None, direct_many, [ASRRequest(audio=load_audio(b), model=model, beam_size=beam)
                                for b in bodies]))
        expect(f"four at once: {[r.json['text'] for r in replies]} against "
               f"{[r.text for r in direct]}; launches {n} against {n_direct}",
               [r.status for r in replies] == [200] * 4 and n == n_direct
               and [r.json["text"] for r in replies] == [r.text for r in direct])
        expect_asr("four at once", n)
        print(f"/api/asr × 4 at once (asyncio.gather): one dispatch of 4 in {ms:.2f} ms "
              f"({card}), launches equal to the direct transcribe_coalesced ({_launches(n)}), "
              f"tokens equal: True")
        dispatches.clear()
        await asyncio.gather(*(app.asr(state, {}, wav44) for _ in range(4)))
        print(f"/api/asr × 4 at once with the 44.1 kHz stereo WAV (each decoded on the event "
              f"loop first): dispatches {dispatches}")

        dispatches.clear()
        for query, body, needle in (({"beam_size": "99"}, wav44, "beam"),
                                    ({"force_language": "yue"}, wav44, "large-v3"),
                                    ({"force_language": "xx"}, wav44, "Invalid force_language"),
                                    ({}, b"these bytes are no audio", "Invalid audio")):
            rep, n, ms = await _counted_async(every, app.asr(state, query, body))
            expect(f"refused {query}: {rep.status} {rep.json} {n} depth "
                   f"{state.executor.queue_depth} {dispatches}",
                   rep.status == 400 and needle in rep.json["error"] and not any(n.values())
                   and state.executor.queue_depth == 0 and dispatches == [])
            print(f"/api/asr refused {query or 'no audio'}: 400 {rep.json['error']!r} in "
                  f"{ms:.3f} ms, 0 launches, queue depth 0, nothing dispatched")

        # /api/willow
        want_raw = direct_one(load_audio(raw, **raw_kw), beam_size=beam)
        rep, n, ms = await _counted_async(every, app.willow(state, {"stats": "true"},
                                                            pcm_headers, raw))
        expect(f"/api/willow pcm {rep.status} {rep.json}", rep.status == 200
               and set(rep.json) == ASR_FIELDS and rep.json["text"] == want_raw.text)
        expect_asr("/api/willow pcm", n)
        print(f"/api/willow (raw s16le 16 kHz, x-audio-* headers, stats): {ms:.2f} ms ({card}), "
              f"text equal to engine.transcribe: True; launches: {_launches(n)}")
        rep, n, ms = await _counted_async(every, app.willow(
            state, {"save_audio": "true"}, {"x-audio-codec": "wav"}, wav44))
        with open(state.save_audio_path, "rb") as f:
            saved = f.read()
        expect(f"/api/willow save_audio {rep.status} {rep.json}", rep.status == 200
               and set(rep.json) == {"language", "text"} and rep.json["text"] == want44.text
               and saved == pcm_to_wav_bytes(audio44)
               and load_audio(saved).shape == audio44.shape)
        expect_asr("/api/willow wav", n)
        print(f"/api/willow?save_audio=true (WAV): {ms:.2f} ms; {len(saved)} bytes written to "
              f"the temporary static root, decoding to the request's {audio44.shape[0]} samples")

        # speaker verification: no voice enrolled yet, so none matches
        alice = pcm_to_wav_bytes(_voice_audio(4.0, 210.0, 91))
        bob = pcm_to_wav_bytes(_voice_audio(4.0, 105.0, 92))
        rep, n, ms = await _counted_async(every, app.willow(
            state, {"voice_auth": "true"}, {"x-audio-codec": "wav"}, alice))
        expect(f"unknown voice {rep.status} {rep.text} {n}", rep.status == 406
               and rep.text == "Unauthorized voice" and not any(n.values()))
        print(f"/api/willow?voice_auth=true, no voice enrolled: 406 in {ms:.2f} ms (the WavLM "
              f"embedder built at first use), no ASR launch")
        rep = await app.sv(state, {"enroll": "../x"}, alice)
        expect(f"enroll=../x {rep.status} {rep.json}", rep.status == 400
               and rep.json == {"error": "Invalid speaker name"}
               and not os.path.exists(s.sv_speaker_dir))
        sv_ms = {}
        for name, body in (("alice", alice), ("bob", bob)):
            t0 = time.perf_counter()
            rep = await app.sv(state, {"enroll": name}, body)
            sv_ms[f"enrol {name}"] = (time.perf_counter() - t0) * 1e3
            expect(f"enrol {name}: {rep.status} {rep.json}",
                   rep.status == 200 and rep.json == {"enrolled": name})
        t0 = time.perf_counter()
        rep = await app.sv(state, {}, alice)
        sv_ms["verify"] = (time.perf_counter() - t0) * 1e3
        hits = rep.json["speakers"]
        expect(f"verify {rep.status} {hits}", rep.status == 200 and next(iter(hits)) == "alice"
               and hits["alice"] >= 0.99
               and sorted(os.listdir(s.sv_speaker_dir)) == ["alice.npy", "bob.npy"])
        print(f"/api/sv: enroll=../x refused 400 before any file was written; "
              f"{', '.join(f'{k} {v:.2f} ms' for k, v in sv_ms.items())} ({card}): {hits}")
        rep, n, ms = await _counted_async(every, app.willow(
            state, {"voice_auth": "true"}, {"x-audio-codec": "wav"}, alice))
        expect(f"enrolled voice {rep.status} {rep.json}", rep.status == 200
               and set(rep.json) == ASR_FIELDS | {"voice_auth", "speaker_status"}
               and rep.json["speaker_status"] == "I heard alice say:"
               and rep.json["voice_auth"]["alice"] >= 0.99)
        expect_asr("/api/willow voice_auth", n)
        print(f"/api/willow?voice_auth=true, alice enrolled: {ms:.2f} ms, "
              f"{rep.json['speaker_status']!r} {rep.json['voice_auth']}; launches: "
              f"{_launches(n)}")

        # the WebSocket loop on phase 11's frames
        pcm = _audio_i16(3840, 330)

        async def messages():
            yield json.dumps({"type": "start", "obj": {"sample_rate": 16000, "bits": 16,
                                                       "channel": 1}})
            for i in range(0, pcm.shape[0], 320):  # 20 ms frames
                yield pcm[i:i + 320].astype("<i2").tobytes()
            yield json.dumps({"type": "stop", "obj": {}})
            yield "{not json"

        async def frames():
            return [json.loads(m) async for m in app.run_ws(app.ws_session(state, {}),
                                                             messages())]

        out, n, ms = await _counted_async(every, frames())
        expect(f"WS frames {out}", [m["type"] for m in out] == ["log", "infer", "log", "error"]
               and out[1]["obj"]["text"] == session_text
               and out[1]["obj"]["audio_duration"] == 3840)
        expect_asr("WS", n)
        print(f"/api/ws/asr (run_ws): start, 192 frames of 20 ms, stop, a malformed message → "
              f"log, infer, log, error in {ms:.2f} ms ({card}); text equal to phase 11's session "
              f"text: True; error frame {out[3]['obj']['msg'][:40]!r}; launches: {_launches(n)}")

        ping = await app.ping(state)
        st = await app.status(state)
        doc = await app.openapi(state)
        docs = await app.docs(state)
        expect(f"ping {ping.json}; status {st.json}; openapi {sorted(doc.json['paths'])}",
               ping.json == {"message": "pong"}
               and st.json["devices"] == [f"cuda:{i}" for i in range(torch.cuda.device_count())]
               and model in st.json["models_loaded"] and st.json["queue_depth"] == 0
               and len(doc.json["paths"]) == 7 and docs.content_type == "text/html")
        print(f"/api/status: devices {st.json['devices']}, models {st.json['models_loaded']}, "
              f"queue depth 0, {st.json['compiled_programs']} programs; /api/ping, "
              f"/api/openapi.json (7 paths), /api/docs answer")

    async def tts_routes():
        cap = xtts.cfg.gpt.max_audio_tokens
        voc = xtts.cfg.vocoder
        cap_bytes = 2 * (cap * voc.gpt_code_stride * voc.sample_rate // voc.input_sample_rate)
        q = {"text": TTS_TEXT, "min_audio_tokens": str(TTS_MIN_TOKENS)}
        (chunks, first, total), n, ms = await _counted_async(every, _collect(
            tts_app.tts_get(tts, dict(q, speaker="nobody"))))
        voices = (await tts_app.tts_speakers_list(tts)).json["speakers"]
        expect(f"provisioning stream: {len(chunks)} chunks, voices {voices}, launches {n}",
               voices == ["CLB", "default", "female", "male"]
               and chunks[0] == wav_stream_header(sr=voc.sample_rate)
               and sum(len(c) for c in chunks[1:]) == cap_bytes
               and n["fused_gpt_step"] == cap and n["fused_gpt_head"] == 0
               and n["int8_matmul"] == 180
               and not any(v for k, v in n.items()
                           if k not in ("fused_gpt_step", "int8_matmul")))
        print(f"/api/tts, unknown speaker, empty store: 4 built-in voices cloned and "
              f"{len(chunks) - 1} chunks streamed ({cap_bytes // 2} samples) in {ms:.2f} ms; "
              f"launches: {_launches(n)} ({card})")

        ttfc, totals = [], []
        for _ in range(5):
            (chunks, first, total), n, _ = await _counted_async(every, _collect(
                tts_app.tts_get(tts, dict(q, speaker="default"))))
            expect(f"stream launches {n}", n["fused_gpt_step"] == cap
                   and n["fused_gpt_head"] == 0 and n["int8_matmul"] == 180
                   and sum(len(c) for c in chunks[1:]) == cap_bytes)
            ttfc.append(first)
            totals.append(total)
        print(f"/api/tts (default voice, {len(TTS_TEXT)} characters, {cap} tokens): time to the "
              f"first chunk median {statistics.median(ttfc):.2f} ms "
              f"({', '.join(f'{t:.2f}' for t in ttfc)}), stream median "
              f"{statistics.median(totals):.2f} ms ({', '.join(f'{t:.2f}' for t in totals)}), "
              f"host clock ({card})")

        greedy = [dict(q, speaker=v, do_sample="false") for v in ("female", "male")]
        lone = [b"".join((await _collect(tts_app.tts_get(tts, g)))[0]) for g in greedy]
        t0 = time.perf_counter()
        together = await asyncio.gather(*(_collect(tts_app.tts_get(tts, g)) for g in greedy))
        both_ms = (time.perf_counter() - t0) * 1e3
        together = [b"".join(c[0]) for c in together]
        expect(f"two concurrent greedy streams equal to their lone runs: "
               f"{[a == b for a, b in zip(together, lone)]}",
               together == lone and lone[0] != lone[1]
               and all(len(b) == 44 + cap_bytes for b in lone))
        print(f"/api/tts × 2 at once (do_sample=false, voices female and male): "
              f"{both_ms:.2f} ms, each stream's bytes equal to its lone run: True")

        upload = pcm_to_wav_bytes(CLONE_AUDIO)
        t0 = time.perf_counter()
        rep = await tts_app.tts_enroll(tts, {"speaker": "carol"}, upload)
        enrol_ms = (time.perf_counter() - t0) * 1e3
        expect(f"enrol {rep.status} {rep.json}", rep.status == 200
               and rep.json == {"speaker": "carol", "status": "saved"})
        t0 = time.perf_counter()
        rep = await tts_app.clone_speaker(tts, upload)
        clone_ms = (time.perf_counter() - t0) * 1e3
        lat = np.asarray(rep.json["gpt_cond_latent"], np.float32)
        emb = np.asarray(rep.json["speaker_embedding"], np.float32)
        expect(f"clone {lat.shape} {emb.shape}", rep.status == 200
               and lat.shape == (xtts.cfg.cond_len, xtts.cfg.gpt.d_model)
               and emb.shape == (voc.cond_dim,) and np.isfinite(lat).all())
        chunks, first, total = await _collect(tts_app.tts_stream(
            tts, dict(rep.json, text="Hello from the cloned voice.", language="en")))
        listed = (await tts_app.tts_speakers_list(tts)).json["speakers"]
        expect(f"/tts_stream {len(chunks)} chunks; speakers {listed}",
               chunks[0][:4] == b"RIFF" and len(chunks) >= 2
               and listed == ["CLB", "carol", "default", "female", "male"])
        print(f"POST /api/tts?speaker=carol (6 s upload): {enrol_ms:.2f} ms; "
              f"POST /clone_speaker: {clone_ms:.2f} ms, latents {lat.shape}; "
              f"POST /tts_stream in that voice: "
              f"{len(chunks) - 1} chunks, first at {first:.2f} ms, {total:.2f} ms; the speakers "
              f"list {listed} ({card})")

    async def run():
        state.executor.start()
        try:
            await asr_routes()
            await tts_routes()
        finally:
            state.executor.shutdown()

    engine.transcribe, engine.transcribe_coalesced = one, many
    try:
        asyncio.run(run())
    finally:
        del engine.transcribe, engine.transcribe_coalesced
        shutil.rmtree(root, ignore_errors=True)

    for cmd in ("run", "run-tts"):
        res = subprocess.run([sys.executable, "-m", "wis_tpu_torch.cli", cmd, "--help"],
                             cwd=REPO, capture_output=True, text=True, timeout=120)
        expect(f"cli {cmd} --help: {res.returncode} {res.stderr[-2000:]}",
               res.returncode == 0 and "--device" in res.stdout)
    expect("aiohttp imported by the cores", "aiohttp" not in sys.modules)
    print("python -m wis_tpu_torch.cli run --help, run-tts --help: exit 0; aiohttp imported: "
          "False")


# --------------------------------------------------------------------------- #
# Phase 13: every further Whisper size on the card
# --------------------------------------------------------------------------- #
def size_launches(cfg, detect):
    """The kernel launches one single-window request on ``cfg`` must make on
    the fused path: LayerNorm 2·L_enc + 1 (two a layer and ln_post), packed
    flash L_enc, int8_matmul 10·L_dec (the 2 cross-KV products and the
    prefill's 8 a decoder layer) plus 8·L_dec for the detection pass."""
    return dict(layer_norm_cuda=2 * cfg.n_audio_layer + 1,
                flash_attention_packed=cfg.n_audio_layer,
                int8_matmul=10 * cfg.n_text_layer + 8 * cfg.n_text_layer * detect)


def check_size(torch, dev, size, counters):
    """One further Whisper size at its published widths with the production
    settings (bf16, int8 weights, cross-KV and logits table, the fused
    decode path), seeded weights through ``ModelRegistry``: its kernels
    held to their plain versions at its shapes (LayerNorm and packed flash
    at D, int8_matmul at its cross-KV, MLP and decode rows, the fused step
    at BK 1, 5 and 13 windows of 1, the logits head at BK 1 (k 1 and 6) and
    5, plain and grammar mode), the encoder held to the f32 one as phase 6 holds
    large-v2's, then a 3.84 s request at beam 1, at beam 5 and with
    detection, each with the counters set to 0 just before and read just
    after and checked against ``size_launches``. Evicted at the end.
    → {request: launches}."""
    from wis_tpu_torch.ops.flash import flash_attention_packed
    from wis_tpu_torch.ops.layernorm import layer_norm_cuda
    from wis_tpu_torch.runtime.engine import WhisperEngine
    from wis_tpu_torch.runtime.residency import ModelRegistry
    from wis_tpu_torch.settings import APISettings

    settings = APISettings(whisper_model_default=size, beam_size=5, long_beam_size=5,
                           quant="int8", xa_quant="int8", fused_decode="auto")
    engine = WhisperEngine(ModelRegistry(settings, dev))
    t0 = time.perf_counter()
    loaded = engine.registry.get(size)
    packed = engine._packed_decoder(loaded)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg = loaded.cfg
    D, H, L = cfg.n_audio_state, cfg.n_audio_head, cfg.n_text_layer
    expect(f"{size}: tok_emb_q in the tree", "tok_emb_q" in loaded.params["decoder"])
    errs = {}
    errs["layer_norm"] = layer_norm_case(torch, dev, D, seed=D)[3]
    errs["flash_attention_packed"] = max(flash_case(torch, dev, H, trap, D + trap, d=D)[3]
                                         for trap in (False, True))
    errs["int8_matmul"] = max(int8_case(torch, dev, m, k, n)[3] for m, k, n in
                              ((1500, D, D), (13 * 1500, D, D), (5, D, 4 * D), (5, 4 * D, D),
                               (1, D, 4 * D), (20, D, D)))
    cases = tuple((128, True, trap, n_seq, beams) for n_seq, beams in ((1, 1), (1, 5), (13, 1))
                  for trap in (False, True))
    errs["fused_decode_step (‖Δ‖/‖plain‖)"] = check_fused_step(torch, dev, cfg, packed, cases,
                                                               timed=False)[1]
    errs["fused_logits_topk"] = max(check_fused_head(torch, dev, cfg, bk, k)
                                    for bk, k in ((1, 1), (1, 6), (5, 6)))
    errs["fused_logits_topk(grammar)"] = check_grammar_head(torch, dev, cfg, ((1, 1), (5, 6)),
                                                            int8s=(True,))
    _, got, ref, exact, launched = encode_three_ways(
        torch, dev, loaded, (layer_norm_cuda, flash_attention_packed))
    err, floor = encoder_rel(got, ref, exact)
    print(f"encode {size} (1,1500,{D}): launches layer_norm_cuda {launched[0]}, "
          f"flash_attention_packed {launched[1]}; kernels vs plain max|Δ| "
          f"{float((got - ref).abs().max()):.3e}; relative ‖Δ‖ to the f32 encoder: kernels "
          f"{err:.3e}, plain bf16 {floor:.3e} (tolerance 1.5 × plain)")
    want_enc = size_launches(cfg, False)
    if not (err <= 1.5 * floor and launched == [want_enc["layer_norm_cuda"],
                                                 want_enc["flash_attention_packed"]]):
        raise AssertionError(f"{size} encoder: {err} against 1.5 × {floor}, launches {launched}")

    out, ms = {}, {}
    for name, beam, detect in (("beam1", 1, False), ("beam5", 5, False), ("detect", 5, True)):
        def call(beam=beam, detect=detect):
            return engine.transcribe(_audio_i16(3840, 50 + beam), beam_size=beam, max_tokens=32,
                                     detect_language=detect)

        call()  # warm-up: the same request
        res, n, tok = request(torch, dev, counters, f"{size} request 3.84s beam{beam} cap32 "
                              f"detect={detect}", call)
        want = size_launches(cfg, detect)
        expect(f"{size} {name} launches {n} against {want}",
               all(n[k] == v for k, v in want.items()) and n["flash_attention"] == 0
               and n["fused_decode_step"] == n["fused_logits_topk"] >= max(1, tok[0] - 1)
               and n["ancestry_attention"] == n["fused_logits_topk(grammar)"] == 0)
        expect(f"{size} {name}: {tok} tokens, {res[0].audio_duration_ms} ms",
               1 <= tok[0] <= 32 and res[0].audio_duration_ms == 3840)
        out[name], ms[name] = n, res[0].infer_time_ms
    print(f"size {size}: D {D}, H {H}, L_enc {cfg.n_audio_layer}, L_dec {L}, n_mels "
          f"{cfg.n_mels}, V {cfg.n_vocab}; loaded in {load_s:.2f} s; max|Δ| to plain: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; encoder {err:.3e} (plain {floor:.3e}); launches "
          + "; ".join(f"{name}: " + ", ".join(f"{k} {n[k]}" for k in (
              "layer_norm_cuda", "flash_attention_packed", "int8_matmul", "fused_decode_step",
              "fused_logits_topk")) for name, n in out.items())
          + "; infer ms " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()))
    expect(f"{size} evicted", engine.registry.evict(size))
    del engine, loaded, packed
    torch.cuda.empty_cache()
    return out


def check_sizes(torch, dev, counters):
    """Phase 13: every entry of WHISPER_CONFIGS but large-v2 (phases 4-6)
    through ``check_size``, after holding ``size_launches`` to phase 5's
    large-v2 counts. → {size: {request: launches}}."""
    from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS

    large = WHISPER_CONFIGS["large-v2"]
    expect("size_launches(large-v2) against phase 5's counts",
           list(size_launches(large, False).values()) == [MIN_LN, MIN_FLASH, INT8_CALL]
           and size_launches(large, True)["int8_matmul"] == INT8_CALL + INT8_PASS)
    sizes = [n for n in WHISPER_CONFIGS if n not in ("large", "large-v2")]
    return {size: check_size(torch, dev, size, counters) for size in sizes}


# --------------------------------------------------------------------------- #
# Phase 14: the port's bench; phase 15: entry(), check and check-edge
# --------------------------------------------------------------------------- #
#: phase 14's repeats (the bench's own: 10 after 2, long-form and TTS 5 after 1)
BENCH_REPEATS = dict(RUNS=3, WARMUP=1, LONG_RUNS=2, LONG_WARMUP=1, TTS_RUNS=2, TTS_WARMUP=1)


def check_bench(torch, dev, counters, tts_counters):
    """Phase 14: ``wis_tpu_torch.bench.main(["--device", "cuda"])`` in this
    process at BENCH_REPEATS: eight rows then the summary, every line JSON,
    every value finite and positive, the summary's card name and power
    limit; the long-form row one dispatch of 13 windows through the fused
    step at BK 13 (base's launches a request, the programs it built), the
    TTS row through the fused GPT step. → the rows."""
    import io

    from wis_tpu_torch import bench
    from wis_tpu_torch.runtime.engine import WhisperEngine

    programs = []
    real_program = WhisperEngine._program

    def spy_program(self, model, **kw):
        prog, fused = real_program(self, model, **kw)
        programs.append((model.name, kw["beam"], kw["batch"], fused, kw["chunked"]))
        return prog, fused

    row_launches = {}

    def counted(name, fn, cs):
        def run(*a, **kw):
            for c in cs:
                c.launches = 0
            fn(*a, **kw)
            row_launches[name] = {c.__name__: c.launches for c in cs}
        return run

    buf = io.StringIO()
    patches = [mock.patch.object(bench, k, v) for k, v in BENCH_REPEATS.items()]
    patches += [mock.patch.object(WhisperEngine, "_program", spy_program),
                mock.patch.object(bench, "_longform_row",
                                  counted("long", bench._longform_row, counters)),
                mock.patch.object(bench, "_tts_row",
                                  counted("tts", bench._tts_row, tts_counters)),
                contextlib.redirect_stdout(buf)]
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        rc = bench.main(["--device", "cuda"])
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        print(f"bench: {line}")
    print(f"bench: rc {rc}, {len(lines)} lines in {time.perf_counter() - t0:.1f} s")
    rows = [json.loads(line) for line in lines]
    expect(f"bench printed {len(rows)} lines, rc {rc}", rc == 0 and len(rows) == 9)
    metrics = [c[0] for c in bench.CONFIGS] + ["large-v2_beam5_batch4_throughput_req_s",
                                               "base_beam1_180s_realtime_x", "xtts_stream_rtf"]
    expect(f"bench rows {[r.get('metric') for r in rows]}",
           [r["metric"] for r in rows[:8]] == metrics and rows[8]["metric"] == metrics[0])
    expect("bench values finite and positive",
           all(np.isfinite(r["value"]) and r["value"] > 0 for r in rows))
    summary = rows[8]
    expect(f"bench summary {summary}", [r["metric"] for r in summary["rows"]] == metrics
           and summary["device"]["name"] and summary["device"]["power_limit"])
    long_n = row_launches["long"]
    base_cfg = dict(layer_norm_cuda=13, flash_attention_packed=6, int8_matmul=60)
    repeats = BENCH_REPEATS["LONG_RUNS"] + BENCH_REPEATS["LONG_WARMUP"]
    long_programs = {p for p in programs if p[0] == "base"}
    print(f"bench long-form row: launches {long_n} over {repeats} requests; programs "
          f"{sorted(long_programs)}")
    expect(f"long-form row: one dispatch of 13 windows a request ({long_n}, {long_programs})",
           all(long_n[k] == v * repeats for k, v in base_cfg.items())
           and long_programs == {("base", 1, 13, True, True)}
           and long_n["fused_decode_step"] == long_n["fused_logits_topk"] >= repeats)
    tts_n = row_launches["tts"]
    print(f"bench TTS row: launches {tts_n}")
    expect(f"TTS row through the fused GPT step: {tts_n}",
           tts_n["fused_gpt_step"] >= 140 * (BENCH_REPEATS["TTS_RUNS"]
                                            + BENCH_REPEATS["TTS_WARMUP"])
           and tts_n["fused_gpt_head"] == 0)
    return rows


def check_entry_points(torch, dev, counters):
    """Phase 15: ``wis_tpu_torch.entry.entry()`` on the card (finite
    (1, 51865) step logits, the encoder's 65 LayerNorm and 32 packed flash
    launches, counted from 0 just before the forward), then ``python -m
    wis_tpu_torch.cli check`` and ``check-edge`` as a user runs them, each
    exit 0."""
    from wis_tpu_torch.entry import entry

    forward, args = entry()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    logits = forward(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    n = {c.__name__: c.launches for c in counters}
    finite = bool(torch.isfinite(logits).all())
    print(f"entry(): step logits {tuple(logits.shape)} {logits.dtype} on {logits.device}, "
          f"finite {finite}, {ms:.1f} ms; launches "
          + ", ".join(f"{k} {v}" for k, v in n.items()))
    expect(f"entry() logits {tuple(logits.shape)} finite {finite}, launches {n}",
           tuple(logits.shape) == (1, 51865) and finite and n["layer_norm_cuda"] == MIN_LN
           and n["flash_attention_packed"] == MIN_FLASH)
    del forward, args, logits
    torch.cuda.empty_cache()
    for sub in (["check"], ["check-edge"]):
        cmd = [sys.executable, "-m", "wis_tpu_torch.cli", *sub]
        res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
        print(f"{' '.join(cmd[1:])}: exit {res.returncode}")
        for line in res.stdout.strip().splitlines():
            print(f"  {line}")
        if res.returncode != 0:
            raise AssertionError(f"{' '.join(cmd[1:])} failed: {res.stderr[-3000:]}")


# --------------------------------------------------------------------------- #
# Phase 16: tensor and data parallelism, two ranks on the one card
# --------------------------------------------------------------------------- #
#: launches one rank makes for a 3.84 s beam-5 request through the eager
#: tensor-parallel decoder, as the single-rank eager request (phase 5):
#: (LayerNorm, packed flash, int8_matmul per request, int8_matmul and
#: ancestry_attention per decode step) — 2·L_enc+1, L_enc, 10·L_dec,
#: 8·L_dec and L_dec
MESH_PREDICTED = {"large-v2": (65, 32, 320, 256, 32), "medium": (49, 24, 240, 192, 24)}
#: XTTS v2's eager GPT: six int8 products a layer, for the prefill and each token
XTTS_INT8_PASS = 6 * 30
#: the shard shapes of the kernels on the 2-way path (each rank's half of
#: large-v2's heads and hidden width; XTTS v2's GPT at one stream)
MESH_INT8_SHAPES = ((1500, 1280, 640), (5, 1280, 640), (5, 640, 1280), (5, 1280, 2560),
                    (5, 2560, 1280), (1, 1024, 512), (1, 512, 1024), (1, 1024, 2048),
                    (1, 2048, 1024))
#: the row-parallel products among them (large-v2's o_w and w2, XTTS v2's
#: proj_w and mlp_w2): ``parallel/axis.row_parallel`` asks the kernel for
#: its f32 store, the partial sums the ranks reduce
MESH_INT8_ROW = {(5, 640, 1280), (5, 2560, 1280), (1, 512, 1024), (1, 2048, 1024)}


def check_shard_kernels(torch, dev):
    """Each kernel the 2-way path launches, held to its plain version at a
    rank's shapes and timed beside its bound and library call: LayerNorm
    over the replicated (1, 1500, 1280) rows, packed flash on 10 heads of
    64 (1, 1500, 640), standard and trap inputs, int8_matmul at every
    MESH_INT8_SHAPES product (the row-parallel ones with the f32 store
    their partial sums take), ancestry_attention at BK 5 over 10 heads to
    the request's last position (T 36, pos 35), and the logits head on one
    rank's half of large-v3's vocabulary, (5, 1280)·(25933, 1280) bf16.
    → {row name: row numbers}."""
    from wis_tpu_torch.models.whisper.config import WhisperConfig
    from wis_tpu_torch.ops.decode_attn import ancestry_attention, ancestry_attention_plain
    from wis_tpu_torch.ops.flash import flash_attention_packed, flash_attention_packed_plain
    from wis_tpu_torch.ops.fused_logits import fused_logits_topk, fused_logits_topk_plain
    from wis_tpu_torch.ops.layernorm import layer_norm_cuda, layer_norm_plain
    from wis_tpu_torch.ops.quant import int8_matmul, int8_matmul_plain

    rows = {}
    x, g, b, err = layer_norm_case(torch, dev, 1280, seed=16)
    bound_ms, bound_by = _bound(2 * x.numel() * 2 + 2 * 1280 * 4, 8 * x.numel(), F32_FLOPS)
    rows["layer_norm"] = dict(
        max_abs_err=err, ms=_median_ms(lambda: layer_norm_cuda(x, g, b)),
        plain_ms=_median_ms(lambda: layer_norm_plain(x, g, b)), bound_ms=bound_ms,
        bound_by=bound_by, library_ms=_median_ms(lambda: torch.nn.functional.layer_norm(
            x, (1280,), g.bfloat16(), b.bfloat16())))

    errs = [flash_case(torch, dev, 10, trap, 160 + trap, d=640)[3] for trap in (True, False)]
    q, k, v, _ = flash_case(torch, dev, 10, False, 160, d=640)
    qh, kh, vh = (t.view(1, 1500, 10, 64).transpose(1, 2) for t in (q, k, v))
    bound_ms, bound_by = _bound(4 * q.numel() * 2, 4 * 1500 * 1500 * 640, BF16_FLOPS)
    rows["flash_attention_packed"] = dict(
        max_abs_err=max(errs), ms=_median_ms(lambda: flash_attention_packed(q, k, v, 10)),
        plain_ms=_median_ms(lambda: flash_attention_packed_plain(q, k, v, 10)),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=_median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh)))

    for m, k_, n in MESH_INT8_SHAPES:
        # a row-parallel product runs as row_parallel runs it: bf16 x, the
        # f32 store, held to the plain version's f32 result
        od = torch.float32 if (m, k_, n) in MESH_INT8_ROW else None
        xi, qi, si, err = int8_case(torch, dev, m, k_, n, od)
        wb = qi.to(torch.bfloat16) * si.to(torch.bfloat16)
        out_bytes = 4 if od is not None else 2
        bound_ms, bound_by = _bound(m * k_ * 2 + k_ * n + n * 4 + m * n * out_bytes,
                                    2 * m * k_ * n, BF16_FLOPS)
        rows[f"int8_matmul {m}x{k_}x{n}{' f32 store' if od is not None else ''}"] = dict(
            max_abs_err=err, ms=_median_ms(lambda: int8_matmul(xi, qi, si, od)),
            plain_ms=_median_ms(lambda: int8_matmul_plain(xi, qi, si, od), reps=5, replays=5),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=_median_ms(lambda: torch.mm(xi, wb, out_dtype=od) if od is not None
                                  else torch.mm(xi, wb)))

    # the request's cache (4 prompt + 32 positions) at its last step; the
    # trap with four unwritten columns past pos
    bk, pos, heads = 5, 35, 10
    errs = []
    for trap, t in ((True, 40), (False, 36)):
        qa, kc, vc, anc = _anc_inputs(torch, dev, bk, t, pos, trap, seed=161 + trap, heads=heads)
        got, want = ancestry_attention(qa, kc, vc, anc, pos), ancestry_attention_plain(
            qa, kc, vc, anc, pos)
        r = want.float()
        d = (got.float() - r).abs()
        bad = int((d > 2 * _bf16_ulp(r) + 2.0 ** -8 * float(r.abs().max())).sum())
        print(f"ancestry_attention BK={bk} H={heads} Dh=64 T={t} pos={pos}"
              f"{' trap' if trap else ''}: max|Δ| {float(d.max()):.3e} ({bad} elements over "
              f"2 bf16 ulps + 2^-8·max|plain|)")
        expect(f"ancestry_attention at a rank's heads{' (trap)' if trap else ''}",
               bad == 0 and float(got.float().abs().max()) < 100)
        errs.append(float(d.max()))
    n_pos = pos + 1
    bound_ms, bound_by = _bound(2 * bk * heads * 64 * n_pos * 2 + bk * n_pos * 4
                                + 2 * bk * heads * 64 * 2, 4 * bk * heads * 64 * n_pos, F32_FLOPS)
    rows["ancestry_attention"] = dict(
        max_abs_err=max(errs), ms=_median_ms(lambda: ancestry_attention(qa, kc, vc, anc, pos)),
        plain_ms=_median_ms(lambda: ancestry_attention_plain(qa, kc, vc, anc, pos), reps=5,
                            replays=5),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)

    shard = WhisperConfig(name="large-v3-vocab-shard", n_vocab=51866 // 2, n_text_state=1280)
    case = head_case(torch, dev, shard, 5, False, False)
    args, kw = case["args"], case["kw"]
    got, want = fused_logits_topk(*args, **kw), fused_logits_topk_plain(*args, **kw)
    err = float((got[0] - want[0]).abs().max())
    print(f"{case['name']} (a rank's half of large-v3's vocabulary): values max|Δ| "
          f"{err:.3e}, lse max|Δ| {float((got[2] - want[2]).abs().max()):.3e} "
          f"(tolerance {HEAD_ATOL})")
    expect(f"{case['name']}: kernel disagrees with plain", head_agrees(got, want, False))
    bound_ms, bound_by = head_bound(shard, 5, False, False)
    rows["fused_logits_topk"] = dict(
        max_abs_err=err, ms=_median_ms(lambda: fused_logits_topk(*args, **kw)),
        plain_ms=_median_ms(lambda: fused_logits_topk_plain(*args, **kw), reps=5, replays=5),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    for name, row in rows.items():
        print(f"shard shape {name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"library {row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 4)}"
              f" ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


def _mesh_request_lines(name, stages, predicted=None):
    """Print one full-width stage per rank and hold it: launches (beside
    the single-rank request's and the prediction), tokens equal on every
    rank, host ms beside the single-rank request's, the teacher-forced
    logits' distance at every position. → the stage's rank reports."""
    from wis_tpu_torch.entry import ROW_MISMATCH_MAX, TF_REL_TOL

    ref = next(st for st in stages if "tf_rel" in st)
    for rank, st in enumerate(stages):
        print(f"{name} rank {rank}: {st['ms']:.2f} ms on the host clock "
              f"(single-rank eager {ref['single_ms']:.2f} ms), {st['collectives']} "
              f"collectives, launches {st['launches']}, tokens {st['tokens'].tolist()}")
    print(f"{name} single rank: launches {ref['single_launches']}, tokens "
          f"{ref['single_tokens'].tolist()}")
    same = all(np.array_equal(st["tokens"], stages[0]["tokens"]) for st in stages)
    rel = np.asarray(ref["tf_rel"])
    print(f"{name}: every rank's tokens equal: {same}; tokens equal to the single rank's: "
          f"{np.array_equal(stages[0]['tokens'], ref['single_tokens'])}; teacher-forced "
          f"logits over {ref['tf_positions']} positions: ‖Δ‖/‖single‖ max {rel.max():.3e}, "
          f"median {np.median(rel):.3e} (tolerance {TF_REL_TOL}), max|Δ| "
          f"{ref['tf_max_abs']:.3e}, argmax equal at {ref['tf_argmax_equal']:.3f} of them")
    expect(f"{name}: the ranks' tokens equal", same)
    expect(f"{name}: teacher-forced logits within {TF_REL_TOL}", rel.max() <= TF_REL_TOL)
    for k, r in ref["row_parallel"].items():
        print(f"{name} row-parallel {k} (layer 0, bf16 x): {r['frac']:.3e} of the elements "
              f"off the single-rank product (at most {ROW_MISMATCH_MAX}), max|Δ| "
              f"{r['max_abs']:.3e}; partial sums rounded to bf16 before the reduce (the "
              f"control) {r['ctl_frac']:.3e}")
        expect(f"{name} row-parallel {k}: {r}", r["frac"] <= ROW_MISMATCH_MAX < r["ctl_frac"])
    if predicted:
        ln, fl, per_req, per_step, anc = predicted
        for rank, st in enumerate(stages):
            n = st["launches"]
            steps = n["ancestry_attention"] // anc
            ok = (n["layer_norm_cuda"] == ln and n["flash_attention_packed"] == fl
                  and n["ancestry_attention"] == anc * steps
                  and n["int8_matmul"] == per_req + per_step * steps
                  and n == ref["single_launches"])
            print(f"{name} rank {rank}: prediction LayerNorm {ln}, packed flash {fl}, "
                  f"ancestry_attention {anc} a step, int8_matmul {per_req} + {per_step} a "
                  f"step, the single rank's counts: {steps} steps, held {ok}")
            expect(f"{name} rank {rank} launches {n}", ok)
    return stages


def check_mesh(torch, dev, card):
    """Phase 16: ``wis_tpu_torch.entry.dryrun_multichip(2)`` — two ranks on
    the one card over gloo, a 1×2 mesh — then each stage's numbers per
    rank, and the kernels at a rank's shapes (``check_shard_kernels``).
    → (the dryrun's report, the shard rows)."""
    from wis_tpu_torch.entry import VOCAB_HEAD_CASES, dryrun_multichip

    print(f"phase 16 on {card}")
    t0 = time.perf_counter()
    report = dryrun_multichip(2)
    ranks = report["ranks"]
    print(f"mesh {report['mesh']}, backend {report['backend']}, ranks "
          f"{[(r['rank'], r['coords'], r['device']) for r in ranks]}, dryrun "
          f"{time.perf_counter() - t0:.1f} s")
    _mesh_request_lines("large-v2 TP 2 3.84s beam5 cap32", [r["large-v2"] for r in ranks],
                        MESH_PREDICTED["large-v2"])
    _mesh_request_lines("medium TP 2 3.84s beam5 cap8", [r["medium"] for r in ranks],
                        MESH_PREDICTED["medium"])
    xtts = _mesh_request_lines("xtts v2 GPT TP 2 prefill + 20 greedy tokens",
                               [r["xtts"]["full"] for r in ranks])
    for rank, st in enumerate(xtts):
        want = XTTS_INT8_PASS * (1 + st["chunk"])
        print(f"xtts v2 rank {rank}: int8_matmul {st['launches']['int8_matmul']} against "
              f"{XTTS_INT8_PASS} for the prefill + {XTTS_INT8_PASS} a token = {want}")
        expect(f"xtts v2 rank {rank} int8_matmul", st["launches"]["int8_matmul"] == want)
    ref = next(st for st in xtts if "tf_hidden_rel" in st)
    print(f"xtts v2 teacher-forced latents ‖Δ‖/‖single‖ max "
          f"{float(np.max(ref['tf_hidden_rel'])):.3e}")
    for name in VOCAB_HEAD_CASES:
        for rank, r in enumerate(ranks):
            h = r["vocab_head"][name]
            same = np.array_equal(h["tok"], h["ref_tok"])
            print(f"vocab-sharded head {name} rank {rank} (D {h['d']}, V {h['v']}, "
                  f"{h['v'] // 2} a shard, BK {h['bk']}, k {h['k']}): ids equal to the whole "
                  f"head's {same}, values and lse max|Δ| {h['max_abs_err']:.3e} (tolerance "
                  f"1e-5), fused_logits_topk launches {h['launches']['fused_logits_topk']}")
            expect(f"vocab-sharded head {name}", same and h["max_abs_err"] <= 1e-5)
    rows = check_shard_kernels(torch, dev)
    return report, rows


class PhaseClock:
    """Prints each phase's seconds as it ends."""

    def __init__(self):
        self.start = self.mark = time.perf_counter()

    def done(self, phase):
        now = time.perf_counter()
        print(f"phase {phase}: {now - self.mark:.1f} s (total {now - self.start:.1f} s)",
              flush=True)
        self.mark = now


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout of this repo (the parent commit's "
                    "files): time its kernels and decode steps beside this tree's")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from wis_tpu_torch.device import resolve_device
    from wis_tpu_torch.ops import _build
    from wis_tpu_torch.ops.flash import flash_attention, flash_attention_packed
    from wis_tpu_torch.models.xtts.model import XTTSModel
    from wis_tpu_torch.ops.fused_decode import fused_decode_step
    from wis_tpu_torch.ops.fused_gpt import fused_gpt_step
    from wis_tpu_torch.ops.fused_gpt_head import fused_gpt_head
    from wis_tpu_torch.ops.fused_logits import fused_logits_topk
    from wis_tpu_torch.ops.decode_attn import ancestry_attention
    from wis_tpu_torch.ops.layernorm import layer_norm_cuda
    from wis_tpu_torch.ops.quant import int8_matmul
    from wis_tpu_torch.runtime.engine import WhisperEngine
    from wis_tpu_torch.runtime.residency import ModelRegistry
    from wis_tpu_torch.settings import APISettings

    dev = resolve_device("cuda")
    clock = PhaseClock()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}"
    )

    clock.done(1)
    t0 = time.perf_counter()
    _build.kernels()
    print(f"kernels built/loaded from {_build.library_path()} in "
          f"{time.perf_counter() - t0:.2f} s")
    print_ptxas()
    clock.done(2)

    ln = check_layer_norm(torch, dev)
    fl = check_flash(torch, dev)
    hm = check_head_major_flash(torch, dev)
    i8 = check_int8_matmul(torch, dev)
    if args.parent:
        compare_with_parent(torch, dev, args.parent)
    anc = check_ancestry_attention(torch, dev)
    clock.done(3)

    settings = APISettings(
        whisper_model_default="large",
        beam_size=5,
        long_beam_size=5,  # the bench rows fix the beam per row
        quant="int8",
    )
    engine = WhisperEngine(ModelRegistry(settings, dev))
    t0 = time.perf_counter()
    loaded = engine.registry.get("large")
    packed = engine._packed_decoder(loaded)
    torch.cuda.synchronize()
    print(
        f"large-v2 seeded random int8 weights on {dev}: "
        f"{loaded.param_bytes / 2**30:.3f} GiB, packed decoder "
        f"{sum(t.numel() * t.element_size() for t in packed) / 2**30:.3f} GiB, "
        f"in {time.perf_counter() - t0:.2f} s"
    )
    step = check_fused_step(torch, dev, loaded.cfg, packed)[0]
    if args.parent:
        compare_steps_with_parent(torch, dev, args.parent, loaded.cfg, packed)
    head_err = check_fused_head(torch, dev, loaded.cfg)
    grammar_err = check_grammar_head(torch, dev, loaded.cfg)
    heads = time_heads(torch, dev, loaded.cfg)
    for case, err in (((5, True, False), head_err), ((5, True, True), grammar_err)):
        heads[case]["max_abs_err"] = max(heads[case]["max_abs_err"], err)
    if args.parent:
        compare_heads_with_parent(torch, dev, args.parent, loaded.cfg)
    clock.done(4)

    counters = (layer_norm_cuda, flash_attention_packed, flash_attention, int8_matmul,
                ancestry_attention, fused_decode_step, fused_logits_topk, GrammarLaunches())
    served = serve(torch, dev, engine, counters)
    clock.done(5)
    check_encode(torch, dev, loaded)
    switched_n = serve_switched(torch, dev, engine, counters)
    check_selftest(torch, dev)
    check_checkpoint_round_trip(torch, dev, settings)
    clock.done(6)

    t0 = time.perf_counter()
    xtts = XTTSModel(dev)
    torch.cuda.synchronize()
    print(f"XTTS v2 seeded random weights on {dev} (int8 GPT, fused step): packed GPT "
          f"{sum(t.numel() * t.element_size() for t in xtts.gpt_packed) / 2**30:.3f} GiB, "
          f"in {time.perf_counter() - t0:.2f} s")
    t_full = tts_full_bucket(xtts)
    gpt_step = check_fused_gpt_step(torch, dev, xtts.cfg.gpt, xtts.gpt_packed, t_full)
    if args.parent:
        compare_gpt_steps_with_parent(torch, dev, args.parent, xtts.cfg.gpt, xtts.gpt_packed,
                                      t_full)
    gpt_head = check_fused_gpt_head(torch, dev, xtts.cfg.gpt, xtts.gpt_head_packed)
    if args.parent:
        compare_gpt_head_with_parent(torch, dev, args.parent, xtts.cfg.gpt,
                                     xtts.gpt_head_packed)
    time_xtts_epilogue(torch, dev, xtts)
    clock.done(7)
    tts_counters = (fused_gpt_step, fused_gpt_head)
    stream_xtts(torch, dev, xtts, tts_counters, "warm-up", max_chunks=2)
    seeded_chunks = []
    step_n = stream_xtts(torch, dev, xtts, tts_counters,
                         f"default (fused step, pipeline_depth={xtts.pipeline_depth})",
                         chunks_out=seeded_chunks)[0]
    if not (step_n[0] == xtts.cfg.gpt.max_audio_tokens and step_n[1] == 0):
        raise AssertionError(f"default stream ran {step_n[0]} steps / {step_n[1]} heads")
    compare_pipeline_depths(torch, dev, xtts, tts_counters)
    xtts.fused_head = True
    stream_xtts(torch, dev, xtts, tts_counters, "warm-up", max_chunks=2)
    head_n = stream_xtts(torch, dev, xtts, tts_counters, "fused-head")[0]
    if not head_n[0] == head_n[1] == xtts.cfg.gpt.max_audio_tokens:
        raise AssertionError(f"fused-head stream ran {head_n[0]} steps / {head_n[1]} heads")
    xtts.fused_head = False
    eager = XTTSModel(dev, fused="off")
    eager_n = stream_xtts(torch, dev, eager, tts_counters, "eager (first 3 chunks)",
                          max_chunks=3)[0]
    if any(eager_n):
        raise AssertionError(f"the eager stream launched fused kernels: {eager_n}")
    del eager
    clock.done(8)
    check_xtts_checkpoint(torch, dev, seeded_chunks[:3], tts_counters, xtts)
    clock.done(9)

    check_conditioning(torch, dev)
    check_wavlm(torch, dev)
    clone_n = check_clone(torch, dev, xtts, tts_counters + (int8_matmul,))
    if not (clone_n[0] == xtts.cfg.gpt.max_audio_tokens and clone_n[1] == 0 and clone_n[2] > 0):
        raise AssertionError(f"the cloned-voice stream ran {clone_n[0]} steps / {clone_n[1]} "
                             f"heads / {clone_n[2]} int8_matmul")
    check_xtts_selftest_cli()
    check_sv(torch, dev)
    clock.done(10)
    session_text = check_serving(torch, dev, engine, counters, served, smi)
    clock.done(11)
    check_apps(torch, dev, engine, counters, xtts, session_text, smi)
    clock.done(12)
    del xtts
    torch.cuda.empty_cache()
    check_sizes(torch, dev, counters)
    clock.done(13)
    check_bench(torch, dev, counters, tts_counters)
    clock.done(14)
    check_entry_points(torch, dev, counters)
    clock.done(15)
    mesh_report, shard = check_mesh(torch, dev, smi)
    clock.done(16)

    rows = [
        dict(name="layer_norm", source="wis_tpu_torch/csrc/layernorm.cu",
             replaces="wis_tpu/ops/layernorm.py:38", **ln),
        dict(name="flash_attention_packed", source="wis_tpu_torch/csrc/flash_attention.cu",
             replaces="wis_tpu/ops/flash.py:121", **fl),
        dict(name="fused_decode_step", source="wis_tpu_torch/csrc/fused_decode.cu",
             replaces="wis_tpu/ops/fused_decode.py:184", **step[(128, 1)]),
        dict(name="fused_logits_topk", source="wis_tpu_torch/csrc/fused_logits.cu",
             replaces="wis_tpu/ops/fused_logits.py:48", **heads[(5, True, False)]),
        dict(name="fused_gpt_step", source="wis_tpu_torch/csrc/fused_gpt.cu",
             replaces="wis_tpu/ops/fused_gpt.py:122", **gpt_step[t_full]),
        dict(name="fused_gpt_head", source="wis_tpu_torch/csrc/fused_gpt_head.cu",
             replaces="wis_tpu/ops/fused_gpt_head.py:56", **gpt_head),
        dict(name="int8_matmul", source="wis_tpu_torch/csrc/int8_matmul.cu",
             replaces="wis_tpu/ops/quant_pallas.py:41", **i8[(1500, 1280, 1280)]),
        dict(name="ancestry_attention", source="wis_tpu_torch/csrc/ancestry_attention.cu",
             replaces="wis_tpu/ops/decode_attn.py:83", **anc[ANC_CASES[0]]),
        dict(name="fused_logits_topk(grammar)", source="wis_tpu_torch/csrc/fused_logits.cu",
             replaces="wis_tpu/ops/fused_logits.py:48", **heads[(5, True, True)]),
        dict(name="flash_attention", source="wis_tpu_torch/csrc/flash_attention.cu",
             replaces="wis_tpu/ops/flash.py:193", **hm),
        dict(name="fused_logits_topk(BK=20)", source="wis_tpu_torch/csrc/fused_logits.cu",
             replaces="wis_tpu/ops/fused_logits.py:48", **heads[(20, True, False)]),
        # phase 16: a rank's shapes on the 2-way large-v2 request, the
        # vocabulary-sharded head at large-v3's width
        dict(name="layer_norm(TP 2 rank)", source="wis_tpu_torch/csrc/layernorm.cu",
             replaces="wis_tpu/ops/layernorm.py:38", **shard["layer_norm"]),
        dict(name="flash_attention_packed(TP 2 rank, 10 heads)",
             source="wis_tpu_torch/csrc/flash_attention.cu",
             replaces="wis_tpu/ops/flash.py:121", **shard["flash_attention_packed"]),
        dict(name="int8_matmul(TP 2 rank, 1500x1280x640)",
             source="wis_tpu_torch/csrc/int8_matmul.cu",
             replaces="wis_tpu/ops/quant_pallas.py:41", **shard["int8_matmul 1500x1280x640"]),
        dict(name="ancestry_attention(TP 2 rank, 10 heads)",
             source="wis_tpu_torch/csrc/ancestry_attention.cu",
             replaces="wis_tpu/ops/decode_attn.py:83", **shard["ancestry_attention"]),
        dict(name="fused_logits_topk(vocab shard 25933)",
             source="wis_tpu_torch/csrc/fused_logits.cu",
             replaces="wis_tpu/ops/fused_logits.py:48", **shard["fused_logits_topk"]),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the whisper rows and int8_matmul count the fused ASR requests (the
    # main path); ancestry_attention the eager request, the grammar head the
    # timestamp request, head-major flash the WIS_NO_PACKED_FLASH request;
    # the GPT step the default XTTS stream, the GPT head the fused-head
    # stream, the head at BK 20 the 180 s long-form request; the phase 16
    # rows rank 0's 2-way large-v2 request and its vocabulary-sharded head
    fused = served["fused"]
    launches = [fused["layer_norm_cuda"], fused["flash_attention_packed"],
                fused["fused_decode_step"], fused["fused_logits_topk"], step_n[0], head_n[1],
                fused["int8_matmul"], served["eager"]["ancestry_attention"],
                served["timestamps"]["fused_logits_topk(grammar)"],
                switched_n["WIS_NO_PACKED_FLASH"]["flash_attention"],
                served["long"]["fused_logits_topk"]]
    tp0 = mesh_report["ranks"][0]["large-v2"]["launches"]
    launches += [tp0["layer_norm_cuda"], tp0["flash_attention_packed"], tp0["int8_matmul"],
                 tp0["ancestry_attention"],
                 mesh_report["ranks"][0]["vocab_head"]["large-v3"]["launches"]["fused_logits_topk"]]
    for row, n in zip(rows, launches):
        row.update(route="cuda", launches=n)
    print(json.dumps({"kernels": [{key: row[key] for key in keys} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
