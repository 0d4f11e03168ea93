#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``wis_tpu_torch``) once on one NVIDIA GPU.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without printing a result:

1. require a CUDA device; print the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit``);
2. build the hand-written kernels from ``wis_tpu_torch/csrc`` (one nvcc per
   source, in parallel, into ``build/wis_tpu_torch/``) and print the build
   seconds;
3. hold each encoder kernel against its plain PyTorch version on the card,
   in bf16, at the encoder's shapes (flash also on inputs that expose an
   unmasked ragged key tile), and time kernel, plain version and the
   PyTorch library call that computes the same function;
4. load large-v2 with seeded random int8 weights; hold the fused decode
   step (all 32 layers, BK=5, caches of 128 and 256 positions, int8 and
   bf16 cross-KV) and the fused logits head (V=51865, bf16 and int8
   embedding) against their plain versions, on standard inputs and on
   trap inputs that a kernel reading a masked column, ignoring the
   suppress mask or breaking a tie the wrong way fails; time both;
5. serve a large-v2 beam-5 request through the eager decoder
   (``fused_decode="off"``), then the main path: the bench shapes 3.84 s /
   10.7 s / 29.2 s with 32 / 64 / 100 tokens plus one language-detect
   request with ``fused_decode="auto"`` (the fused path on the card),
   every kernel launch counter set to 0 just before each path and read
   just after;
6. run the large-v2 encoder with the kernels and again with the plain
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
#: the H100's published peaks (SXM, dense, at 700 W): device memory, bf16
#: tensor cores, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
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


def _bound(n_bytes, ops, flops_per_s):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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
    gb, bb = g.bfloat16(), b.bfloat16()
    library_ms = _median_ms(lambda: torch.nn.functional.layer_norm(x, (1280,), gb, bb))
    bound_ms, bound_by = _bound(2 * x.numel() * 2 + 2 * 1280 * 4, 8 * x.numel(), F32_FLOPS)
    print(
        f"layer_norm (1,1500,1280) bf16: max|Δ| {float(err.max()):.3e} "
        f"(tolerance 1 bf16 ulp of the reference + 1e-6, {bad} elements over); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, F.layer_norm {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})"
    )
    if bad:
        raise AssertionError(f"layer_norm kernel disagrees with plain on {bad} elements")
    return dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms,
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
            dh = 1280 // heads
            qh, kh, vh = (t.view(1, 1500, heads, dh).transpose(1, 2) for t in (q, k, v))
            library_ms = _median_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh)
            )
            bound_ms, bound_by = _bound(4 * q.numel() * 2, 4 * 1500 * 1500 * 1280, BF16_FLOPS)
            print(f"{case}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"scaled_dot_product_attention {library_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by})")
            if heads == 20:
                times = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=library_ms)
    return dict(max_abs_err=max(rows), **times)


#: fused step vs plain at full width: bound on ‖Δ‖/‖plain‖ of x_out and of
#: the written K/V columns
STEP_REL_NORM = 2e-2
#: the value at which a trap column's key scores and its value sits
TRAP_KEY, TRAP_VALUE = 30.0, 100.0


def _step_inputs(torch, dev, cfg, t_cache, xa_int8, trap, seed):
    """Large-v2 decode-step inputs at BK=5, the step at position
    t_cache // 2 with random beam ancestry before it. With ``trap`` every
    cache column that no row's ``sel`` picks (the stale column at pos, the
    unwritten positions after it, the beams no row descends from) holds
    keys of ±TRAP_KEY and values of TRAP_VALUE — some score ~10× above the
    real keys — and so do the cross-KV pad columns 1500..1535. A kernel
    that reads a column sel excludes, double-counts the self column or
    reads a pad column moves every output far off."""
    from wis_tpu_torch.ops.fused_decode import quantize_xa_columns

    L, D, H = cfg.n_text_layer, cfg.n_text_state, cfg.n_text_head
    bk, s_audio = 5, cfg.n_audio_ctx
    s_pad = ((s_audio + 127) // 128) * 128
    pos = t_cache // 2
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    rng = np.random.default_rng(seed)
    anc = rng.integers(0, bk, (bk, pos))
    sel = np.zeros((bk, t_cache, bk), np.float32)
    for r in range(bk):
        sel[r, np.arange(pos), anc[r]] = 1.0
    sel = torch.from_numpy(sel.reshape(bk, t_cache * bk)).to(dev)
    kc = randn(L, D, bk * t_cache, scale=0.5)
    vc = randn(L, D, bk * t_cache, scale=0.5)
    xk = randn(L, H, D // H, s_pad, scale=0.5)
    xv = randn(L, H, D // H, s_pad, scale=0.5)
    xk[..., s_audio:] = 0.0
    xv[..., s_audio:] = 0.0
    if trap:
        excluded = sel.sum(dim=0) == 0
        kc[:, :, excluded] = TRAP_KEY * torch.sign(randn(L, D, int(excluded.sum())))
        vc[:, :, excluded] = TRAP_VALUE
        xk[..., s_audio:] = TRAP_KEY * torch.sign(randn(L, H, D // H, s_pad - s_audio))
        xv[..., s_audio:] = TRAP_VALUE
    kc, vc, xk, xv = (t.to(torch.bfloat16) for t in (kc, vc, xk, xv))
    xs = None
    if xa_int8:
        xk, xv, xs = quantize_xa_columns(xk, xv)
    x_emb = randn(bk, D, scale=0.5)
    return dict(x_emb=x_emb, k_cache=kc, v_cache=vc, xa_k=xk, xa_v=xv, sel=sel,
                pos=pos, s_audio=s_audio, xa_s=xs)


def _step_bound(inp, cfg):
    """The least time of one step: every int8 weight chunk, scale, bias and
    LayerNorm row, the cross-KV's real columns (and their scales), the
    cache columns some row selects, the step's written columns, x in and
    out and sel, each moved once; the products and attention in bf16."""
    L, D, H = cfg.n_text_layer, cfg.n_text_state, cfg.n_text_head
    bk, s_audio = inp["x_emb"].shape[0], inp["s_audio"]
    xa_elem = inp["xa_k"].element_size()
    picked = int((inp["sel"].sum(dim=0) > 0).sum())
    n_bytes = (
        L * 14 * D * D + L * 14 * D * 4 * 2 + L * 6 * D * 4
        + 2 * L * D * s_audio * xa_elem
        + (2 * L * 2 * H * s_audio if inp["xa_s"] is not None else 0)
        + 2 * L * D * picked * 2 + 2 * L * D * bk * 2
        + 2 * bk * D * 4 + inp["sel"].numel() * 4
    )
    per_row_cols = int(inp["sel"][0].sum()) + 1
    ops = L * (2 * bk * 14 * D * D + 4 * bk * D * per_row_cols + 4 * bk * D * s_audio)
    return _bound(n_bytes, ops, BF16_FLOPS)


def check_fused_step(torch, dev, cfg, packed):
    """The fused step against its plain version at full large-v2 width."""
    from wis_tpu_torch.ops.fused_decode import fused_decode_step, fused_decode_step_plain

    rows = {}
    for t_cache, xa_int8, trap in ((128, True, False), (128, True, True), (128, False, True),
                                   (256, True, False), (256, False, True)):
        inp = _step_inputs(torch, dev, cfg, t_cache, xa_int8, trap, seed=t_cache + trap)
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
        case = (f"fused_decode_step L=32 D=1280 BK=5 t_cache={t_cache} "
                f"xa {'int8' if xa_int8 else 'bf16'}{' trap' if trap else ''}")
        print(f"{case}: x_out max|Δ| {err:.3e}, ‖Δ‖/‖plain‖ x_out {rels[0]:.3e}, "
              f"written K {rels[1]:.3e}, V {rels[2]:.3e} (tolerance {STEP_REL_NORM:.0e}); "
              f"other cache columns bit-identical: {kept}")
        if not (max(rels) <= STEP_REL_NORM and kept and bool(torch.isfinite(xk).all())):
            raise AssertionError(f"{case}: kernel disagrees with plain")
        if trap:
            continue
        args["k_cache"], args["v_cache"] = kc0.clone(), vc0.clone()
        ms = _median_ms(lambda: fused_decode_step(cfg, packed, **args))
        plain_ms = _median_ms(lambda: fused_decode_step_plain(cfg, packed, **args),
                              reps=2, replays=5)
        bound_ms, bound_by = _step_bound(inp, cfg)
        print(f"{case}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})")
        rows[t_cache] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return rows


#: fused head vs plain: |Δ| bound on the candidates' values and on lse.
#: Both compute f32 dots of the same bf16 operands in another order
#: (~1e-5 at these magnitudes), but the LayerNorm's statistics too, and an
#: LN output that lands on a bf16 rounding boundary rounds apart by one
#: ulp: 2⁻⁸·|xn|·|e| ≤ ~0.05 for one element at these N(0, 1) inputs.
HEAD_ATOL = 0.05


def check_fused_head(torch, dev, cfg):
    """The fused head against its plain version at V = 51865, on a
    numpy-seeded N(0, 1) table. The seed is one whose top-(k+1) gaps all
    clear twice the tolerance in both tables (checked below), so equal ids
    are a real check. Traps: each row's two largest raw logits are
    suppressed, and a duplicated embedding row makes row 0's best id tie
    with a lower id — the lower id must win."""
    from wis_tpu_torch.models.whisper.tokenizer import DEFAULT_SUPPRESS_TOKENS
    from wis_tpu_torch.ops.fused_logits import fused_logits_topk, fused_logits_topk_plain
    from wis_tpu_torch.ops.quant import quantize_rows

    V, D, bk, k = cfg.n_vocab, cfg.n_text_state, 5, 6
    rng = np.random.default_rng(6)

    def host(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    x = host(rng.standard_normal((bk, D)) * 2 + 0.3)
    ln_g = host(1 + 0.1 * rng.standard_normal(D))
    ln_b = host(0.1 * rng.standard_normal(D))
    emb = host(rng.standard_normal((V, D), dtype=np.float32)).to(torch.bfloat16)
    sup = torch.zeros(V, device=dev)
    sup[list(DEFAULT_SUPPRESS_TOKENS)] = -1e30
    raw = fused_logits_topk_plain(x, ln_g, ln_b, emb, torch.zeros_like(sup), k=2)[1]
    sup[raw.flatten()] = -1e30  # trap: the largest raw logits are suppressed
    best = fused_logits_topk_plain(x, ln_g, ln_b, emb, sup, k=1)[1][0, 0]
    low = int(best) // 2
    while float(sup[low]) != 0.0:  # an id neither suppressed nor trapped
        low -= 1
    emb[low] = emb[best]  # trap: row 0's best id now ties with a lower id
    rows = {}
    for int8 in (False, True):
        table = quantize_rows(emb) if int8 else emb
        for full in (False, True):
            want = fused_logits_topk_plain(x, ln_g, ln_b, table, sup, k=k, full_lse=full)
            got = fused_logits_topk(x, ln_g, ln_b, table, sup, k=k, full_lse=full)
            torch.cuda.synchronize()
            top = fused_logits_topk_plain(x, ln_g, ln_b, table, sup, k=k + 1, full_lse=full)[0]
            gaps = (top[:, :-1] - top[:, 1:]).flatten()
            margin = float(gaps[gaps > 0].min())
            ids_equal = torch.equal(got[1], want[1])
            err = float((got[0] - want[0]).abs().max())
            lse_err = float((got[2] - want[2]).abs().max())
            tie = got[1][0, :2].tolist() == [low, int(best)]
            hidden = not bool(torch.isin(got[1], raw.reshape(-1)).any())
            case = (f"fused_logits_topk V={V} BK={bk} k={k} emb {'int8' if int8 else 'bf16'} "
                    f"full_lse={full}")
            print(f"{case}: ids equal {ids_equal}, values max|Δ| {err:.3e}, lse max|Δ| "
                  f"{lse_err:.3e} (tolerance {HEAD_ATOL}); smallest non-tie gap {margin:.3e}; "
                  f"tie to the lower id {tie}; suppressed ids kept out {hidden}")
            if margin <= 2 * HEAD_ATOL:
                raise AssertionError(f"{case}: the seed's decisions are closer than the tolerance")
            if not (ids_equal and err <= HEAD_ATOL and lse_err <= HEAD_ATOL and tie and hidden):
                raise AssertionError(f"{case}: kernel disagrees with plain")
            if full:
                continue
            ms = _median_ms(lambda: fused_logits_topk(x, ln_g, ln_b, table, sup, k=k))
            plain_ms = _median_ms(
                lambda: fused_logits_topk_plain(x, ln_g, ln_b, table, sup, k=k), reps=5, replays=5)
            n_bytes = (V * D * (1 if int8 else 2) + (V * 4 if int8 else 0) + V * 4
                       + bk * D * 4 + 2 * D * 4 + bk * (k * 12 + 4))
            bound_ms, bound_by = _bound(n_bytes, 2 * bk * V * D, BF16_FLOPS)
            print(f"{case}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by})")
            rows[int8] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return rows


def serve(torch, dev, engine, requests, counters, path):
    """Run `requests` (audio ms, token cap, detect) through the engine with
    every counter set to 0 just before; → the counts just after. Each
    request must run LayerNorm 65 and flash 32 times; on the fused path the
    step and the head once per decode step each."""
    for c in counters:
        c.launches = 0
    for i, (ms, cap, detect) in enumerate(requests):
        before = [c.launches for c in counters]
        torch.cuda.reset_peak_memory_stats(dev)
        res = engine.transcribe(
            _audio_i16(ms, i), beam_size=5, max_tokens=cap, detect_language=detect
        )
        n = [c.launches - b for c, b in zip(counters, before)]
        # the seeded-random model has no vocabulary files: its text is the
        # placeholder rendering, one "t<id>" piece per emitted token
        n_tok = len(re.findall(r"t\d+", res.text))
        counts = ", ".join(f"{c.__name__} {k}" for c, k in zip(counters, n))
        print(
            f"{path} request {ms / 1000:.2f}s beam5 cap{cap} detect={detect}: "
            f"infer {res.infer_time_ms:.2f} ms (asr_dispatch "
            f"{res.timings['asr_dispatch']:.2f} ms), tokens {n_tok}, "
            f"language {res.language}, launches: {counts}, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB"
        )
        if n[0] < MIN_LN or n[1] < MIN_FLASH:
            raise AssertionError(f"request ran {n[0]} LN / {n[1]} flash launches")
        if len(n) > 2 and not (n[2] == n[3] and n[2] >= max(1, n_tok - 1)):
            raise AssertionError(f"request of {n_tok} tokens ran {n[2]} steps / {n[3]} heads")
        if not 1 <= n_tok <= cap or res.audio_duration_ms != ms:
            raise AssertionError(f"bad result: {n_tok} tokens, {res.audio_duration_ms} ms")
    return [c.launches for c in counters]


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
    from wis_tpu_torch.ops.fused_decode import fused_decode_step
    from wis_tpu_torch.ops.fused_logits import fused_logits_topk
    from wis_tpu_torch.ops.layernorm import layer_norm_cuda
    from wis_tpu_torch.runtime.engine import WhisperEngine
    from wis_tpu_torch.runtime.residency import ModelRegistry
    from wis_tpu_torch.settings import APISettings

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

    ln = check_layer_norm(torch, dev)
    fl = check_flash(torch, dev)

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
    step = check_fused_step(torch, dev, loaded.cfg, packed)
    head = check_fused_head(torch, dev, loaded.cfg)

    counters = (layer_norm_cuda, flash_attention_packed, fused_decode_step, fused_logits_topk)
    settings.fused_decode = "off"
    engine.transcribe(_audio_i16(1000, 99), beam_size=5, max_tokens=4)  # warm-up
    serve(torch, dev, engine, [(3840, 32, False)], counters[:2], "eager")
    settings.fused_decode = "auto"
    engine.transcribe(_audio_i16(1000, 99), beam_size=5, max_tokens=4)  # warm-up
    requests = [(ms, cap, False) for ms, cap in REQUESTS] + [(3840, 32, True)]
    launches = serve(torch, dev, engine, requests, counters, "fused")
    check_encode(torch, dev, loaded)

    rows = [
        dict(name="layer_norm", source="wis_tpu_torch/csrc/layernorm.cu",
             replaces="wis_tpu/ops/layernorm.py:38", **ln),
        dict(name="flash_attention_packed", source="wis_tpu_torch/csrc/flash_attention.cu",
             replaces="wis_tpu/ops/flash.py:121", **fl),
        dict(name="fused_decode_step", source="wis_tpu_torch/csrc/fused_decode.cu",
             replaces="wis_tpu/ops/fused_decode.py:184", **step[128]),
        dict(name="fused_logits_topk", source="wis_tpu_torch/csrc/fused_logits.cu",
             replaces="wis_tpu/ops/fused_logits.py:48", **head[True]),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
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
