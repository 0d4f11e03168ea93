"""The port's counterparts of ``__graft_entry__``'s entry points.

    from wis_tpu_torch.entry import entry, dryrun_multichip
    forward, (params, mel, prompt) = entry()          # on the card
    step_logits = forward(params, mel, prompt)        # (1, 51865) f32
    report = dryrun_multichip(2)                      # two ranks on the card

``forward`` is whisper large-v2's flagship step: the encoder (on the card
its LayerNorms and attention run the LayerNorm and packed flash kernels),
the cross-attention K/V, a 64-position cache, the prompt's prefill, its
argmax token and one cached decode step. The weights are seeded random in
bf16; the mel is 30 s of zeros; the cache takes the weights' dtype (bf16,
as ``__graft_entry__``'s). ``__graft_entry__`` also turns on JAX's
persistent compilation cache, which has no counterpart here: nothing is
compiled.

``dryrun_multichip(n_devices)`` runs ``__graft_entry__.dryrun_multichip``'s
stages on a ``("data", "model")`` mesh of ``n_devices`` ranks, each a
process of a ``torch.distributed`` world (``parallel/world.py``): the
model axis is 2 when n_devices is even, the data axis the rest, as there.
JAX runs its mesh on virtual CPU devices and only compiles its medium and
large-v2 programs; here the ranks are real processes, on the card unless
the CPU is asked for, and the ``full_width`` stages *run* at the
published widths: medium and large-v2 2-way at beam 5, XTTS v2's GPT, and
the vocabulary-sharded logits head at large-v3's width. Ranks that share
one card talk over ``gloo`` (the collectives travel through the host; the
products and kernels stay on the card); ranks on cards of their own over
``nccl``. The tensor-parallel decoder is the eager one, as JAX's GSPMD
path is (``decoding/beam.py``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from wis_tpu_torch.device import DeviceLike

#: every full-width stage holds each position's logits of a teacher-forced
#: pass under tensor parallelism to the single-rank pass's on the same
#: weights, by relative L2: bf16 rounds once per product on either side,
#: at other places (the f32 reduce of a row-parallel product, the sum's
#: order), and such differences random-walk over the residual stream —
#: about sqrt(3 L) · 2^-9 ≈ 0.02 at 32 layers; the bound leaves 2.5×.
#: It catches gross faults (a bias added on every rank, a head split
#: wrong) and not a reduce of bf16 partial sums: on an H100 that moves
#: large-v2's reading from 0.0159 to 0.0169 and XTTS v2's from 0.0126 to
#: 0.0145 (``scripts/probe_tp_reduce_control.py``). ROW_MISMATCH_MAX does.
TF_REL_TOL = 5e-2
#: a row-parallel product in bf16 (``parallel/axis.row_parallel``) rounds
#: once, after the f32 sum across the ranks: it equals the single rank's
#: product bit for bit except where the two f32 sums, taken in another
#: order, round apart (0 to 2e-4 of the elements on an H100 and on the
#: CPU). Partial sums rounded to bf16 before the reduce move 0.36-0.39 of
#: them. The share that may differ:
ROW_MISMATCH_MAX = 1e-2


def entry(device: DeviceLike = "cuda"):
    """→ (forward, (params, mel, prompt)) for large-v2 on ``device`` (the
    card unless the CPU is asked for; raises without a card)."""
    import torch

    from wis_tpu_torch.device import resolve_device
    from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS
    from wis_tpu_torch.models.whisper.model import (
        DecoderCache,
        cross_kv,
        decode_step,
        encode,
        prefill,
    )
    from wis_tpu_torch.models.whisper.tokenizer import build_prompt
    from wis_tpu_torch.models.whisper.weights import random_params

    dev = resolve_device(device)
    cfg = WHISPER_CONFIGS["large-v2"]
    params = random_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    mel = torch.zeros((1, cfg.n_mels, 3000), dtype=torch.float32, device=dev)
    prompt = torch.tensor([build_prompt("en", "transcribe")], dtype=torch.int64, device=dev)

    def forward(params, mel, prompt):
        with torch.inference_mode():
            xa = encode(params, mel, cfg)
            xa_kv = cross_kv(params, xa, cfg)
            dtype = params["decoder"]["tok_emb"].dtype
            cache = DecoderCache.zeros(cfg, 1, 64, dtype, mel.device)
            logits, cache = prefill(params, prompt, cache, xa_kv, cfg)
            tok = torch.argmax(logits[:, -1], dim=-1)
            step_logits, cache = decode_step(params, tok, cache, xa_kv, cfg)
        return step_logits

    return forward, (params, mel, prompt)


# --------------------------------------------------------------------------- #
# dryrun_multichip: __graft_entry__.dryrun_multichip's stages on a world of
# ranks
# --------------------------------------------------------------------------- #
#: the tiny v3-layout config of stage 1 (__graft_entry__.py:187-197)
DRYRUN_CFG = dict(name="dryrun", n_mels=128, n_vocab=51866, n_audio_state=64,
                  n_audio_head=4, n_audio_layer=2, n_text_state=64, n_text_head=4,
                  n_text_layer=1)
#: the tiny GPT of stage 4 (__graft_entry__.py:379-383)
XTTS_TINY = dict(n_layer=2, n_head=4, d_model=32, n_text_vocab=64, n_audio_vocab=36,
                 max_text_tokens=16, max_audio_tokens=24, start_audio_token=34,
                 stop_audio_token=35)
#: full-width requests: a 3.84 s window at beam 5 to cap 32 (large-v2, the
#: bench's headline row) and for a few tokens (medium)
FULL_REQUESTS = {"medium": dict(beam=5, cap=8), "large-v2": dict(beam=5, cap=32)}
#: XTTS v2 at full width: 32 conditioning rows, a 64-token text bucket, one
#: greedy chunk of the reference's 20 tokens
XTTS_FULL = dict(cond_len=32, text_len=64, chunk=20)
REQUEST_MS = 3840


def _launch_counters():
    """Every kernel wrapper's launch counter (each adds one where it
    launches its kernel)."""
    from wis_tpu_torch.ops.decode_attn import ancestry_attention
    from wis_tpu_torch.ops.flash import flash_attention, flash_attention_packed
    from wis_tpu_torch.ops.fused_decode import fused_decode_step
    from wis_tpu_torch.ops.fused_gpt import fused_gpt_step
    from wis_tpu_torch.ops.fused_gpt_head import fused_gpt_head
    from wis_tpu_torch.ops.fused_logits import fused_logits_topk
    from wis_tpu_torch.ops.layernorm import layer_norm_cuda
    from wis_tpu_torch.ops.quant import int8_matmul

    return (layer_norm_cuda, flash_attention_packed, flash_attention, int8_matmul,
            ancestry_attention, fused_decode_step, fused_logits_topk, fused_gpt_step,
            fused_gpt_head)


class _Counted:
    """Launches of every kernel and collectives of the model axis between
    ``__enter__`` and ``__exit__``, and the host-clock ms (the device
    synchronised at both ends)."""

    def __init__(self, device, axis=None):
        self.device, self.axis = device, axis

    def __enter__(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.counters = _launch_counters()
        for c in self.counters:
            c.launches = 0
        self.collectives0 = self.axis.collectives if self.axis else 0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.ms = (time.perf_counter() - self.t0) * 1e3
        self.launches = {c.__name__: c.launches for c in self.counters}
        self.collectives = (self.axis.collectives if self.axis else 0) - self.collectives0
        return False


def _same_on_axis(axis, t, what: str) -> None:
    """Raise unless every rank along ``axis`` holds the same bits."""
    import torch

    parts = axis.all_gather(t[None], dim=0)
    if not all(torch.equal(parts[0], p) for p in parts):
        raise AssertionError(f"{what} differ across the model axis")


def _stage_tp_dp_decode(mesh, params: Optional[dict] = None):
    """Stage 1 (``__graft_entry__.py:168-234``): the tiny v3-layout config
    with int8 decoder weights sharded by ``whisper_param_specs``, a batch of
    n_data zero windows split over the data axis, ``build_generate_xa`` at
    beam 2 for 4 tokens. ``params``: a whole tree to shard instead of the
    seeded one (f32 on the CPU, bf16 on the card: the flash kernels take
    bf16). → tokens (n_data, 2, 4) int64, numpy, the same on every rank."""
    import torch

    from wis_tpu_torch.decoding.beam import build_generate_xa
    from wis_tpu_torch.models.whisper.config import WhisperConfig
    from wis_tpu_torch.models.whisper.model import cross_kv, encode
    from wis_tpu_torch.models.whisper.tokenizer import build_prompt
    from wis_tpu_torch.models.whisper.weights import random_params
    from wis_tpu_torch.ops.quant import quantize_whisper_params
    from wis_tpu_torch.parallel.mesh import batch_sharding, shard_params, whisper_param_specs

    cfg = WhisperConfig(**DRYRUN_CFG)
    dev = mesh.device
    if params is None:
        dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
        params = quantize_whisper_params(random_params(cfg, seed=0, device=dev, dtype=dtype))
    params = shard_params(params, mesh, whisper_param_specs(cfg))
    n_data = mesh.shape[0]
    mel = batch_sharding(mesh)(torch.zeros((n_data, cfg.n_mels, 3000), device=dev))
    prompt = torch.tensor(build_prompt("en", "transcribe"), device=dev)
    tp = mesh.model_axis
    gen = build_generate_xa(cfg, beam_size=2, batch=mel.shape[0], max_new_tokens=4,
                            prompt_len=prompt.shape[0], suppress_tokens=(),
                            begin_suppress_tokens=(), tp=tp)
    with torch.inference_mode():
        xa_kv = cross_kv(params, encode(params, mel, cfg, tp), cfg, tp)
        tokens = gen(params, xa_kv, prompt, 4).tokens
        tokens = mesh.data_axis.all_gather(tokens, dim=0)
        _same_on_axis(tp, tokens, "stage 1 tokens")
    if tuple(tokens.shape) != (n_data, 2, 4):
        raise AssertionError(f"stage 1 tokens {tuple(tokens.shape)}")
    return tokens.cpu().numpy()


def _stage_replica_pool(mesh, devices) -> dict:
    """Stage 2 (``__graft_entry__.py:243-287``): the port's ``ReplicaPool``
    over every rank's device, on the mesh's first rank (the pool is one
    process's; the other ranks wait): tiny, beam 1, three 0.5 s requests
    through the dynamic batcher. → {"replicas", "served"}."""
    import torch.distributed as dist

    out = {}
    if dist.get_rank() == 0:
        from wis_tpu_torch.parallel.replicas import ReplicaPool
        from wis_tpu_torch.runtime.batcher import ASRRequest
        from wis_tpu_torch.settings import APISettings

        settings = APISettings(whisper_model_default="tiny", beam_size=1, max_decode_tokens=3,
                               batch_buckets=["1", "2"], batch_window_s=0.01,
                               dtype="float32" if mesh.device.type == "cpu" else "bfloat16")
        pool = ReplicaPool(settings, devices=list(devices))
        pool.start()
        try:
            rng = np.random.default_rng(0)
            reqs = [ASRRequest(audio=(rng.standard_normal(8000) * 0.05).astype(np.float32),
                               model="tiny", beam_size=1, max_tokens=3) for _ in range(3)]
            futures = [pool.submit(r) for r in reqs]
            results = [f.result(timeout=900) for f in futures]
            if not all(r.audio_duration_ms == 500 for r in results):
                raise AssertionError("replica pool: a result is not of 500 ms of audio")
            out = {"replicas": len(pool.executors),
                   "served": sum(1 for eng in pool.engines if eng.registry.loaded())}
        finally:
            pool.shutdown()
    dist.barrier()
    return out


def _audio(ms: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pcm = rng.standard_normal(ms * 16) * 0.05
    return np.clip(pcm * 32768.0, -32768, 32767).astype(np.int16)


def _rel_by_position(got, want):
    """Per position (all but the last axis) ‖got − want‖ / ‖want‖, and the
    largest |got − want|."""
    import torch

    d = (got.float() - want.float()).flatten(0, -2)
    ref = want.float().flatten(0, -2)
    rel = torch.linalg.vector_norm(d, dim=-1) / torch.linalg.vector_norm(ref, dim=-1)
    return rel.cpu().numpy(), float(d.abs().max())


def _within_tolerance(what: str, rel) -> None:
    if float(np.max(rel)) > TF_REL_TOL:
        raise AssertionError(f"{what}: {float(np.max(rel)):.3g} from the single-rank run's "
                             f"(tolerance {TF_REL_TOL})")


def _row_parallel_check(tp, m: int, local_w, full_w, seed: int) -> dict:
    """One row-parallel product at a rank's shapes through the models' own
    ``row_parallel``, on seeded bf16 x of (m, K), the same on every rank,
    each rank taking its share of K; beside it the control, the ranks'
    partial sums rounded to bf16 before the reduce. The model-index-0
    rank, which holds the whole weight (``full_w``; None on the others),
    holds both to the single-rank product. → on that rank
    {"frac": the share of elements not bit-equal, "ctl_frac": the
    control's, "max_abs": the largest |Δ|}, else {}."""
    import torch

    from wis_tpu_torch.ops.quant import qmatmul
    from wis_tpu_torch.parallel.axis import row_parallel

    lead = local_w["q"] if isinstance(local_w, dict) else local_w
    k_local = lead.shape[0]
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (m, k_local * tp.size), dtype=np.float32)).to(lead.device, torch.bfloat16)
    xl = x[:, tp.index * k_local:(tp.index + 1) * k_local].contiguous()
    got = row_parallel(xl, local_w, tp)
    ctl = tp.all_reduce_sum(qmatmul(xl, local_w)).to(x.dtype)
    if full_w is None:
        return {}
    want = row_parallel(x, full_w, None)
    return {"frac": float((got != want).float().mean()),
            "ctl_frac": float((ctl != want).float().mean()),
            "max_abs": float((got.float() - want.float()).abs().max())}


def _hold_rows(what: str, rows: dict) -> None:
    """Raise unless each row-parallel product's share of elements off the
    single rank's is within ROW_MISMATCH_MAX and the control's beyond it
    (the check tells the fault on these inputs)."""
    for name, r in rows.items():
        if not (r["frac"] <= ROW_MISMATCH_MAX < r["ctl_frac"]):
            raise AssertionError(f"{what} row-parallel {name}: {r['frac']:.3g} of the elements "
                                 f"off the single-rank product (at most {ROW_MISMATCH_MAX}), "
                                 f"the bf16-partial control {r['ctl_frac']:.3g}")


def _full_width_line(st: dict) -> str:
    """The numbers a full-width stage adds to its STAGE OK line (rank 0's)."""
    rows = ", ".join(f"{k} {r['frac']:.2g} (bf16-partial control {r['ctl_frac']:.2g})"
                     for k, r in st["row_parallel"].items())
    return (f"{st['ms']:.1f} ms a rank on the host clock (the single-rank eager request "
            f"{st['single_ms']:.1f} ms), {st['collectives']} collectives, teacher-forced "
            f"logits ‖Δ‖/‖single‖ ≤ {float(np.max(st['tf_rel'])):.3g} (tolerance "
            f"{TF_REL_TOL}); row-parallel products, share of elements off the single "
            f"rank's: {rows} (at most {ROW_MISMATCH_MAX})")


def _stage_whisper_tp(mesh, size: str) -> dict:
    """Stages 3 and 6 at full width (JAX compiles them, ``:290-355`` and
    ``:484-549``): ``size`` at its published widths, bf16, int8 decoder
    weights and logits table, sharded by ``whisper_param_specs``; one 3.84
    s window at beam 5 through the eager tensor-parallel decoder, each
    rank's kernel launches and host ms counted around it. The rank at
    model index 0 also keeps the whole tree and runs the same request on
    its own (its ms and launches: the single-rank eager request), then
    both feed the single-rank tokens to the decoder (a teacher-forced
    pass) and it holds the tensor-parallel logits at every position to its
    own. → the stage's numbers."""
    import torch

    from wis_tpu_torch.audio.mel import N_SAMPLES, log_mel
    from wis_tpu_torch.decoding.beam import build_generate_xa
    from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS
    from wis_tpu_torch.models.whisper.model import (
        DecoderCache,
        _layer,
        cross_kv,
        encode,
        prefill,
    )
    from wis_tpu_torch.models.whisper.tokenizer import build_prompt
    from wis_tpu_torch.models.whisper.weights import random_params
    from wis_tpu_torch.ops.quant import quantize_whisper_params
    from wis_tpu_torch.parallel.mesh import shard_params, whisper_param_specs

    cfg = WHISPER_CONFIGS[size]
    req = FULL_REQUESTS[size]
    dev, tp = mesh.device, mesh.model_axis
    ref = tp.index == 0
    full = quantize_whisper_params(random_params(cfg, seed=0, device=dev, dtype=torch.bfloat16))
    local = shard_params(full, mesh, whisper_param_specs(cfg))
    if not ref:
        del full
        torch.cuda.empty_cache()
    audio = torch.from_numpy(_audio(REQUEST_MS, seed=7)).to(dev).float() / 32768.0
    audio = torch.nn.functional.pad(audio, (0, N_SAMPLES - audio.shape[0]))
    mel = log_mel(audio[None], n_mels=cfg.n_mels)
    prompt = torch.tensor(build_prompt("en", "transcribe"), device=dev)
    kw = dict(beam_size=req["beam"], batch=1, max_new_tokens=req["cap"],
              prompt_len=prompt.shape[0], suppress_tokens=(), begin_suppress_tokens=())

    def request(params, axis, cap):
        gen = build_generate_xa(cfg, **kw, tp=axis)
        xa_kv = cross_kv(params, encode(params, mel, cfg, axis), cfg, axis)
        res = gen(params, xa_kv, prompt, cap)
        return res, xa_kv

    out = {"size": size, "layers": (cfg.n_audio_layer, cfg.n_text_layer),
           "width": cfg.n_text_state, "heads": cfg.n_text_head, **req}
    with torch.inference_mode():
        request(local, tp, 2)  # warm-up: the first products, two tokens
        with _Counted(dev, tp) as c:
            res, xa_kv = request(local, tp, req["cap"])
        best = int(res.best[0])
        tokens = res.tokens[0, best, : int(res.lengths[0, best])]
        _same_on_axis(tp, res.tokens, f"{size} tokens")
        out.update(ms=c.ms, launches=c.launches, collectives=c.collectives,
                   tokens=tokens.cpu().numpy())
        if ref:
            request(full, None, 2)
            with _Counted(dev) as c1:
                res1, xa_kv1 = request(full, None, req["cap"])
            best1 = int(res1.best[0])
            single = res1.tokens[0, best1, : int(res1.lengths[0, best1])]
            out.update(single_ms=c1.ms, single_launches=c1.launches,
                       single_tokens=single.cpu().numpy())
        else:
            single = torch.zeros(req["cap"], dtype=torch.long, device=dev)
        # teacher forcing: the single-rank tokens through both decoders
        n = tp.broadcast(torch.tensor([single.shape[0]], device=dev))
        single = tp.broadcast(torch.nn.functional.pad(single, (0, req["cap"] - single.shape[0])))
        seq = torch.cat([prompt, single[: int(n[0])]])[None]
        cache = DecoderCache.zeros(cfg, 1, seq.shape[1], torch.bfloat16, dev, tp)
        logits, _ = prefill(local, seq, cache, xa_kv, cfg, tp)
        _same_on_axis(tp, logits, f"{size} teacher-forced logits")
        if ref:
            cache = DecoderCache.zeros(cfg, 1, seq.shape[1], torch.bfloat16, dev)
            logits1, _ = prefill(full, seq, cache, xa_kv1, cfg)
            rel, max_abs = _rel_by_position(logits, logits1)
            _within_tolerance(f"{size} teacher-forced logits", rel)
            out.update(tf_positions=int(seq.shape[1]), tf_rel=rel, tf_max_abs=max_abs,
                       tf_argmax_equal=float((logits.argmax(-1) == logits1.argmax(-1))
                                             .float().mean()))
        # layer 0's row-parallel products at a decode step's rows
        blk = _layer(local["decoder"]["blocks"], 0)
        blk1 = _layer(full["decoder"]["blocks"], 0) if ref else None
        rows = {name: _row_parallel_check(tp, req["beam"], blk[sub][name],
                                          blk1[sub][name] if ref else None, seed=17 + i)
                for i, (sub, name) in enumerate((("attn", "o_w"), ("mlp", "w2")))}
        if ref:
            _hold_rows(size, rows)
            out["row_parallel"] = rows
    del local, xa_kv
    if ref:
        del full, xa_kv1
    torch.cuda.empty_cache()
    return out


def _stage_xtts_tp(mesh, full_width: bool) -> dict:
    """Stage 4 (``__graft_entry__.py:358-407``): the XTTS GPT's prefill and
    one greedy chunk with ``xtts_gpt_param_specs``, at the tiny GPT (f32,
    6 tokens); with ``full_width`` also XTTS v2's GPT (30 layers, D 1024,
    16 heads, int8, bf16, a 20-token chunk), in the form of
    ``_stage_whisper_tp``: launches and ms per rank, the single-rank chunk
    on the model-index-0 rank, and a teacher-forced pass over its tokens
    held at every position (hidden states and audio-code logits).
    → {"tiny": tokens, "full": the full-width numbers}."""
    import torch

    from wis_tpu_torch.models.xtts.gpt import (
        GPTCache,
        GPTConfig,
        _audio_embed,
        _layer,
        build_prefill,
        embed_prompt,
        gpt_pass,
        random_gpt,
        run_decode_chunk,
    )
    from wis_tpu_torch.ops.quant import quantize_gpt_params
    from wis_tpu_torch.parallel.mesh import shard_params, xtts_gpt_param_specs

    dev, tp = mesh.device, mesh.model_axis

    def chunk_of(params, cfg, cond, text, chunk, axis):
        max_len = cond.shape[1] + text.shape[1] + 1 + cfg.max_audio_tokens
        prefill = build_prefill(cfg, batch=1, cond_len=cond.shape[1], text_len=text.shape[1],
                                max_len=max_len, tp=axis)
        _, cache = prefill(params, cond, text)
        history = torch.zeros((1, cfg.max_audio_tokens), dtype=torch.long, device=dev)
        gumbel = torch.zeros((chunk, 1, cfg.n_audio_vocab), device=dev)
        start = torch.full((1,), cfg.start_audio_token, dtype=torch.long, device=dev)
        tokens, latents, *_ = run_decode_chunk(
            params, start, cache, history, 0, gumbel, 1.0, 5, 0.9, 2.0, False,
            cfg=cfg, chunk=chunk, batch=1, tp=axis)
        return tokens, latents

    out = {}
    cfg = GPTConfig(**XTTS_TINY)
    params = shard_params(random_gpt(cfg, seed=0, dtype=torch.float32, device=dev), mesh,
                          xtts_gpt_param_specs())
    with torch.inference_mode():
        cond = torch.zeros((1, 2, cfg.d_model), device=dev)
        text = torch.tensor([[3, 5, 7, 9]], device=dev)
        tokens, latents = chunk_of(params, cfg, cond, text, 6, tp)
        _same_on_axis(tp, tokens, "xtts tokens")
    if tuple(tokens.shape) != (1, 6) or not bool(torch.isfinite(latents).all()):
        raise AssertionError(f"xtts tiny: tokens {tuple(tokens.shape)}, latents finite "
                             f"{bool(torch.isfinite(latents).all())}")
    out["tiny"] = tokens.cpu().numpy()
    if not full_width:
        return out

    cfg = GPTConfig()
    ref = tp.index == 0
    whole = quantize_gpt_params(random_gpt(cfg, seed=0, dtype=torch.bfloat16, device=dev))
    local = shard_params(whole, mesh, xtts_gpt_param_specs())
    if not ref:
        del whole
    rng = np.random.default_rng(11)
    n_cond, n_text, chunk = XTTS_FULL["cond_len"], XTTS_FULL["text_len"], XTTS_FULL["chunk"]
    cond = torch.from_numpy((rng.standard_normal((1, n_cond, cfg.d_model)) * 0.5)
                            .astype(np.float32)).to(dev, torch.bfloat16)
    text = torch.from_numpy(rng.integers(7, cfg.n_text_vocab, (1, n_text))).to(dev)
    full = {"layers": cfg.n_layer, "width": cfg.d_model, "heads": cfg.n_head, "chunk": chunk}
    with torch.inference_mode():
        chunk_of(local, cfg, cond, text, 2, tp)  # warm-up
        with _Counted(dev, tp) as c:
            tokens, _ = chunk_of(local, cfg, cond, text, chunk, tp)
        _same_on_axis(tp, tokens, "xtts v2 tokens")
        full.update(ms=c.ms, launches=c.launches, collectives=c.collectives,
                    tokens=tokens[0].cpu().numpy())
        if ref:
            chunk_of(whole, cfg, cond, text, 2, None)
            with _Counted(dev) as c1:
                single, _ = chunk_of(whole, cfg, cond, text, chunk, None)
            full.update(single_ms=c1.ms, single_launches=c1.launches,
                        single_tokens=single[0].cpu().numpy())
        else:
            single = torch.zeros((1, chunk), dtype=torch.long, device=dev)
        single = tp.broadcast(single)
        # teacher forcing: the prefix, then each step's input token as
        # run_decode_chunk embeds it (START, then the tokens before the last)
        feed = torch.cat([torch.full((1, 1), cfg.start_audio_token, device=dev,
                                     dtype=torch.long), single[:, :-1]], dim=1)

        def forced(params, axis):
            prefix = embed_prompt(params, cond, text, cfg)
            steps = torch.stack([_audio_embed(params, feed[:, i], i + 1)
                                 for i in range(chunk)], dim=1)
            x = torch.cat([prefix, steps], dim=1)
            cache = GPTCache.zeros(cfg, 1, x.shape[1], torch.bfloat16, dev, axis)
            hidden, _ = gpt_pass(params, x, 0, cache, cfg, axis)
            hidden = hidden[:, prefix.shape[1]:]
            return hidden, (hidden @ params["head_w"] + params["head_b"]).float()

        hidden, logits = forced(local, tp)
        _same_on_axis(tp, logits, "xtts v2 teacher-forced logits")
        if ref:
            hidden1, logits1 = forced(whole, None)
            rel, max_abs = _rel_by_position(logits, logits1)
            _within_tolerance("xtts v2 teacher-forced logits", rel)
            rel_h, _ = _rel_by_position(hidden, hidden1)
            full.update(tf_positions=chunk, tf_rel=rel, tf_max_abs=max_abs,
                        tf_hidden_rel=rel_h,
                        tf_argmax_equal=float((logits.argmax(-1) == logits1.argmax(-1))
                                              .float().mean()))
        # layer 0's row-parallel products at a token's row
        rows = {name: _row_parallel_check(tp, 1, _layer(local["blocks"][name], 0),
                                          _layer(whole["blocks"][name], 0) if ref else None,
                                          seed=19 + i)
                for i, name in enumerate(("proj_w", "mlp_w2"))}
        if ref:
            _hold_rows("xtts v2", rows)
            full["row_parallel"] = rows
    del local
    if ref:
        del whole
    torch.cuda.empty_cache()
    out["full"] = full
    return out


def vocab_tp_head(mesh, d: int, v: int, bk: int, k: int, seed: int = 0) -> dict:
    """The port's fused logits head with the vocabulary sharded over the
    model axis (``__graft_entry__.py:410-481``, Megatron's output-embedding
    parallelism): each rank runs the head on its shard of a seeded bf16
    (v, d) table, the candidates are all-gathered and cut to a global
    top-k, the logsumexp combines through one max and one sum; the whole
    head runs beside it. → values, ids and lse of both, numpy, and the
    launches and collectives of the sharded head."""
    import torch

    from wis_tpu_torch.decoding.beam import top_k
    from wis_tpu_torch.models.whisper.config import WhisperConfig
    from wis_tpu_torch.ops.fused_logits import build_fused_logits_topk

    dev, tp = mesh.device, mesh.model_axis
    vs = v // tp.size
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((bk, d)).astype(np.float32)).to(dev)
    ln_g = torch.ones(d, device=dev)
    ln_b = torch.zeros(d, device=dev)
    emb = torch.from_numpy((rng.standard_normal((v, d)) * 0.1).astype(np.float32)).to(
        dev, torch.bfloat16)
    sup = torch.where(torch.arange(v, device=dev) % 97 == 0, -1e30, 0.0).float()
    head_full = build_fused_logits_topk(WhisperConfig(name="tp-head", n_vocab=v,
                                                      n_text_state=d), bk=bk, k=k)
    head_shard = build_fused_logits_topk(WhisperConfig(name="tp-head-shard", n_vocab=vs,
                                                       n_text_state=d), bk=bk, k=k)
    lo = tp.index * vs
    ref_val, ref_tok, ref_lse = head_full(x, ln_g, ln_b, emb, sup)
    # fresh copies: the kernels take 16-byte aligned rows
    emb_sh, sup_sh = emb[lo:lo + vs].clone(), sup[lo:lo + vs].clone()
    with _Counted(dev, tp) as c:
        val, tok, lse = head_shard(x, ln_g, ln_b, emb_sh, sup_sh)
        val_g = tp.all_gather(val, dim=1)
        tok_g = tp.all_gather(tok + lo, dim=1)
        best, slot = top_k(val_g, k)
        best_tok = torch.gather(tok_g, 1, slot)
        m = tp.all_reduce_max(lse)
        lse_tot = m + torch.log(tp.all_reduce_sum(torch.exp(lse - m)))
    out = {name: t.cpu().numpy() for name, t in dict(
        val=best, tok=best_tok, lse=lse_tot, ref_val=ref_val, ref_tok=ref_tok,
        ref_lse=ref_lse).items()}
    return dict(out, launches=c.launches, collectives=c.collectives)


#: the vocabulary-sharded heads: stage 5's (__graft_entry__.py:426) and, at
#: full width, large-v3's (D 1280, V 51866, BK 5 at beam 5, k 6)
VOCAB_HEAD_CASES = {"tiny": dict(d=64, v=2048, bk=2, k=4),
                    "large-v3": dict(d=1280, v=51866, bk=5, k=6)}


def _stage_fused_head_vocab_tp(mesh, full_width: bool) -> dict:
    """Stage 5: ``vocab_tp_head`` at the tiny case and, with
    ``full_width``, at large-v3's width; ids equal to the whole head's,
    values and lse within 1e-5. → {case: the head's numbers}."""
    import torch

    out = {}
    for name, case in VOCAB_HEAD_CASES.items():
        if name != "tiny" and not full_width:
            continue
        with torch.inference_mode():
            r = vocab_tp_head(mesh, **case)
        err = max(float(np.abs(r["val"] - r["ref_val"]).max()),
                  float(np.abs(r["lse"] - r["ref_lse"]).max()))
        if not np.array_equal(r["tok"], r["ref_tok"]) or err > 1e-5:
            raise AssertionError(f"vocab-sharded head {name}: ids equal "
                                 f"{np.array_equal(r['tok'], r['ref_tok'])}, max|Δ| {err:.3g}")
        out[name] = dict(case, **r, max_abs_err=err)
    return out


def _dryrun_rank(rank: int, devices, n_data: int, n_model: int, full_width: bool) -> dict:
    """One rank of ``dryrun_multichip``: every stage in the JAX order, a
    ``STAGE OK`` line from rank 0 after each. → this rank's report."""
    from wis_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_data, n_model, devices)

    def say(line):
        """Rank 0 prints ``line()``, made from its own report (the other
        ranks do not hold the single-rank numbers)."""
        if rank == 0:
            print(line(), flush=True)

    report = {"rank": rank, "coords": mesh.coords, "device": str(mesh.device),
              "backend": mesh.backend}
    report["tp_dp"] = _stage_tp_dp_decode(mesh)
    say(lambda: f"STAGE OK: tp+dp sharded beam decode — mesh=({n_data}x{n_model}) "
                f"tokens shape {report['tp_dp'].shape}")
    report["replica_pool"] = _stage_replica_pool(mesh, devices)
    say(lambda: f"STAGE OK: batcher+replica-pool dispatch — "
                f"{report['replica_pool']['replicas']} replicas, "
                f"{report['replica_pool']['served']} served requests")
    if full_width:
        report["medium"] = _stage_whisper_tp(mesh, "medium")
        say(lambda: f"STAGE OK: medium TP — beam 5, 24L/1024d over {n_model} ranks, "
                    f"{len(report['medium']['tokens'])} tokens; "
                    f"{_full_width_line(report['medium'])}")
    report["xtts"] = _stage_xtts_tp(mesh, full_width)
    say(lambda: f"STAGE OK: xtts gpt tensor-parallel decode — {n_model}-way TP, chunk 6 "
                f"tokens" + (f"; XTTS v2 30L/1024d, 20 tokens, "
                             f"{_full_width_line(report['xtts']['full'])}" if full_width else ""))
    report["vocab_head"] = _stage_fused_head_vocab_tp(mesh, full_width)
    say(lambda: f"STAGE OK: fused logits head vocab-TP — {n_model}-way embedding shard, "
                f"cases {sorted(report['vocab_head'])}, top-k and lse equal to the whole head")
    if full_width:
        report["large-v2"] = _stage_whisper_tp(mesh, "large-v2")
        say(lambda: f"STAGE OK: large-v2 TP — beam 5, 32L/1280d over {n_model} ranks, "
                    f"{len(report['large-v2']['tokens'])} tokens; "
                    f"{_full_width_line(report['large-v2'])}")
    return report


def _check_reports(reports, full_width: bool) -> None:
    """Every rank's tokens equal in every stage, and in each full-width
    stage each rank's launches equal to the single-rank request's (the
    ranks held the teacher-forced logits to TF_REL_TOL themselves)."""
    def same(key, get):
        first = get(reports[0])
        if not all(np.array_equal(get(r), first) for r in reports):
            raise AssertionError(f"{key}: the ranks' tokens differ")

    same("stage 1", lambda r: r["tp_dp"])
    same("xtts tiny", lambda r: r["xtts"]["tiny"])
    if not full_width:
        return
    stages = {"medium": lambda r: r["medium"], "large-v2": lambda r: r["large-v2"],
              "xtts v2": lambda r: r["xtts"]["full"]}
    for key, get in stages.items():
        same(key, lambda r: get(r)["tokens"])
        single = next(get(r) for r in reports if "tf_rel" in get(r))["single_launches"]
        for r in reports:
            if get(r)["launches"] != single:
                raise AssertionError(f"{key}: rank {r['rank']} launched {get(r)['launches']}, "
                                     f"the single-rank request {single}")


def dryrun_multichip(n_devices: int, device: DeviceLike = "cuda",
                     full_width: bool = True) -> dict:
    """Run ``__graft_entry__.dryrun_multichip``'s stages on a mesh of
    ``n_devices`` ranks, one process each (``spawn``): n_model = 2 when
    n_devices is even, else 1; n_data the rest.

    device: "cuda" puts rank r on card r % device_count() (raises without
    a card), "cpu" every rank on the CPU. full_width: also run stage 3
    (medium), XTTS v2's GPT in stage 4, large-v3's vocabulary-sharded head
    in stage 5 and stage 6 (large-v2), all at published widths (the card's
    work; the CPU tests pass False). A rank that raises makes this raise
    with its traceback. → {"mesh", "backend", "ranks": each rank's report}."""
    import torch

    from wis_tpu_torch.device import resolve_device
    from wis_tpu_torch.parallel.world import run_world

    dev = resolve_device(device)
    if dev.type == "cuda":
        from wis_tpu_torch.ops import _build

        _build.kernels()  # built here once; the ranks load it
        count = torch.cuda.device_count()
        devices = [f"cuda:{r % count}" for r in range(n_devices)]
    else:
        devices = ["cpu"] * n_devices
    n_model = 2 if n_devices % 2 == 0 else 1
    n_data = n_devices // n_model
    reports = run_world(_dryrun_rank, devices, (n_data, n_model, full_width), timeout=1800)
    _check_reports(reports, full_width)
    print(f"dryrun_multichip OK: mesh=({n_data}x{n_model}) tokens shape "
          f"{reports[0]['tp_dp'].shape}", flush=True)
    return {"mesh": (n_data, n_model), "backend": reports[0]["backend"], "ranks": reports}
