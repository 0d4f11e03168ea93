"""XTTS orchestrator: text → streaming 24 kHz speech (port of
``wis_tpu/models/xtts/model.py``).

The reference's custom-voice TTS is Coqui XTTS v2's ``inference_stream``:
speaker latents (``gpt_cond_latent`` (N, 1024) and a 512-dim
``speaker_embedding``), chunked GPT decoding, and the HiFi-GAN vocoder per
chunk. ``XTTSModel.inference_stream`` keeps the JAX package's behaviour
step for step:

- the chunk schedule: a short first chunk for time to first audio, steady
  ``stream_chunk_size`` chunks, and a remainder chunk at the token cap;
- on the fused path, the flat KV cache in length buckets
  (``gpt_cache_buckets``, then the full lane-aligned length), grown by
  zero-padding when the next chunk would overflow it;
- per chunk one packed float32 result ``wav ‖ valid ‖ done`` and, on the
  host, the sample arithmetic ``target()`` and the crossfade.

The JAX package dispatches up to ``depth`` chunks ahead and starts their
device-to-host copies asynchronously. Here each chunk's packed result is
copied into a pinned host buffer behind one CUDA event, and chunks queued
past a stop are dropped. Queuing blocks on the card once its launch queue
is full, so a chunk queued behind another holds that one's fetch, and
the listener, until it is itself nearly done. Each chunk is therefore
yielded before the queue is topped up to ``pipeline_depth`` chunks, and
the default depth is 1: each chunk reaches the listener as soon as it is
done, and the card idles only while the host fetches one chunk and
queues the next (``chip_smoke.py`` compares depths 1-3 by second chunk,
worst slack to playback and total). Positions and history lengths
advance by exactly the chunk size per dispatch, so the host predicts
them and nothing syncs per token.

The host loop: on the card, with the fused step and without the fused
head, a stream takes a slot of the model's pool (``slots.py``) at its
start and gives it back when it ends. The slot holds the stream's state
in static buffers, and one CUDA graph per cache bucket captured from
``gpt.decode_code`` (the embedding, the fused step, the sampling
epilogue and the history update, every per-code number read from device
scalars): each code is one replay, so the card, not the host, sets the
pace of a chunk. Elsewhere (the CPU, ``fused="off"``, the fused head)
each code is launched eagerly, the same ``decode_code`` on the fused
path.

Under the caller's current timer (``utils/timing``; the TTS app's
``tts_stream`` record) a stream records ``tts.prefill``, a ``tts.launch n=
t=`` span around each chunk's queuing (codes, cache bucket) and a
``tts.fetch`` span around each wait on its event, and counts
``tts.in_flight``: at each launch, the streams the app has in flight
(``STREAMS``); ``tts.graph_codes`` and ``tts.eager_codes``: the codes
replayed from a graph and those launched eagerly; ``tts.graph_captures``.

Constructor knobs are the JAX package's environment switches:
``quant`` (XTTS_QUANT: "int8" or "none"), ``fused`` (XTTS_FUSED: "auto" =
the fused step on CUDA, "on" forces it — the CPU then runs the kernels'
plain versions —, "off" the eager ``gpt_pass`` path), ``fused_head``
(XTTS_FUSED_HEAD, off by default as there) and ``pipeline_depth``
(XTTS_PIPELINE_DEPTH, 1 by default here, see above). Sampling draws come from a ``torch.Generator``
seeded per call, so they differ from ``jax.random``'s; greedy decoding is
the same.

Weights: ``<model_dir>/model.pth``, a Coqui XTTS v2 checkpoint, converted
by ``convert.py`` as the JAX package converts it; without one, or where it
does not convert, seeded random weights (the JAX package's rule). The
conditioning encoder's keys convert on their own: where they do not,
``clone_speaker`` runs on seeded conditioning weights (logged), as there.

Voice cloning (``clone_speaker``): the reference audio's log-mel
(``audio/mel.py`` after ``pad_or_trim``, (80, 3000)) through the
conditioning encoder (``conditioning.py``, f32) gives ``gpt_cond_latent``;
the WavLM x-vector, padded or cut to the vocoder's ``cond_dim`` and
L2-normalized, gives ``speaker_embedding``; both come back as float16
lists, as in the JAX package. The x-vector's weights are the speaker
verifier's (``server/sv.wavlm_dir``, ``<model_dir>/wavlm-base-plus-sv``), not
the JAX package's relative default; ``embed_fn`` replaces the embedder
(``SpeakerVerifier``'s seam).

Not ported: the XLA compile cache.
"""

from __future__ import annotations

import collections
import logging
import os
import re
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from wis_tpu_torch.device import DeviceLike, resolve_device
from wis_tpu_torch.models.xtts.gpt import (
    GPTConfig,
    build_prefill,
    flatten_gpt_cache,
    random_gpt,
    run_decode_chunk,
    run_decode_chunk_fused,
)
from wis_tpu_torch.models.xtts.hifigan import HiFiGANConfig, hifigan_forward, random_hifigan
from wis_tpu_torch.models.xtts.slots import CodeSlots
from wis_tpu_torch.utils.timing import count, level, span

logger = logging.getLogger("wis_tpu_torch")

#: the level (``utils/timing.inside``) of streams the server has in flight;
#: each chunk's launch adds it to the ``tts.in_flight`` count
STREAMS = "tts.streams"

#: XTTS v2 supported language codes (reference xtts/main.py WillowStreamingInputs)
XTTS_LANGUAGES = (
    "en", "es", "fr", "de", "it", "pt", "pl", "tr", "ru", "nl", "cs", "ar",
    "zh-cn", "hu", "ko", "ja",
)


@dataclass(frozen=True)
class XTTSConfig:
    gpt: GPTConfig = field(default_factory=GPTConfig)
    vocoder: HiFiGANConfig = field(default_factory=HiFiGANConfig)
    text_buckets: tuple = (32, 64, 128, 256, 400)
    cond_len: int = 32
    left_context_frames: int = 2  # vocoder left context per chunk
    #: fused-GPT KV cache length buckets (lane-aligned t_pad candidates):
    #: the fused step reads only the written columns, but the cache is
    #: allocated and grown in these steps, then the full length
    gpt_cache_buckets: tuple = (256, 512)


def _fused_mode(fused: Union[str, bool], device: torch.device) -> bool:
    mode = str(fused).lower()
    if mode in ("1", "on", "true"):
        return True
    if mode in ("0", "off", "false", "none"):
        return False
    if mode != "auto":
        raise ValueError(f"fused={fused!r} (auto, on or off)")
    return device.type == "cuda"


class _Pending:
    """One dispatched chunk's packed result, on its way to the host: a
    pinned buffer filled behind a CUDA event, or the tensor itself on the
    CPU."""

    def __init__(self, packed: torch.Tensor):
        if packed.is_cuda:
            self.host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = packed, None

    def fetch(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class XTTSModel:
    def __init__(
        self,
        device: DeviceLike = "cuda",
        cfg: Optional[XTTSConfig] = None,
        seed: int = 0,
        quant: str = "int8",
        fused: Union[str, bool] = "auto",
        fused_head: bool = False,
        pipeline_depth: int = 1,
        dtype: torch.dtype = torch.bfloat16,
        model_dir: Optional[str] = None,
        embed_fn=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg or XTTSConfig()
        self.dtype = dtype
        self.fused_head = bool(fused_head)
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._tokenizer = self._load_tokenizer(model_dir)
        # voice cloning: the conditioning weights (from the checkpoint, else
        # seeded at first use) and the speaker embedder
        self._cond_params: Optional[Dict] = None
        self._cond_program = None
        self._embed_fn = embed_fn
        self._clone_lock = threading.Lock()
        # weights: the converted Coqui checkpoint if there is one, else seeded
        self.gpt_params, self.vocoder_params = self._load_checkpoint(model_dir)
        if self.gpt_params is None:
            logger.info("XTTS: seeded random weights (seed %d) on %s", seed, self.device)
            self.gpt_params = random_gpt(self.cfg.gpt, seed=seed, dtype=dtype,
                                         device=self.device)
            self.vocoder_params = random_hifigan(self.cfg.vocoder, seed=seed + 1, dtype=dtype,
                                                 device=self.device)
        if quant == "int8":
            # the chunked decode streams the whole block stack per audio
            # token: int8 halves its bytes (the JAX package's default)
            from wis_tpu_torch.ops.quant import quantize_gpt_params

            self.gpt_params = quantize_gpt_params(self.gpt_params)
        elif quant != "none":
            raise ValueError(f"quant={quant!r} (int8 or none)")
        self._fused = _fused_mode(fused, self.device)
        self.gpt_packed = None
        self.gpt_head_packed = None
        if self._fused:
            from wis_tpu_torch.ops.fused_gpt import pack_gpt
            from wis_tpu_torch.ops.fused_gpt_head import pack_head

            self.gpt_packed = pack_gpt(self.gpt_params, self.cfg.gpt)
            self.gpt_head_packed = pack_head(self.gpt_params, self.cfg.gpt, dtype)
        # on the card, each code of a stream is a replay of its slot's graph
        self._slots = (CodeSlots(self.cfg.gpt, self.device, self.gpt_params["text_emb"].dtype)
                       if self._fused and not self.fused_head and self.device.type == "cuda"
                       else None)

    # ------------------------------------------------------------------ #
    def _load_checkpoint(self, model_dir):
        """(GPT tree, vocoder tree) converted from ``<model_dir>/model.pth``,
        or (None, None) where there is none or it does not convert (logged,
        as the JAX package does; a half-converted pair is never kept)."""
        ckpt = os.path.join(model_dir or "", "model.pth")
        if not (model_dir and os.path.isfile(ckpt)):
            return None, None
        from wis_tpu_torch.models.xtts.convert import (
            gpt_from_coqui,
            hifigan_from_coqui,
            load_coqui_checkpoint,
        )

        sd = load_coqui_checkpoint(ckpt)
        if not sd:
            return None, None
        self._load_conditioning(sd)
        try:
            gpt = gpt_from_coqui(sd, self.cfg.gpt, self.dtype, self.device)
            vocoder = hifigan_from_coqui(sd, self.cfg.vocoder, self.dtype, self.device)
        except (KeyError, ValueError) as e:
            logger.warning("XTTS: checkpoint conversion failed: %s", e)
            return None, None
        logger.info("XTTS: loaded Coqui checkpoint %s", ckpt)
        return gpt, vocoder

    def _load_conditioning(self, sd) -> None:
        """The conditioning encoder's tree from the checkpoint's
        ``gpt.conditioning_*`` keys, on its own: where they do not convert,
        logged, and ``clone_speaker`` uses seeded weights."""
        from wis_tpu_torch.models.xtts.convert import conditioning_from_coqui

        try:
            cond = conditioning_from_coqui(sd, self._cond_cfg(), torch.float32, self.device)
        except (KeyError, ValueError) as e:
            logger.warning("XTTS: conditioning conversion failed (%s); clone_speaker "
                           "uses seeded conditioning weights", e)
            return
        cond.pop("_unmapped")
        self._cond_params = cond
        logger.info("XTTS: loaded the conditioning encoder from the checkpoint")

    @staticmethod
    def _load_tokenizer(model_dir):
        path = os.path.join(model_dir or "", "tokenizer.json")
        if model_dir and os.path.isfile(path):
            try:
                from tokenizers import Tokenizer

                return Tokenizer.from_file(path)
            except Exception as e:  # noqa: BLE001
                logger.warning("XTTS: tokenizer load failed: %s", e)
        return None

    def tokenize(self, text: str, language: str) -> np.ndarray:
        """``[lang]`` + the cleaned text (``textnorm.preprocess_text``) over
        the BPE of a ``tokenizer.json``; without one, bytes map
        deterministically into the text vocabulary."""
        from wis_tpu_torch.models.xtts.textnorm import preprocess_text

        prompt = f"[{language}]{preprocess_text(text, language)}"
        if self._tokenizer is not None:
            ids = self._tokenizer.encode(prompt).ids
        else:
            ids = [7 + (b % (self.cfg.gpt.n_text_vocab - 10)) for b in prompt.encode()]
        return np.asarray(ids[: self.cfg.gpt.max_text_tokens], np.int32)

    def _text_bucket(self, n: int) -> int:
        for b in self.cfg.text_buckets:
            if n <= b:
                return b
        return self.cfg.text_buckets[-1]

    def _gumbel(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """n gumbel rows (n, 1, V) f32 for one chunk, ``-log(-log(U))``
        with U uniform on [tiny, 1), drawn on the device."""
        u = torch.rand((n, 1, self.cfg.gpt.n_audio_vocab), generator=gen, device=self.device)
        tiny = torch.finfo(torch.float32).tiny
        return -torch.log(-torch.log(torch.clamp_min(u, tiny)))

    # ------------------------------------------------------------------ #
    # Voice cloning: reference audio → (gpt_cond_latent, speaker_embedding)
    # ------------------------------------------------------------------ #
    def _cond_cfg(self):
        from wis_tpu_torch.models.xtts.conditioning import ConditioningConfig

        g = self.cfg.gpt
        return ConditioningConfig(
            n_mels=80,
            d_model=g.d_model,
            n_heads=g.n_head,
            n_blocks=min(6, g.n_layer),
            n_latents=self.cfg.cond_len,
            n_groups=min(32, g.d_model // 4),
            perceiver_heads=min(8, g.n_head),
            perceiver_depth=2,
        )

    def _conditioning(self):
        """(the clone program, the conditioning tree), made at first use."""
        from wis_tpu_torch.models.xtts.conditioning import (
            build_clone_program,
            random_conditioning,
        )

        with self._clone_lock:
            if self._cond_params is None:
                self._cond_params = random_conditioning(self._cond_cfg(), device=self.device)
            if self._cond_program is None:
                self._cond_program = build_clone_program(self._cond_cfg())
        return self._cond_program, self._cond_params

    def _speaker_embedding(self, audio_16k: np.ndarray) -> np.ndarray:
        """The vocoder's speaker embedding: the WavLM x-vector (the speaker
        verifier's embedder) padded or cut to ``cond_dim``, L2-normalized,
        float16."""
        cdim = self.cfg.vocoder.cond_dim
        with self._clone_lock:
            if self._embed_fn is None:
                from wis_tpu_torch.models.wavlm import default_embedder
                from wis_tpu_torch.server.sv import wavlm_dir

                self._embed_fn = default_embedder(wavlm_dir(), self.device)
        emb = np.asarray(self._embed_fn(audio_16k), np.float32).reshape(-1)
        if emb.shape[0] < cdim:
            emb = np.pad(emb, (0, cdim - emb.shape[0]))
        emb = emb[:cdim]
        return (emb / max(np.linalg.norm(emb), 1e-6)).astype(np.float16)

    def clone_speaker(self, audio_16k: np.ndarray) -> Dict[str, list]:
        """Reference audio (16 kHz float32) → a voice: ``gpt_cond_latent``
        (cond_len, d_model) and ``speaker_embedding`` (cond_dim,), float16
        lists (the reference's saved-voice JSON)."""
        from wis_tpu_torch.audio.mel import log_mel, pad_or_trim

        program, cond_params = self._conditioning()
        audio = np.ascontiguousarray(pad_or_trim(np.asarray(audio_16k, np.float32)))
        with torch.inference_mode():
            mel = log_mel(torch.from_numpy(audio).to(self.device))  # (80, 3000)
        cond = program(cond_params, mel[None]).cpu().numpy().astype(np.float16)
        emb = self._speaker_embedding(audio_16k)
        return {"gpt_cond_latent": cond.tolist(), "speaker_embedding": emb.tolist()}

    # ------------------------------------------------------------------ #
    def inference_stream(
        self,
        text: str,
        language: str,
        gpt_cond_latent: np.ndarray,  # (N_cond, D) or smaller (padded)
        speaker_embedding: np.ndarray,  # (cond_dim,)
        stream_chunk_size: int = 20,
        first_chunk_size: Optional[int] = None,
        overlap_wav_len: int = 1024,
        temperature: float = 0.1,
        length_penalty: float = 1.0,
        repetition_penalty: float = 7.0,
        top_k: int = 50,
        top_p: float = 0.8,
        do_sample: bool = True,
        speed: float = 1.0,
        decoder: str = "ne_hifigan",
        seed: int = 0,
        min_audio_tokens: int = 0,
    ) -> Iterator[np.ndarray]:
        """Yield float32 waveform chunks at 24 kHz (the reference's
        ``inference_stream`` surface). ``decoder`` names the one HiFi-GAN;
        ``length_penalty`` is accepted and unused (sampling, not beams);
        ``first_chunk_size`` defaults to min(6, stream_chunk_size)."""
        del length_penalty, decoder
        g = self.cfg.gpt
        dev, dtype = self.device, self.dtype
        tokens = self.tokenize(text, language)
        bucket = self._text_bucket(len(tokens))
        text_pad = np.zeros(bucket, np.int64)
        text_pad[: len(tokens)] = tokens
        cond = np.zeros((1, self.cfg.cond_len, g.d_model), np.float32)
        lat = np.asarray(gpt_cond_latent, np.float32).reshape(-1, g.d_model)
        cond[0, : min(self.cfg.cond_len, lat.shape[0])] = lat[: self.cfg.cond_len]
        speaker = np.asarray(speaker_embedding, np.float32).reshape(1, -1)

        prefix_len = self.cfg.cond_len + bucket + 1
        max_len = prefix_len + g.max_audio_tokens
        fused = self._fused
        full_t = ((max_len + 127) // 128) * 128
        t_buckets = [b for b in sorted(self.cfg.gpt_cache_buckets)
                     if b % 128 == 0 and b < full_t] + [full_t]

        def t_for(need: int) -> int:
            return next((b for b in t_buckets if need <= b), full_t)

        with span("tts.prefill"):
            prefill = build_prefill(g, batch=1, cond_len=self.cfg.cond_len, text_len=bucket,
                                    max_len=max_len)
            _, cache = prefill(self.gpt_params, torch.from_numpy(cond).to(dev, dtype),
                               torch.from_numpy(text_pad[None]).to(dev))
            speaker_dev = torch.from_numpy(speaker).to(dev, dtype)

        chunk = stream_chunk_size
        if first_chunk_size is None:
            first_chunk_size = min(6, chunk)
        first_chunk_size = max(1, min(first_chunk_size, chunk))
        # a short first chunk for time to first audio, steady chunks, then a
        # remainder chunk so a cap-length generation emits every token
        sizes = [first_chunk_size]
        while sum(sizes) + chunk <= g.max_audio_tokens:
            sizes.append(chunk)
        rem = g.max_audio_tokens - sum(sizes)
        if rem > 0:
            sizes.append(rem)
        max_chunks = len(sizes)

        left = self.cfg.left_context_frames
        voc = self.cfg.vocoder
        gen = torch.Generator(device=dev).manual_seed(seed)
        knobs = (temperature, top_k, top_p, repetition_penalty, bool(do_sample), min_audio_tokens)
        st = dict(
            ctx=torch.zeros((1, left, g.d_model), dtype=dtype, device=dev),
            last=torch.full((1,), g.start_audio_token, dtype=torch.long, device=dev),
            history=torch.zeros((1, g.max_audio_tokens), dtype=torch.long, device=dev),
            hist_len=0,
            cache=cache,
        )
        if fused:
            from wis_tpu_torch.ops.fused_gpt import build_fused_gpt_step
            from wis_tpu_torch.ops.fused_gpt_head import build_fused_gpt_head

            st["t_cur"] = t_for(prefix_len + sizes[0])
            st["kc"], st["vc"] = flatten_gpt_cache(cache, st["t_cur"])
            st["pos"] = cache.pos
            st["cache"] = None
            head_fn = build_fused_gpt_head(g, dtype=dtype) if self.fused_head else None
        launched = 0

        def launch() -> _Pending:
            """Queue the next chunk: its GPT step, vocoder and pack (a
            ``tts.launch`` span with its codes and cache bucket)."""
            nonlocal launched
            c_i = sizes[launched]
            launched += 1
            t_cache = (max(st["t_cur"], t_for(prefix_len + sum(sizes[:launched])))
                       if fused else max_len)
            with span("tts.launch", n=c_i, t=t_cache):
                count("tts.in_flight", level(STREAMS))
                return queue_chunk(c_i, t_cache)

        def queue_chunk(c_i: int, t_cache: int) -> _Pending:
            gum = self._gumbel(gen, c_i)
            if fused:
                if t_cache > st["t_cur"]:
                    # grow the cache to the next bucket (bk = 1: one column
                    # per position)
                    grow = (0, t_cache - st["t_cur"])
                    st["kc"], st["vc"] = F.pad(st["kc"], grow), F.pad(st["vc"], grow)
                    st["t_cur"] = t_cache
                step_fn = build_fused_gpt_step(g, bk=1, t_cache=st["t_cur"])
                toks, latents, st["kc"], st["vc"], st["pos"], st["history"], st["hist_len"], done = (
                    run_decode_chunk_fused(
                        self.gpt_params, self.gpt_packed, step_fn, st["last"], st["kc"],
                        st["vc"], st["pos"], st["history"], st["hist_len"], gum, *knobs,
                        head_packed=self.gpt_head_packed, cfg=g, chunk=c_i, batch=1,
                        head_fn=head_fn, slot=slot,
                    )
                )
            else:
                toks, latents, st["cache"], st["history"], st["hist_len"], done = run_decode_chunk(
                    self.gpt_params, st["last"], st["cache"], st["history"], st["hist_len"],
                    gum, *knobs, cfg=g, chunk=c_i, batch=1,
                )
            voc_in = torch.cat([st["ctx"], latents], dim=1).to(speaker_dev.dtype)
            wav = hifigan_forward(self.vocoder_params, voc_in, speaker_dev, voc)
            st["ctx"] = latents[:, -left:]
            st["last"] = toks[:, -1]
            # valid = tokens before the first stop in this chunk
            is_stop = (toks[0] == g.stop_audio_token).int()
            valid = torch.where(is_stop.any(), torch.argmax(is_stop), c_i)
            packed = torch.cat([wav[0].float(), valid.float()[None], done[0].float()[None]])
            return _Pending(packed)

        # exact aggregate duration: token n's emission boundary in output
        # samples (floor, so per-chunk slices sum to the true length)
        def target(n: int) -> int:
            return n * voc.gpt_code_stride * voc.sample_rate // voc.input_sample_rate

        prev_wav_tail: Optional[np.ndarray] = None
        emitted = 0
        inflight: "collections.deque[_Pending]" = collections.deque()
        slot = self._slots.acquire() if self._slots is not None else None
        try:
            # a chunk queued behind another would hold its fetch until it is
            # nearly done (the card's launch queue holds a few tokens), so
            # the first goes alone and the rest are queued after each yield
            inflight.append(launch())
            for i in range(max_chunks):
                c_i = sizes[i]
                with span("tts.fetch"):
                    arr = inflight.popleft().fetch()
                valid = int(arr[-2])
                done = bool(arr[-1])
                if valid > 0:
                    full = arr[:-2]
                    # the chunk's wav covers (left + c_i) tokens and ends at
                    # token boundary emitted + c_i: emit the `want` samples
                    # ending at the first `valid` new tokens' boundary
                    want = target(emitted + valid) - target(emitted)
                    end = round(len(full) * (left + valid) / (left + c_i))
                    wav = full[max(0, end - want): end].copy()
                    if prev_wav_tail is not None and overlap_wav_len > 0:
                        n = min(len(prev_wav_tail), overlap_wav_len, len(wav))
                        if n > 0:
                            ramp = np.linspace(0.0, 1.0, n, dtype=np.float32)
                            wav[:n] = wav[:n] * ramp + prev_wav_tail[:n] * (1 - ramp)
                    if overlap_wav_len > 0 and len(wav) > overlap_wav_len:
                        prev_wav_tail = wav[-overlap_wav_len:].copy()
                    emit = wav
                    if speed != 1.0 and speed > 0:
                        from wis_tpu_torch.audio.resample import resample

                        emit = resample(emit, int(voc.sample_rate * speed), voc.sample_rate)
                    emitted += valid
                    yield emit.astype(np.float32)
                if done or valid < c_i:
                    break
                # then keep pipeline_depth chunks queued ahead of the next fetch
                while launched < max_chunks and len(inflight) < self.pipeline_depth:
                    inflight.append(launch())
        finally:
            # chunks queued past a stop are dropped with their buffers; the
            # slot's queued work runs before the next stream's in it
            inflight.clear()
            if slot is not None:
                self._slots.release(slot)

    def inference_stream_split(self, text: str, language: str, *args,
                               enable_text_splitting: bool = False, **kwargs
                               ) -> Iterator[np.ndarray]:
        """``inference_stream``, optionally over the text's sentences in
        turn (the reference's enable_text_splitting)."""
        pieces = split_sentences(text) if enable_text_splitting else [text]
        for piece in pieces:
            if piece.strip():
                yield from self.inference_stream(piece, language, *args, **kwargs)

    def synthesize(self, *args, **kwargs) -> np.ndarray:
        """Non-streaming convenience: all chunks concatenated."""
        chunks = list(self.inference_stream(*args, **kwargs))
        if not chunks:
            return np.zeros(0, np.float32)
        return np.concatenate(chunks)


def split_sentences(text: str) -> list:
    """Naive sentence segmentation for enable_text_splitting."""
    parts = re.split(r"(?<=[.!?。！？])\s+", text.strip())
    return [p for p in parts if p]
