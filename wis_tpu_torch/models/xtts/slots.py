"""Stream slots: the XTTS code loop replayed from captured CUDA graphs.

Every audio code of a stream is the same work on other numbers: the
embedding, the fused GPT step, the sampling epilogue and the history
update of ``gpt.decode_code``, about sixty launches around one kernel
chain of ~1.2 ms on an H100. Launched from Python, they take the host
longer than the card takes to run them. A slot holds, for one stream at a
time, every tensor a code reads or writes at a fixed address: the flat
K/V caches of each cache bucket it has met, the history, a gumbel row and
a latent per code, and the device scalars of ``gpt.CodeState`` (position,
history length, stop floor, knobs). It captures one graph per (cache
bucket, do_sample) from ``decode_code`` over them, and a chunk is then its
copies in, one replay per code and two copies out.

The host writes the chunk's position, history length, floor and knobs
into the slot's scalars, as it predicts them, and reads nothing back.
Tokens come out of the history (the code at ``hist_len`` is written
there), latents out of the slot's latent rows, each chunk's as a fresh
copy that later chunks leave alone.

``CodeSlots`` is the pool of one model on the card: ``acquire()`` gives a
free slot or, with every slot taken, a new one, whose graphs are captured
at the first use of each bucket; ``release()`` takes it back. The pool
keeps every slot it made, each with its caches and graphs (PERF.md gives
the memory a slot holds). Replays run on the caller's current CUDA stream,
where the chunks of every stream are queued, so a slot left by an
abandoned stream may be taken at once: its queued work runs first. Each
slot owns an ``ops/graphs.GraphPool``, as its graphs run one after another
on one stream; a capture warms up on copies of the slot's state, writing
only the cache column that the chunk's first code writes again.

The chunk's own record (``utils/timing``) counts ``tts.graph_codes`` (codes
replayed) and ``tts.graph_captures``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import torch

from wis_tpu_torch.models.xtts.gpt import CodeState, GPTConfig, SampleKnobs, decode_code
from wis_tpu_torch.ops.graphs import Graph, GraphPool
from wis_tpu_torch.utils.timing import count


class CodeSlot:
    """One stream's static buffers and graphs (see the module)."""

    def __init__(self, g: GPTConfig, dev: torch.device, dtype: torch.dtype):
        m, v = g.max_audio_tokens, g.n_audio_vocab
        self.state = CodeState(
            tok=torch.zeros((1,), dtype=torch.long, device=dev),
            pos=torch.zeros((), dtype=torch.int32, device=dev),
            hist_len=torch.zeros((), dtype=torch.long, device=dev),
            min_tokens=torch.zeros((), dtype=torch.long, device=dev),
            done=torch.zeros((1,), dtype=torch.bool, device=dev),
            history=torch.zeros((1, m), dtype=torch.long, device=dev),
            knobs=SampleKnobs.of(1.0, 1, 1.0, 1.0, v, dev),
        )
        self.gumbel = torch.zeros((m, 1, v), dtype=torch.float32, device=dev)
        self.latents = torch.zeros((1, m, g.d_model), dtype=dtype, device=dev)
        #: cache width → (kc, vc), each (L, D, width) bf16
        self.caches: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        #: (cache width, do_sample) → the graph of one code
        self.codes: Dict[Tuple[int, bool], Graph] = {}
        self.graphs = GraphPool(dev)

    def _cache(self, like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        width = like.shape[-1]
        if width not in self.caches:
            self.caches[width] = (torch.zeros_like(like), torch.zeros_like(like))
        return self.caches[width]

    def run(self, params, packed, step_fn, last_token, kc, vc, pos: int, history,
            hist_len: int, gumbel, knobs: tuple, min_tokens: int, do_sample: bool, *,
            cfg: GPTConfig, chunk: int, batch: int):
        """``run_decode_chunk_fused``'s chunk (batch 1, no fused head) in this
        slot: the same arguments and results, the caches and history
        returned being the slot's."""
        st, m = self.state, self.latents.shape[1]
        width = kc.shape[-1]
        if batch != 1:
            raise ValueError(f"a slot runs one stream (batch 1), not {batch}")
        if pos + chunk > width or hist_len + chunk > m:
            raise ValueError(f"a chunk of {chunk} codes at pos {pos}, hist_len {hist_len} "
                             f"overflows the cache ({width}) or the history ({m})")
        # the caller's tensors are copied in; the slot's own, which the
        # chunk before returned, are left (copy_ onto itself does nothing)
        skc, svc = self._cache(kc)
        skc.copy_(kc)
        svc.copy_(vc)
        st.history.copy_(history)
        st.tok.copy_(last_token)
        st.pos.fill_(pos)
        st.hist_len.fill_(hist_len)
        st.min_tokens.fill_(int(min_tokens))
        st.knobs.fill_(SampleKnobs.values(*knobs, cfg.n_audio_vocab))
        st.done.zero_()
        self.gumbel[hist_len:hist_len + chunk].copy_(gumbel)
        code = self.codes.get((width, do_sample))
        if code is None:
            code = self.codes[(width, do_sample)] = self._capture(params, packed, step_fn, skc,
                                                                  svc, cfg, do_sample)
        code.replay(chunk)
        count("tts.graph_codes", chunk)
        end = hist_len + chunk
        return (st.history[:, hist_len:end].clone(), self.latents[:, hist_len:end].clone(),
                skc, svc, pos + chunk, st.history, end, st.done.clone())

    def _capture(self, params, packed, step_fn, kc, vc, cfg, do_sample: bool) -> Graph:
        """One code over the slot's buffers as a graph, warmed up on copies of
        its state and scratch latents."""

        def code(st: CodeState, latents) -> None:  # its gumbel and latent rows at hist_len
            i = st.hist_len.clamp(max=latents.shape[1] - 1).view(1)
            _, hidden = decode_code(params, packed, step_fn, kc, vc, st,
                                    self.gumbel.index_select(0, i)[0], cfg=cfg, batch=1,
                                    do_sample=do_sample)
            latents.index_copy_(1, i, hidden[:, None])

        st = self.state
        scratch = st._replace(tok=st.tok.clone(), pos=st.pos.clone(), hist_len=st.hist_len.clone(),
                              done=st.done.clone(), history=st.history.clone())
        graph = self.graphs.capture(lambda: code(st, self.latents),
                                    lambda: code(scratch, torch.empty_like(self.latents)))
        count("tts.graph_captures")
        return graph


class CodeSlots:
    """The slots of one model on a CUDA device (see the module)."""

    def __init__(self, cfg: GPTConfig, device: torch.device, dtype: torch.dtype):
        self.cfg, self.device, self.dtype = cfg, torch.device(device), dtype
        if self.device.type != "cuda":
            raise ValueError(f"stream slots replay CUDA graphs: no slots on {self.device}")
        self.slots: List[CodeSlot] = []
        self._free: List[CodeSlot] = []
        self._lock = threading.Lock()  # the slots and the free list

    def acquire(self) -> CodeSlot:
        with self._lock:
            if self._free:
                return self._free.pop()
            slot = CodeSlot(self.cfg, self.device, self.dtype)
            self.slots.append(slot)
            return slot

    def release(self, slot: CodeSlot) -> None:
        with self._lock:
            self._free.append(slot)

    @property
    def captures(self) -> int:  # the code graphs its slots have captured
        return sum(len(s.codes) for s in list(self.slots))
