"""Prefill slots: the fused ASR program's prompt prefill replayed from a
captured CUDA graph.

``decoding/beam.py``'s fused branch opens every call with the same work on
other numbers (``beam.prefill_state``): the prompt through the eager
decoder (``models/whisper/model.py`` ``prefill``: per layer three
LayerNorms, eight int8 products, masked self-attention and cross-attention
over the audio), the first token's log-probabilities, and the fused loop's
layouts — the flat time-major caches, the padded cross-KV and its int8
columns. That is some 3,000 launches of a few microseconds of device work
each: launched from Python, they keep the card idle far longer than they
keep it busy. A slot holds every tensor that work reads at a fixed address
— the prompt (B, P), the cross-KV k and v (L, B, H, Dh, S), the first
token's mask — and the outputs of one graph captured over them. A call is
then three copies in and one replay, and the decode loop reads the graph's
outputs.

A model's ``PrefillSlots`` (``LoadedModel.prefill_slots``, which the engine
hands to every fused program it runs) makes a key's slot at its first ask
(``get``): every program of the model that prefills one shape shares it,
whatever else the programs differ in (audio bucket, language detection,
translation, decode bucket). The key is ``build_generate_xa``'s
``prefill_key``: batch, beams, prompt length, cache length, int8 cross-KV
and the first token's mask rule. Slots are held for good, as the model's
packed weights are; ``PrefillSlot.bytes`` is what a slot added on the card.

The slots of a model serve one call at a time: the call holds the store's
``lock`` from its copies in until its decode loop, which reads the outputs,
has been launched. (In the engine every program runs under ``device_lock``
besides.) Replays run on the caller's current stream. So a graph's outputs
are dead once its call has queued its last read of them, and the store's
graphs share one memory pool: a capture takes over the memory that the
captures before it freed (their intermediates), never their outputs, and a
replay that writes there again can only overwrite what an earlier call is
done with. The pool holds the largest capture's transient peak once, and
every slot's outputs.

At a key's first use the slot captures, on the store's side stream and one
capture at a time in the process: one eager prefill over the slot's inputs (it builds
the kernels and brings cuBLAS up on that stream; its outputs are dropped),
then the capture in ``thread_local`` mode; the call then replays. The int8
products launched under the capture are counted by ``int8_matmul`` in its
``captured`` tally; the graph keeps that number, the warm-up's products are
taken back from ``int8_matmul.launches`` by it, and each replay adds it
there again. The warm-up's products share the card's split-K counters
(``ops/quant``) with whatever else the process launches meanwhile: the
engine captures under its ``device_lock``, so no other ASR product runs.

The call's record (``utils/timing``) counts ``asr.prefill_graph`` (a
prefill replayed) and ``asr.prefill_captures``; the eager prefill of
``beam.py`` counts ``asr.prefill_eager``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from wis_tpu_torch.ops.quant import int8_matmul
from wis_tpu_torch.utils.timing import count

#: one capture at a time in the process, so ``int8_matmul.captured`` counts
#: that capture's products alone
_CAPTURE = threading.Lock()


class PrefillSlot:
    """One prefill key's inputs, graph and outputs (see the module)."""

    def __init__(self, store: "PrefillSlots", key: tuple):
        self.store, self.key = store, key
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: (prompt, xa_k, xa_v): the graph's inputs, copied in at each call
        self.inputs: Tuple[torch.Tensor, ...] = ()
        #: the first token's mask: the key's own, copied in once
        self.begin_sup: Optional[torch.Tensor] = None
        self.out = None
        #: int8 products one replay launches
        self.tally = 0
        #: device bytes the slot added: its inputs and what its capture grew
        #: the store's memory pool by
        self.bytes = 0

    def run(self, body: Callable, prompt: torch.Tensor, xa_kv, begin_sup: torch.Tensor):
        """``body(prompt, (xa_k, xa_v), begin_sup)`` replayed over the
        slot's copies of its arguments → the graph's outputs, which the
        slot's next call overwrites."""
        if self.graph is None:
            self._capture(body, prompt, xa_kv, begin_sup)
        else:
            for mine, theirs in zip(self.inputs, (prompt, *xa_kv)):
                mine.copy_(theirs)
        self.graph.replay()
        int8_matmul.launches += self.tally
        count("asr.prefill_graph")
        return self.out

    def _capture(self, body: Callable, prompt, xa_kv, begin_sup) -> None:
        dev, store = prompt.device, self.store
        if store.pool is None:
            store.pool, store.side = torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev)
        with _CAPTURE:
            self.inputs = (prompt.clone(), xa_kv[0].clone(), xa_kv[1].clone())
            self.begin_sup = bs = begin_sup.clone()
            p, xk, xv = self.inputs
            cur, side = torch.cuda.current_stream(dev), store.side
            side.wait_stream(cur)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                body(p, (xk, xv), bs)
                before, reserved = int8_matmul.captured, torch.cuda.memory_reserved(dev)
                graph.capture_begin(pool=store.pool, capture_error_mode="thread_local")
                try:
                    out = body(p, (xk, xv), bs)
                finally:
                    graph.capture_end()
                self.tally = int8_matmul.captured - before
                int8_matmul.launches -= self.tally  # the warm-up's products are no prefill
                pool = torch.cuda.memory_reserved(dev) - reserved
            cur.wait_stream(side)
            self.out, self.graph = out, graph
            self.bytes = pool + sum(t.numel() * t.element_size() for t in (*self.inputs, bs))
        count("asr.prefill_captures")


class PrefillSlots:
    """One model's prefill slots by key, their lock and their graphs'
    memory pool (see the module)."""

    def __init__(self):
        self.slots: Dict[tuple, PrefillSlot] = {}
        #: held by a call from its slot's copies in to its decode loop's launch
        self.lock = threading.Lock()
        #: the graphs' shared memory pool and the stream they are captured
        #: on (the allocator reuses a freed block on its own stream only),
        #: made at the first capture
        self.pool = None
        self.side: Optional[torch.cuda.Stream] = None

    def get(self, key: tuple) -> PrefillSlot:
        """``key``'s slot, made at the first ask; the caller holds ``lock``."""
        slot = self.slots.get(key)
        if slot is None:
            slot = self.slots[key] = PrefillSlot(self, key)
        return slot

    @property
    def bytes(self) -> int:
        return sum(s.bytes for s in self.slots.values())
