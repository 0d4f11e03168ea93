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
besides.) So a graph's outputs are dead once its call has queued its last
read of them, and the store's graphs share one ``ops/graphs.GraphPool``: it
holds the largest capture's transient peak once, and every slot's outputs.
A key's first call captures its slot's graph, warmed up by one eager
prefill, whose int8 products share the card's split-K counters
(``ops/quant``) with whatever else the process launches: the engine
captures under its ``device_lock``, so no other ASR product runs.

The call's record (``utils/timing``) counts ``asr.prefill_graph`` (a
prefill replayed) and ``asr.prefill_captures``; the eager prefill of
``beam.py`` counts ``asr.prefill_eager``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from wis_tpu_torch.ops.graphs import Graph, GraphPool
from wis_tpu_torch.utils.timing import count


class PrefillSlot:
    """One prefill key's inputs and graph (see the module)."""

    def __init__(self, key: tuple, pools: Dict[torch.device, GraphPool]):
        #: the store's ``pools``, not the store: no cycle keeps them on the card
        self.key, self.pools = key, pools
        self.graph: Optional[Graph] = None
        #: (prompt, xa_k, xa_v, first token's mask): the graph's inputs, the
        #: first three copied in at each call, the mask (the key's own) once
        self.inputs: Tuple[torch.Tensor, ...] = ()
        #: device bytes the slot added: its inputs and what its capture grew
        #: the store's memory pool by
        self.bytes = 0

    def run(self, body: Callable, prompt: torch.Tensor, xa_kv, begin_sup: torch.Tensor):
        """``body(prompt, (xa_k, xa_v), begin_sup)`` replayed over the
        slot's copies of its arguments → the graph's outputs, which the
        slot's next call overwrites."""
        if self.graph is None:
            self.inputs = p, xk, xv, bs = tuple(t.clone() for t in (prompt, *xa_kv, begin_sup))
            graphs = self.pools.setdefault(prompt.device, GraphPool(prompt.device))
            self.graph = graphs.capture(lambda: body(p, (xk, xv), bs))
            self.bytes = self.graph.bytes + sum(t.numel() * t.element_size() for t in self.inputs)
            count("asr.prefill_captures")
        else:
            for mine, theirs in zip(self.inputs, (prompt, *xa_kv)):
                mine.copy_(theirs)
        count("asr.prefill_graph")
        return self.graph.replay()


class PrefillSlots:
    """One model's prefill slots by key, their lock and their graphs'
    memory pool (see the module)."""

    def __init__(self):
        self.slots: Dict[tuple, PrefillSlot] = {}
        #: held by a call from its slot's copies in to its decode loop's launch
        self.lock = threading.Lock()
        #: device → the pool every slot of the model captures into, made at
        #: the first capture
        self.pools: Dict[torch.device, GraphPool] = {}

    def get(self, key: tuple) -> PrefillSlot:
        """``key``'s slot, made at the first ask; the caller holds ``lock``."""
        slot = self.slots.get(key)
        if slot is None:
            slot = self.slots[key] = PrefillSlot(key, self.pools)
        return slot

    @property
    def bytes(self) -> int:
        return sum(s.bytes for s in self.slots.values())
