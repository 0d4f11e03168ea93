"""The one-call speech-to-text program of Uni-MoE-2.0-Omni (``run_omni``;
the pattern of ``decoding/fused.py``'s ASR program).

int16 audio (B, n_samples) → log-mel (128 bins) → the Whisper-large encoder
→ the connector's 200 audio tokens, framed by the prompt's text tokens →
prefill of every row in one pass → greedy decode through the KV cache →
one packed int32 tensor:

    [tokens (B·max_new)] [lengths (B)] [counters (8)]

A row's reply is its tokens up to its first EOS (included) or its cap; the
batch decodes to the largest cap, a row that has ended riding along with
its experts skipped (``moe.IDLE``), as are the padding rows past ``rows``.
The counters (``moe.counters``: tokens, dynamic-expert rows, null-expert
rows, experts touched, over the whole dispatch, then over its prefill)
accumulate on the device and come back with the tokens, in the dispatch's
one host read. Every ``SYNC_EVERY`` steps one host read of the rows' end
flags lets a batch whose rows all ended stop early.

The decode steps replay a CUDA graph (``StepSlot``): a step is some 2000
small launches over 28 layers, which the host takes several times longer
to launch than the card takes to run them. A slot, one per batch bucket
of a model, holds the KV cache and every input and output of a step at a
fixed address and captures ``model.step`` once; the prefill writes the
same cache eagerly. A step is then three copies in and one replay
(``ops/graphs``: a pool a slot; each replay counts its launches). On the
CPU the step runs eagerly.

Spans (``utils/timing``): ``omni.encode``, ``omni.prefill``, ``omni.decode``
and inside it one ``omni.step`` per decode step (the host launching the
step), ``omni.sync`` for the end-flag reads (counted), and
``omni.capture`` (counted) when a slot captures its graph.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from wis_tpu_torch.audio.mel import N_SAMPLES, log_mel
from wis_tpu_torch.models.unimoe import model as M
from wis_tpu_torch.models.unimoe.config import OmniConfig
from wis_tpu_torch.models.unimoe.moe import N_CODES, counters
from wis_tpu_torch.ops.graphs import GraphPool
from wis_tpu_torch.utils.timing import count, span

#: decode steps between two host reads of the rows' end flags
SYNC_EVERY = 16
N_COUNTERS = 8


class StepSlot:
    """One batch bucket's decode state at fixed addresses: the KV cache
    (``max_len`` positions), the step's tokens, position, served rows and
    routing accumulator, and on the card the step's captured graph."""

    def __init__(self, params: dict, cfg: OmniConfig, batch: int, max_len: int, device,
                 dtype: torch.dtype):
        self.params, self.cfg = params, cfg
        self.cache = M.OmniCache.zeros(cfg, batch, max_len, dtype, device)
        self.tables = M.rope_tables(cfg, max_len, device)
        self.tok = torch.zeros(batch, dtype=torch.long, device=device)
        self.pos = torch.zeros(1, dtype=torch.long, device=device)
        self.valid = torch.zeros(batch, dtype=torch.bool, device=device)
        self.acc = torch.zeros(N_CODES + 1, dtype=torch.int64, device=device)
        self.graphs = GraphPool(device)
        self.graph = None

    def _step(self) -> torch.Tensor:
        return M.step(self.params, self.tok, self.pos, self.cache, self.cfg, self.tables,
                      self.valid, self.acc)

    def run(self, tok: torch.Tensor, pos: int, valid: torch.Tensor) -> torch.Tensor:
        """The next tokens (B,) after ``tok`` at position ``pos``."""
        self.tok.copy_(tok)
        self.pos.fill_(pos)
        self.valid.copy_(valid)
        if self.tok.device.type != "cuda":
            return self._step()
        if self.graph is None:
            count("omni.capture")
            with span("omni.capture"):
                self.graph = self.graphs.capture(self._step, self._warm)
        return self.graph.replay()

    def _warm(self) -> None:
        """The capture's eager step: it writes the cache column at ``pos``, as
        the replay does again; its routing counts are taken back."""
        acc = self.acc.clone()
        self._step()
        self.acc.copy_(acc)


@torch.inference_mode()
def run_omni(params: dict, cfg: OmniConfig, audio_i16: torch.Tensor, caps: Sequence[int],
             rows: int, slots: Dict, max_len: int) -> torch.Tensor:
    """One dispatch: audio_i16 (B, n_samples ≤ 30 s) on the device, B the
    batch bucket, its first ``rows`` real; caps (B ints) → packed int32 on
    the device, of ``packed_width(B, max(caps))``. ``slots`` (the model's:
    ``LoadedOmni.slots``) keeps each batch bucket's ``StepSlot`` across
    dispatches; its cache holds ``max_len`` positions, the prompt and the
    largest cap."""
    batch, dev = audio_i16.shape[0], audio_i16.device
    prompt_len = cfg.prompt_len
    max_new = max(int(c) for c in caps)
    if prompt_len + max_new > max_len:
        raise ValueError(f"cap {max_new} over the cache's {max_len - prompt_len} positions")
    with span("omni.encode"):
        audio = F.pad(audio_i16.float() / 32768.0, (0, N_SAMPLES - audio_i16.shape[-1]))
        mel = log_mel(audio, n_mels=cfg.encoder.n_mels)
        x = M.embed_prompt(params, M.audio_tokens(params, mel, cfg), cfg)
    slot = slots.get(batch)
    if slot is None:
        slot = slots[batch] = StepSlot(params, cfg, batch, max_len, dev, params["embed"].dtype)
    served = torch.arange(batch, device=dev) < rows
    caps_d = torch.tensor([int(c) for c in caps], dtype=torch.int32, device=dev)
    pre = torch.zeros(N_CODES + 1, dtype=torch.int64, device=dev)
    slot.acc.zero_()
    with span("omni.prefill"):
        h = M.prefill(params, x, slot.cache, cfg, slot.tables,
                      valid=served[:, None].expand(batch, prompt_len).reshape(-1), acc=pre)
        tok = M.logits(params, h[:, -1]).argmax(-1)
    out = torch.zeros(batch, max_new, dtype=torch.int32, device=dev)
    lengths = torch.zeros(batch, dtype=torch.int32, device=dev)
    done = ~served
    with span("omni.decode"):
        for i in range(max_new):
            with span("omni.step"):
                out[:, i] = tok.to(torch.int32)
                lengths += (~done).to(torch.int32)
                done = done | (tok == cfg.eos_token_id) | (caps_d <= i + 1)
                if i + 1 == max_new:
                    break
                tok = slot.run(tok, prompt_len + i, ~done)
            if (i + 1) % SYNC_EVERY == 0:
                count("omni.sync")
                with span("omni.sync"):
                    if bool(done.all()):
                        break
    k, e = cfg.mlp_dynamic_top_k, cfg.mlp_dynamic_expert_num
    ctr = torch.cat([counters(pre + slot.acc, k, e), counters(pre, k, e)])
    return torch.cat([out.reshape(-1), lengths, ctr.to(torch.int32)])


def packed_width(batch: int, max_new: int) -> int:
    return batch * max_new + batch + N_COUNTERS


def unpack_omni(packed: np.ndarray, batch: int, max_new: int):
    """Host-side → (tokens (B, max_new), lengths (B,), counters (8,))."""
    tokens = packed[: batch * max_new].reshape(batch, max_new)
    lengths = packed[batch * max_new: batch * max_new + batch]
    return tokens, lengths, packed[batch * max_new + batch:]
