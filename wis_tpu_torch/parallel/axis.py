"""The one object the model code sees of a mesh: ``ModelAxis``, a mesh
axis as a rank holds it, with the collectives over its process group;
``local_heads``, the heads a rank holds; and ``row_parallel``, the
product whose input axis is split across the ranks. No model imports,
so the model layers depend on this and not on ``mesh.py``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from wis_tpu_torch.ops.quant import Weight, qmatmul


class ModelAxis:
    """One mesh axis as a rank sees it: ``size`` ranks along it, this
    rank at ``index``, and the collectives over its process group (the
    identity at size 1). ``collectives`` counts the calls."""

    def __init__(self, size: int, index: int, group=None):
        self.size = size
        self.index = index
        self.group = group
        self.collectives = 0

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The f32 sum of every rank's ``t`` (t is reduced in f32)."""
        t = t.float()
        if self.size > 1:
            self.collectives += 1
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        if self.size > 1:
            self.collectives += 1
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim``, in axis order."""
        if self.size == 1:
            return t
        self.collectives += 1
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """The ``t`` of the rank at axis index ``src``, on every rank."""
        t = t.clone()
        if self.size > 1:
            self.collectives += 1
            dist.broadcast(t, group_src=src, group=self.group)
        return t


def local_heads(n_heads: int, tp: Optional[ModelAxis]) -> int:
    """The heads this rank holds: all of them, or under tensor parallelism
    its 1/tp.size share (column-parallel q/k/v keep whole heads)."""
    if tp is None:
        return n_heads
    if n_heads % tp.size:
        raise ValueError(f"{n_heads} heads do not split {tp.size} ways")
    return n_heads // tp.size


def row_parallel(x: torch.Tensor, w: Weight, tp: Optional[ModelAxis]) -> torch.Tensor:
    """x @ w in x's dtype (``qmatmul``). Under ``tp`` x and w hold this
    rank's share of the input axis: the ranks' f32 partial sums are
    all-reduced in f32 and rounded to x's dtype once, after the sum, as
    GSPMD's psum of the f32 product does."""
    if tp is None:
        return qmatmul(x, w)
    return tp.all_reduce_sum(qmatmul(x, w, out_dtype=torch.float32)).to(x.dtype)
