"""Device mesh and sharding rules over ``torch.distributed`` (port of
``wis_tpu/parallel/mesh.py``, with its names).

The JAX package lays its parameters out on a ``("data", "model")`` mesh
and lets GSPMD insert the collectives. Here every rank is a process of a
``torch.distributed`` world and the model code calls the collectives
itself, through the one object it sees, ``ModelAxis``:

- **Data parallelism**: the request batch is split along ``data``
  (``batch_sharding``); the ranks of one model row share nothing on the
  forward pass.
- **Tensor parallelism** (Megatron): attention heads and the MLP hidden
  width are split along ``model`` — q/k/v and mlp w1 column-parallel,
  the attention output and mlp w2 row-parallel — so each block needs one
  all-reduce per attention and one per MLP. The row-parallel products
  return f32 partial sums, reduced in f32 before the rounding and the
  bias (``axis.row_parallel``). The conv stem's two convs are
  column-parallel, each output all-gathered along D.

``make_mesh`` needs an initialised world (``parallel/world.py``
``run_world`` makes one, a process per rank); ``shard_params`` needs only
a ``Mesh``'s coordinates, so a ``Mesh`` built by hand slices a tree with
no world at all.

Backend: ``nccl`` where each rank has a card of its own, ``gloo`` where
ranks share a card or run on the CPU (``choose_backend``; the launcher
prints the choice). Over ``gloo`` the collectives on CUDA tensors travel
through the host, while every product and kernel stays on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from wis_tpu_torch.models.whisper.config import WhisperConfig
from wis_tpu_torch.ops.quant import is_quantized
from wis_tpu_torch.parallel.axis import ModelAxis, local_heads, row_parallel  # noqa: F401


class P(tuple):
    """A partition spec (``jax.sharding.PartitionSpec``): one entry per
    leading axis of a leaf, the mesh axis it is split along (``"data"`` or
    ``"model"``) or None; axes past the spec's length are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def choose_backend(devices: Sequence) -> str:
    """``"nccl"`` when every rank has a CUDA device of its own, else
    ``"gloo"`` (ranks on the CPU, or sharing a card)."""
    devs = [torch.device(d) for d in devices]
    own_cards = all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs)
    return "nccl" if own_cards else "gloo"


@dataclass
class Mesh:
    """A ``("data", "model")`` mesh as one rank holds it: the mesh's
    shape, this rank's (data, model) coordinates, its device and the
    backend, and an axis (``ModelAxis``) for its model row and its data
    column."""

    shape: Tuple[int, int]
    coords: Tuple[int, int]
    device: torch.device
    backend: Optional[str] = None
    model_axis: Optional[ModelAxis] = None
    data_axis: Optional[ModelAxis] = None

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.model_axis is None:
            self.model_axis = ModelAxis(self.shape[1], self.coords[1])
        if self.data_axis is None:
            self.data_axis = ModelAxis(self.shape[0], self.coords[0])

    def axis(self, name: str) -> ModelAxis:
        return {"data": self.data_axis, "model": self.model_axis}[name]


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ("data", "model") mesh over the first n_data · n_model ranks
    of the world; rank r sits at (r // n_model, r % n_model) on
    ``devices[r]``, by default on the rank's current card (``run_world``
    sets it; raises without a card: a CPU mesh names ``"cpu"`` for every
    rank). Every rank of the world must call it, in the same order as its
    other ``make_mesh`` calls: each creates one process group per model
    row and per data column (``new_group`` blocks until every rank has
    made the same call). A rank outside the mesh raises once the groups
    exist."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    n = n_data * n_model
    if n < 1 or n > world:
        raise ValueError(f"mesh ({n_data} x {n_model}) does not fit a world of {world}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device for this rank; a CPU mesh "
                               "passes devices=['cpu'] * world_size")
        devices = [None] * world
        devices[rank] = torch.device("cuda", torch.cuda.current_device())
    devices = list(devices)
    rows = [[d * n_model + m for m in range(n_model)] for d in range(n_data)]
    cols = [[d * n_model + m for d in range(n_data)] for m in range(n_model)]
    row_groups = [dist.new_group(r) for r in rows] if n_model > 1 else [None] * n_data
    col_groups = [dist.new_group(c) for c in cols] if n_data > 1 else [None] * n_model
    if rank >= n:
        raise ValueError(f"rank {rank} lies outside the mesh ({n_data} x {n_model})")
    d, m = divmod(rank, n_model)
    return Mesh(
        shape=(n_data, n_model),
        coords=(d, m),
        device=torch.device(devices[rank]),
        backend=dist.get_backend(),
        model_axis=ModelAxis(n_model, m, row_groups[d]),
        data_axis=ModelAxis(n_data, d, col_groups[m]),
    )


# --------------------------------------------------------------------------- #
# Whisper tensor-parallel sharding specs
# --------------------------------------------------------------------------- #
def _block_specs(cross: bool) -> dict:
    """Specs for one stacked block tree (leading layer axis): column-parallel
    in-projections (the output/head axis split), row-parallel
    out-projections (the input axis split)."""
    attn = {
        "q_w": P(None, None, "model"),
        "q_b": P(None, "model"),
        "k_w": P(None, None, "model"),
        "v_w": P(None, None, "model"),
        "v_b": P(None, "model"),
        "o_w": P(None, "model", None),
        "o_b": P(None, None),
    }
    out = {
        "attn_ln": {"g": P(None, None), "b": P(None, None)},
        "attn": dict(attn),
        "mlp_ln": {"g": P(None, None), "b": P(None, None)},
        "mlp": {
            "w1": P(None, None, "model"),
            "b1": P(None, "model"),
            "w2": P(None, "model", None),
            "b2": P(None, None),
        },
    }
    if cross:
        out["cross_ln"] = {"g": P(None, None), "b": P(None, None)}
        out["cross"] = dict(attn)
    return out


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def whisper_param_specs(cfg: WhisperConfig, tensor_parallel: bool = True) -> dict:
    """Spec tree matching the whisper parameter tree;
    tensor_parallel=False → every leaf replicated (pure data parallelism)."""
    if not tensor_parallel:
        return _map(lambda _: P(), _skeleton(cfg))
    return {
        "encoder": {
            "conv1": {"w": P(None, None, "model"), "b": P("model")},
            "conv2": {"w": P(None, None, "model"), "b": P("model")},
            "pos": P(None, None),
            "blocks": _block_specs(cross=False),
            "ln_post": {"g": P(None), "b": P(None)},
        },
        "decoder": {
            "tok_emb": P(None, None),
            "pos": P(None, None),
            "blocks": _block_specs(cross=True),
            "ln": {"g": P(None), "b": P(None)},
        },
    }


# --------------------------------------------------------------------------- #
# XTTS GPT tensor-parallel sharding specs
# --------------------------------------------------------------------------- #
def xtts_gpt_param_specs() -> dict:
    """Spec tree for the XTTS GPT tree (``models/xtts/gpt.py``
    ``random_gpt``): q/k/v and mlp_w1 column-parallel (whole heads a
    shard), proj_w and mlp_w2 row-parallel; embeddings, LayerNorms and the
    1026-way audio-code head replicated; the cache follows the heads
    (``xtts_cache_spec``)."""
    col_w, col_b = P(None, None, "model"), P(None, "model")
    row_w, repl_b = P(None, "model", None), P(None, None)
    ln = P(None, None)
    return {
        "text_emb": P(None, None),
        "text_pos": P(None, None),
        "audio_emb": P(None, None),
        "audio_pos": P(None, None),
        "blocks": {
            "ln1_g": ln, "ln1_b": ln,
            "q_w": col_w, "q_b": col_b,
            "k_w": col_w, "k_b": col_b,
            "v_w": col_w, "v_b": col_b,
            "proj_w": row_w, "proj_b": repl_b,
            "ln2_g": ln, "ln2_b": ln,
            "mlp_w1": col_w, "mlp_b1": col_b,
            "mlp_w2": row_w, "mlp_b2": repl_b,
        },
        "gpt_lnf_g": P(None), "gpt_lnf_b": P(None),
        "lnf_g": P(None), "lnf_b": P(None),
        "head_w": P(None, None),
        "head_b": P(None),
    }


def xtts_cache_spec() -> P:
    """KV cache (L, B, H, T, Dh): heads follow the column-split q/k/v."""
    return P(None, None, "model", None, None)


def _skeleton(cfg: WhisperConfig) -> dict:
    """A tree with the parameters' structure and no data (the meta
    device), for replicated spec trees."""
    from wis_tpu_torch.models.whisper.weights import random_params

    micro = WhisperConfig(
        name="skeleton",
        n_audio_state=8,
        n_audio_head=2,
        n_audio_layer=1,
        n_text_state=8,
        n_text_head=2,
        n_text_layer=1,
        n_vocab=64,
        n_audio_ctx=4,
        n_text_ctx=4,
    )
    return random_params(micro, seed=0, device="meta")


def expand_specs_for_quant(specs, params) -> dict:
    """Adapt a spec tree to a (possibly) int8-quantized parameter tree.

    A quantized leaf {"q": (..., K, N), "s": (..., 1, N)} gives "q" the
    weight's spec; its per-output-channel scale "s" is split along the same
    output axis (the spec's last entry) and replicated otherwise — so a
    row-parallel weight's scale is whole on every rank. A per-ROW
    quantized leaf ("s" (..., R, 1), the tok_emb_q logits copy) splits its
    scale along the leading axes instead. A key with no spec of its own
    takes its base weight's ("tok_emb_q" → "tok_emb")."""

    def lookup(spec, k):
        if isinstance(spec, dict):
            if k in spec:
                return spec[k]
            if k.endswith("_q") and k[:-2] in spec:
                return spec[k[:-2]]
        return spec

    def walk(spec, param):
        if is_quantized(param):
            if len(spec) and param["s"].shape[-1] == 1:
                s_spec = P(*(tuple(spec[:-1]) + (None,)))
            elif len(spec):
                s_spec = P(*((None,) * (len(spec) - 1) + (spec[-1],)))
            else:
                s_spec = P()
            return {"q": spec, "s": s_spec}
        if isinstance(param, dict):
            return {k: walk(lookup(spec, k), v) for k, v in param.items()}
        return spec

    return {k: walk(lookup(specs, k), v) for k, v in params.items()}


def _has_quant(tree) -> bool:
    if is_quantized(tree):
        return True
    return isinstance(tree, dict) and any(_has_quant(v) for v in tree.values())


def _place(leaf: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A fresh contiguous copy on ``device`` (aligned, owning its storage)."""
    return torch.empty(leaf.shape, dtype=leaf.dtype, device=device).copy_(leaf)


def _shard_leaf(spec: P, leaf: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    for dim, name in enumerate(spec):
        if name is None:
            continue
        axis = mesh.axis(name)
        n = leaf.shape[dim]
        if n % axis.size:
            raise ValueError(f"axis {dim} of {n} does not split {axis.size} ways")
        step = n // axis.size
        leaf = leaf.narrow(dim, axis.index * step, step)
    return _place(leaf, mesh.device)


def _zip_specs(fn, specs, params, path=""):
    """fn(spec, leaf) over a spec tree (P leaves) and a tree of the same
    structure; a structural mismatch raises, as ``jax.tree.map`` does."""
    if _is_spec(specs):
        if not isinstance(params, torch.Tensor):
            raise ValueError(f"{path or '/'}: spec {specs} against a subtree")
        return fn(specs, params)
    if not isinstance(params, dict) or set(specs) != set(params):
        raise ValueError(f"{path or '/'}: spec keys {sorted(specs)} against "
                         f"{sorted(params) if isinstance(params, dict) else 'a leaf'}")
    return {k: _zip_specs(fn, specs[k], params[k], f"{path}/{k}") for k in params}


def shard_params(params, mesh: Mesh, specs) -> dict:
    """This rank's parameters: each leaf sliced along its spec's mesh axes
    at this rank's coordinates, as a fresh contiguous tensor on
    ``mesh.device``. A quantized tree (int8 {"q", "s"} leaves) expands the
    spec tree first (``expand_specs_for_quant``)."""
    if _has_quant(params):
        specs = expand_specs_for_quant(specs, params)
    return _zip_specs(lambda s, a: _shard_leaf(s, a, mesh), specs, params)


def replicate_params(params, mesh: Mesh) -> dict:
    """Every parameter whole on this rank's device (replica data
    parallelism)."""
    return _map(lambda a: _place(a, mesh.device), params)


def batch_sharding(mesh: Mesh):
    """Split the leading batch axis over the data axis (``P("data")``):
    → local(x), this data rank's slice of x's first axis."""
    size, index = mesh.shape[0], mesh.coords[0]

    def local(x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        if b % size:
            raise ValueError(f"batch {b} does not split {size} ways")
        return x.narrow(0, index * (b // size), b // size)

    return local
