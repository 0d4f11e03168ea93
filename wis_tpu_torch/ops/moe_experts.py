"""Routed experts: a grouped SwiGLU product over the rows each expert was
given, as two hand-written CUDA kernels (``csrc/moe_experts.cu``), and its
plain PyTorch version.

Replaces no TPU kernel: the JAX package runs no sparse-expert model. It is
the expert layer of Uni-MoE-2.0-Omni (``models/unimoe/moe.py``), where a
token runs 0, 1 or 2 of 4 dynamic experts of width 18944 at d 3584, as
its router decided. ``codes`` (N, K) names, for each token's K slots, the
dynamic expert it runs (0 ≤ code < E) or anything else (the null expert, a
slot not taken, a token not served), which computes nothing; ``weights``
(N, K) are the slots' router probabilities. The result, in float32, is

    y[t] = Σ_k [codes[t, k] < E] · weights[t, k] · (silu(h[t] Wg_e) ⊙ h[t] Wu_e) Wd_e

with e = codes[t, k], the SwiGLU's activation rounded to h's dtype between
the two products (as a bf16 model stores it).

On the card (``grouped_swiglu`` with a CUDA tensor):

1. The permutation, on the device and without a host sync: each (token,
   slot) pair gets its expert's key (E for every pair that computes
   nothing), a stable sort orders the pairs by expert, and a histogram with
   its running sum gives each expert's first sorted position and count.
2. ``moe_gate_up_kernel``, one launch for every dynamic expert's rows: block
   (e, m, n) gathers rows m·BM… of expert e's sorted pairs from h, runs
   them against the BN-wide tiles of Wg_e and Wu_e over the whole depth,
   and stores silu(g)·u as bf16 at the pairs' sorted positions. A block
   whose expert has no rows there returns at once, so an expert no token
   chose reads none of its weights, and null-routed rows cost nothing.
3. ``moe_down_kernel``, one launch: the same rows of the activation against
   Wd_e, the depth cut into ``wis_moe_down_splits`` parts (4 at decode, so
   few rows still spread over the SMs), each scaled by its slot's weight
   and stored in float32 at (part, pair); the parts and a token's slots are
   summed after.

Bound: at decode (≤ 16 pairs) the weights of the experts touched, 407 MB
an expert in bf16, streamed once: HBM bytes. In the prefill (thousands of
rows an expert) the products: tensor-core operations. ``launches`` counts
the kernel launches, replayed ones included (``ops/graphs``).
The kernels are built at the first launch, never when this module is
imported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wis_tpu_torch.ops import _build
from wis_tpu_torch.ops.graphs import launched


def grouped_swiglu_plain(h: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                         w_down: torch.Tensor, codes: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """The same function as a loop over the experts, in float32 with the
    activation rounded to h's dtype: (N, D) float32."""
    n, d = h.shape
    y = torch.zeros(n, d, dtype=torch.float32, device=h.device)
    for e in range(w_gate.shape[0]):
        tok, slot = torch.nonzero(codes == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok].float()
        act = (F.silu(x @ w_gate[e].float().T) * (x @ w_up[e].float().T)).to(h.dtype)
        y.index_add_(0, tok, (act.float() @ w_down[e].float().T) * weights[tok, slot, None])
    return y


def sort_pairs(codes: torch.Tensor, e_num: int):
    """The permutation, on the codes' device with no host read: the (token,
    slot) pairs (flat index token·K + slot) ordered by expert, stably, the
    pairs of no dynamic expert last → (order (N·K,) int32, counts (E + 1,)
    int32 with the pairs of no expert last, starts (E + 1,) int32: each
    expert's first position in ``order``)."""
    key = torch.clamp(codes.reshape(-1), 0, e_num).long()
    order = torch.argsort(key, stable=True).to(torch.int32)
    counts = torch.zeros(e_num + 1, dtype=torch.int32, device=codes.device)
    counts.scatter_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    starts = (torch.cumsum(counts, 0, dtype=torch.int32) - counts).contiguous()
    return order, counts, starts


def grouped_swiglu(h: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor, codes: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """h (N, D); w_gate, w_up (E, F, D); w_down (E, D, F); codes (N, K)
    integer; weights (N, K) float32 → (N, D) float32. A CUDA h runs the
    kernels (bf16 h and weights, contiguous); a CPU one the plain loop."""
    if h.device.type == "cpu":
        return grouped_swiglu_plain(h, w_gate, w_up, w_down, codes, weights)
    if h.device.type != "cuda":
        raise ValueError(f"grouped_swiglu: unsupported device {h.device}")
    n, d = h.shape
    e_num, f, d_w = w_gate.shape
    if d_w != d or w_up.shape != w_gate.shape or w_down.shape != (e_num, d, f):
        raise ValueError(f"grouped_swiglu: h {tuple(h.shape)} with gate {tuple(w_gate.shape)}, "
                         f"up {tuple(w_up.shape)}, down {tuple(w_down.shape)}")
    for name, t in (("h", h), ("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != h.device:
            raise ValueError(f"grouped_swiglu: {name} must be contiguous bf16 on {h.device}")
    if d % 128 or f % 128:
        raise ValueError(f"grouped_swiglu: d {d} and width {f} must be multiples of 128")
    if codes.shape != weights.shape or codes.shape[0] != n:
        raise ValueError(f"grouped_swiglu: codes {tuple(codes.shape)}, "
                         f"weights {tuple(weights.shape)} for {n} rows")
    k_slots = codes.shape[1]
    pairs = n * k_slots
    if n == 0:
        return torch.zeros(0, d, dtype=torch.float32, device=h.device)

    order, counts, starts = sort_pairs(codes, e_num)
    wts = weights.reshape(-1).float().contiguous()
    lib = _build.kernels()
    split = lib.wis_moe_down_splits(n, f)
    act = torch.empty(pairs, f, dtype=torch.bfloat16, device=h.device)
    # pairs that no dynamic expert takes keep their zero rows
    part = torch.zeros(split, pairs, d, dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.wis_moe_gate_up(h.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                                 act.data_ptr(), order.data_ptr(), counts.data_ptr(),
                                 starts.data_ptr(), n, e_num, d, f, k_slots, stream)
        _build.check(rc, "moe_gate_up")
        rc = lib.wis_moe_down(act.data_ptr(), w_down.data_ptr(), part.data_ptr(),
                              order.data_ptr(), counts.data_ptr(), starts.data_ptr(),
                              wts.data_ptr(), n, e_num, d, f, k_slots, split, stream)
        _build.check(rc, "moe_down")
    launched(grouped_swiglu, 2)
    y = part.sum(0) if split > 1 else part[0]
    return y.view(n, k_slots, d).sum(1)


grouped_swiglu.launches = 0
