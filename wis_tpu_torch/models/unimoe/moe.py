"""Uni-MoE-2.0-Omni's feed-forward: 2 fixed (shared) experts that every
token runs, and 4 dynamic experts plus 1 null expert under top-p routing.

Routing (``route``), in float32 (``fp32_gate``): p = softmax(h W_router)
over 5 slots, the 4 dynamic experts then the null one (assumed layout); a
token takes the fewest slots, by descending p (ties to the lower slot),
whose sum reaches ``top_p`` (0.7), at most ``top_k`` (2): slot j is taken
while the mass of the slots ahead of it is below ``top_p``. The null
expert computes nothing. The dynamic experts' outputs are weighted by
their p, not renormalised over the taken slots (assumed); no token is
dropped (``token_drop`` false).

``route`` returns, per token and slot, a code: the dynamic expert's index
(0-3), ``NULL`` (4) for the null expert, ``NOT_TAKEN`` for a slot past the
threshold and ``IDLE`` for every slot of a token not served (a padding row
or a row that has ended), so the experts skip it. A histogram of the codes,
added on the device into an accumulator (``count_into``, no host read), is
what the program's counters are made from (``counters``).

The fixed experts are one SwiGLU of twice their width: the sum of two
SwiGLUs is the SwiGLU over their concatenated units.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from wis_tpu_torch.ops.moe_experts import grouped_swiglu

#: codes past the dynamic experts (with 4 of them)
NULL, NOT_TAKEN, IDLE = 4, 5, 6
N_CODES = 7


def route(h: torch.Tensor, router_w: torch.Tensor, n_dynamic: int, top_p: float, top_k: int,
          valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (N, D), router_w (slots, D) → codes (N, top_k) int64 and the slots'
    probabilities (N, top_k) float32. ``valid`` (N,) bool marks the tokens
    served; the others get ``IDLE`` in every slot."""
    p = torch.softmax(F.linear(h.float(), router_w.float()), dim=-1)
    return select(p, n_dynamic, top_p, top_k, valid)


def select(p: torch.Tensor, n_dynamic: int, top_p: float, top_k: int,
           valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``route``'s choice from the router's float32 probabilities p (N,
    slots)."""
    top, idx = torch.sort(p, dim=-1, descending=True, stable=True)
    top, idx = top[:, :top_k], idx[:, :top_k]
    ahead = torch.cat([torch.zeros_like(top[:, :1]), torch.cumsum(top, -1)[:, :-1]], dim=-1)
    codes = torch.where(ahead < top_p, idx, n_dynamic + 1)
    if valid is not None:
        codes = torch.where(valid[:, None], codes, n_dynamic + 2)
    return codes, top


def count_into(acc: torch.Tensor, codes: torch.Tensor, n_dynamic: int) -> None:
    """Add a call's codes to ``acc`` (N_CODES + 1,) int64 on their device,
    in place and without a host read: one count per code, and 1 in the
    last entry for each dynamic expert given at least one row."""
    ones = torch.ones(codes.numel(), dtype=torch.int64, device=codes.device)
    hist = torch.zeros(N_CODES, dtype=torch.int64, device=codes.device)
    hist.scatter_add_(0, codes.reshape(-1), ones)
    acc[:N_CODES] += hist
    acc[N_CODES] += (hist[:n_dynamic] > 0).sum()


def counters(acc: torch.Tensor, top_k: int, n_dynamic: int = NULL) -> torch.Tensor:
    """``count_into``'s totals → (4,) int64 on their device: tokens (a token
    counted in each layer it passed through), dynamic-expert rows,
    null-expert rows, and experts with at least one row summed over the
    expert calls."""
    return torch.stack([acc[:IDLE].sum() // top_k, acc[:n_dynamic].sum(), acc[NULL],
                        acc[N_CODES]])


def shared_swiglu(h: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """The fixed experts: gate_up (2·W, D) stacks their gate rows then their
    up rows, down (D, W) their down columns."""
    g, u = F.linear(h, gate_up).chunk(2, dim=-1)
    return F.linear(F.silu(g) * u, down)


def moe(h: torch.Tensor, layer: dict, cfg, valid: Optional[torch.Tensor] = None,
        acc: Optional[torch.Tensor] = None,
        record: Optional[Callable[[torch.Tensor], None]] = None) -> torch.Tensor:
    """The layer's feed-forward for h (N, D): fixed experts plus the routed
    ones, in float32 (the residual stream's type); the
    routing counted into ``acc`` (``count_into``) and its codes handed to
    ``record``."""
    codes, probs = route(h, layer["router"], cfg.mlp_dynamic_expert_num, cfg.mlp_dynamic_top_p,
                         cfg.mlp_dynamic_top_k, valid)
    if acc is not None:
        count_into(acc, codes, cfg.mlp_dynamic_expert_num)
    if record is not None:
        record(codes)
    routed = grouped_swiglu(h, layer["w_gate"], layer["w_up"], layer["w_down"], codes, probs)
    return routed + shared_swiglu(h, layer["shared_gate_up"], layer["shared_down"]).float()
