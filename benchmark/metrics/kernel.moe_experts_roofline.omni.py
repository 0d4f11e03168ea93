"""The grouped expert kernel's share of its roofline: Σ least time of its
calls in the traced dispatches (the touched experts' weights and the
routed rows' bytes, or their FLOPs, the larger: ``work_omni.
moe_experts_ms``, the prefill's calls and the steps' apart) over Σ device
time of ``moe_gate_up_kernel`` and ``moe_down_kernel`` launched there."""

from benchmark import program_omni


def read(run):
    return program_omni.moe_roofline(run)
