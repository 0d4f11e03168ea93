"""Dynamic experts a token ran, averaged over every (token, layer) the
dispatches before the traced slice served: Σ ``moe.expert_rows`` over Σ
``moe.tokens`` (0 to 2; the null expert and untaken slots add nothing)."""

from benchmark import program_omni


def read(run):
    return program_omni.experts_per_token(run)
