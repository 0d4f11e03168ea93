"""The fused logits/top-k head's share of its roofline: Σ least time of
each call from its shapes over Σ its device time."""

from benchmark import readers

HEAD = ("logits_topk_kernel",)


def read(run):
    return readers.head_roofline(run, HEAD)
