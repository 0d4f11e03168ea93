"""The fused Whisper decode step's share of its roofline: Σ least time of
each call from its shapes over Σ device time of the step's kernels."""

from benchmark import readers

#: the kernels of one fused step call
STEP = ("int8_product_kernel", "self_attention_kernel", "cross_attention_kernel")
#: launched once per step call
HEAD = ("logits_topk_kernel",)


def read(run):
    return readers.decode_step_roofline(run, STEP, HEAD)
