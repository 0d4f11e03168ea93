"""Model FLOPs of the real windows dispatched (encoder, cross-KV, prefill,
each beam row's decode steps with the logits head), counted from shapes,
over the summed asr_dispatch time at the bf16 peak. The int8 products count
against the bf16 peak."""

from benchmark import readers


def read(run):
    return readers.asr_mfu(run)
