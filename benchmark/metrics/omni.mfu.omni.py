"""Useful model FLOPs of the omni dispatches before the traced slice (each
real row's encoder window and connector, its prompt, each decode token
with the head, 6·d·f per routed expert row from the program's counters:
``work_omni.dispatch_flops``) over their summed ``omni_dispatch`` time at
the bf16 peak."""

from benchmark import program_omni


def read(run):
    return program_omni.mfu(run)
