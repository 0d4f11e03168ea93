"""Host time of one decode step's launch (the end-flag update and the
step graph's replay): the median ``omni.step`` span of the omni dispatches
before the traced slice."""

from benchmark import program_omni


def read(run):
    return program_omni.step_ms(run)
