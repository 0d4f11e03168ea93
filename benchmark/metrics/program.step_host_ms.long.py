"""Host time to launch one decode step (the fused step and the beam
selection, from the loop's top to its stop check): the median over engine
calls of Σ ``asr.step`` ms over the call's ``asr.step`` count."""

from benchmark import program


def read(run):
    return program.step_host_ms(run)
