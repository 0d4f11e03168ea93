"""Set-up seconds: process start to the window's start (weights from the
seed, warm-up of the cell's shapes, the kernels' build on a first run)."""


def read(run):
    return run.setup_s
