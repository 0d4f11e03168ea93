"""Share of the time inside the ASR program's ``asr.decode`` ranges (the
token loop) in which no operation ran on the device (traced slice)."""

from benchmark import program


def read(run):
    return program.decode_idle_share(run)
