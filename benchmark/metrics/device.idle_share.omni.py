"""Share of the time inside ``omni_dispatch`` ranges in which no operation
ran on the device (traced slice)."""

from benchmark import program_omni


def read(run):
    return program_omni.idle_share(run)
