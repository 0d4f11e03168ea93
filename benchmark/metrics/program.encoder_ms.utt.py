"""Device time of the log-mel, encoder and cross-KV a real window: the
median over dispatches of the device time launched inside ``asr.encode``
over the dispatch's ``rows=`` (traced slice)."""

from benchmark import program


def read(run):
    return program.encoder_ms_per_row(run)
