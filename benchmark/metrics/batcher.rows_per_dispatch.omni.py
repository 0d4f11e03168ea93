"""Requests per engine call: how many the dynamic batcher coalesced."""

from benchmark import readers


def read(run):
    cs = readers.calls(run)
    return sum(len(c["rids"]) for c in cs) / len(cs) if cs else None
