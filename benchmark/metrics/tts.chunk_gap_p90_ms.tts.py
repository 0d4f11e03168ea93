"""90th percentile of the gaps between consecutive audio chunks, over the
replies answered before the traced slice: the stream's tail beside the
end-to-end median."""

from benchmark import readers


def read(run):
    gaps = [(b - a) * 1e3 for r in run.requests if r["ok"] and r["end"] <= run.t_stamps
            for a, b in zip(r["chunks"], r["chunks"][1:])]
    return readers.percentile(gaps, 90)
