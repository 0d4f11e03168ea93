"""Audio seconds transcribed per second of the window: each answered
request's audio weighted by the share of its time (sent to answered) that
falls inside the window."""

from benchmark import stats


def read(run):
    done = sum(r["audio_s"] * stats.overlap_share(r["sent"], r["end"], run.t0, run.t1)
               for r in run.requests if r["ok"])
    return done / run.seconds
