"""The one traffic generator: a mix's data file → a run's requests.

A mix (``traffic/<name>.json``) is an arrival process and a set of
fields::

    {"loop": "open", "rate_per_s": 12.0, "fields": {...}}
    {"loop": "closed", "clients": 2, "pool": 48, "fields": {...}}

An open loop sends ``round(rate · seconds)`` requests on a schedule of
Poisson gaps; a closed loop gives each client the next request of a pool
as soon as its last one is answered. Each field is a constant, a
distribution (``lognormal`` with ``median`` and ``sigma``, ``loguniform``,
``uniform``, each clipped to ``min``/``max``), or derived from another
field (``{"from": f, "mul": a, "add": b, "round": "ceil"}``).

Every seed gets the same set of sizes and gaps, in another order: a
distribution's n values are its quantiles at (i + 0.5) / n, shuffled by the
seed, and the gaps are scaled to fill the window exactly. So two seeds do
the same work, and only the order, the audio and the words differ. Each
request also carries ``content_seed`` for the system to draw its content
from.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import numpy as np

_NORMAL = statistics.NormalDist()


def _quantiles(spec: Dict, n: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    kind = spec["dist"]
    if kind == "lognormal":
        z = np.array([_NORMAL.inv_cdf(float(x)) for x in u])
        v = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    elif kind == "loguniform":
        lo, hi = math.log(spec["min"]), math.log(spec["max"])
        v = np.exp(lo + (hi - lo) * u)
    elif kind == "uniform":
        v = spec["min"] + (spec["max"] - spec["min"]) * u
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return np.clip(v, spec.get("min", -np.inf), spec.get("max", np.inf))


def _derive(spec: Dict, x: float):
    y = spec.get("mul", 1.0) * x + spec.get("add", 0.0)
    rounding = spec.get("round")
    if rounding == "ceil":
        return int(math.ceil(y - 1e-9))
    if rounding == "floor":
        return int(math.floor(y + 1e-9))
    if rounding == "nearest":
        return int(round(y))
    return float(y)


def draw(mix: Dict, n: int, rng: np.random.Generator) -> List[Dict]:
    """n requests with the mix's fields: each distribution's stratified
    values in a seeded order."""
    fields = mix.get("fields", {})
    cols: Dict[str, list] = {}
    for name, spec in fields.items():
        if isinstance(spec, dict) and "dist" in spec:
            cols[name] = list(rng.permutation(_quantiles(spec, n)))
    for name, spec in fields.items():
        if isinstance(spec, dict) and "from" in spec:
            cols[name] = [_derive(spec, x) for x in cols[spec["from"]]]
        elif not isinstance(spec, dict):
            cols[name] = [spec] * n
    seeds = rng.integers(0, 2**62, size=n)
    return [
        {"id": i, "content_seed": int(seeds[i]), **{k: _plain(v[i]) for k, v in cols.items()}}
        for i in range(n)
    ]


def _plain(v):
    if isinstance(v, np.generic):
        return v.item()
    return v


def schedule(mix: Dict, seed: int, seconds: float) -> List[Dict]:
    """The run's requests. Open loop: each has ``due``, seconds after the
    window opens, all inside it. Closed loop: the pool, in the order the
    clients take it."""
    rng = np.random.default_rng(seed)
    if mix["loop"] == "open":
        n = max(1, int(round(mix["rate_per_s"] * seconds)))
        reqs = draw(mix, n, rng)
        u = (np.arange(n) + 0.5) / n
        gaps = rng.permutation(-np.log1p(-u))
        gaps *= seconds / gaps.sum()
        due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        for r, t in zip(reqs, due):
            r["due"] = float(t)
        return reqs
    if mix["loop"] == "closed":
        return draw(mix, int(mix["pool"]), rng)
    raise ValueError(f"unknown loop {mix['loop']!r}")
