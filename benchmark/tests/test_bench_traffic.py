"""The traffic generator: deterministic per seed, keeps to its mix, and
gives every seed the same sizes and gaps in another order."""

import json
import math
from pathlib import Path

import pytest

from benchmark import traffic

MIXES = Path(__file__).resolve().parent.parent / "traffic"


def mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["asr-utterances", "tts-replies", "asr-longform"])
def test_same_seed_same_requests(name):
    a = traffic.schedule(mix(name), 4000000007, 30.0)
    b = traffic.schedule(mix(name), 4000000007, 30.0)
    assert a == b
    c = traffic.schedule(mix(name), 4000000008, 30.0)
    assert a != c


@pytest.mark.parametrize("name", ["asr-utterances", "tts-replies", "asr-longform"])
def test_seeds_share_sizes_in_another_order(name):
    m = mix(name)
    key = "audio_s" if "audio_s" in m["fields"] else "chars"
    a = traffic.schedule(m, 11, 30.0)
    b = traffic.schedule(m, 2**31 + 5, 30.0)
    assert sorted(r[key] for r in a) == pytest.approx(sorted(r[key] for r in b))
    assert [r[key] for r in a] != [r[key] for r in b]


def test_open_loop_keeps_rate_and_window():
    m = mix("asr-utterances")
    reqs = traffic.schedule(m, 5, 30.0)
    assert len(reqs) == round(m["rate_per_s"] * 30)
    dues = [r["due"] for r in reqs]
    assert dues == sorted(dues) and dues[0] == 0.0 and dues[-1] < 30.0
    gaps = [b - a for a, b in zip(dues, dues[1:])]
    assert sum(gaps) / len(gaps) == pytest.approx(1 / m["rate_per_s"], rel=0.05)


def test_fields_keep_their_bounds_and_rules():
    reqs = traffic.schedule(mix("asr-utterances"), 6, 30.0)
    assert all(1.0 <= r["audio_s"] <= 8.0 for r in reqs)
    assert all(r["max_tokens"] == math.ceil(3 * r["audio_s"] + 2 - 1e-9) for r in reqs)
    assert sorted(r["audio_s"] for r in reqs)[len(reqs) // 2] == pytest.approx(3.0, rel=0.05)
    tts = traffic.schedule(mix("tts-replies"), 7, 30.0)
    assert all(25 <= r["chars"] <= 120 for r in tts)


def test_closed_loop_pool():
    m = mix("asr-longform")
    reqs = traffic.schedule(m, 8, 30.0)
    assert len(reqs) == m["pool"] and "due" not in reqs[0]
    assert all(60 <= r["audio_s"] <= 300 for r in reqs)
