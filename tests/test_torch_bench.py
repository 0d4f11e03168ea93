"""The port's benchmark (``wis_tpu_torch/bench.py``) against ``bench.py``
on the CPU: the same rows in the same order with the same metric names,
units, token budgets, baselines and repeats; the same fixture audio; and a
whole run of ``main(["--device", "cpu"])`` on micro configs patched in for
large, medium, base and XTTS v2, whose rows' values are the audio's
duration over the median of the engine's ``infer_time_ms``. ``bench.py``
imports only numpy at module level, so it is read and called here without
a TPU.
"""

import ast
import inspect
import json
import os
import statistics
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench as jax_bench  # noqa: E402
from torch_port_helpers import SMALL, wav_bytes
from wis_tpu_torch import bench

torch.set_num_threads(1)


def _emitted_constants(fn):
    """{key: constant} of the row dict ``fn`` (a bench.py function) passes
    to ``_emit``; keys whose value is computed are left out."""
    tree = ast.parse(inspect.getsource(fn))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "_emit"
                and isinstance(node.args[0], ast.Dict)):
            return {k.value: v.value for k, v in zip(node.args[0].keys, node.args[0].values)
                    if isinstance(v, ast.Constant)}
    raise AssertionError(f"no _emit row in {fn.__name__}")


def _assigned(fn, name):
    """The constant tuple ``fn`` assigns to ``name`` (``runs, warmup = 5, 1``)."""
    for node in ast.walk(ast.parse(inspect.getsource(fn))):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Tuple):
            names = [t.id for t in node.targets[0].elts]
            if name in names:
                return tuple(v.value for v in node.value.elts)
    raise AssertionError(f"{name} not assigned in {fn.__name__}")


def test_configs_and_repeats_equal_bench_py():
    assert bench.CONFIGS == jax_bench.CONFIGS
    assert (bench.RUNS, bench.WARMUP) == (jax_bench.RUNS, jax_bench.WARMUP) == (10, 2)
    assert (bench.LONG_RUNS, bench.LONG_WARMUP) == _assigned(jax_bench._longform_row, "runs")
    src = inspect.getsource(jax_bench._tts_row)
    assert "range(5)" in src and src.count("stream_once()") == 3  # def, one warm-up, runs
    assert (bench.TTS_RUNS, bench.TTS_WARMUP) == (5, 1)


def _refuse_open(*args, **kwargs):
    raise FileNotFoundError(args[0] if args else "")


@pytest.mark.parametrize("name,synth_ms", sorted({(c[3], c[4]) for c in bench.CONFIGS}))
def test_load_fixture_noise_bit_equal(monkeypatch, name, synth_ms):
    """No reference clips: both fall back to the same seeded noise, bit for
    bit (bench.py's clip directory is made unreadable for the test)."""
    monkeypatch.setattr(jax_bench, "open", _refuse_open, raising=False)
    want = jax_bench._load_fixture(name, synth_ms)
    got = bench._load_fixture(name, synth_ms)
    assert got.dtype == want.dtype == np.int16
    assert np.array_equal(got, want)
    assert np.array_equal(bench._load_fixture(name, synth_ms, "/nonexistent-dir"), want)


def test_load_fixture_clip_bit_equal(monkeypatch, tmp_path):
    """With a clip present both decode it through their own load_audio to
    the same int16 samples."""
    clip = tmp_path / "3sec.flac"
    clip.write_bytes(wav_bytes(1.5, 4))  # a WAV under the clip's name: sniffed, not named
    real_open = open
    monkeypatch.setattr(jax_bench, "open", lambda path, mode="r": real_open(clip, mode),
                        raising=False)
    want = jax_bench._load_fixture("3sec.flac", 3840)
    got = bench._load_fixture("3sec.flac", 3840, str(tmp_path))
    assert want.shape == (24000,) and np.array_equal(got, want)


@pytest.fixture
def micro(monkeypatch):
    """Micro whisper configs under large, medium and base, a micro XTTS v2
    as the default config, one run of each row."""
    from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS, WhisperConfig
    from wis_tpu_torch.models.xtts import gpt as tg
    from wis_tpu_torch.models.xtts import hifigan as th
    from wis_tpu_torch.models.xtts import model as tm

    for size in ("large", "medium", "base"):
        monkeypatch.setitem(WHISPER_CONFIGS, size, WhisperConfig(**dict(SMALL, name=size)))
    gpt = dict(n_layer=2, n_head=2, d_model=32, n_text_vocab=256, n_audio_vocab=68,
               max_text_tokens=32, start_audio_token=66, stop_audio_token=67,
               max_audio_tokens=24)
    voc = dict(in_dim=32, cond_dim=16, upsample_initial=32, upsample_rates=(4, 2),
               upsample_kernels=(8, 4), resblock_kernels=(3,), resblock_dilations=((1, 3),),
               gpt_code_stride=16)
    cfg = tm.XTTSConfig(gpt=tg.GPTConfig(**gpt), vocoder=th.HiFiGANConfig(**voc),
                        text_buckets=(32, 64, 128), cond_len=4, left_context_frames=2,
                        gpt_cache_buckets=(128,))
    monkeypatch.setattr(tm, "XTTSConfig", lambda: cfg)
    for name, value in dict(RUNS=1, WARMUP=0, LONG_RUNS=1, LONG_WARMUP=0, TTS_RUNS=1,
                            TTS_WARMUP=0).items():
        monkeypatch.setattr(bench, name, value)


def test_main_on_the_cpu(micro, capsys):
    """Eight rows in bench.py's order, then the summary; each ASR row's
    value is the audio's duration over the median infer_time_ms (the
    throughput row: four requests over it), and every constant field
    equals bench.py's."""
    assert bench.main(["--device", "cpu"]) == 0
    captured = capsys.readouterr()
    rows = [json.loads(line) for line in captured.out.strip().splitlines()]
    raws = {r["metric"]: r for r in map(json.loads, captured.err.strip().splitlines())
            if "metric" in r}
    metrics = [c[0] for c in jax_bench.CONFIGS] + [
        "large-v2_beam5_batch4_throughput_req_s", "base_beam1_180s_realtime_x",
        "xtts_stream_rtf"]
    assert len(rows) == 9 and [r["metric"] for r in rows[:8]] == metrics
    for row, (metric, _m, _b, _f, _ms, budget, base_x, base_hw) in zip(rows, jax_bench.CONFIGS):
        audio_ms = bench._load_fixture(_f, _ms).shape[0] / 16.0
        med = statistics.median(raws[metric]["all_ms"])
        assert row["value"] == round(audio_ms / med, 2)
        assert row["vs_baseline"] == round(audio_ms / med / base_x, 3)
        assert (row["unit"], row["span"], row["token_budget"], row["baseline"]) == (
            "x_realtime", "single_shot", budget, f"{base_x}x {base_hw}")
        assert row["single_shot_ms"] == round(med, 1)
    through, long, tts = rows[5:8]
    med = statistics.median(raws[through["metric"]]["all_ms"])
    assert through["value"] == round(4000.0 / med, 2)
    assert long["value"] == round(180000.0 / statistics.median(raws[long["metric"]]["all_ms"]), 2)
    for row, fn in ((through, jax_bench._throughput_row), (long, jax_bench._longform_row),
                    (tts, jax_bench._tts_row)):
        want = _emitted_constants(fn)
        want.pop("span", None)  # "pipelined" there, "single_shot" here
        assert {k: row[k] for k in want} == want
    assert all(np.isfinite(r["value"]) and r["value"] > 0 for r in rows)
    summary = rows[8]
    assert summary["metric"] == metrics[0] and summary["value"] == rows[0]["value"]
    assert summary["device"] == {"name": "cpu", "power_limit": None}
    assert [r["metric"] for r in summary["rows"]] == metrics
    assert "tunnel" not in summary and "rtt_ms" not in rows[0]


@pytest.mark.skipif(torch.cuda.is_available(), reason="asserts the refusal without a card")
def test_main_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--device", "cuda"])


def test_cli_bench_passes_its_arguments(monkeypatch):
    from wis_tpu_torch import cli

    seen = []
    monkeypatch.setattr(bench, "main", lambda argv: seen.append(argv) or 0)
    assert cli.main(["bench", "--device", "cpu", "--fixtures", "clips"]) == 0
    assert cli.main(["bench"]) == 0
    assert seen == [["--device", "cpu", "--fixtures", "clips"], ["--device", "cuda"]]
