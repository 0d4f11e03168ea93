"""The harness end to end on the CPU at tiny widths: the result line's
shape, the refusals, no JAX module loaded, and a cell, configuration,
traffic mix and metric added as files alone and found by name."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import run as brun
from benchmark.tests.conftest import tiny_cell, tiny_whisper

ROOT = Path(__file__).resolve().parents[2]


def _cli(cwd, *args):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = _cli(ROOT, "--workload", "asr-utterances", "--seed", "1", "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_refuses_beside_only_its_own_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path, "--workload", "asr-utterances", "--seed", "2", "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""


def test_result_line_shape(cpu):
    c = tiny_cell("asr-utterances")
    run, peak, checks = brun.execute(c, 2**33 + 1, 2.0, False, cpu)
    result, rows = brun.result_line(c, run, peak, checks, "cpu", traced=False)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert set(result["metrics"]) == {"asr_p50_ms", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    assert result["device"] == {"platform": "gpu", "kind": "cpu", "count": 1,
                                "memory_peak_bytes": 0}
    assert result["attempted"] == 4 and result["failed"] == 0 and result["correct"]
    limits = c["config"]["check"]["limits"]
    assert rows == [["asr_gap_max", checks["served"]["gap_max"], limits["asr_gap_max"][1]],
                    ["asr_score_gap_mean", checks["served"]["score_gap_mean"],
                     limits["asr_score_gap_mean"][1]]]
    json.dumps(result)
    json.dumps(brun.summary_line(run, checks))


def test_no_jax_module_is_loaded():
    code = (
        "import torch\n"
        "from benchmark import run\n"
        "from benchmark.tests.conftest import tiny_cell\n"
        "run.execute(tiny_cell('asr-longform'), 3, 1.0, False, torch.device('cpu'))\n"
        "print(run.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "wis_tpu_torch_extra", sys)
    assert "wis_tpu_torch_extra" not in brun.forbidden_modules()
    monkeypatch.setitem(sys.modules, "wis_tpu.something", sys)
    assert "wis_tpu.something" in brun.forbidden_modules()


def test_references_import_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("wis_tpu_torch", "wis_tpu", "jax", "jaxlib",
                                                  "flax"), (path.name, name)


def test_a_cell_added_as_files_is_found_by_name(tmp_path, cpu):
    """A later PR adds a configuration, a traffic mix, a metric and a cell
    by adding files and entries: nothing in the harness changes."""
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics"):
        (bench / sub).mkdir(parents=True)
    (bench / "configs" / "whisper-tiny.json").write_text(json.dumps(tiny_whisper()))
    mix = json.loads((ROOT / "benchmark" / "traffic" / "asr-utterances.json").read_text())
    mix.update(rate_per_s=1.5, fields=dict(mix["fields"], beam_size=1))
    (bench / "traffic" / "tiny-greedy.json").write_text(json.dumps(mix))
    (bench / "metrics" / "answered_share.py").write_text(
        "def read(run):\n"
        "    return 100.0 * sum(r['ok'] for r in run.requests) / len(run.requests)\n")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "whisper-tiny", "source": "https://huggingface.co/openai/"
                            "whisper-tiny", "file": "benchmark/configs/whisper-tiny.json",
                            "reduced": [], "why": "a throwaway entry"})
    spec["workloads"].append({"name": "tiny.greedy", "config": "whisper-tiny",
                              "traffic": "tiny-greedy", "chips": 1, "why": "a throwaway cell"})
    spec["per_layer"].append({"name": "answered_share", "unit": "%", "better": "higher",
                              "source": "host_clock", "layer": "runtime/batcher",
                              "moves": "asr_p50_ms", "workloads": ["tiny.greedy"]})
    spec["end_to_end"][0]["workloads"].append("tiny.greedy")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    c = brun.cell(brun.load_spec(tmp_path), "tiny.greedy", root=tmp_path, bench=bench)
    assert [m["name"] for m in c["per_layer"]] == ["answered_share"]
    run, _, checks = brun.execute(c, 77, 2.0, False, cpu)
    assert brun.reader("answered_share", bench=bench)(run) == 100.0
    assert brun.reader("asr_p50_ms")(run) > 0
    assert checks["served"]["gap_max"] <= c["config"]["check"]["limits"]["asr_gap_max"][1]


@pytest.mark.cuda
def test_cell_on_the_card(card):
    """Each cell's set-up, a short window and its check on the card."""
    spec = brun.load_spec()
    for w in spec["workloads"]:
        c = brun.cell(spec, w["name"])
        run, peak, checks = brun.execute(c, 5, 4.0, False, card)
        result, _ = brun.result_line(c, run, peak, checks, torch.cuda.get_device_name(card),
                                     traced=False)
        assert result["correct"], (w["name"], result)
