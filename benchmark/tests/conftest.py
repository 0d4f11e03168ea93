"""Fixtures of the benchmark's CPU tests: tiny copies of the cells'
configurations (the published layouts at small widths) and short mixes,
run through the same harness on the CPU."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent


def load(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def tiny_whisper() -> dict:
    """whisper-large-v2's file at the widths of the port's ``tiny``."""
    cfg = load("configs", "whisper-large-v2")
    cfg.update(served_model="tiny", d_model=384, encoder_layers=4, decoder_layers=4,
               encoder_attention_heads=6, decoder_attention_heads=6,
               encoder_ffn_dim=1536, decoder_ffn_dim=1536)
    cfg["deployment"]["fused_decode"] = "on"
    cfg["check"]["windows"] = 24
    return cfg


def tiny_xtts() -> dict:
    cfg = load("configs", "xtts-v2")
    cfg["gpt"].update(gpt_layers=2, gpt_n_model_channels=128, gpt_n_heads=4)
    cfg["hifigan"].update(input_dim=128, upsample_initial_channel=32, cond_dim=64)
    cfg["fused"] = "on"
    cfg["check"].update(tokens=60)
    return cfg


def tiny_cell(name: str) -> dict:
    """A cell of BENCHMARK.json at CPU size: its configuration at small
    widths, its mix at a low rate and short lengths."""
    if name == "asr-utterances":
        cfg, mix = tiny_whisper(), load("traffic", "asr-utterances")
        mix["rate_per_s"] = 2.0
    elif name == "asr-longform":
        cfg, mix = tiny_whisper(), load("traffic", "asr-longform")
        mix["fields"]["audio_s"] = {"dist": "loguniform", "min": 31, "max": 36}
        mix["fields"]["max_tokens"] = 5
        mix["pool"] = 3
    else:
        cfg, mix = tiny_xtts(), load("traffic", "tts-replies")
        mix["rate_per_s"] = 1.5
        mix["fields"]["chars"] = {"dist": "loguniform", "min": 25, "max": 35}
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return {"workload": {"name": name, "chips": 1}, "config": cfg, "mix": mix,
            "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
            "per_layer": [m for m in spec["per_layer"] if mine(m)]}


@pytest.fixture
def cpu():
    return torch.device("cpu")


@pytest.fixture
def card():
    """The card, for tests marked ``cuda``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from wis_tpu_torch.device import resolve_device

    return resolve_device("cuda:0")
