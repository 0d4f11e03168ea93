"""The port's converter self-test and its ``convert-model`` entry point,
held against ``transformers`` and the JAX package on the CPU:

- the hand-written HF key list and shapes (``hf_whisper_shapes``; the
  card's machine has no ``transformers``) equal to
  ``WhisperForConditionalGeneration.state_dict()``, the model built on the
  ``meta`` device (keys and shapes only; a real large-v3 would take ~6 GB);
- ``whisper_selftest("tiny")`` on the CPU reports what
  ``wis_tpu.utils.selftest.whisper_selftest("tiny")`` reports (the same
  keys, parameter count, bytes and encoder shape; the times are each
  side's own);
- ``python -m wis_tpu_torch.cli convert-model`` with ``--device cpu``
  prints what ``wisctl convert-model`` prints, for the self-test, a
  checkpoint directory and a directory without one.

Tolerance: none — every comparison is exact.
"""

import argparse
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from wis_tpu_torch import cli
from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS, WhisperConfig
from wis_tpu_torch.utils.selftest import hf_whisper_shapes, synthetic_hf_whisper, whisper_selftest

torch.set_num_threads(1)

TIMES = ("build_s", "convert_s", "forward_s")


@pytest.mark.parametrize("size", ["tiny", "large-v3"])
def test_hf_key_list_equals_transformers(size):
    import transformers

    cfg = WHISPER_CONFIGS[size]
    hf_cfg = transformers.WhisperConfig(
        vocab_size=cfg.n_vocab, num_mel_bins=cfg.n_mels, d_model=cfg.n_audio_state,
        encoder_layers=cfg.n_audio_layer, encoder_attention_heads=cfg.n_audio_head,
        decoder_layers=cfg.n_text_layer, decoder_attention_heads=cfg.n_text_head,
        encoder_ffn_dim=4 * cfg.n_audio_state, decoder_ffn_dim=4 * cfg.n_text_state,
        max_source_positions=cfg.n_audio_ctx, max_target_positions=cfg.n_text_ctx,
    )
    with torch.device("meta"):
        model = transformers.WhisperForConditionalGeneration(hf_cfg)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = hf_whisper_shapes(cfg)
    assert list(got) == list(want)
    assert got == want


def test_synthetic_checkpoint_is_zero_and_tied():
    cfg = WhisperConfig(name="micro", n_audio_state=64, n_audio_head=2, n_audio_layer=1,
                        n_text_state=64, n_text_head=2, n_text_layer=1)
    sd = synthetic_hf_whisper(cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in sd.items()} == hf_whisper_shapes(cfg)
    assert all(v.dtype == torch.float32 and not bool(v.any()) for v in sd.values())
    assert sd["proj_out.weight"] is sd["model.decoder.embed_tokens.weight"]


@pytest.fixture(scope="module")
def jax_tiny_report():
    from wis_tpu.utils.selftest import whisper_selftest as jax_selftest

    return jax_selftest("tiny", forward=True)


def test_whisper_selftest_tiny_reports_as_jax(jax_tiny_report):
    got = whisper_selftest("tiny", forward=True, device="cpu")
    assert got.keys() == jax_tiny_report.keys()
    for key, want in jax_tiny_report.items():
        if key not in TIMES:
            assert got[key] == want, key
    assert got["encoder_out"] == (1, 1500, 384) and got["model"] == "tiny"


def _wisctl_args(**kw):
    base = dict(src=None, size=None, selftest=False, no_forward=False)
    return argparse.Namespace(**{**base, **kw})


def test_cli_selftest_prints_the_wisctl_line(capsys, jax_tiny_report):
    assert cli.main(["convert-model", "--selftest", "tiny", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    got = json.loads(line)
    want = json.loads(json.dumps({"selftest": "ok", **jax_tiny_report}))
    assert list(got) == list(want)
    assert {k: v for k, v in got.items() if k not in TIMES} == \
        {k: v for k, v in want.items() if k not in TIMES}


def test_cli_runs_as_a_module_without_forward():
    res = subprocess.run(
        [sys.executable, "-m", "wis_tpu_torch.cli", "convert-model", "--selftest", "tiny",
         "--no-forward", "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["selftest"] == "ok" and "forward_s" not in report
    assert report["params"] == 37760640


def test_cli_converts_a_checkpoint_as_wisctl(tmp_path, capsys):
    """A checkpoint directory of a micro config: the port's and wisctl's
    convert-model print the same line; a directory without safetensors
    gives the same message and exit code on both."""
    import wisctl
    from safetensors.numpy import save_file

    from wis_tpu.models.whisper.config import WHISPER_CONFIGS as JAX_CONFIGS
    from wis_tpu.models.whisper.config import WhisperConfig as JaxConfig

    spec = dict(name="micro-cli", n_audio_state=64, n_audio_head=2, n_audio_layer=1,
                n_text_state=64, n_text_head=2, n_text_layer=1)
    cfg = WhisperConfig(**spec)
    rng = np.random.default_rng(0)
    save_file({k: (rng.standard_normal(s) * 0.05).astype(np.float32)
               for k, s in hf_whisper_shapes(cfg).items() if k != "proj_out.weight"},
              str(tmp_path / "model.safetensors"))
    (tmp_path / "empty").mkdir()
    JAX_CONFIGS[spec["name"]] = JaxConfig(**spec)
    WHISPER_CONFIGS[spec["name"]] = cfg
    try:
        outs = []
        for run in (
            lambda: cli.main(["convert-model", str(tmp_path), "--size", spec["name"],
                              "--device", "cpu"]),
            lambda: wisctl.cmd_convert_model(_wisctl_args(src=str(tmp_path),
                                                          size=spec["name"])),
            lambda: cli.main(["convert-model", str(tmp_path / "empty"), "--size",
                              spec["name"], "--device", "cpu"]),
            lambda: wisctl.cmd_convert_model(_wisctl_args(src=str(tmp_path / "empty"),
                                                          size=spec["name"])),
            lambda: cli.main(["convert-model", "--device", "cpu"]),
            lambda: wisctl.cmd_convert_model(_wisctl_args(size="tiny")),
        ):
            rc = run()
            cap = capsys.readouterr()
            outs.append((rc, cap.out, cap.err))
    finally:
        JAX_CONFIGS.pop(spec["name"], None)
        WHISPER_CONFIGS.pop(spec["name"], None)
    assert outs[0] == outs[1]
    assert outs[0][1] == "converted micro-cli: encoder OK, output (1, 1500, 64)\n"
    assert outs[2] == outs[3] and outs[2][0] == 1 and "no safetensors found" in outs[2][2]
    assert outs[4] == outs[5] and outs[4][0] == 1


def test_cli_refuses_an_unknown_size():
    with pytest.raises(SystemExit):
        cli.main(["convert-model", "--selftest", "huge", "--device", "cpu"])
