"""The port's XTTS converter self-test (``utils/selftest.xtts_selftest``) and
``python -m wis_tpu_torch.cli convert-model --selftest xtts``, held against
``wis_tpu.utils.selftest.xtts_selftest`` on the CPU at a micro config (the
full-width run is ``chip_smoke.py``'s): the same key count, parameter bytes
and vocoder output; every conditioning key converted.
"""

import json

import pytest
import torch

from wis_tpu_torch import cli
from wis_tpu_torch.models.xtts.conditioning import ConditioningConfig
from wis_tpu_torch.models.xtts.gpt import GPTConfig
from wis_tpu_torch.models.xtts.hifigan import HiFiGANConfig
from wis_tpu_torch.models.xtts.model import XTTSConfig
from wis_tpu_torch.utils import selftest

torch.set_num_threads(1)

GPT = dict(n_layer=2, n_head=2, d_model=64, n_text_vocab=256, n_audio_vocab=68,
           max_text_tokens=32, max_audio_tokens=40, start_audio_token=66, stop_audio_token=67)
VOC = dict(in_dim=64, cond_dim=32, upsample_initial=32, upsample_rates=(4, 4),
           upsample_kernels=(8, 8))
COND = dict(d_model=64, n_heads=2, n_blocks=2, n_latents=4, n_groups=16, perceiver_heads=2)
TIMES = ("build_s", "convert_s", "forward_s")
MICRO = XTTSConfig(gpt=GPTConfig(**GPT), vocoder=HiFiGANConfig(**VOC), cond_len=4)
MICRO_COND = ConditioningConfig(**COND)


@pytest.fixture(scope="module")
def jax_report():
    """wis_tpu's self-test with its XTTS v2 configs swapped for the micro
    ones (it builds them inside the call)."""
    from wis_tpu.models.xtts import conditioning as jcond
    from wis_tpu.models.xtts import gpt as jg
    from wis_tpu.models.xtts import hifigan as jh
    from wis_tpu.models.xtts import model as jm
    from wis_tpu.utils.selftest import xtts_selftest as jax_selftest

    micro = jm.XTTSConfig(gpt=jg.GPTConfig(**GPT), vocoder=jh.HiFiGANConfig(**VOC), cond_len=4)
    micro_cond = jcond.ConditioningConfig(**COND)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm, "XTTSConfig", lambda: micro)
        mp.setattr(jcond, "ConditioningConfig", lambda: micro_cond)
        return jax_selftest(forward=True)


@pytest.fixture
def micro(monkeypatch):
    """The port's self-test at the micro configs, swapped in the same way."""
    from wis_tpu_torch.models.xtts import conditioning as tcond
    from wis_tpu_torch.models.xtts import model as tm

    monkeypatch.setattr(tm, "XTTSConfig", lambda: MICRO)
    monkeypatch.setattr(tcond, "ConditioningConfig", lambda: MICRO_COND)


def test_xtts_selftest_reports_as_jax(jax_report, micro):
    got = selftest.xtts_selftest(device="cpu")
    assert set(jax_report) <= set(got) and got["cond_out"] == (1, 4, 64)
    for key, want in jax_report.items():
        if key not in TIMES:
            assert got[key] == want, key


def test_cli_selftest_xtts(capsys, micro):
    assert cli.main(["convert-model", "--selftest", "xtts", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["selftest"] == "ok" and report["model"] == "xtts-v2"
    assert report["vocoder_out"] == [1, 8912] and report["keys"] > 0
    assert cli.main(["convert-model", "--selftest", "xtts", "--device", "cpu",
                     "--no-forward"]) == 0
    assert "forward_s" not in json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with pytest.raises(SystemExit):
        cli.main(["convert-model", "some/dir", "--size", "xtts", "--device", "cpu"])
