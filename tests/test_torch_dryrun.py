"""``wis_tpu_torch.entry.dryrun_multichip`` (the port of
``__graft_entry__.dryrun_multichip``, tests/test_graft_entry.py) and the
world it runs on (``parallel/world.py``), on the CPU.

``dryrun_multichip(4, device="cpu", full_width=False)`` runs in a fresh
interpreter and from this process, which has already run torch work;
either way a 2×2 mesh of four ``gloo`` ranks prints every stage and
the final line. The full-width stages' code runs at micro stand-ins for
their configs on two ranks. Stage 1's tokens equal JAX's ``_dryrun_body``
stage 1 on the same weights; stage 5's heads run their plain version
here (no launch). The fused decode step refuses tensor parallelism, a rank that
raises or dies fails the call with its traceback, a hung rank hits the
timeout, and without a card ``device="cuda"`` raises.

JAX is imported inside the tests only: the ranks import this module.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from wis_tpu_torch import entry
from wis_tpu_torch.models.whisper.weights import params_from_jax
from wis_tpu_torch.parallel.mesh import ModelAxis, make_mesh
from wis_tpu_torch.parallel.world import run_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("STAGE OK: tp+dp sharded beam decode — mesh=(2x2) tokens shape (2, 2, 4)",
          "STAGE OK: batcher+replica-pool dispatch — 4 replicas",
          "STAGE OK: xtts gpt tensor-parallel decode — 2-way TP, chunk 6 tokens",
          "STAGE OK: fused logits head vocab-TP — 2-way embedding shard",
          "dryrun_multichip OK: mesh=(2x2) tokens shape (2, 2, 4)")

torch.set_num_threads(1)


def test_dryrun_fresh_process():
    code = ("import sys; from wis_tpu_torch.entry import dryrun_multichip; "
            "dryrun_multichip(4, device='cpu', full_width=False); "
            "assert 'jax' not in sys.modules; print('no jax')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    for line in STAGES + ("world: 4 ranks on ['cpu', 'cpu', 'cpu', 'cpu'], backend gloo",
                          "no jax"):
        assert line in proc.stdout, (line, proc.stdout)


def test_dryrun_after_torch_work(capfd):
    """From a process that has run torch work (threads, allocations):
    every stage passes and every rank reports the same tokens; the
    vocabulary-sharded head ran its plain version (no kernel launch)."""
    torch.manual_seed(0)
    torch.randn(64, 64) @ torch.randn(64, 64)
    report = entry.dryrun_multichip(4, device="cpu", full_width=False)
    out = capfd.readouterr().out
    for line in STAGES:
        assert line in out, (line, out)
    ranks = report["ranks"]
    assert report["mesh"] == (2, 2) and report["backend"] == "gloo"
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        np.testing.assert_array_equal(r["tp_dp"], ranks[0]["tp_dp"])
        head = r["vocab_head"]["tiny"]
        np.testing.assert_array_equal(head["tok"], head["ref_tok"])
        assert head["max_abs_err"] <= 1e-5
        assert not any(head["launches"].values())
        assert set(r) >= {"tp_dp", "replica_pool", "xtts", "vocab_head"}
        assert "medium" not in r and "large-v2" not in r
    assert ranks[0]["replica_pool"]["replicas"] == 4
    assert ranks[0]["replica_pool"]["served"] >= 1


def _micro_full_width_rank(rank, devices):
    """``_dryrun_rank`` with ``full_width`` on, at micro stand-ins for the
    full-width configs (medium, large-v2, XTTS v2's GPT, large-v3's
    vocabulary): the stages' own code on the CPU, in this rank only."""
    import functools
    from unittest import mock

    from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS, WhisperConfig
    from wis_tpu_torch.models.xtts import gpt

    micro = dict(n_audio_state=64, n_audio_head=2, n_audio_layer=1, n_text_state=64,
                 n_text_head=2, n_text_layer=1)
    configs = {size: WhisperConfig(name=size, **micro) for size in ("medium", "large-v2")}
    gpt_micro = functools.partial(gpt.GPTConfig, n_layer=1, n_head=2, d_model=32,
                                  n_text_vocab=64, n_audio_vocab=36, max_text_tokens=80,
                                  max_audio_tokens=24, start_audio_token=34,
                                  stop_audio_token=35)
    heads = dict(entry.VOCAB_HEAD_CASES, **{"large-v3": dict(d=64, v=1024, bk=5, k=6)})
    with mock.patch.dict(WHISPER_CONFIGS, configs), \
            mock.patch.object(gpt, "GPTConfig", gpt_micro), \
            mock.patch.object(entry, "VOCAB_HEAD_CASES", heads):
        return entry._dryrun_rank(rank, devices, 1, 2, True)


def test_full_width_stages_at_micro_dims(capfd):
    """The full-width stages' code (the teacher-forced pass, the
    single-rank request on the model-index-0 rank, the counters, rank 0's
    STAGE OK lines) at micro dims in bf16 on two CPU ranks, and the
    parent's checks of their reports."""
    reports = run_world(_micro_full_width_rank, ["cpu"] * 2, timeout=600)
    entry._check_reports(reports, full_width=True)
    out = capfd.readouterr().out
    for stage in ("medium TP", "large-v2 TP", "XTTS v2 30L/1024d, 20 tokens"):
        line = next(x for x in out.splitlines() if stage in x)
        assert "teacher-forced logits" in line and "single-rank eager request" in line
    ref, other = reports[0], reports[1]
    for key in ("medium", "large-v2"):
        assert "tf_rel" in ref[key] and "tf_rel" not in other[key]
        assert float(np.max(ref[key]["tf_rel"])) <= entry.TF_REL_TOL
        assert ref[key]["collectives"] == other[key]["collectives"] > 0
    full = ref["xtts"]["full"]
    for rows in (ref["medium"]["row_parallel"], ref["large-v2"]["row_parallel"],
                 full["row_parallel"]):
        assert len(rows) == 2
        for r in rows.values():
            assert r["frac"] <= entry.ROW_MISMATCH_MAX < r["ctl_frac"]
    assert full["tokens"].shape == (entry.XTTS_FULL["chunk"],)
    assert float(np.max(full["tf_hidden_rel"])) <= entry.TF_REL_TOL
    head = ref["vocab_head"]["large-v3"]
    np.testing.assert_array_equal(head["tok"], head["ref_tok"])


def _stage1_rank(rank, devices, tree):
    mesh = make_mesh(2, 2, devices)
    return entry._stage_tp_dp_decode(mesh, params_from_jax(tree, mesh.device))


def test_stage1_tokens_equal_jax():
    """Stage 1 on JAX's weights (f32, int8 decoder) against JAX's
    ``_dryrun_body`` stage 1 on its virtual 2×2 mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from torch_port_helpers import np_tree
    from wis_tpu.decoding.beam import build_encode, build_generate_xa
    from wis_tpu.models.whisper.config import WhisperConfig as JaxConfig
    from wis_tpu.models.whisper.tokenizer import build_prompt
    from wis_tpu.models.whisper.weights import random_params
    from wis_tpu.ops.quant import quantize_whisper_params
    from wis_tpu.parallel.mesh import make_mesh as jmake_mesh
    from wis_tpu.parallel.mesh import shard_params, whisper_param_specs

    cfg = JaxConfig(**entry.DRYRUN_CFG)
    params = quantize_whisper_params(random_params(cfg, seed=0, dtype=jnp.float32))
    mesh = jmake_mesh(n_data=2, n_model=2)
    sharded = shard_params(params, mesh, whisper_param_specs(cfg))
    mel = jax.device_put(jnp.zeros((2, cfg.n_mels, 3000), jnp.float32),
                         NamedSharding(mesh, JP("data", None, None)))
    prompt = jnp.asarray(build_prompt("en", "transcribe"), jnp.int32)
    gen = build_generate_xa(cfg, beam_size=2, batch=2, max_new_tokens=4,
                            prompt_len=prompt.shape[0], suppress_tokens=(),
                            begin_suppress_tokens=())
    want = np.asarray(gen(sharded, build_encode(cfg)(sharded, mel), prompt, jnp.int32(4)).tokens)

    reports = run_world(_stage1_rank, ["cpu"] * 4, (np_tree(params),), timeout=600)
    for got in reports:
        np.testing.assert_array_equal(got, want)


def test_fused_decode_refuses_tp():
    from wis_tpu_torch.decoding.beam import build_generate_xa
    from wis_tpu_torch.models.whisper.config import WhisperConfig

    with pytest.raises(ValueError, match="tensor parallelism"):
        build_generate_xa(WhisperConfig(**entry.DRYRUN_CFG), beam_size=2, batch=1,
                          max_new_tokens=4, prompt_len=4, suppress_tokens=(),
                          begin_suppress_tokens=(), fused=True, tp=ModelAxis(2, 0))


def _raise_on_rank_1(rank, devices):
    if rank == 1:
        raise ArithmeticError("rank one's own fault")
    return rank


def _exit_on_rank_1(rank, devices):
    if rank == 1:
        os._exit(3)
    return rank


def _hang_on_rank_1(rank, devices):
    if rank == 1:
        time.sleep(600)
    return rank


def test_rank_that_raises_fails_the_call():
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 of 2 failed.*ArithmeticError: "
                                           r"rank one's own fault"):
        run_world(_raise_on_rank_1, ["cpu"] * 2, timeout=120)
    with pytest.raises(RuntimeError, match="rank 1 exited with code 3 without a result"):
        run_world(_exit_on_rank_1, ["cpu"] * 2, timeout=120)


def test_hung_rank_hits_the_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        run_world(_hang_on_rank_1, ["cpu"] * 2, timeout=15)
    assert time.monotonic() - t0 < 60


def test_dryrun_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the dryrun would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(2)
