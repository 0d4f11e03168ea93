"""The omni cell on the CPU at tiny widths: a sound run reads under the
configuration's limits, and its control (the reference at fp8) and each
fault the cell can have, planted underneath the timed path, read over them
and turn ``correct`` false: an expert whose rows are dropped, a route
flipped to the token's next slot, and a reply answered with another row's
tokens. The yardstick's bound equals ``chip_smoke.py``'s."""

import json

import numpy as np
import pytest
import torch

from benchmark import run as brun
from benchmark import work_omni
from benchmark.tests.conftest import BENCH, load

torch.set_num_threads(1)


def tiny_omni() -> dict:
    """uni-moe-2.0-omni's file at micro widths, GQA 7:1, the routing and
    the published 28 layers kept (rounding and faults grow through the
    layers as at full width), over a vocabulary of 4096."""
    cfg = load("configs", "uni-moe-2.0-omni")
    cfg.update(hidden_size=56, num_hidden_layers=28, num_attention_heads=14,
               num_key_value_heads=2, head_dim=4, vocab_size=4096, shared_intermediate_size=16,
               dynamic_intermediate_size=32, whisper_hidden_size=64)
    cfg["audio_encoder"].update(d_model=64, encoder_layers=1, encoder_attention_heads=2,
                                encoder_ffn_dim=256)
    cfg["generation"].update(prompt_head=list(range(10, 26)), prompt_tail=list(range(30, 38)),
                             eos_token_id=4095)
    # every answered request is checked: a planted fault shows in a few
    cfg["check"]["requests"] = 64
    return cfg


def tiny_omni_cell() -> dict:
    mix = load("traffic", "omni-commands")
    mix["rate_per_s"] = 8.0
    mix["fields"]["audio_s"] = {"dist": "loguniform", "min": 1.0, "max": 8.0}
    mix["fields"]["reply_tokens"] = {"dist": "loguniform", "min": 3, "max": 6}
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())

    def mine(m):
        return "workloads" not in m or "omni-commands" in m["workloads"]

    return {"workload": {"name": "omni-commands", "chips": 1}, "config": tiny_omni(), "mix": mix,
            "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
            "per_layer": [m for m in spec["per_layer"] if mine(m)]}


def _run(cpu, seed=41, seconds=3.0):
    c = tiny_omni_cell()
    run, peak, checks = brun.execute(c, seed, seconds, False, cpu)
    return c, run, brun.result_line(c, run, peak, checks, "cpu", traced=False)[0]


def test_sound_run_passes_and_the_control_fails(cpu):
    c, run, result = _run(cpu)
    assert result["correct"], result["compared"]
    assert result["attempted"] == 24 and result["failed"] == 0
    assert set(result["metrics"]) == {"asr_p50_ms", "setup_s"}
    readings = run.system.check(("served", "control"))
    limits = c["config"]["check"]["limits"]
    over = [n for n, (key, limit) in limits.items() if readings["control"][key] > limit]
    assert over, readings
    assert readings["served"]["requests"] == 24 and readings["served"]["routes"] > 0


def _drop_expert(monkeypatch):
    from wis_tpu_torch.models.unimoe import moe
    from wis_tpu_torch.ops import moe_experts

    orig = moe_experts.grouped_swiglu

    def dropped(h, w_gate, w_up, w_down, codes, weights):
        return orig(h, w_gate, w_up, w_down, torch.where(codes == 0, moe.NOT_TAKEN, codes),
                    weights)

    monkeypatch.setattr(moe, "grouped_swiglu", dropped)


def _flip_route(monkeypatch):
    from wis_tpu_torch.models.unimoe import moe

    orig = moe.route

    def flipped(h, router_w, n_dynamic, top_p, top_k, valid=None):
        codes, probs = orig(h, router_w, n_dynamic, top_p, top_k, valid)
        first = codes[:, 0]
        moved = torch.where(first < n_dynamic, (first + 1) % n_dynamic, first)
        return torch.cat([moved[:, None], codes[:, 1:]], 1), probs

    monkeypatch.setattr(moe, "route", flipped)


def _other_row(monkeypatch):
    from wis_tpu_torch.runtime import engine

    orig = engine.unpack_omni

    def swapped(packed, batch, max_new):
        tokens, lengths, ctr = orig(packed, batch, max_new)
        return np.roll(tokens, 1, axis=0), lengths, ctr

    monkeypatch.setattr(engine, "unpack_omni", swapped)


@pytest.mark.parametrize("plant", [_drop_expert, _flip_route, _other_row])
def test_planted_faults_fail(plant, cpu, monkeypatch):
    plant(monkeypatch)
    _, _, result = _run(cpu, seed=43)
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("rows,routing", [(1, "two"), (8, "uneven"), (16, "null_heavy"),
                                          (1792, "two")])
def test_moe_bound_is_chip_smokes(rows, routing):
    import chip_smoke

    codes, _ = chip_smoke.moe_codes(torch, torch.device("cpu"), rows, routing, 7)
    want, _ = chip_smoke.moe_bound(rows, codes)
    routed = codes[codes < chip_smoke.MOE_E]
    got = work_omni.moe_experts_ms(touched=len(set(routed.tolist())), rows=int(routed.numel()),
                                   d=chip_smoke.MOE_D, f=chip_smoke.MOE_F)
    assert got == pytest.approx(want, rel=1e-12)


def test_forced_routes_follow_the_other_side():
    """The judge handed routes follows them: its own routes handed back give
    its unforced logits bit for bit, and each token moved to other experts
    changes the logits while the judge still reports its own choice."""
    from benchmark import weights_omni
    from benchmark.reference import unimoe as ref

    cfg = tiny_omni()
    cfg["num_hidden_layers"] = 4
    judge = ref.UniMoE(weights_omni.omni_hf(cfg, 5, torch.device("cpu")), cfg)
    g = torch.Generator().manual_seed(5)
    audio = judge.encode(torch.randn(2, ref.wref.N_SAMPLES, generator=g) * 0.05)
    replies = [[7, 9, 11], [13, 4095]]
    logits, own = judge.teacher_forced(audio, replies)
    same, again = judge.teacher_forced(audio, replies, [own[:, 0], own[:, 1]])
    assert all(torch.equal(a, b) for a, b in zip(logits, same)) and torch.equal(own, again)
    # every token's routing moved to expert 0 alone, or expert 1 where it took 0
    moved = torch.where(own == 1, 2, 1)
    other, mine = judge.teacher_forced(audio, replies, [moved[:, 0], moved[:, 1]])
    # the first layer chooses before any forced expert ran
    assert torch.equal(mine[0], own[0])
    assert not torch.allclose(logits[0], other[0])
