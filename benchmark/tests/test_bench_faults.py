"""The check fails what it must: at tiny widths on the CPU, each cell's
sound run reads under its limits, and its control (the reference one
precision step below the configuration) and each fault the cell can have,
planted underneath the timed path, read over them and turn ``correct``
false. One chip has no exchange between chips, and the TTS stream has no
batch: those faults do not apply."""

import pytest

from benchmark import control
from benchmark import run as brun
from benchmark.tests.conftest import tiny_cell


def _run(name, cpu, seed=31, seconds=3.0):
    c = tiny_cell(name)
    run, peak, checks = brun.execute(c, seed, seconds, False, cpu)
    return c, run, brun.result_line(c, run, peak, checks, "cpu", traced=False)[0]


def _limits(c):
    return c["config"]["check"]["limits"]


@pytest.mark.parametrize("name", ["asr-utterances", "tts-replies"])
def test_sound_runs_pass_and_the_control_fails(name, cpu):
    c, run, result = _run(name, cpu)
    assert result["correct"], result["compared"]
    readings = run.system.check(("served", "control"))
    over = [n for n, (key, limit) in _limits(c).items() if readings["control"][key] > limit]
    assert over, readings


def _asr_unpack(monkeypatch, fault):
    from wis_tpu_torch.runtime import engine

    orig = engine.unpack_asr_result

    def faulty(packed, beam, max_new):
        tokens, lengths, best, lang_idx, lang_prob = orig(packed, beam, max_new)
        tokens = tokens.copy()
        fault(tokens)
        return tokens, lengths, best, lang_idx, lang_prob

    monkeypatch.setattr(engine, "unpack_asr_result", faulty)


def _alter(tokens):
    tokens[:, :, 1] = (tokens[:, :, 1] + 1000) % 50000


def _half_batch(tokens):
    half = tokens.shape[0] // 2
    if half:
        tokens[-half:] = tokens[:half]


def _frozen_state(module, name):
    """A step builder whose step returns the caches it was given, as they
    were: the step's own writes never land."""
    orig = getattr(module, name)

    def build(*args, **kwargs):
        step = orig(*args, **kwargs)

        def frozen(packed, x, kc, vc, *rest):
            out = step(packed, x, kc.clone(), vc.clone(), *rest)
            return (out[0], kc, vc) + tuple(out[3:])
        return frozen
    return build


@pytest.mark.parametrize("fault", ["token altered", "half the batch", "state unchanged",
                                   "greedy"])
def test_asr_faults_fail(fault, cpu, monkeypatch):
    if fault == "token altered":
        _asr_unpack(monkeypatch, _alter)
    elif fault == "half the batch":
        _asr_unpack(monkeypatch, _half_batch)
    elif fault == "greedy":
        monkeypatch.setattr(*control.planted(fault))
    else:
        from wis_tpu_torch.decoding import beam

        monkeypatch.setattr(beam, "build_fused_decode_step",
                            _frozen_state(beam, "build_fused_decode_step"))
    c, run, result = _run("asr-utterances", cpu, seed=41)
    if fault == "half the batch":
        assert max(len(call["rids"]) for call in run.system.calls) >= 2
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("fault", ["code altered", "state unchanged"])
def test_tts_faults_fail(fault, cpu, monkeypatch):
    if fault == "code altered":
        from wis_tpu_torch.models.xtts import model as xmodel

        orig = xmodel.run_decode_chunk_fused

        def altered(*args, **kwargs):
            out = orig(*args, **kwargs)
            toks = out[0].clone()
            toks[:, min(2, toks.shape[1] - 1)] = (toks[:, min(2, toks.shape[1] - 1)] + 7) % 1000
            return (toks,) + tuple(out[1:])

        monkeypatch.setattr(xmodel, "run_decode_chunk_fused", altered)
    else:
        from wis_tpu_torch.ops import fused_gpt

        monkeypatch.setattr(fused_gpt, "build_fused_gpt_step",
                            _frozen_state(fused_gpt, "build_fused_gpt_step"))
    c, run, result = _run("tts-replies", cpu, seed=43)
    assert not result["correct"], result["compared"]
