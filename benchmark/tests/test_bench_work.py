"""The yardstick's least-time arithmetic equals ``chip_smoke.py``'s, which
the kernel table in PERF.md was measured against, at that table's shapes."""

import numpy as np
import pytest
import torch

import chip_smoke
from benchmark import work
from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS
from wis_tpu_torch.models.xtts.gpt import GPTConfig

LARGE = WHISPER_CONFIGS["large"]


def _step_inp(t_cache, n_seq, beams, seed):
    """chip_smoke's fused-step inputs, reduced to what its bound reads: the
    random ancestry's sel at pos = t_cache // 2."""
    bk, pos = beams * n_seq, t_cache // 2
    rng = np.random.default_rng(seed)
    anc = rng.integers(0, beams, (bk, pos)) + (np.arange(bk) // beams * beams)[:, None]
    sel = np.zeros((bk, t_cache, bk), np.float32)
    for r in range(bk):
        sel[r, np.arange(pos), anc[r]] = 1.0
    sel = torch.from_numpy(sel.reshape(bk, t_cache * bk))
    return dict(x_emb=torch.empty(bk, 1), s_audio=LARGE.n_audio_ctx, n_seq=n_seq,
                xa_k=torch.empty(1, dtype=torch.int8), xa_s=torch.empty(1), sel=sel)


@pytest.mark.parametrize("t_cache,n_seq,beams", [(128, 1, 5), (256, 1, 5), (256, 4, 5)])
def test_whisper_step_bound(t_cache, n_seq, beams):
    inp = _step_inp(t_cache, n_seq, beams, t_cache)
    want, _ = chip_smoke._step_bound(inp, LARGE)
    sel = inp["sel"]
    got = work.whisper_step_ms(
        L=LARGE.n_text_layer, D=LARGE.n_text_state, H=LARGE.n_text_head, bk=sel.shape[0],
        n_seq=n_seq, s_audio=LARGE.n_audio_ctx, xa_elem=1, xa_scaled=True,
        picked=int((sel.sum(dim=0) > 0).sum()), per_row_cols=int(sel[0].sum()) + 1,
        sel_numel=sel.numel())
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("bk", [5, 20])
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("grammar", [True, False])
def test_whisper_head_bound(bk, int8, grammar):
    want, _ = chip_smoke.head_bound(LARGE, bk, int8, grammar)
    got = work.whisper_head_ms(V=LARGE.n_vocab, D=LARGE.n_text_state, bk=bk,
                               k=chip_smoke.HEAD_K, int8=int8, grammar=grammar)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("t_pad", [256, 512, 896])
def test_gpt_step_bound(t_pad):
    cfg = GPTConfig()
    pos = t_pad - 56
    sel = (torch.arange(t_pad) < pos).float()[None, :]
    want, _ = chip_smoke._gpt_step_bound({"x_emb": torch.empty(1, 1), "sel": sel}, cfg)
    got = work.gpt_step_ms(L=cfg.n_layer, D=cfg.d_model, bk=1, picked=pos,
                           per_row_cols=pos + 1, sel_numel=t_pad)
    assert got == pytest.approx(want, rel=1e-12)


def test_kernel_table_bounds():
    """PERF.md's kernel table: the fused step 0.2692 ms at t_cache 128 and
    0.4561 at BK 20, the GPT step 0.1209 at 256 columns."""
    assert work.whisper_step_ms(
        L=32, D=1280, H=20, bk=5, n_seq=1, s_audio=1500, xa_elem=1, xa_scaled=True,
        picked=int((_step_inp(128, 1, 5, 128)["sel"].sum(0) > 0).sum()), per_row_cols=65,
        sel_numel=5 * 128 * 5) == pytest.approx(0.2692, abs=5e-4)
    assert work.gpt_step_ms(L=30, D=1024, bk=1, picked=200, per_row_cols=201,
                            sel_numel=256) == pytest.approx(0.1209, abs=5e-4)


def test_least_ms_takes_the_larger_bound():
    assert work.least_ms(3.35e12, 0) == pytest.approx(1e3)
    assert work.least_ms(0, 989e12) == pytest.approx(1e3)
