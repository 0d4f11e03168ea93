"""The fused logits head of the PyTorch port (``wis_tpu_torch/ops/
fused_logits.py``) held against wis_tpu's ``build_fused_logits_topk`` — the
Pallas kernel in interpret mode under jit, as the JAX package runs it on
the CPU — on the narrow config (D=128) with the real 51865-token
vocabulary: bf16 and per-row int8 embedding, the logsumexp over the
suppressed or the raw logits.

Inputs are numpy-seeded: N(0, 1) embedding rows spread the logits (std
~11), and the seed is one whose candidate gaps all clear twice the
tolerance; each row's two largest raw logits are suppressed, and one id
is given a lower-id twin (a duplicated embedding row) so that the two tie
at the row's top.

Tolerance on the candidates' values and on lse: 2e-2 absolute. Both sides
take the same f32 LayerNorm and round it once to bf16, then dot bf16
operands in f32 in another order (~1e-5 here); but an LN output that lands
on a bf16 rounding boundary can round one ulp apart (the two rsqrt
implementations differ in the last f32 bit), which moves a logit by at most
2⁻⁸·|xn_i|·|e_i| (< 2e-2 at these magnitudes). Candidate ids must be equal,
and the test asserts that the gaps between consecutive candidates stand
above twice the tolerance, so equal ids are a real check.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import JAX_CFG, PORT_CFG
from wis_tpu.ops import fused_logits as jl
from wis_tpu.ops.quant import quantize_rows as jax_quantize_rows
from wis_tpu_torch.ops import fused_logits as tl

torch.set_num_threads(1)

V, D = JAX_CFG.n_vocab, JAX_CFG.n_text_state
BK = 5
TOL = 2e-2


@lru_cache(maxsize=None)
def _inputs(seed=9):
    """x, LN rows, the bf16 table (as the f32 values of its bf16 elements)
    with its tie, the suppress row, the two tied ids (row 0's best and its
    lower twin) and the suppressed raw top two. The seed is one whose
    top-(k+1) gaps clear twice the tolerance in both tables."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((BK, D)) * 2 + 0.3).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    emb = torch.from_numpy(rng.standard_normal((V, D), dtype=np.float32))
    emb = emb.to(torch.bfloat16).float().numpy()
    sup = np.zeros(V, np.float32)
    sup[rng.choice(V, 200, replace=False)] = -1e30
    # trap: the two largest raw logits of every row are suppressed
    raw = tl.fused_logits_topk_plain(*_port(x, g, b, emb, np.zeros_like(sup)), k=2)[1]
    sup[raw.numpy().reshape(-1)] = -1e30
    best = int(tl.fused_logits_topk_plain(*_port(x, g, b, emb, sup), k=1)[1][0, 0])
    low = best // 2
    while sup[low] != 0.0:
        low -= 1
    emb = emb.copy()
    emb[low] = emb[best]  # trap: row 0's best id ties with a lower id
    return x, g, b, emb, sup, (low, best), raw.numpy()


def _port(x, g, b, emb, sup):
    if isinstance(emb, dict):
        t_emb = {"q": torch.from_numpy(np.asarray(emb["q"])),
                 "s": torch.from_numpy(np.asarray(emb["s"]))}
    else:
        t_emb = torch.from_numpy(emb).to(torch.bfloat16)
    return (torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), t_emb,
            torch.from_numpy(sup))


def _table(int8: bool):
    emb = _inputs()[3]
    if not int8:
        return emb
    return jax.tree.map(np.asarray, jax_quantize_rows(jnp.asarray(emb, jnp.bfloat16)))


@pytest.mark.parametrize("k", [6, 1])
@pytest.mark.parametrize("full_lse", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_head_plain_matches_jax_kernel(int8, full_lse, k):
    x, g, b, _, sup, (low, best), raw = _inputs()
    table = _table(int8)
    head = jl.build_fused_logits_topk(JAX_CFG, bk=BK, k=k, full_lse=full_lse, emb_int8=int8)
    j_emb = {"q": jnp.asarray(table["q"]), "s": jnp.asarray(table["s"])} if int8 else (
        jnp.asarray(table, jnp.bfloat16))
    want = jax.jit(head)(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), j_emb, jnp.asarray(sup))
    want_val, want_tok, want_lse = (np.asarray(t) for t in want)

    port = tl.build_fused_logits_topk(PORT_CFG, bk=BK, k=k, full_lse=full_lse, emb_int8=int8)
    before = tl.fused_logits_topk.launches
    got_val, got_tok, got_lse = (t.numpy() for t in port(*_port(x, g, b, table, sup)))
    assert tl.fused_logits_topk.launches == before  # the CPU runs the plain version

    assert got_val.shape == (BK, k) and got_tok.shape == (BK, k) and got_lse.shape == (BK, 1)
    np.testing.assert_array_equal(got_tok, want_tok)
    assert np.abs(got_val - want_val).max() <= TOL
    assert np.abs(got_lse - want_lse).max() <= TOL
    # the decisions stand clear of the tolerance (the tie aside)
    wide = tl.fused_logits_topk_plain(*_port(x, g, b, table, sup), k=k + 1)[0].numpy()
    gaps = (wide[:, :-1] - wide[:, 1:]).reshape(-1)
    assert gaps[gaps > 0].min() > 2 * TOL
    # the traps: the tie goes to the lower id, suppressed ids stay out
    assert got_tok[0, 0] == low and (k == 1 or got_tok[0, 1] == best)
    assert not np.isin(got_tok, raw).any()
    # a logsumexp lies above the largest candidate
    assert (got_lse > got_val[:, :1]).all()


def test_head_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="k=9"):
        tl.build_fused_logits_topk(PORT_CFG, bk=BK, k=9)
    x, g, b, emb, sup, _, _ = _inputs()
    head = tl.build_fused_logits_topk(PORT_CFG, bk=BK, k=6, emb_int8=True)
    with pytest.raises(ValueError, match="emb_int8"):
        head(*_port(x, g, b, emb, sup))
    # a grammar head needs its ts_state, and a plain head takes none
    with pytest.raises(ValueError, match="grammar=True takes ts_state"):
        tl.build_fused_logits_topk(PORT_CFG, bk=BK, k=6, grammar=True)(*_port(x, g, b, emb, sup))
    ts = torch.zeros((BK, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="grammar=False takes ts_state None"):
        tl.build_fused_logits_topk(PORT_CFG, bk=BK, k=6)(*_port(x, g, b, emb, sup), ts)
    meta = torch.empty((BK, D), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tl.fused_logits_topk(meta, meta[0], meta[0], meta, meta[0], k=6)


# --------------------------------------------------------------------------- #
# Grammar mode: inputs whose logits are exact (chip_smoke.grammar_head_case:
# ±1 LayerNorm outputs against a table of multiples of 1/8), so the two sides
# must agree on every id and value; lse within 1e-5 (f32 sums in another
# order and chunking).
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("bk", [5, 10])
@pytest.mark.parametrize("full_lse", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_grammar_head_plain_matches_jax_kernel(int8, full_lse, bk):
    from chip_smoke import grammar_decisions, grammar_head_case
    from wis_tpu_torch.models.whisper.tokenizer import EOT, layout_for_vocab

    ts_base = layout_for_vocab(V).timestamp_base
    x, g, b, emb, sup, ts = grammar_head_case(bk, D, V, ts_base, EOT, seed=bk)
    if int8:
        table = jax.tree.map(np.asarray, jax_quantize_rows(jnp.asarray(emb, jnp.bfloat16)))
        j_emb = {"q": jnp.asarray(table["q"]), "s": jnp.asarray(table["s"])}
    else:
        table, j_emb = emb, jnp.asarray(emb, jnp.bfloat16)
    kw = dict(bk=bk, k=6, grammar=True, ts_base=ts_base, eot=EOT, full_lse=full_lse,
              emb_int8=int8)
    head = jl.build_fused_logits_topk(JAX_CFG, **kw)
    want = jax.jit(head)(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), j_emb,
                         jnp.asarray(sup), jnp.asarray(ts))
    want_val, want_tok, want_lse = (np.asarray(t) for t in want)
    port = tl.build_fused_logits_topk(PORT_CFG, **kw)
    got_val, got_tok, got_lse = (
        t.numpy() for t in port(*_port(x, g, b, table, sup), torch.from_numpy(ts)))
    np.testing.assert_array_equal(got_tok, want_tok)
    np.testing.assert_allclose(got_val, want_val, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_lse, want_lse, rtol=1e-5, atol=1e-5)
    held = grammar_decisions(got_val, got_tok, ts_base, EOT)
    assert all(held.values()), held


# --------------------------------------------------------------------------- #
# The CUDA kernel's plan, replayed on the host: nb blocks, each a contiguous
# range of 64-row vocabulary tiles, each keeping a running top-k (taking a
# tile's column only while it beats the k-th entry) and a running logsumexp
# pair, folded in block order by the last block (csrc/fused_logits.cu). It
# must give the plain version's stable top-k exactly, for any block count.
# --------------------------------------------------------------------------- #
TILE = 64


def _lse_merge(m, s, mo, so):
    big = max(m, mo)
    if big == -np.inf:
        return m, s
    return big, ((0.0 if m == -np.inf else s * np.exp(m - big))
                 + (0.0 if mo == -np.inf else so * np.exp(mo - big)))


def _planned_head(logits, src, k, nb):
    """(values, ids, lse) of each row as the kernel's plan computes them."""
    bk, v = logits.shape
    tiles = -(-v // TILE)
    vals, ids, lses = [], [], []
    for r in range(bk):
        lists, pairs = [], []
        for b in range(nb):
            top, m, s = [(-np.inf, 2**31 - 1)] * k, -np.inf, 0.0
            for t in range(tiles * b // nb, tiles * (b + 1) // nb):
                cols = np.arange(t * TILE, min(v, (t + 1) * TILE))
                sv = src[r, cols]
                mt = sv.max()
                m, s = _lse_merge(m, s, mt, np.exp(sv[sv > NEG_HALF] - mt).sum())
                for i in sorted(cols, key=lambda c: (-logits[r, c], c)):
                    if not logits[r, i] > top[-1][0]:
                        break
                    top = sorted(top + [(logits[r, i], i)], key=lambda e: (-e[0], e[1]))[:k]
            lists += top
            pairs.append((m, s))
        m, s = -np.inf, 0.0
        for mo, so in pairs:
            m, s = _lse_merge(m, s, mo, so)
        best = sorted(lists, key=lambda e: (-e[0], e[1]))[:k]
        vals.append([e[0] for e in best])
        ids.append([e[1] for e in best])
        lses.append(m + np.log(max(s, 1e-30)))
    return np.asarray(vals), np.asarray(ids), np.asarray(lses)[:, None]


NEG_HALF = -0.5e30


@pytest.mark.parametrize("v,nb", [(1000, 1), (1000, 7), (1000, 16), (51865, 132)])
@pytest.mark.parametrize("live", [None, (700, 3, 999)])
def test_kernel_plan_gives_the_stable_top_k(v, nb, live):
    """Equal rows across a tile boundary (63, 64) and far apart (5, v − 1)
    tie to the lower id; with ``live`` only three columns are unsuppressed,
    so suppressed columns at NEG fill the rest, lowest ids first."""
    rng = np.random.default_rng(v + nb)
    d, bk, k = 16, 3, 8
    x = rng.standard_normal((bk, d)).astype(np.float32)
    emb = (np.round(rng.standard_normal((v, d)) * 8) / 8).astype(np.float32)
    emb[[63, 64]] = emb[[5, v - 1]] = x[0] * 4
    sup = np.zeros(v, np.float32)
    if live is not None:
        sup[:] = -1e30
        sup[list(live)] = 0.0
    dot = x @ emb.T
    logits = (dot + sup).astype(np.float32)
    val, tok, lse = _planned_head(logits, logits, k, nb)
    ref = torch.sort(torch.from_numpy(logits), dim=-1, descending=True, stable=True)
    np.testing.assert_array_equal(tok, ref.indices[:, :k].numpy())
    np.testing.assert_array_equal(val, ref.values[:, :k].numpy())
    np.testing.assert_allclose(lse, tl._lse(torch.from_numpy(logits)).numpy(), rtol=1e-5)
    if live is None:
        assert tok[0, :4].tolist() == [5, 63, 64, v - 1]
    else:
        assert sorted(tok[0, :3].tolist()) == [3, 700, 999]
        assert tok[0, 3:].tolist() == [0, 1, 2, 4, 5]
