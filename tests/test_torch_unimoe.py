"""Uni-MoE-2.0-Omni's speech-to-text path in the port (``models/unimoe``,
``ops/moe_experts``, ``decoding/omni``) against its plain float32
reference (``models/unimoe/reference.py``), on the CPU at micro widths
with the published head ratio (14 query heads over 2 KV heads, 7:1) and
the published routing (4 dynamic experts, 1 null, top-p 0.7, top-k 2):

- prefill and cached decode against the reference's full forward, on
  logits, with every kind of routing present;
- the top-p / top-k / null selection against a brute-force enumeration
  of the slot sets, ties at 0.7 and between slots included;
- the expert layer's CPU path and its device permutation against loops;
- a coalesced executor dispatch against one-by-one dispatches;
- the ``omni_call`` record's spans and counters;
- the published configuration's widths and size.

Tolerances: both sides compute in float32 here, in another order (SDPA and
the cache against one causal product; the experts' rows gathered), so
logits agree to 1e-4 of their spread; the audio tower is compared apart at
3e-3, since the port's Whisper encoder takes the tanh GELU (the JAX
package's) where the reference takes the exact one.
"""

import itertools

import numpy as np
import pytest
import torch

from wis_tpu_torch.decoding.omni import run_omni, unpack_omni
from wis_tpu_torch.models.unimoe import config as C
from wis_tpu_torch.models.unimoe import model as M
from wis_tpu_torch.models.unimoe import moe
from wis_tpu_torch.models.unimoe import reference as R
from wis_tpu_torch.models.unimoe import weights as W
from wis_tpu_torch.models.whisper.config import WhisperConfig
from wis_tpu_torch.ops.moe_experts import grouped_swiglu, grouped_swiglu_plain, sort_pairs
from wis_tpu_torch.runtime.batcher import ASRRequest, InferenceExecutor
from wis_tpu_torch.runtime.engine import COUNTERS, WhisperEngine
from wis_tpu_torch.runtime.residency import ModelRegistry
from wis_tpu_torch.settings import APISettings
from wis_tpu_torch.utils import timing

torch.set_num_threads(1)

ENC = WhisperConfig(name="micro-omni", n_mels=128, n_audio_state=64, n_audio_head=2,
                    n_audio_layer=1)
TINY = C.omni_config(hidden_size=56, num_hidden_layers=2, num_attention_heads=14,
                     num_key_value_heads=2, head_dim=4, vocab_size=300,
                     shared_intermediate_size=16, dynamic_intermediate_size=32,
                     whisper_hidden_size=64, encoder=ENC, prompt_head=tuple(range(10, 26)),
                     prompt_tail=tuple(range(30, 38)), eos_token_id=299)


def _audio(seconds, seed):
    return (np.random.default_rng(seed).standard_normal(int(seconds * 16000)) * 0.05
            ).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    sd = W.seeded_hf(TINY, 21, "cpu", torch.float32)
    return sd, W.params_from_hf(dict(sd), TINY, torch.float32, "cpu")


def _kind(slots):
    if slots[0] == moe.NULL:
        return "null first"
    if len(slots) == 2 and slots[1] == moe.NULL:
        return "null second"
    return "one expert" if len(slots) == 1 else "two experts"


def _codes_to_slots(codes):
    return tuple(int(c) for c in codes if c <= moe.NULL)


def test_prefill_and_decode_match_the_reference(tiny):
    sd, params = tiny
    ref = R.Reference(sd, TINY)
    mel = R.log_mel(torch.from_numpy(_audio(2.5, 3)), ENC.n_mels)[None]
    audio = M.audio_tokens(params, mel, TINY)
    reply = [5, 17, 42, 99, 7]
    p = TINY.prompt_len
    cache = M.OmniCache.zeros(TINY, 1, p + len(reply), torch.float32, "cpu")
    tables = M.rope_tables(TINY, p + len(reply), "cpu")
    got = [M.logits(params, M.prefill(params, M.embed_prompt(params, audio, TINY), cache, TINY,
                                      tables)[:, -1])[0]]
    for i, t in enumerate(reply[:-1]):
        h = M.step_hidden(params, torch.tensor([t]), torch.tensor([p + i]), cache, TINY, tables)
        got.append(M.logits(params, h)[0])
    routes = []
    want = ref.decode(audio[0], reply[:-1], routes)[p - 1:]
    got = torch.stack(got)
    spread = float(want.max() - want.min())
    assert float((got - want).abs().max()) < 1e-4 * spread
    # the reference's routing, layer by layer over every position, is the
    # port's, as its cache keeps it
    n = p + len(reply) - 1
    want_slots = [routes[li * n:(li + 1) * n] for li in range(TINY.num_hidden_layers)]
    for li in range(TINY.num_hidden_layers):
        mine = [_codes_to_slots(c) for c in cache.routes[li, 0, :n].tolist()]
        assert mine == [tuple(s) for s in want_slots[li]]
    kinds = {_kind(s) for s in routes}
    assert kinds == {"one expert", "two experts", "null first", "null second"}


def test_the_audio_tower_matches_the_reference(tiny):
    sd, params = tiny
    ref = R.Reference(sd, TINY)
    audio = torch.from_numpy(_audio(3.0, 4))
    with R.full_f32():
        want = ref.encode(audio)
    mel = R.log_mel(audio, ENC.n_mels)[None]
    got = M.audio_tokens(params, mel, TINY)[0]
    assert float((got - want).norm() / want.norm()) < 3e-3


def _brute_force(p, top_p, top_k):
    """The smallest set of slots whose float32 sum reaches top_p, else the
    best set of top_k; of equal sets the larger sum, then the lower
    slots, ordered by descending p (ties to the lower slot)."""
    slots = range(len(p))
    best = None
    for size in range(1, top_k + 1):
        sets = [s for s in itertools.combinations(slots, size)]
        mass = {s: np.float32(sum(np.float32(p[i]) for i in s)) for s in sets}
        reach = [s for s in sets if mass[s] >= np.float32(top_p)]
        pool = reach or (sets if size == top_k else [])
        if pool:
            best = max(pool, key=lambda s: (mass[s], [-i for i in s]))
            break
    return tuple(sorted(best, key=lambda i: (-p[i], i)))


CASES = [
    [0.7, 0.1, 0.1, 0.05, 0.05],  # exactly at the threshold: one slot
    [0.69, 0.11, 0.1, 0.05, 0.05],
    [0.35, 0.35, 0.1, 0.1, 0.1],  # a tie between slots: the lower first
    [0.1, 0.1, 0.1, 0.1, 0.6],  # the null expert first, then a tie
    [0.5, 0.1, 0.1, 0.1, 0.2],  # the null expert second
    [0.2, 0.2, 0.2, 0.2, 0.2],  # all tied
    [0.05, 0.05, 0.05, 0.05, 0.8],  # the null expert alone
]


def test_selection_matches_brute_force():
    rng = np.random.default_rng(5)
    rand = rng.dirichlet(np.full(5, 0.7), size=400)
    probs = np.concatenate([np.asarray(CASES), rand]).astype(np.float32)
    p = torch.from_numpy(probs)  # float32 rows; the first is float32(0.7), the threshold
    assert float(p[0, 0]) == float(np.float32(TINY.mlp_dynamic_top_p))
    codes, weights = moe.select(p, 4, TINY.mlp_dynamic_top_p, TINY.mlp_dynamic_top_k)
    for row, c, w in zip(p, codes, weights):
        want = _brute_force(row.numpy(), TINY.mlp_dynamic_top_p, TINY.mlp_dynamic_top_k)
        assert _codes_to_slots(c) == want
        assert w.tolist()[: len(want)] == [float(row[i]) for i in want]
    assert [_codes_to_slots(c) for c in codes[:7]] == [(0,), (0, 1), (0, 1), (4, 0), (0, 4),
                                                        (0, 1), (4,)]
    # tokens not served take no slot
    valid = torch.arange(len(p)) % 3 != 0
    idle, _ = moe.select(p, 4, 0.7, 2, valid)
    assert (idle[~valid] == moe.IDLE).all() and (idle[valid] == codes[valid]).all()


def test_expert_layer_against_a_loop():
    g = torch.Generator().manual_seed(8)
    n, d, f, e = 13, 24, 40, 4
    h = torch.randn(n, d, generator=g)
    wg, wu = torch.randn(e, f, d, generator=g) / 5, torch.randn(e, f, d, generator=g) / 5
    wd = torch.randn(e, d, f, generator=g) / 6
    codes = torch.randint(0, 7, (n, 2), generator=g)
    weights = torch.rand(n, 2, generator=g)
    want = torch.zeros(n, d)
    for t in range(n):
        for k in range(2):
            x = int(codes[t, k])
            if x < e:
                act = torch.nn.functional.silu(h[t] @ wg[x].T) * (h[t] @ wu[x].T)
                want[t] += weights[t, k] * (act @ wd[x].T)
    got = grouped_swiglu(h, wg, wu, wd, codes, weights)
    assert torch.allclose(got, want, atol=1e-5)
    assert torch.equal(got, grouped_swiglu_plain(h, wg, wu, wd, codes, weights))
    # the device permutation: pairs grouped by expert, stably, the rest last
    order, counts, starts = sort_pairs(codes, e)
    flat = codes.reshape(-1)
    for x in range(e + 1):
        mine = order[int(starts[x]): int(starts[x]) + int(counts[x])].tolist()
        want_pairs = [i for i in range(flat.numel()) if min(int(flat[i]), e) == x]
        assert mine == want_pairs


@pytest.fixture
def engine(monkeypatch):
    monkeypatch.setitem(C.OMNI_CONFIGS, C.OMNI_NAME, TINY)
    settings = APISettings(dtype="float32", batch_buckets=["1", "2", "4", "8"])
    return WhisperEngine(ModelRegistry(settings, "cpu"))


def test_coalesced_dispatch_equals_one_by_one(engine):
    reqs = [ASRRequest(audio=_audio(1.0 + i, 30 + i), model=C.OMNI_NAME, beam_size=1,
                       max_tokens=3 + i) for i in range(3)]
    batch = engine.transcribe_coalesced(reqs)
    alone = [engine.transcribe(r.audio, model=C.OMNI_NAME, max_tokens=r.max_tokens) for r in reqs]
    assert [r.tokens for r in batch] == [r.tokens for r in alone]
    assert [len(r.tokens) for r in batch] == [3, 4, 5]
    ex = InferenceExecutor(engine, engine.settings)
    try:
        served = [f.result(timeout=120) for f in [ex.submit(r) for r in [
            ASRRequest(audio=r.audio, model=C.OMNI_NAME, beam_size=1, max_tokens=r.max_tokens)
            for r in reqs]]]
    finally:
        ex.shutdown()
    assert [r.tokens for r in served] == [r.tokens for r in alone]


def test_omni_call_record(engine):
    reqs = [ASRRequest(audio=_audio(2.0, 40 + i), model=C.OMNI_NAME, beam_size=1, max_tokens=cap)
            for i, cap in enumerate((4, 6))]
    res = engine.transcribe_coalesced(reqs)
    rec = [t for t in timing.recent() if t.kind == "omni_call"][-1]
    names = [s.name for s in rec.spans]
    for name in ("features", "omni_dispatch", "omni.encode", "omni.prefill", "omni.decode",
                 "omni.readback"):
        assert names.count(name) == 1, name
    assert names.count("omni.step") == 6
    disp = next(s for s in rec.spans if s.name == "omni_dispatch")
    assert disp.attrs == {"B": 2, "rows": 2, "cap": 6}
    assert set(COUNTERS) <= set(rec.counts)
    c = rec.counts
    layers, p = TINY.num_hidden_layers, TINY.prompt_len
    # every layer passes 2 rows of the prompt, then each token fed back
    # while its row runs: 3 for the first row, 5 for the second
    assert c["moe.prefill_tokens"] == layers * 2 * p
    assert c["moe.tokens"] == layers * (2 * p + 3 + 5)
    assert c["moe.prefill_expert_rows"] <= c["moe.expert_rows"] <= 2 * c["moe.tokens"]
    assert 0 < c["moe.null_rows"] < c["moe.tokens"]
    assert c["moe.prefill_experts_touched"] <= 4 * layers
    assert c["moe.experts_touched"] <= 4 * layers * 6
    assert [len(r.tokens) for r in res] == [4, 6]
    assert disp.parent is None and all(res_i.timings["omni_dispatch"] > 0 for res_i in res)


def test_program_packs_tokens_lengths_and_counters(tiny):
    _, params = tiny
    audio = torch.from_numpy(np.stack([(_audio(2.0, 50 + i) * 32768).astype(np.int16)
                                       for i in range(4)]))
    packed = run_omni(params, TINY, audio, [5, 2, 5, 5], 2, {}, TINY.prompt_len + 8).numpy()
    tokens, lengths, ctr = unpack_omni(packed, 4, 5)
    assert tokens.shape == (4, 5) and lengths.tolist() == [5, 2, 0, 0]
    assert ctr.shape == (8,) and ctr[0] == TINY.num_hidden_layers * (2 * TINY.prompt_len + 4 + 1)


def test_published_configuration():
    cfg = C.omni_config()
    assert (cfg.num_hidden_layers, cfg.hidden_size, cfg.num_attention_heads,
            cfg.num_key_value_heads, cfg.head_dim, cfg.vocab_size) == (28, 3584, 28, 4, 128, 152064)
    assert (cfg.mlp_fixed_expert_num, cfg.shared_intermediate_size, cfg.mlp_dynamic_expert_num,
            cfg.dynamic_intermediate_size,
            cfg.mlp_dynamic_null_expert_num) == (2, 2368, 4, 18944, 1)
    assert (cfg.mlp_dynamic_top_p, cfg.mlp_dynamic_top_k, cfg.router_slots) == (0.7, 2, 5)
    assert cfg.prompt_len == 224 and cfg.encoder.n_mels == 128
    assert cfg.kv_bytes_per_token() == 57344
    shapes = dict(W.hf_shapes(cfg))
    assert sum(int(np.prod(s)) for s in shapes.values()) == cfg.param_count()
    assert shapes["model.layers.27.mlp.experts.3.down_proj.weight"] == (3584, 18944)
    # 26.2 B in the decoder and its head, 0.64 B in the audio tower
    assert 26.1e9 < cfg.param_count() - 0.63e9 < 26.3e9
    assert C.is_omni("Uni-MoE-2.0-Omni") and not C.is_omni("large")


@pytest.mark.cuda
@pytest.mark.parametrize("n,routing", [(1, "two"), (8, "uneven"), (16, "null_heavy"),
                                       (300, "two")])
def test_grouped_kernel_on_the_card(n, routing):
    """The CUDA kernels against the plain loop on the card (no CPU
    mode), at a narrow width: relative L2 under 4e-3 (float32 sums of
    the same bf16 products; the activation rounded to bf16 in between)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the grouped expert kernel has no CPU mode")
    import chip_smoke
    from wis_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(n)
    d, f, e = 512, 1024, 4
    wg = (torch.randn(e, f, d, generator=g, device=dev) * d ** -0.5).bfloat16()
    wu = (torch.randn(e, f, d, generator=g, device=dev) * d ** -0.5).bfloat16()
    wd = (torch.randn(e, d, f, generator=g, device=dev) * f ** -0.5).bfloat16()
    h = torch.randn(n, d, generator=g, device=dev).bfloat16()
    codes, wts = chip_smoke.moe_codes(torch, dev, n, routing, 11)
    got = grouped_swiglu(h, wg, wu, wd, codes, wts)
    want = grouped_swiglu_plain(h, wg, wu, wd, codes, wts)
    assert float((got - want).norm() / want.norm().clamp_min(1e-30)) < 4e-3
