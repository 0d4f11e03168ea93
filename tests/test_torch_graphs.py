"""The port's one way to capture and count CUDA graphs (``ops/graphs.py``).

On the CPU: ``launched`` counts into an entry's ``launches`` eagerly and
into the capture's tally on a capturing stream; a ``Graph`` adds its tally
at each replay; ``GraphPool.capture`` run over stand-ins for the CUDA calls
(warm-up, tally, take-back, a pool made once, one capture stream a
device); every counted kernel entry of ``ops/`` counts through
``launched`` in its source (its CUDA path runs on the card only); and no
other module of the package captures a graph.

On the card (marker ``cuda``): each counted entry captured alone, on the
inputs of tests/test_torch_cuda_kernels.py, its launches in the graph's
tally and each replay's in ``launches``; a body of ``int8_matmul`` and
``layer_norm_cuda`` captured and replayed, its tallies and results; and
Uni-MoE-2.0-Omni's step replayed from its ``StepSlot`` against the eager
``model.step`` at two batch buckets, bit for bit. The card's machine has no
JAX; run them there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs.py
"""

import ast
import contextlib
import importlib
import inspect
import pathlib

import numpy as np
import pytest
import torch

from wis_tpu_torch.ops import graphs
from wis_tpu_torch.ops.graphs import Graph, GraphPool, launched

PACKAGE = pathlib.Path(graphs.__file__).resolve().parents[1]

#: every counted kernel entry of ops/: (module, function, the entry it counts)
ENTRIES = [
    ("quant", "int8_matmul", "int8_matmul"),
    ("layernorm", "layer_norm_cuda", "layer_norm_cuda"),
    ("flash", "flash_attention_packed", "flash_attention_packed"),
    ("flash", "flash_attention", "flash_attention"),
    ("decode_attn", "ancestry_attention", "ancestry_attention"),
    ("fused_decode", "fused_decode_step", "fused_decode_step"),
    ("fused_logits", "fused_logits_topk", "fused_logits_topk"),
    ("fused_logits", "fused_logits_topk", "fused_logits_topk.grammar"),
    ("fused_gpt", "fused_gpt_step", "fused_gpt_step"),
    ("fused_gpt_head", "fused_gpt_head", "fused_gpt_head"),
    ("moe_experts", "grouped_swiglu", "grouped_swiglu"),
    ("bias_act", "bias_act", "bias_act"),
]


def _entry(name):
    def entry():
        pass

    entry.__name__ = name
    entry.launches = 0
    return entry


@pytest.fixture
def capturing(monkeypatch):
    """``torch.cuda.is_current_stream_capturing`` as a switch, a fresh
    capture tally and no capture stream yet."""
    state = {"on": False}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: state["on"])
    monkeypatch.setattr(graphs, "_tally", {})
    monkeypatch.setattr(graphs, "_streams", {})
    return state


def test_launched_counts_eagerly(capturing):
    a, b = _entry("a"), _entry("b")
    launched(a)
    launched(a, 2)
    launched(b)
    assert (a.launches, b.launches) == (3, 1) and graphs._tally == {}


def test_launched_counts_into_the_capture_tally(capturing):
    a, b = _entry("a"), _entry("b")
    capturing["on"] = True
    launched(a)
    launched(a, 2)
    launched(b)
    assert (a.launches, b.launches) == (0, 0) and graphs._tally == {a: 3, b: 1}


def test_a_replay_adds_its_tally():
    a, b = _entry("a"), _entry("b")

    class Fake:
        replays = 0

        def replay(self):
            Fake.replays += 1

    g = Graph(Fake(), "out", {a: 2, b: 1}, 0)
    assert g.replay() == "out" and g.replay(3) == "out"
    assert (Fake.replays, a.launches, b.launches) == (4, 8, 4)


class _FakeCuda:
    """Stand-ins for the CUDA calls ``GraphPool.capture`` makes: the
    capture flips ``capturing`` and grows the reserved bytes by 512."""

    def __init__(self, state):
        self.state, self.reserved, self.waits = state, 1024, []
        self.pools = self.streams = self.replays = 0
        fake = self

        class Stream:
            def __init__(self, device=None):
                fake.streams += 1
                self.name = f"side{fake.streams}"

            def wait_stream(self, other):
                fake.waits.append((self.name, other.name))

        class CUDAGraph:
            def capture_begin(self, pool=None, capture_error_mode="global"):
                assert pool == "pool" and capture_error_mode == "thread_local"
                fake.state["on"] = True

            def capture_end(self):
                fake.state["on"] = False
                fake.reserved += 512

            def replay(self):
                fake.replays += 1

        caller = Stream.__new__(Stream)
        caller.name = "caller"
        self.Stream, self.CUDAGraph, self.caller = Stream, CUDAGraph, caller

    def install(self, monkeypatch):
        def graph_pool_handle():
            self.pools += 1
            return "pool"

        monkeypatch.setattr(torch.cuda, "graph_pool_handle", graph_pool_handle)
        monkeypatch.setattr(torch.cuda, "Stream", self.Stream)
        monkeypatch.setattr(torch.cuda, "CUDAGraph", self.CUDAGraph)
        monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: self.caller)
        monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: self.reserved)


def test_capture_tallies_the_body_and_takes_the_warm_up_back(capturing, monkeypatch):
    fake = _FakeCuda(capturing)
    fake.install(monkeypatch)
    a, b = _entry("a"), _entry("b")
    a.launches = 5
    calls = []

    def body():
        calls.append("body")
        launched(a, 2)
        launched(b)
        return "out"

    def warm():
        calls.append("warm")
        launched(a, 2)
        launched(b)

    pool = GraphPool("cpu")
    assert pool.handle is None and fake.pools == fake.streams == 0
    g = pool.capture(body, warm)
    assert calls == ["warm", "body"] and g.out == "out" and g.bytes == 512
    assert g.tally == {a: 2, b: 1}
    assert (a.launches, b.launches) == (5, 0)  # the warm-up's taken back
    # the side stream after the caller's, then the caller after the side stream
    assert fake.waits == [("side1", "caller"), ("caller", "side1")]
    g2 = pool.capture(body)  # the body warms up by default
    assert calls[2:] == ["body", "body"] and g2.tally == g.tally and g2.out == "out"
    assert (a.launches, b.launches) == (5, 0) and fake.pools == fake.streams == 1
    g.replay(3)
    assert (a.launches, b.launches, fake.replays) == (11, 3, 3)
    # another pool on the device: a pool of its own, the same capture stream
    GraphPool("cpu").capture(body)
    assert (fake.pools, fake.streams) == (2, 1) and fake.waits[-1] == ("caller", "side1")


def _resolve(obj, path):
    for name in path.split("."):
        obj = getattr(obj, name)
    return obj


@pytest.mark.parametrize("module,name,path", ENTRIES, ids=[p for _, _, p in ENTRIES])
def test_each_entry_counts_through_launched(module, name, path):
    """The function's CUDA path counts the entry's launches with one
    ``launched(entry)``, into a ``launches`` that starts at 0, and
    assigns no count of its own. (The path runs on the card only:
    test_each_entry_counts_its_replays below holds it to its tally.)"""
    mod = importlib.import_module(f"wis_tpu_torch.ops.{module}")
    entry = _resolve(mod, path)
    assert mod.launched is launched
    assert isinstance(entry.launches, int) and not hasattr(entry, "captured")
    fn = ast.parse(inspect.getsource(getattr(mod, name))).body[0]
    counted = [ast.unparse(c.args[0]) for c in ast.walk(fn) if isinstance(c, ast.Call)
               and isinstance(c.func, ast.Name) and c.func.id == "launched"]
    assert counted.count(path) == 1
    assigned = [ast.unparse(t) for node in ast.walk(fn)
                if isinstance(node, (ast.AugAssign, ast.Assign))
                for t in ([node.target] if isinstance(node, ast.AugAssign) else node.targets)
                if isinstance(t, ast.Attribute) and ast.unparse(t.value).startswith(name)]
    assert assigned == []


def test_only_ops_graphs_captures():
    names = ("CUDAGraph", "capture_begin", "graph_pool_handle", "torch.cuda.graph(",
             "is_current_stream_capturing", ".captured")
    found = [(str(p.relative_to(PACKAGE)), n) for p in sorted(PACKAGE.rglob("*.py"))
             if p.name != "graphs.py" or p.parent.name != "ops"
             for n in names if n in p.read_text()]
    assert found == []


# --------------------------------------------------------------- the card


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs replay the Hopper kernels")
    from wis_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _case(path, dev):
    """A call of the entry at ``path`` on small inputs of the card's kernel
    tests → (the call, {entry: its launches in one call})."""
    import chip_smoke
    import test_torch_cuda_kernels as K

    rng = np.random.default_rng(7)
    bf16, f32 = torch.bfloat16, torch.float32
    if path == "int8_matmul":
        from wis_tpu_torch.ops.quant import int8_matmul as e
        from wis_tpu_torch.ops.quant import quantize_weight

        w = quantize_weight(K._randn(rng, (256, 128), dev, f32, scale=0.05))
        x = K._randn(rng, (4, 256), dev, bf16)
        return lambda: e(x, w["q"], w["s"].reshape(-1)), {e: 1}
    if path == "layer_norm_cuda":
        from wis_tpu_torch.ops.layernorm import layer_norm_cuda as e

        x, g, b = K._randn(rng, (5, 384), dev, bf16), K._randn(rng, (384,), dev, f32), \
            K._randn(rng, (384,), dev, f32)
        return lambda: e(x, g, b), {e: 1}
    if path == "flash_attention_packed":
        from wis_tpu_torch.ops.flash import flash_attention_packed as e

        q, k, v = (K._randn(rng, (1, 65, 256), dev, bf16) for _ in range(3))
        return lambda: e(q, k, v, 2), {e: 1}
    if path == "flash_attention":
        from wis_tpu_torch.ops.flash import flash_attention as e

        q, k, v = K._head_major_inputs(dev, 1, 2, 65, 64, False, seed=1)
        return lambda: e(q, k, v), {e: 1}
    if path == "ancestry_attention":
        from wis_tpu_torch.ops.decode_attn import ancestry_attention as e

        q, kc, vc, anc = K._anc_case(dev, 5, 5, 20, 64, 100, 50, seed=1)
        return lambda: e(q, kc, vc, anc, 50), {e: 1}
    if path == "fused_decode_step":
        from wis_tpu_torch.ops.fused_decode import fused_decode_step as e

        cfg, packed = K._narrow_decoder(dev)
        inp = K._step_case(dev, cfg, 5, 1, 128, 1500, True, seed=1)
        return lambda: e(cfg, packed, **inp), {e: 1}
    if path.startswith("fused_logits_topk"):
        from wis_tpu_torch.models.whisper.tokenizer import EOT, V2_LAYOUT
        from wis_tpu_torch.ops.fused_logits import fused_logits_topk as e

        if path == "fused_logits_topk":
            x, g, b, emb, sup = K._head_inputs(dev, 5, 1000, seed=1)
            return lambda: e(x, g, b, emb, sup, k=6), {e: 1}
        v, ts_base = V2_LAYOUT.n_vocab, V2_LAYOUT.timestamp_base
        x, g, b, emb, sup, ts = (torch.from_numpy(a).to(dev) for a in
                                 chip_smoke.grammar_head_case(5, 256, v, ts_base, EOT, seed=5))
        emb = emb.to(bf16)
        return (lambda: e(x, g, b, emb, sup, k=6, ts_state=ts, ts_base=ts_base, eot=EOT),
                {e: 1, e.grammar: 1})
    if path == "fused_gpt_step":
        from wis_tpu_torch.ops.fused_gpt import fused_gpt_step as e

        cfg, _, packed = K._narrow_gpt(dev)
        kc, vc = (K._randn(rng, (cfg.n_layer, cfg.d_model, 256), dev, bf16) for _ in range(2))
        sel = (torch.arange(256, device=dev) < 100).float()[None]
        x = K._randn(rng, (1, cfg.d_model), dev, f32)
        return lambda: e(cfg, packed, x, kc, vc, sel, 100), {e: 1}
    if path == "fused_gpt_head":
        from wis_tpu_torch.models.xtts.gpt import GPTConfig
        from wis_tpu_torch.ops.fused_gpt_head import fused_gpt_head as e

        cfg = GPTConfig()
        inputs = chip_smoke._gpt_head_decision_case(torch, dev, cfg, seed=5)[0]
        knobs = torch.tensor([[0.1, 50, 0.8, 7.0, 1.0, 1.0, 0.0, 0.0]], device=dev)
        return lambda: e(*inputs, knobs, cfg=cfg), {e: 1}
    if path == "bias_act":
        from wis_tpu_torch.ops.bias_act import bias_act as e

        y, r = K._randn(rng, (20, 1280), dev, bf16), K._randn(rng, (20, 1280), dev, bf16)
        b = K._randn(rng, (1280,), dev, bf16)
        return lambda: e(y, b, gelu=True, residual=r), {e: 1}
    from wis_tpu_torch.ops.moe_experts import grouped_swiglu as e

    h = K._randn(rng, (8, 128), dev, bf16)
    wg, wu, wd = (K._randn(rng, (4, 128, 128), dev, bf16, scale=0.05) for _ in range(3))
    codes = torch.from_numpy(rng.integers(0, 5, (8, 2))).to(dev)  # 4: no dynamic expert
    weights = torch.rand(8, 2, device=dev)
    return lambda: e(h, wg, wu, wd, codes, weights), {e: 2}


@pytest.mark.cuda
@pytest.mark.parametrize("path", [p for _, _, p in ENTRIES])
def test_each_entry_counts_its_replays(dev, path):
    """The entry captured alone: its launches go to the graph's tally, the
    warm-up's are taken back, and each replay adds the tally to
    ``launches``."""
    call, want = _case(path, dev)
    before = {e: e.launches for e in want}
    graph = GraphPool(dev).capture(call)
    assert graph.tally == want
    assert {e: e.launches for e in want} == before
    graph.replay(2)
    torch.cuda.synchronize()
    assert {e: e.launches - before[e] for e in want} == {e: 2 * n for e, n in want.items()}


@pytest.mark.cuda
def test_a_captured_body_counts_each_replay(dev):
    from wis_tpu_torch.ops.layernorm import layer_norm_cuda
    from wis_tpu_torch.ops.quant import int8_matmul, quantize_weight

    g = torch.Generator(device=dev).manual_seed(3)
    w = quantize_weight(torch.randn(256, 128, generator=g, device=dev) * 0.05)
    ln_g, ln_b = torch.rand(256, generator=g, device=dev) + 0.5, torch.zeros(256, device=dev)
    x = torch.randn(4, 256, generator=g, device=dev).bfloat16()

    def body():
        h = layer_norm_cuda(x, ln_g, ln_b)
        return int8_matmul(int8_matmul(h, w["q"], w["s"].reshape(-1)).repeat(1, 2),
                           w["q"], w["s"].reshape(-1))

    before = (int8_matmul.launches, layer_norm_cuda.launches)
    graph = GraphPool(dev).capture(body)
    assert (int8_matmul.launches, layer_norm_cuda.launches) == before  # the warm-up's taken back
    assert graph.tally == {layer_norm_cuda: 1, int8_matmul: 2}
    for seed in (4, 5):
        x.copy_(torch.randn(4, 256, generator=g.manual_seed(seed), device=dev).bfloat16())
        want = body()
        before = (int8_matmul.launches, layer_norm_cuda.launches)
        got = graph.replay(3).clone()
        torch.cuda.synchronize()
        assert (int8_matmul.launches - before[0], layer_norm_cuda.launches - before[1]) == (6, 3)
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4])
def test_omni_step_replay_is_the_eager_step(dev, batch):
    """A micro Uni-MoE-2.0-Omni (widths the grouped kernel takes, GQA
    4:1, the published routing) prefilled, then 12 steps replayed
    from a ``StepSlot`` against ``model.step`` on a copy of the same cache:
    tokens, the cache's K/V and routes, and the routing counts bit for bit;
    the padding row of the bucket of 4 idle."""
    from wis_tpu_torch.decoding.omni import StepSlot
    from wis_tpu_torch.models.unimoe import config as C
    from wis_tpu_torch.models.unimoe import model as M
    from wis_tpu_torch.models.unimoe import moe
    from wis_tpu_torch.models.unimoe import weights as W
    from wis_tpu_torch.models.whisper.config import WhisperConfig
    from wis_tpu_torch.ops.moe_experts import grouped_swiglu

    enc = WhisperConfig(name="micro-omni", n_mels=128, n_audio_state=64, n_audio_head=2,
                        n_audio_layer=1)
    cfg = C.omni_config(hidden_size=256, num_hidden_layers=2, num_attention_heads=8,
                        num_key_value_heads=2, head_dim=32, vocab_size=512,
                        shared_intermediate_size=128, dynamic_intermediate_size=256,
                        whisper_hidden_size=64, whisper_query_tokens_size=24, encoder=enc,
                        prompt_head=tuple(range(10, 26)), prompt_tail=tuple(range(30, 38)),
                        eos_token_id=511)
    params = W.params_from_hf(W.seeded_hf(cfg, 23, dev), cfg, torch.bfloat16, dev)
    steps, p = 12, cfg.prompt_len
    slot = StepSlot(params, cfg, batch, p + steps + 1, dev, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(batch)
    audio = torch.randn(batch, cfg.whisper_query_tokens_size, cfg.hidden_size, generator=gen,
                        device=dev).bfloat16()
    valid = torch.arange(batch, device=dev) < max(1, batch - 1)
    with torch.inference_mode():
        h = M.prefill(params, M.embed_prompt(params, audio, cfg), slot.cache, cfg, slot.tables,
                      valid=valid[:, None].expand(batch, p).reshape(-1))
        tok = M.logits(params, h[:, -1]).argmax(-1)
        cache = M.OmniCache(*(t.clone() for t in slot.cache))
        acc = torch.zeros_like(slot.acc)
        want, t = [], tok
        for i in range(steps):
            t = M.step(params, t, torch.tensor([p + i], device=dev), cache, cfg, slot.tables,
                       valid, acc)
            want.append(t.clone())
        slot.acc.zero_()
        launches, got, t = grouped_swiglu.launches, [], tok
        for i in range(steps):
            t = slot.run(t, p + i, valid)
            got.append(t.clone())
        torch.cuda.synchronize()
    layers = cfg.num_hidden_layers
    assert slot.graph.tally == {grouped_swiglu: 2 * layers}
    assert grouped_swiglu.launches - launches == 2 * layers * steps
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(slot.acc, acc) and int(acc[:-1].sum()) > 0
    for mine, ref in zip(slot.cache, cache):
        assert torch.equal(mine, ref)
    if batch > 1:  # the padding row runs no expert
        assert bool((slot.cache.routes[:, -1, p:p + steps] == moe.IDLE).all())
