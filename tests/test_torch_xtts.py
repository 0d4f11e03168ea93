"""The XTTS slice of the PyTorch port (``wis_tpu_torch/models/xtts``) held
against wis_tpu's on the CPU: seeded weights, the quantizer and the bridge
bit for bit; the text cleaner and the resampler as copies; the sampling
stack; ``gpt_pass`` and the prefill; the HiFi-GAN vocoder.

Tolerances (each stated at its test): bit-equal where both sides run the
same arithmetic on the same numbers (weight draws, quantization, the
bridge); 1e-5 relative for the f32 GPT (XLA and PyTorch sum the same
products in another order, and XLA's f32 tanh in the gelu is a rational
approximation a few ulps off torch's); 2e-2 for bf16 (both round every
activation to bf16, in places that differ); 1e-4 for the f32 vocoder (a
dozen convolutions, each an f32 sum of up to 11·512 products in another
order).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import np_tree
from wis_tpu.models.xtts import gpt as jg
from wis_tpu.models.xtts import hifigan as jh
from wis_tpu_torch.models.xtts import gpt as tg
from wis_tpu_torch.models.xtts import hifigan as th
from wis_tpu_torch.models.xtts.weights import params_from_jax

torch.set_num_threads(1)

#: a narrow GPT: 2 layers, D=128, 2 heads (head dim 64, the kernels')
GPT_SMALL = dict(n_layer=2, n_head=2, d_model=128, n_text_vocab=64, n_audio_vocab=68,
                 max_text_tokens=16, max_audio_tokens=24, start_audio_token=66,
                 stop_audio_token=67)
JG, TG = jg.GPTConfig(**GPT_SMALL), tg.GPTConfig(**GPT_SMALL)
#: the JAX tests' micro vocoder (tests/test_xtts.py)
VOC_MICRO = dict(in_dim=32, cond_dim=16, upsample_initial=32, upsample_rates=(4, 2),
                 upsample_kernels=(8, 4), resblock_kernels=(3,), resblock_dilations=((1, 3),),
                 gpt_code_stride=16)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


def _assert_trees_bit_equal(want, got):
    want, got = dict(_leaves(want)), dict(_leaves(got))
    assert want.keys() == got.keys()
    for name, w in want.items():
        g = got[name]
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, name
        np.testing.assert_array_equal(_torch_bits(g), _bits(w), err_msg=name)


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want).astype(np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# --------------------------------------------------------------------------- #
# weights, quantizer, bridge: bit-equal
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_random_weights_bit_equal(dtype):
    """random_gpt and random_hifigan repeat the JAX package's numpy draws:
    the same leaves, shapes, dtypes and bits."""
    _assert_trees_bit_equal(np_tree(jg.random_gpt(JG, seed=3, dtype=getattr(jnp, dtype))),
                            tg.random_gpt(TG, seed=3, dtype=getattr(torch, dtype)))
    jv, tv = jh.HiFiGANConfig(**VOC_MICRO), th.HiFiGANConfig(**VOC_MICRO)
    _assert_trees_bit_equal(np_tree(jh.random_hifigan(jv, seed=4, dtype=getattr(jnp, dtype))),
                            th.random_hifigan(tv, seed=4, dtype=getattr(torch, dtype)))


def test_quantize_gpt_params_and_bridge_bit_equal():
    """quantize_gpt_params equals JAX's (int8 q and f32 scales, the other
    leaves untouched), and the bridge carries every leaf of a quantized GPT
    tree and a vocoder tree across unchanged."""
    from wis_tpu.ops.quant import quantize_gpt_params as jq
    from wis_tpu_torch.ops.quant import quantize_gpt_params as tq

    src = jg.random_gpt(JG, seed=5, dtype=jnp.bfloat16)
    want = np_tree(jq(src))
    _assert_trees_bit_equal(want, tq(params_from_jax(np_tree(src), "cpu")))
    _assert_trees_bit_equal(want, params_from_jax(want, "cpu"))
    voc = np_tree(jh.random_hifigan(jh.HiFiGANConfig(**VOC_MICRO), seed=1))
    _assert_trees_bit_equal(voc, params_from_jax(voc, "cpu"))
    assert isinstance(params_from_jax(voc, "cpu")["ups"], list)


def test_configs_equal():
    from wis_tpu.models.xtts import model as jm
    from wis_tpu_torch.models.xtts import model as tm

    assert dataclasses.asdict(tg.GPTConfig()) == dataclasses.asdict(jg.GPTConfig())
    assert dataclasses.asdict(th.HiFiGANConfig()) == dataclasses.asdict(jh.HiFiGANConfig())
    assert dataclasses.asdict(tm.XTTSConfig()) == dataclasses.asdict(jm.XTTSConfig())
    assert tm.XTTS_LANGUAGES == jm.XTTS_LANGUAGES
    cfg = th.HiFiGANConfig()
    for n in (1, 6, 20, 22, 605):
        assert cfg.vocoded_length(n) == jh.HiFiGANConfig().vocoded_length(n)
    for text in ("One. Two! Three?", "  no split here ", "好。好！"):
        assert tm.split_sentences(text) == jm.split_sentences(text)


# --------------------------------------------------------------------------- #
# host copies: the text cleaner and the resampler
# --------------------------------------------------------------------------- #
#: inputs beside the JAX tests' own: mixed text in every language with
#: number tables, the languages without them, and the repaired case
TEXTNORM_EXTRA = [
    ("Pay $5, Dr. Lee!", "en"), ("I have 3.14 apples and 21st place", "en"),
    ('He said "hello" @ 5% off & more', "en"), ("£2.50 or €3", "en"),
    ("Sr. García pagó $3.50 el 1º", "es"), ("M. Dupont a payé 21 € — 80%", "fr"),
    ("Herr Dr. Müller zahlt 1.000 € für 99 Äpfel", "de"),
    ("%50 indirim, 1996 yılında İstanbul'da", "tr"), ("У меня 21 рубль и 5 рублей", "ru"),
    ("12 45 1000000 2000000", "de"), ("価格は100円です", "ja"), ("가격은 100원입니다", "ko"),
    ("السعر 100", "ar"), ("价格是100元", "zh-cn"), ("Az ár 100 forint", "hu"),
    ("  lots   of\tspace ", "en"), ("2,5 kg", "de"), ("3,141", "it"),
]


def _jax_textnorm_corpus():
    """Every preprocess_text(text, lang) call with literal arguments in the
    JAX package's textnorm tests."""
    import ast
    import pathlib

    calls = []
    for name in ("test_textnorm.py", "test_textnorm_breadth.py"):
        tree = ast.parse((pathlib.Path(__file__).parent / name).read_text())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "preprocess_text"
                    and len(node.args) == 2
                    and all(isinstance(a, ast.Constant) for a in node.args)):
                calls.append(tuple(a.value for a in node.args))
    return calls


def test_textnorm_copy_equals_jax_but_for_the_repair():
    """preprocess_text over the JAX tests' corpus and a number sweep in
    every language with tables: equal, except the continental decimal
    comma with three fraction digits (the one deliberate difference)."""
    from wis_tpu.models.xtts import textnorm as jt
    from wis_tpu_torch.models.xtts import textnorm as tt

    corpus = _jax_textnorm_corpus()
    assert len(corpus) >= 20
    repaired = {("3,141", "it")}
    for text, lang in corpus + TEXTNORM_EXTRA:
        if (text, lang) in repaired:
            assert tt.preprocess_text(text, lang) != jt.preprocess_text(text, lang)
        else:
            assert tt.preprocess_text(text, lang) == jt.preprocess_text(text, lang), (text, lang)
    for lang in ("en", "es", "fr", "de", "it", "pt", "pl", "ru", "nl", "tr", "cs"):
        for n in (0, 1, 7, 13, 21, 99, 100, 101, 999, 1000, 1001, 1996, 21000, 10**6, 2 * 10**6):
            assert tt.preprocess_text(f"{n} x", lang) == jt.preprocess_text(f"{n} x", lang)


def test_textnorm_reads_continental_decimals_with_three_digits():
    """The repaired fault: "3,141" is a decimal in continental languages,
    while English still reads the thousands group."""
    from wis_tpu_torch.models.xtts.textnorm import expand_numbers, preprocess_text

    assert expand_numbers("3,141", "de") == "drei komma eins vier eins"
    assert preprocess_text("3,141", "it") == "tre virgola uno quattro uno"
    assert preprocess_text("1,234 items", "en") == "one thousand two hundred thirty-four items"
    assert preprocess_text("€1,500", "de") == preprocess_text("€1,50", "de")


@pytest.mark.parametrize("rates", [(24000, 12000), (24000, 30000), (22050, 24000)])
def test_resample_equals_jax_copy(rates):
    from wis_tpu.audio.codecs import _resample_python
    from wis_tpu_torch.audio.resample import resample

    pcm = np.random.default_rng(0).standard_normal(5000).astype(np.float32)
    np.testing.assert_array_equal(resample(pcm, *rates), _resample_python(pcm, *rates))


# --------------------------------------------------------------------------- #
# sampling
# --------------------------------------------------------------------------- #
def _logits_case(seed, v=68, b=2):
    """Logits with exact ties, negative and positive values, and a history
    zero-padded past its length (token 0 counts as emitted, as in JAX)."""
    rng = np.random.default_rng(seed)
    logits = np.round(rng.standard_normal((b, v)) * 3, 1).astype(np.float32)
    hist = np.zeros((b, 12), np.int64)
    hist[:, :5] = rng.integers(1, v, (b, 5))
    return logits, hist


#: (temperature, top_k, top_p, repetition_penalty); the seeds' top-p prefix
#: sums over the top-k tokens (the only ones whose cutoff the k-threshold
#: leaves visible) stay more than 1e-6 from top_p (checked below), so XLA's
#: and torch's cumsum orders cannot move the kept set
KNOB_GRID = [
    (1.0, 5, 0.9, 2.0), (0.1, 50, 0.8, 7.0), (0.7, 1, 1.0, 1.0), (1.3, 1000, 0.5, 1.5),
    (2e-6, 10, 0.95, 3.0), (0.5, 68, 0.3, 1.0),
]


def _prefix_margin(logits, hist, temperature, top_k, top_p, rp):
    """Smallest |prefix − top_p| over the top-k tokens of the sorted
    pre-top-k distribution."""
    hit = np.zeros(logits.shape, bool)
    np.put_along_axis(hit, hist, True, axis=1)
    l = np.where(hit, np.where(logits > 0, logits / rp, logits * rp), logits)
    l = l / max(temperature, 1e-5)
    s = -np.sort(-l.astype(np.float64), axis=1)
    p = np.exp(s - s[:, :1])
    p /= p.sum(axis=1, keepdims=True)
    k = min(max(top_k, 1), logits.shape[1])
    return float(np.abs(np.cumsum(p, axis=1) - p - top_p)[:, :k].min())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("knobs", KNOB_GRID)
def test_mask_logits_matches_jax(seed, knobs):
    """The masked set equal, kept values within 1e-6, on ties and the
    token-0 quirk."""
    temperature, top_k, top_p, rp = knobs
    logits, hist = _logits_case(seed)
    assert _prefix_margin(logits, hist, temperature, top_k, top_p, rp) > 1e-6
    want = np.asarray(jg._mask_logits(
        jnp.asarray(logits), jnp.asarray(hist, jnp.int32), jnp.float32(temperature),
        jnp.int32(top_k), jnp.float32(top_p), jnp.float32(rp)))
    got = tg._mask_logits(torch.from_numpy(logits), torch.from_numpy(hist), temperature,
                          top_k, top_p, rp).numpy()
    np.testing.assert_array_equal(got > -1e29, want > -1e29)
    kept = want > -1e29
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6, atol=1e-6)


def test_categorical_is_argmax_of_logits_plus_gumbel():
    """What the port relies on: jax.random.categorical(key, l) draws
    argmax(l + gumbel(key, l.shape))."""
    rng = np.random.default_rng(0)
    for i in range(20):
        l = jnp.asarray(rng.standard_normal((2, 68)) * 2, jnp.float32)
        key = jax.random.PRNGKey(i)
        want = np.asarray(jax.random.categorical(key, l, axis=-1))
        got = np.argmax(np.asarray(l) + np.asarray(jax.random.gumbel(key, l.shape)), axis=-1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("do_sample", [True, False])
@pytest.mark.parametrize("knobs", KNOB_GRID[:4])
def test_sample_token_matches_jax_draws(knobs, do_sample):
    temperature, top_k, top_p, rp = knobs
    for seed in range(4):
        logits, hist = _logits_case(seed + 10)
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jg._sample_token(
            jnp.asarray(logits), jnp.asarray(hist, jnp.int32), key, jnp.float32(temperature),
            jnp.int32(top_k), jnp.float32(top_p), jnp.float32(rp), jnp.bool_(do_sample), JG))
        gum = torch.from_numpy(np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32)))
        got = tg._sample_token(torch.from_numpy(logits), torch.from_numpy(hist), gum,
                               temperature, top_k, top_p, rp, do_sample)
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------- #
# gpt_pass and the prefill
# --------------------------------------------------------------------------- #
def _gpt_pair(dtype, quant, seed=1):
    from wis_tpu.ops.quant import quantize_gpt_params

    p = jg.random_gpt(JG, seed=seed, dtype=getattr(jnp, dtype))
    if quant:
        p = quantize_gpt_params(p)
    return p, params_from_jax(np_tree(p), "cpu")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("quant", [True, False])
def test_prefill_and_gpt_pass_match_jax(dtype, tol, quant):
    """The prefill (conditioning + text + start through a fresh cache),
    then a 3-position gpt_pass at an offset into that cache: hidden states
    and caches within ``tol`` in relative norm."""
    jp, tp = _gpt_pair(dtype, quant)
    cond_len, text_len, max_len = 3, 5, 3 + 5 + 1 + JG.max_audio_tokens
    rng = np.random.default_rng(2)
    cond = rng.standard_normal((1, cond_len, 128)).astype(np.float32) * 0.1
    text = rng.integers(0, 64, (1, text_len))
    jpre = jg.build_prefill(JG, batch=1, cond_len=cond_len, text_len=text_len, max_len=max_len)
    tpre = tg.build_prefill(TG, batch=1, cond_len=cond_len, text_len=text_len, max_len=max_len)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jh_last, jcache = jpre(jp, jnp.asarray(cond, jdt), jnp.asarray(text, jnp.int32))
    th_last, tcache = tpre(tp, torch.from_numpy(cond).to(tdt), torch.from_numpy(text))
    assert tcache.pos == int(jcache.pos) == cond_len + text_len + 1
    assert _rel(th_last, jh_last) <= tol
    assert _rel(tcache.k, jcache.k) <= tol and _rel(tcache.v, jcache.v) <= tol

    x = rng.standard_normal((1, 3, 128)).astype(np.float32) * 0.1
    want, jc2 = jax.jit(partial(jg.gpt_pass, cfg=JG))(jp, jnp.asarray(x, jdt), jcache.pos, jcache)
    got, tc2 = tg.gpt_pass(tp, torch.from_numpy(x).to(tdt), tcache.pos, tcache, TG)
    assert _rel(got, want) <= tol
    assert _rel(tc2.k, jc2.k) <= tol and _rel(tc2.v, jc2.v) <= tol


# --------------------------------------------------------------------------- #
# the vocoder
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("frames", [1, 10, 22])
def test_latent_timeline_matches_jax(frames):
    """Both interpolation stages at the production code stride and at the
    micro one: within 1e-4 relative (f32)."""
    for kw in ({}, VOC_MICRO):
        jc, tc = jh.HiFiGANConfig(**kw), th.HiFiGANConfig(**kw)
        z = np.random.default_rng(frames).standard_normal((1, frames, 8)).astype(np.float32)
        want = jax.jit(partial(jh.latent_timeline, cfg=jc))(jnp.asarray(z))
        got = th.latent_timeline(torch.from_numpy(z), tc)
        assert tuple(got.shape) == want.shape
        assert _rel(got, want) <= 1e-4


#: vocoder configs: the micro one, and one with every production kernel,
#: stride and dilation (16/8 and 4/2 transposed, 3/7/11 × 1/3/5) at
#: narrow channels
VOC_WIDE = dict(in_dim=32, cond_dim=16, upsample_initial=64, gpt_code_stride=256)


@pytest.mark.parametrize("kw", [VOC_MICRO, VOC_WIDE], ids=["micro", "production-kernels"])
def test_hifigan_forward_matches_jax(kw):
    """hifigan_forward in f32 within 1e-4 relative, output length
    vocoded_length(T)."""
    jc, tc = jh.HiFiGANConfig(**kw), th.HiFiGANConfig(**kw)
    jp = jh.random_hifigan(jc, seed=2, dtype=jnp.float32)
    tp = params_from_jax(np_tree(jp), "cpu")
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((1, 7, kw["in_dim"])).astype(np.float32)
    spk = rng.standard_normal((1, kw["cond_dim"])).astype(np.float32)
    want = jax.jit(partial(jh.hifigan_forward, cfg=jc))(jp, jnp.asarray(lat), jnp.asarray(spk))
    got = th.hifigan_forward(tp, torch.from_numpy(lat), torch.from_numpy(spk), tc)
    assert tuple(got.shape) == want.shape == (1, tc.vocoded_length(7))
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("k,stride", [(16, 8), (4, 2), (8, 4), (3, 2), (5, 1)])
def test_transposed_conv_same_padding_matches_jax(k, stride):
    """The transposed convolution's "SAME" cut, for the production and
    micro (kernel, stride) pairs and two odd ones."""
    rng = np.random.default_rng(k * stride)
    x = rng.standard_normal((1, 9, 6)).astype(np.float32)
    w = rng.standard_normal((k, 5, 6)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    want = jh._conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride)
    got = th._conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                               stride)
    assert tuple(got.shape) == want.shape
    assert _rel(got, want) <= 1e-5
