"""``wis_tpu_torch.entry.entry()`` against ``__graft_entry__.entry()`` on
the CPU, with a micro config patched in for large-v2 in both packages:
the same example arguments (a zero mel of large-v2's layout, the English
transcribe prompt, a seeded bf16 tree of the same structure), and on the
JAX tree cast to f32 and bridged to the port, step logits within 1e-4
relative L2 of the JAX forward's, both in f32 throughout (the JAX entry's
bf16 cache is made f32 for the comparison; the port's cache takes the
weights' dtype). Without a card ``entry()`` raises.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import SMALL, np_tree
from wis_tpu_torch.models.whisper.weights import params_from_jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

torch.set_num_threads(1)


@pytest.fixture
def micro_large_v2(monkeypatch):
    from wis_tpu.models.whisper.config import WHISPER_CONFIGS as JAX_CONFIGS
    from wis_tpu.models.whisper.config import WhisperConfig as JaxConfig
    from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS, WhisperConfig

    spec = dict(SMALL, name="large-v2")
    monkeypatch.setitem(JAX_CONFIGS, "large-v2", JaxConfig(**spec))
    monkeypatch.setitem(WHISPER_CONFIGS, "large-v2", WhisperConfig(**spec))
    # JAX's entry turns on its persistent compilation cache: not in a test
    monkeypatch.setenv("WIS_COMPILE_CACHE", "off")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_entry_matches_the_jax_forward(micro_large_v2, monkeypatch):
    import __graft_entry__ as graft
    from wis_tpu_torch.entry import entry

    jax_forward, (jparams, jmel, jprompt) = graft.entry()
    forward, (params, mel, prompt) = entry("cpu")

    assert tuple(mel.shape) == jmel.shape and not bool(mel.any())
    assert np.array_equal(prompt.numpy(), np.asarray(jprompt))
    got_leaves, want_leaves = _leaves(params), _leaves(np_tree(jparams))
    assert set(got_leaves) == set(want_leaves)
    for key, leaf in got_leaves.items():
        assert tuple(leaf.shape) == want_leaves[key].shape, key
    assert params["decoder"]["tok_emb"].dtype == torch.bfloat16

    from wis_tpu.models.whisper.model import DecoderCache

    zeros = DecoderCache.zeros
    monkeypatch.setattr(DecoderCache, "zeros", classmethod(
        lambda cls, cfg, batch, max_len, dtype=None: zeros(cfg, batch, max_len, jnp.float32)))
    f32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    want = np.asarray(jax_forward(f32, jmel, jprompt))
    got = forward(params_from_jax(np_tree(f32), "cpu"), mel, prompt)
    assert got.shape == want.shape == (1, 51865) and got.dtype == torch.float32
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 1e-4, rel
    # the seeded bf16 tree the entry returns runs as it is
    own = forward(params, mel, prompt)
    assert own.shape == (1, 51865) and bool(torch.isfinite(own).all())


@pytest.mark.skipif(torch.cuda.is_available(), reason="asserts the refusal without a card")
def test_entry_without_a_card_raises():
    from wis_tpu_torch.entry import entry

    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
