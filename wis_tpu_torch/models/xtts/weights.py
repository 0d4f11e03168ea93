"""XTTS parameters for the port (the GPT and HiFi-GAN trees).

Both trees keep the JAX package's layout — no transposes: the GPT's
stacked blocks with (in, out) matmul weights and int8 ``{q, s}`` leaves,
the vocoder's "HIO" convolution weights and its lists of upsample stages
and resblocks (``hifigan.py`` converts the convolution layouts at each
call). ``params_from_jax(tree, device)`` bridges a tree the JAX package
built, given as numpy arrays, leaf for leaf and bit for bit (bf16 bit
patterns and int8 leaves included); lists stay lists. Seeded random
weights come from ``gpt.random_gpt`` and ``hifigan.random_hifigan``, which
repeat the JAX package's numpy draws.
"""

from __future__ import annotations

from wis_tpu_torch.device import DeviceLike
from wis_tpu_torch.models.whisper.weights import _leaf_from_numpy


def params_from_jax(tree, device: DeviceLike):
    """A JAX-layout XTTS tree of numpy arrays (dicts and lists) → the same
    tree of torch tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return _leaf_from_numpy(tree, device)
