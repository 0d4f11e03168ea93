"""The port's single-card entry point: ``__graft_entry__.entry``'s
counterpart.

    from wis_tpu_torch.entry import entry
    forward, (params, mel, prompt) = entry()          # on the card
    step_logits = forward(params, mel, prompt)        # (1, 51865) f32

``forward`` is whisper large-v2's flagship step: the encoder (on the card
its LayerNorms and attention run the LayerNorm and packed flash kernels),
the cross-attention K/V, a 64-position cache, the prompt's prefill, its
argmax token and one cached decode step. The weights are seeded random in
bf16; the mel is 30 s of zeros; the cache takes the weights' dtype (bf16,
as ``__graft_entry__``'s). ``__graft_entry__`` also turns on JAX's
persistent compilation cache, which has no counterpart here: nothing is
compiled.
"""

from __future__ import annotations

from wis_tpu_torch.device import DeviceLike


def entry(device: DeviceLike = "cuda"):
    """→ (forward, (params, mel, prompt)) for large-v2 on ``device`` (the
    card unless the CPU is asked for; raises without a card)."""
    import torch

    from wis_tpu_torch.device import resolve_device
    from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS
    from wis_tpu_torch.models.whisper.model import (
        DecoderCache,
        cross_kv,
        decode_step,
        encode,
        prefill,
    )
    from wis_tpu_torch.models.whisper.tokenizer import build_prompt
    from wis_tpu_torch.models.whisper.weights import random_params

    dev = resolve_device(device)
    cfg = WHISPER_CONFIGS["large-v2"]
    params = random_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    mel = torch.zeros((1, cfg.n_mels, 3000), dtype=torch.float32, device=dev)
    prompt = torch.tensor([build_prompt("en", "transcribe")], dtype=torch.int64, device=dev)

    def forward(params, mel, prompt):
        with torch.inference_mode():
            xa = encode(params, mel, cfg)
            xa_kv = cross_kv(params, xa, cfg)
            dtype = params["decoder"]["tok_emb"].dtype
            cache = DecoderCache.zeros(cfg, 1, 64, dtype, mel.device)
            logits, cache = prefill(params, prompt, cache, xa_kv, cfg)
            tok = torch.argmax(logits[:, -1], dim=-1)
            step_logits, cache = decode_step(params, tok, cache, xa_kv, cfg)
        return step_logits

    return forward, (params, mel, prompt)
