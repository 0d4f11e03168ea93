"""The omni cell's yardstick arithmetic: the grouped expert kernel's least
time and the model FLOPs of an omni dispatch, from shapes and the
program's routing counters (``work.py``'s peaks and rules).

The grouped kernel's least time (``moe_experts_ms``) is frozen from
``chip_smoke.moe_bound``: the touched experts' weights read once (gate,
up and down, bf16) with each routed row's token read (bf16) and its output
row written (float32) at the HBM rate, or 6·d·f operations a routed row at
the bf16 peak, the larger.
"""

from __future__ import annotations

from typing import Dict

from benchmark.work import least_ms, whisper_encoder_flops


def moe_experts_ms(*, touched: int, rows: int, d: int, f: int) -> float:
    return least_ms(touched * 3 * d * f * 2 + rows * d * (2 + 4), rows * 6 * d * f)


def token_flops(cfg: Dict, pos: float, logits: bool) -> float:
    """One token at cache position ``pos`` through every layer, the routed
    experts left out (they are counted by their rows): q/k/v and o, the
    attention over ``pos + 1`` keys, the router, the fixed experts; and the
    head when asked."""
    d, dh = cfg["hidden_size"], cfg["head_dim"]
    q, kv = cfg["num_attention_heads"] * dh, cfg["num_key_value_heads"] * dh
    slots = cfg["mlp_dynamic_expert_num"] + cfg["mlp_dynamic_null_expert_num"]
    fixed = cfg["mlp_fixed_expert_num"] * cfg["shared_intermediate_size"]
    per_layer = (2 * d * (q + 2 * kv) + 2 * q * d + 4 * q * (pos + 1) + 2 * d * slots
                 + 6 * d * fixed)
    return cfg["num_hidden_layers"] * per_layer + (2 * d * cfg["vocab_size"] if logits else 0)


def dispatch_flops(cfg: Dict, rows: int, counts: Dict[str, int]) -> float:
    """An omni dispatch's useful FLOPs (padding rows and ended rows left
    out): each real row's encoder window and connector, its prompt's
    positions with the head at the last, each decode token with the head,
    and 6·d·f for every routed expert row. Decode tokens are placed at the
    mean position of their row's reply."""
    e = cfg["audio_encoder"]
    p_len = (len(cfg["generation"]["prompt_head"]) + cfg["whisper_query_tokens_size"]
             + len(cfg["generation"]["prompt_tail"]))
    layers = cfg["num_hidden_layers"]
    decode = (counts.get("moe.tokens", 0) - counts.get("moe.prefill_tokens", 0)) / layers
    total = rows * (whisper_encoder_flops(d=e["d_model"], layers=e["encoder_layers"],
                                          n_mels=e["num_mel_bins"])
                    + 2 * cfg["whisper_query_tokens_size"] * e["d_model"] * cfg["hidden_size"])
    total += rows * sum(token_flops(cfg, p, p == p_len - 1) for p in range(p_len))
    if decode > 0:
        total += decode * token_flops(cfg, p_len + decode / (2 * max(rows, 1)), True)
    total += counts.get("moe.expert_rows", 0) * 6 * cfg["hidden_size"] * cfg[
        "dynamic_intermediate_size"]
    return total
