"""Uni-MoE-2.0-Omni's speech-to-text path: its configuration.

The published model (HIT-TMG/Uni-MoE-2.0-Omni, ``config.json``,
``model_type`` ``grin_qwen2_vl``) is an omni model; the port holds the part
that turns speech into text: the Whisper-large audio tower, a linear
connector of ``whisper_query_tokens_size`` tokens, and the 28-layer Qwen2
decoder whose every feed-forward is a mixture of 2 fixed (shared) experts,
4 dynamic experts and 1 null expert under top-p routing. The vision tower,
the speech generator and the image generator are not held.

What ``config.json`` does not fix is chosen here (assumed): the audio
tower is large-v3's (128 mel bins), the connector pools the 1500 encoder frames to 200 tokens by
``adaptive_avg_pool1d`` before its linear layer, every token takes one
position in all three M-RoPE sections, the router's 5 outputs are the 4
dynamic experts then the null one, the dynamic experts' weights are the
router's probabilities without renormalisation, q/k/v carry biases (Qwen2)
and the prompt frames the audio with 16 text tokens before and 8 after
(drawn once from a seed; no tokenizer files are held).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Tuple

from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS, WhisperConfig

#: the served model's name (``ASRRequest.model``)
OMNI_NAME = "uni-moe-2.0-omni"

#: the prompt's text tokens around the audio (assumed framing), drawn once
#: with ``numpy.random.default_rng(2100).integers(0, 151643, 16)`` and 8
PROMPT_HEAD = (150932, 45346, 124352, 143886, 96890, 40420, 17055, 85293,
               40045, 6164, 100612, 54980, 40574, 47122, 20617, 3327)
PROMPT_TAIL = (54665, 34499, 113667, 67749, 116871, 77225, 87382, 30375)


@dataclass(frozen=True)
class OmniConfig:
    name: str = OMNI_NAME
    hidden_size: int = 3584
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    head_dim: int = 128
    vocab_size: int = 152064
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    mlp_fixed_expert_num: int = 2
    shared_intermediate_size: int = 2368
    mlp_dynamic_expert_num: int = 4
    dynamic_intermediate_size: int = 18944
    mlp_dynamic_null_expert_num: int = 1
    mlp_dynamic_top_p: float = 0.7
    mlp_dynamic_top_k: int = 2
    whisper_hidden_size: int = 1280
    whisper_query_tokens_size: int = 200
    #: the audio tower (assumed: large-v3's layout, 128 mel bins)
    encoder: WhisperConfig = field(default_factory=lambda: WHISPER_CONFIGS["large-v3"])
    prompt_head: Tuple[int, ...] = PROMPT_HEAD
    prompt_tail: Tuple[int, ...] = PROMPT_TAIL
    #: ``<|im_end|>``
    eos_token_id: int = 151645
    #: the reply's length when a request gives no cap
    max_new_tokens: int = 128

    @property
    def router_slots(self) -> int:
        """The router's outputs: the dynamic experts, then the null ones."""
        return self.mlp_dynamic_expert_num + self.mlp_dynamic_null_expert_num

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_head) + self.whisper_query_tokens_size + len(self.prompt_tail)

    def param_count(self) -> int:
        """Parameters held: the audio tower, the connector, the decoder and
        its untied head."""
        d, f, fs = self.hidden_size, self.dynamic_intermediate_size, self.shared_intermediate_size
        kv = self.num_key_value_heads * self.head_dim
        attn = d * (d + 2 * kv) + (d + 2 * kv) + d * d
        moe = (self.mlp_dynamic_expert_num * 3 * d * f + self.mlp_fixed_expert_num * 3 * d * fs
               + self.router_slots * d)
        layer = attn + moe + 2 * d
        e, ed = self.encoder, self.encoder.n_audio_state
        enc = (e.n_audio_layer * (12 * ed * ed + 12 * ed) + 3 * e.n_mels * ed + 3 * ed * ed
               + e.n_audio_ctx * ed + 4 * ed)
        conn = self.whisper_hidden_size * d + d
        return enc + conn + self.num_hidden_layers * layer + 2 * self.vocab_size * d + d

    def hbm_bytes(self, bytes_per_param: int = 2) -> int:
        return self.param_count() * bytes_per_param

    def kv_bytes_per_token(self, bytes_per_elem: int = 2) -> int:
        kv = self.num_key_value_heads * self.head_dim
        return 2 * self.num_hidden_layers * kv * bytes_per_elem


OMNI_CONFIGS = {OMNI_NAME: OmniConfig()}


def is_omni(name: str) -> bool:
    return (name or "").strip().lower() in OMNI_CONFIGS


def omni_config(name: str = OMNI_NAME, **overrides) -> OmniConfig:
    """The named configuration, with any field replaced (tests shrink it)."""
    cfg = OMNI_CONFIGS[(name or "").strip().lower()]
    return replace(cfg, **overrides) if overrides else cfg
