"""Whisper tokenizer layout, prompts, text decode and encode and timestamp
segments — ``wis_tpu/models/whisper/tokenizer.py``, carried as a copy.
Loading that file by path would still import ``wis_tpu.languages`` and so
the ``wis_tpu`` package, which the port never loads.

Special-token ids are computed from the public multilingual vocabulary
layout, so prompt construction needs no vocabulary files. Text decode and
encode are GPT-2 byte-level BPE, from HF ``vocab.json`` + ``merges.txt`` or
``tokenizer.json`` when a model directory provides them, else the same
deterministic placeholder vocabulary the JAX package uses. No serving path
encodes text. A CPU test holds the layout, prompts, suppress lists,
placeholder decode and encode, special ids, merges and segment parsing
equal to ``wis_tpu``'s.

Where the JAX package departs from the HF files it reads, the port follows
HF: ``encode`` splits words with GPT-2's own pre-tokenizer
(``_gpt2_words``), where the JAX package's approximation keeps letters,
digits and ``_`` in one word; a CPU test holds ``encode`` equal to HF's
``GPT2Tokenizer``.
"""

from __future__ import annotations

import json
import os
import unicodedata
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

from wis_tpu_torch.languages import LANGUAGES

N_BASE_VOCAB = 50257  # GPT-2 byte-level BPE tokens
EOT = 50257  # <|endoftext|>
SOT = 50258  # <|startoftranscript|>
LANG_BASE = 50259  # <|en|> .. language tokens in registry order

_LANG_CODES = list(LANGUAGES.keys())
_LANG_CODES_V3 = _LANG_CODES + ["yue"]  # Cantonese, added by large-v3
N_TIMESTAMPS = 1501  # <|0.00|> .. <|30.00|> in 20 ms steps


@dataclass(frozen=True)
class VocabLayout:
    """Derived special-token ids for a given language-token count."""

    n_langs: int

    @property
    def eot(self) -> int:
        return EOT

    @property
    def sot(self) -> int:
        return SOT

    @property
    def lang_base(self) -> int:
        return LANG_BASE

    @property
    def translate(self) -> int:
        return LANG_BASE + self.n_langs

    @property
    def transcribe(self) -> int:
        return self.translate + 1

    @property
    def sot_lm(self) -> int:
        return self.translate + 2

    @property
    def sot_prev(self) -> int:
        return self.translate + 3

    @property
    def no_speech(self) -> int:
        return self.translate + 4

    @property
    def no_timestamps(self) -> int:
        return self.translate + 5

    @property
    def timestamp_base(self) -> int:
        return self.translate + 6

    @property
    def n_vocab(self) -> int:
        return self.timestamp_base + N_TIMESTAMPS

    @property
    def lang_codes(self) -> List[str]:
        return _LANG_CODES_V3[: self.n_langs]

    def lang_token(self, code: str) -> int:
        codes = self.lang_codes
        try:
            return LANG_BASE + codes.index(code)
        except ValueError:
            return LANG_BASE + codes.index("en")


V2_LAYOUT = VocabLayout(n_langs=99)
V3_LAYOUT = VocabLayout(n_langs=100)


def layout_for_vocab(n_vocab: int) -> VocabLayout:
    """Map a config's vocabulary size to its special-token layout."""
    if n_vocab == V3_LAYOUT.n_vocab:
        return V3_LAYOUT
    if n_vocab == V2_LAYOUT.n_vocab:
        return V2_LAYOUT
    raise ValueError(f"No known whisper vocab layout of size {n_vocab}")


#: default token-suppression list for multilingual checkpoints (HF
#: generation_config.json `suppress_tokens`)
DEFAULT_SUPPRESS_TOKENS: Tuple[int, ...] = (
    1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60, 61, 62, 63,
    90, 91, 92, 93, 359, 503, 522, 542, 873, 893, 902, 918, 922, 931, 1350,
    1853, 1982, 2460, 2627, 3246, 3253, 3268, 3536, 3846, 3961, 4183, 4667,
    6585, 6647, 7273, 9061, 9383, 10428, 10929, 11938, 12033, 12331, 12562,
    13793, 14157, 14635, 15265, 15618, 16553, 16604, 18362, 18956, 20075,
    21675, 22520, 26130, 26161, 26435, 28279, 29464, 31650, 32302, 32470,
    36865, 42863, 47425, 49870, 50254, 50258, 50358, 50359, 50360, 50361,
    50362,
)
DEFAULT_BEGIN_SUPPRESS: Tuple[int, ...] = (220, EOT)

#: the BPE-symbol half of the default suppress list (ids < EOT are
#: layout-independent; the special-token tail shifts with the layout)
_SUPPRESS_SYMBOLS: Tuple[int, ...] = tuple(
    t for t in DEFAULT_SUPPRESS_TOKENS if t < EOT
)


def default_suppress_tokens(layout: VocabLayout = V2_LAYOUT) -> Tuple[int, ...]:
    """The HF suppress list for a layout: shared symbol ids plus the
    layout's special-token tail."""
    return _SUPPRESS_SYMBOLS + (
        layout.sot,
        layout.translate,
        layout.transcribe,
        layout.sot_lm,
        layout.sot_prev,
        layout.no_speech,
    )


@lru_cache(maxsize=1)
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 byte ↔ printable-unicode bijection (standard algorithm)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def parse_segments(tokenizer: "WhisperTokenizer", ids: Sequence[int]) -> List[dict]:
    """Split a timestamped token stream into segments:
    <|t0|> text <|t1|> [<|t2|> text <|t3|> ...] →
    [{"start": s, "end": e, "text": ...}, ...]."""
    lay = tokenizer.layout
    TIMESTAMP_BASE, N_VOCAB = lay.timestamp_base, lay.n_vocab
    segments: List[dict] = []
    start: float = 0.0
    current: List[int] = []
    for i in ids:
        i = int(i)
        if TIMESTAMP_BASE <= i < N_VOCAB:
            t = (i - TIMESTAMP_BASE) * 0.02
            if current:
                segments.append(
                    {
                        "start": round(start, 2),
                        "end": round(t, 2),
                        "text": tokenizer.decode(current).strip(),
                    }
                )
                current = []
            start = t
        elif i == EOT:
            break
        elif i < EOT:
            current.append(i)
    if current:
        segments.append(
            {
                "start": round(start, 2),
                "end": round(start, 2),
                "text": tokenizer.decode(current).strip(),
            }
        )
    return segments


def build_prompt(
    language: str = "en",
    task: str = "transcribe",
    notimestamps: bool = True,
    layout: VocabLayout = V2_LAYOUT,
) -> List[int]:
    """<|startoftranscript|><|lang|><|task|>[<|notimestamps|>]."""
    lang_tok = layout.lang_token(language)
    task_tok = layout.translate if task == "translate" else layout.transcribe
    ids = [SOT, lang_tok, task_tok]
    if notimestamps:
        ids.append(layout.no_timestamps)
    return ids


#: GPT-2's contractions, the first alternatives of its pre-tokenizer
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
#: C0 separators that ``str.isspace`` counts and Unicode's White_Space
#: (the ``regex`` package's ``\s``, which GPT-2's pattern uses) does not
_NOT_WHITE_SPACE = frozenset("\x1c\x1d\x1e\x1f")


def _char_class(c: str) -> str:
    r""""s" (``\s``), "L" (``\p{L}``), "N" (``\p{N}``) or "o" (the rest)."""
    if c.isspace() and c not in _NOT_WHITE_SPACE:
        return "s"
    major = unicodedata.category(c)[0]
    return major if major in "LN" else "o"


def _gpt2_words(text: str) -> List[str]:
    r"""GPT-2's pre-tokenizer, ``re.findall`` of
    ``'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+``,
    as a scanner over ``unicodedata`` categories: Python's ``re`` has no
    ``\p{…}`` and the ``regex`` package is not a dependency. Characters
    unassigned in this Python's Unicode tables fall in the last class."""
    kinds = [_char_class(c) for c in text]
    n = len(text)
    words: List[str] = []
    i = 0
    while i < n:
        if text[i] == "'":
            c = next((c for c in _CONTRACTIONS if text.startswith(c, i)), None)
            if c:
                words.append(c)
                i += len(c)
                continue
        # one optional leading " " before a run of letters, digits or others
        j = i + 1 if text[i] == " " and i + 1 < n and kinds[i + 1] != "s" else i
        end = j + 1
        if kinds[j] != "s":
            while end < n and kinds[end] == kinds[j]:
                end += 1
        else:
            while end < n and kinds[end] == "s":
                end += 1
            # \s+(?!\S): a run followed by a non-space ends one early
            if end < n and end - i > 1:
                end -= 1
        words.append(text[i:end])
        i = end
    return words


@dataclass
class WhisperTokenizer:
    """Byte-level BPE with the Whisper special-token layout."""

    vocab: Optional[Dict[str, int]] = None  # token string -> id
    merges: Optional[Dict[Tuple[str, str], int]] = None  # pair -> rank
    suppress_tokens: Tuple[int, ...] = DEFAULT_SUPPRESS_TOKENS
    begin_suppress_tokens: Tuple[int, ...] = DEFAULT_BEGIN_SUPPRESS
    layout: VocabLayout = V2_LAYOUT
    _id_to_token: Dict[int, str] = field(default_factory=dict)

    def __post_init__(self):
        if self.vocab:
            self._id_to_token = {v: k for k, v in self.vocab.items()}
        if (
            self.layout is not V2_LAYOUT
            and self.suppress_tokens == DEFAULT_SUPPRESS_TOKENS
        ):
            self.suppress_tokens = default_suppress_tokens(self.layout)

    @classmethod
    def from_dir(
        cls, model_dir: str, layout: VocabLayout = V2_LAYOUT
    ) -> "WhisperTokenizer":
        """Load the vocabulary and merges (tokenizer.json, or vocab.json +
        merges.txt) and the generation config's suppress lists from an HF
        model directory; fall back to the placeholder vocab."""
        vocab = merges = None
        tok_json = os.path.join(model_dir, "tokenizer.json")
        vocab_json = os.path.join(model_dir, "vocab.json")
        merges_txt = os.path.join(model_dir, "merges.txt")
        if os.path.isfile(tok_json):
            with open(tok_json, encoding="utf-8") as f:
                model = json.load(f)["model"]
            vocab = model["vocab"]
            # each merge an "a b" string or, in newer files, an ["a", "b"] list
            merges = {tuple(m.split(" ")) if isinstance(m, str) else tuple(m): i
                      for i, m in enumerate(model["merges"])}
        elif os.path.isfile(vocab_json):
            with open(vocab_json, encoding="utf-8") as f:
                vocab = json.load(f)
            if os.path.isfile(merges_txt):
                merges = {}
                with open(merges_txt, encoding="utf-8") as f:
                    for line in f:
                        line = line.strip()
                        if line and not line.startswith("#version"):
                            merges[tuple(line.split(" "))] = len(merges)
        suppress = DEFAULT_SUPPRESS_TOKENS
        begin_suppress = DEFAULT_BEGIN_SUPPRESS
        gen_cfg = os.path.join(model_dir, "generation_config.json")
        if os.path.isfile(gen_cfg):
            with open(gen_cfg, encoding="utf-8") as f:
                g = json.load(f)
            suppress = tuple(g.get("suppress_tokens") or suppress)
            begin_suppress = tuple(
                g.get("begin_suppress_tokens") or begin_suppress
            )
        return cls(
            vocab=vocab,
            merges=merges,
            suppress_tokens=suppress,
            begin_suppress_tokens=begin_suppress,
            layout=layout,
        )

    @property
    def all_special_ids(self) -> frozenset:
        """Every id >= EOT (specials + timestamps) — the set the long-form
        LCS merge filters out."""
        return frozenset(range(EOT, self.layout.n_vocab))

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        toks: List[str] = []
        for i in ids:
            i = int(i)
            if i >= EOT:
                if not skip_special:
                    toks.append(self._special_str(i))
                continue
            toks.append(self._token_str(i))
        text = "".join(toks)
        byte_dec = {c: b for b, c in _bytes_to_unicode().items()}
        raw = bytes(byte_dec.get(ch, ord(" ")) for ch in text)
        return raw.decode("utf-8", errors="replace")

    def _token_str(self, i: int) -> str:
        if self._id_to_token:
            return self._id_to_token.get(i, "")
        # placeholder vocab: stable, reversible-ish rendering
        return f"Ġt{i}" if i % 7 == 0 else f"t{i}"

    def _special_str(self, i: int) -> str:
        lay = self.layout
        if i == EOT:
            return "<|endoftext|>"
        if i == SOT:
            return "<|startoftranscript|>"
        if LANG_BASE <= i < LANG_BASE + lay.n_langs:
            return f"<|{lay.lang_codes[i - LANG_BASE]}|>"
        if i == lay.translate:
            return "<|translate|>"
        if i == lay.transcribe:
            return "<|transcribe|>"
        if i == lay.no_timestamps:
            return "<|notimestamps|>"
        if i >= lay.timestamp_base:
            return f"<|{(i - lay.timestamp_base) * 0.02:.2f}|>"
        return f"<|{i}|>"

    def encode(self, text: str) -> List[int]:
        """Text → BPE ids (no special tokens), HF ``GPT2Tokenizer``'s
        ``encode(text, add_special_tokens=False)`` on the same files; a
        piece missing from the vocabulary is 0. Without a vocabulary, the
        placeholder: each UTF-8 byte offset into the base vocabulary."""
        if not self.vocab:
            return [min(b + 320, N_BASE_VOCAB - 1) for b in text.encode("utf-8")]
        b2u = _bytes_to_unicode()
        ids: List[int] = []
        for word in _gpt2_words(text):
            mapped = "".join(b2u[b] for b in word.encode("utf-8"))
            ids.extend(self.vocab.get(piece, 0) for piece in self._bpe(mapped))
        return ids

    def _bpe(self, token: str) -> List[str]:
        """``wis_tpu``'s merge loop: join the leftmost of the lowest-ranked
        pairs until no pair has a rank. On a trained merge list (each
        merge's halves ranked before it) this is GPT-2's loop, which joins
        every occurrence of that pair in one pass."""
        if self.merges is None:
            return [token]
        parts = list(token)
        while len(parts) > 1:
            pairs = [(parts[i], parts[i + 1]) for i in range(len(parts) - 1)]
            ranked = [
                (self.merges.get(p, float("inf")), i) for i, p in enumerate(pairs)
            ]
            best_rank, best_i = min(ranked)
            if best_rank == float("inf"):
                break
            parts = (
                parts[:best_i]
                + [parts[best_i] + parts[best_i + 1]]
                + parts[best_i + 2 :]
            )
        return parts
