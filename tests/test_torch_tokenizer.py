"""The encode half of the port's Whisper tokenizer
(``wis_tpu_torch/models/whisper/tokenizer.py``) on the CPU:

- against ``wis_tpu``'s: ``encode`` on ``tests/test_tokenizer.py``'s
  vocabulary and merges and on the placeholder vocabulary, and the merges
  ``from_dir`` reads from both forms of ``tokenizer.json`` and from
  ``merges.txt``;
- against HF's slow ``GPT2Tokenizer`` (offline, on a written ``vocab.json``
  and ``merges.txt`` learnt from a small corpus): the ids on hypothesis
  text of ASCII and non-ASCII letters and numbers, ``_``, contractions,
  punctuation and runs of spaces and newlines; ``wis_tpu``'s ids wherever
  its word split agrees with GPT-2's;
- the departure from ``wis_tpu``, pinned: GPT-2 splits letters, digits and
  ``_`` that ``wis_tpu`` keeps in one word;
- ``chip_smoke.py``'s pinned ids, against HF's on the files it writes;
- the one class the port cannot match with ``unicodedata``: characters that
  this Python's Unicode tables leave unassigned.
"""

import collections
import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from wis_tpu.models.whisper import tokenizer as jt
from wis_tpu_torch.models.whisper import tokenizer as tt

GPT2_PATTERN = (r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"""
                r"""|\s+(?!\S)|\s+""")

#: the corpus the test vocabulary's merges are learnt from
CORPUS = (
    "The quick brown fox's friends weren't there; they'd gone, we'll see. "
    "I'm sure you've 3 or 42 apples, 3.5 kg at 12:30 — café, Straße, naïve "
    "Æsop, 日本語 三四 ² ½ Ⅻ foo_bar snake_case __init__ abc123 x2 "
    "Hello  world!!  ...  (ok) [yes] \"quote\" well-known e-mail 100% 7/8\n\n"
    "  indented\tline\n\n\nthe end."
)
N_MERGES = 160

#: hypothesis text: the classes GPT-2's pattern tells apart, and pieces the
#: corpus has merges for
PIECES = list("abcXYZ019_'.,!?-é ßÆ²½三日Ⅻ\t\n　\xa0\x1ć") + [
    "'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "  ", "   ", "\n\n", "the", " the",
    "foo", "_bar", "123", "3.5", "café", "Straße", "日本語", "world", "'S",
]


def _learn_merges(corpus, n):
    """A byte-level BPE learnt greedily from ``corpus`` (the most frequent
    pair first, ties to the smaller pair): every merge's halves exist when
    it is learnt, as in a trained vocabulary."""
    b2u = tt._bytes_to_unicode()
    words = collections.Counter(
        tuple(b2u[b] for b in w.encode("utf-8")) for w in tt._gpt2_words(corpus))
    merges = []
    for _ in range(n):
        pairs = collections.Counter()
        for w, c in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        merges.append(best)
        joined = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if w[i:i + 2] == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            joined[tuple(out)] += c
        words = joined
    return merges


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """vocab.json (the 256 byte symbols in GPT-2's order, then each merge's
    result, then <|endoftext|>) and merges.txt."""
    d = tmp_path_factory.mktemp("gpt2")
    vocab = {s: i for i, s in enumerate(tt._bytes_to_unicode().values())}
    merges = _learn_merges(CORPUS, N_MERGES)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges), encoding="utf-8")
    return d, vocab, merges


@pytest.fixture(scope="module")
def three(files):
    from transformers import GPT2Tokenizer

    d = files[0]
    hf = GPT2Tokenizer(str(d / "vocab.json"), str(d / "merges.txt"))
    return tt.WhisperTokenizer.from_dir(str(d)), jt.WhisperTokenizer.from_dir(str(d)), hf


def test_encode_equals_wis_tpu_on_its_vocabulary(tmp_path):
    """``tests/test_tokenizer.py``'s vocabulary and merges, and the
    placeholder vocabulary."""
    (tmp_path / "vocab.json").write_text(json.dumps({"h": 0, "i": 1, "hi": 2, "Ġ": 3, "Ġhi": 4}))
    (tmp_path / "merges.txt").write_text("#version: 0.2\nh i\nĠ hi")
    port, ref = tt.WhisperTokenizer.from_dir(str(tmp_path)), jt.WhisperTokenizer.from_dir(
        str(tmp_path))
    for text in ("hi hi", "hi", "", "hih  hi", "ih hi!"):
        assert port.encode(text) == ref.encode(text)
    assert port.encode("hi hi") == [2, 4]
    assert port.decode(port.encode("hi hi")) == "hi hi"
    for text in ("hello world", "", "café ½ 日本", "\x00\xff"):
        assert tt.WhisperTokenizer().encode(text) == jt.WhisperTokenizer().encode(text)
    assert tt.N_BASE_VOCAB == jt.N_BASE_VOCAB == 50257
    assert tt.WhisperTokenizer().encode("é") == [0xC3 + 320, 0xA9 + 320]


@pytest.mark.parametrize("form", ["strings", "lists", "merges.txt"])
def test_from_dir_reads_merges_as_wis_tpu(tmp_path, form):
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("Ġ", "w")]
    vocab = {"h": 0, "e": 1, "l": 2, "he": 3, "ll": 4, "hell": 5, "Ġ": 6, "w": 7, "Ġw": 8}
    if form == "merges.txt":
        (tmp_path / "vocab.json").write_text(json.dumps(vocab))
        (tmp_path / "merges.txt").write_text(
            "#version: 0.2\n\n" + "\n".join(" ".join(m) for m in merges) + "\n\n")
    else:
        listed = [" ".join(m) if form == "strings" else list(m) for m in merges]
        (tmp_path / "tokenizer.json").write_text(
            json.dumps({"model": {"type": "BPE", "vocab": vocab, "merges": listed}}))
    port, ref = tt.WhisperTokenizer.from_dir(str(tmp_path)), jt.WhisperTokenizer.from_dir(
        str(tmp_path))
    assert port.merges == ref.merges == {m: i for i, m in enumerate(merges)}
    assert port.vocab == ref.vocab == vocab
    assert port.encode("hell w") == ref.encode("hell w") == [5, 8]


def test_the_word_split_follows_gpt2(files):
    """``wis_tpu``'s split keeps letters, digits and ``_`` in one word
    (``?\\w+``); GPT-2's, and the port's, split them. On a vocabulary whose
    merges are ``c 1`` and ``o _``, HF's ids are the port's and not
    ``wis_tpu``'s."""
    from transformers import GPT2Tokenizer

    d = files[0].parent / "split"
    d.mkdir()
    vocab = {s: i for i, s in enumerate(tt._bytes_to_unicode().values())}
    vocab.update({"c1": 256, "o_": 257, "<|endoftext|>": 258})
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\nc 1\no _\n")
    text = "abc123 foo_bar"
    hf = GPT2Tokenizer(str(d / "vocab.json"), str(d / "merges.txt"))
    want = [64, 65, 66, 16, 17, 18, 220, 69, 78, 78, 62, 65, 64, 81]
    assert hf.encode(text, add_special_tokens=False) == want
    assert tt.WhisperTokenizer.from_dir(str(d)).encode(text) == want
    assert jt.WhisperTokenizer.from_dir(str(d)).encode(text) == [
        64, 65, 256, 17, 18, 220, 69, 78, 257, 65, 64, 81]
    assert tt._gpt2_words(text) == ["abc", "123", " foo", "_", "bar"]


@settings(max_examples=300, deadline=None, database=None)
@given(st.lists(st.sampled_from(PIECES), max_size=24).map("".join))
def test_encode_equals_gpt2_tokenizer(three, text):
    """The ids equal HF ``GPT2Tokenizer``'s, the words ``regex``'s
    ``findall`` of GPT-2's pattern; where ``wis_tpu``'s split agrees, its
    ids too."""
    import regex

    port, ref, hf = three
    words = tt._gpt2_words(text)
    assert words == regex.findall(GPT2_PATTERN, text)
    ids = port.encode(text)
    assert ids == hf.encode(text, add_special_tokens=False)
    if jt._gpt2_words(text) == words:
        assert ids == ref.encode(text)
    assert port.decode(ids) == text


def test_the_corpus_round_trips_with_merges(three):
    """The learnt merges are used: the corpus encodes to fewer ids than
    it has bytes, equal to HF's."""
    port, _, hf = three
    ids = port.encode(CORPUS)
    assert ids == hf.encode(CORPUS, add_special_tokens=False)
    assert len(ids) < len(CORPUS.encode("utf-8")) // 2
    assert port.decode(ids) == CORPUS


def test_unassigned_characters_fall_in_the_last_class():
    """What ``unicodedata`` cannot match: a character that this Python's
    Unicode tables leave unassigned (U+105C0, a Todhri letter since Unicode
    16.0) is neither letter nor number to the port, so it splits a word
    that ``regex`` built on newer tables keeps whole. Assigned characters
    and the white-space class agree with ``regex`` everywhere."""
    import unicodedata

    import regex

    c = "\U000105c0"
    assert unicodedata.category(c) == "Cn"
    assert tt._gpt2_words(f"a{c}b") == ["a", c, "b"]
    if regex.match(r"\p{L}", c):
        assert regex.findall(GPT2_PATTERN, f"a{c}b") == [f"a{c}b"]
    classes = {"L": regex.compile(r"\p{L}"), "N": regex.compile(r"\p{N}"),
               "s": regex.compile(r"\s")}
    for cp in list(range(0x3400)) + list(range(0xfe00, 0x10000)) + [0x1d7ce, 0x1f600]:
        ch = chr(cp)
        if 0xD800 <= cp <= 0xDFFF or unicodedata.category(ch) == "Cn":
            continue
        kind = tt._char_class(ch)
        for k, pat in classes.items():
            assert (kind == k) == bool(pat.match(ch)), (hex(cp), k)


def test_chip_smoke_tokenizer_ids_are_gpt2_tokenizers(tmp_path):
    """The ids ``chip_smoke.py``'s tokenizer check holds the port to are
    HF ``GPT2Tokenizer``'s on the files it writes, and the port's."""
    from transformers import GPT2Tokenizer

    import chip_smoke

    chip_smoke.write_tokenizer_files(str(tmp_path))
    hf = GPT2Tokenizer(str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))
    want = hf.encode(chip_smoke.TOKENIZER_TEXT, add_special_tokens=False)
    assert chip_smoke.TOKENIZER_IDS == want
    assert tt.WhisperTokenizer.from_dir(str(tmp_path)).encode(chip_smoke.TOKENIZER_TEXT) == want
