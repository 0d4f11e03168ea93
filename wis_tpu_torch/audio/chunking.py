"""Long-form audio chunking + token-sequence merging — a copy of
``wis_tpu/audio/chunking.py`` (the port never loads the ``wis_tpu``
package; a CPU test holds the two equal).

The reference scales past the 30 s model context by splitting audio into
22 s chunks with 4 s overlap strides, transcribing each, and merging the
token sequences by longest-common-subsequence alignment over the overlaps
(reference wis/audio.py:106-159 — itself HF's ASR-chunking algorithm).
The chunk batch becomes the leading dim of one ASR program call (see
wis_tpu_torch.runtime.engine).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

from wis_tpu_torch.audio.mel import SAMPLE_RATE

CHUNK_LENGTH_S = 22  # effective seconds per chunk
STRIDE_LENGTH_S = (4, 4)  # (left, right) overlap seconds
assert CHUNK_LENGTH_S + sum(STRIDE_LENGTH_S) == 30

CHUNK_LEN = CHUNK_LENGTH_S * SAMPLE_RATE
STRIDE_LEFT = STRIDE_LENGTH_S[0] * SAMPLE_RATE
STRIDE_RIGHT = STRIDE_LENGTH_S[1] * SAMPLE_RATE

#: stride record: (chunk_samples, left_overlap_samples, right_overlap_samples)
Stride = Tuple[int, int, int]


def chunk_iter(audio: np.ndarray) -> Iterator[Tuple[np.ndarray, Stride]]:
    """Yield (chunk, stride) windows over a 1-D 16 kHz signal (reference
    wis/audio.py:119-135)."""
    n = audio.shape[0]
    step = CHUNK_LEN - STRIDE_LEFT - STRIDE_RIGHT
    for start in range(0, n, step):
        chunk = audio[start : start + CHUNK_LEN]
        left = 0 if start == 0 else STRIDE_LEFT
        is_last = start + step + STRIDE_LEFT >= n
        right = 0 if is_last else STRIDE_RIGHT
        if chunk.shape[0] > left:
            yield chunk, (chunk.shape[0], left, right)


def num_chunks(n_samples: int) -> int:
    """Static chunk count for a given sample length (used by the engine to
    pick a batch bucket before featurization)."""
    return sum(1 for _ in chunk_iter(np.empty(n_samples, dtype=np.float32)))


def find_longest_common_sequence(
    sequences: Sequence[Tuple[Sequence[int], Stride]],
    special_ids: frozenset,
) -> np.ndarray:
    """Merge per-chunk token sequences by greedy suffix/prefix alignment
    (reference wis/audio.py:139-159). ``special_ids`` replaces the
    reference's tokenizer object — only ``all_special_ids`` was used."""
    merged: List[int] = [t for t in sequences[0][0] if t not in special_ids]
    for new_seq, _stride in sequences[1:]:
        new_tokens = [t for t in new_seq if t not in special_ids]
        index = 0
        best = 0.0
        # cap the alignment window at len(merged): the reference crashes
        # with a broadcast error when a chunk yields more tokens than the
        # whole merge so far (e.g. a near-empty first chunk)
        for i in range(1, min(len(merged), len(new_tokens)) + 1):
            eps = i / 10000.0  # favor longer perfect matches
            matches = np.sum(
                np.array(merged[-i:]) == np.array(new_tokens[:i])
            )
            score = matches / i + eps
            if matches > 1 and score > best:
                index = i
                best = score
        merged.extend(new_tokens[index:])
    return np.array(merged)
