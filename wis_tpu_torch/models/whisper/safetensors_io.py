"""A reader of the safetensors format, for HF checkpoints.

The card's machine has no ``safetensors`` package, so the port reads the
format itself. A file is an 8-byte little-endian header length N, N bytes
of JSON ``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` (plus
an optional ``"__metadata__"`` entry of strings), then the raw
little-endian tensor bytes, ``data_offsets`` counted from the end of the
header. The file is memory-mapped copy-on-write: every tensor is a view
of the mapping, the bytes are read once, when a tensor is first touched
(on the card, by its copy to the device), and nothing is written back.
"""

from __future__ import annotations

import json
import math
from typing import Dict

import numpy as np
import torch

#: the dtypes a whisper checkpoint holds → (numpy storage, torch dtype);
#: bf16 travels as its uint16 bit pattern
_DTYPES = {
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),
}


class SafetensorsError(ValueError):
    """A file that is not a well-formed safetensors file of F32, F16 or
    BF16 tensors."""


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as CPU tensors over a
    memory map of the file, in the header's order."""
    mm = np.memmap(path, dtype=np.uint8, mode="c")
    if mm.size < 8:
        raise SafetensorsError(f"{path}: {mm.size} bytes, no header")
    n = int.from_bytes(mm[:8].tobytes(), "little")
    if n > mm.size - 8:
        raise SafetensorsError(f"{path}: header of {n} bytes overruns the file")
    try:
        header = json.loads(mm[8 : 8 + n].tobytes())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SafetensorsError(f"{path}: header is not JSON ({e})") from None
    if not isinstance(header, dict):
        raise SafetensorsError(f"{path}: header is not a JSON object")
    header.pop("__metadata__", None)
    data = mm[8 + n :]
    spans = []
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        try:
            dtype, shape, (begin, end) = info["dtype"], info["shape"], info["data_offsets"]
        except (TypeError, KeyError, ValueError):
            raise SafetensorsError(f"{path}: {name}: malformed entry {info!r}") from None
        if dtype not in _DTYPES:
            raise SafetensorsError(f"{path}: {name}: dtype {dtype} is not F32, F16 or BF16")
        if not (isinstance(shape, list) and all(isinstance(s, int) and s >= 0 for s in shape)):
            raise SafetensorsError(f"{path}: {name}: shape {shape!r}")
        np_dtype, torch_dtype = _DTYPES[dtype]
        count = math.prod(shape)
        if not (0 <= begin <= end <= data.size):
            raise SafetensorsError(
                f"{path}: {name}: offsets [{begin}, {end}) overrun the {data.size} data bytes")
        if end - begin != count * np.dtype(np_dtype).itemsize:
            raise SafetensorsError(
                f"{path}: {name}: {end - begin} bytes for {dtype} {shape}")
        spans.append((begin, end, name))
        raw = data[begin:end]
        if (8 + n + begin) % np.dtype(np_dtype).itemsize:
            raw = raw.copy()  # an unaligned tensor is copied, not viewed
        t = torch.from_numpy(raw.view(np_dtype).reshape(shape))
        out[name] = t.view(torch_dtype) if torch_dtype == torch.bfloat16 else t
    spans.sort()
    for (_, prev_end, prev), (begin, _, name) in zip(spans, spans[1:]):
        if begin < prev_end:
            raise SafetensorsError(f"{path}: {name} overlaps {prev}")
    return out
