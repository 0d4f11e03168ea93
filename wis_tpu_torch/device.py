"""Device policy.

The card is asked for explicitly: ``resolve_device("cuda")`` without a
CUDA device raises instead of running on the CPU. Resolving a CUDA device
also pins the float32 numerics the JAX reference uses: full-precision
float32 matmuls and convolutions (cuDNN convolutions default to TF32,
which keeps about three decimal digits and would destroy the log-mel
floor, ``audio/mel.py``), and bf16 matmuls reduced in f32 throughout, as
the JAX package's ``preferred_element_type=float32`` dots are.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``"cpu"``, ``"cuda"`` or ``"cuda:N"`` → a checked torch.device."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available"
        )
    index = 0 if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {device!r} requested but only "
            f"{torch.cuda.device_count()} CUDA device(s) are visible"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs keep f32 accumulation through cuBLAS's split-K reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda", index)


def card_info(index: int = 0) -> dict:
    """{"name", "power_limit"} of CUDA device ``index`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` reads them (a card
    may be set below its maximum power, and then runs slower under load, so
    every time measured on it is reported beside its limit). Without
    ``nvidia-smi`` the name is torch's and the limit None."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        name, limit = (part.strip() for part in out.rsplit(",", 1))
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {"name": torch.cuda.get_device_name(index), "power_limit": None}
