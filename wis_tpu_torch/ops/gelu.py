"""Near-exact gelu without erf (port of ``wis_tpu/ops/gelu.py``).

The JAX package's 7th-order odd polynomial inside tanh, least-squares fit
of exact gelu on [0, 6] with exact tails beyond ±6:

    gelu(x) ≈ 0.5·x·(1 + tanh(x·(c1 + x²·(c3 + x²·(c5 + x²·c7)))))

max |err| vs erf gelu is 1.3e-5. Carried as this polynomial (not
``F.gelu``) so the port rounds the way the reference does.

``gelu_tanh`` is ``jax.nn.gelu(approximate=True)`` itself, the formula the
fused decode steps and the XTTS GPT use.
"""

from __future__ import annotations

import numpy as np
import torch

C1 = 7.97674780e-01
C3 = 3.67492532e-02
C5 = -2.60437574e-04
C7 = -8.21175498e-06


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-tails tanh-form gelu; float32 internal math, x.dtype out."""
    x32 = x.float()
    xc = torch.clamp(x32, -6.0, 6.0)
    u = xc * xc
    p = xc * (C1 + u * (C3 + u * (C5 + u * C7)))
    y = 0.5 * x32 * (1.0 + torch.tanh(p))
    y = torch.where(x32 > 6.0, x32, y)
    y = torch.where(x32 < -6.0, torch.zeros((), dtype=torch.float32, device=x.device), y)
    return y.to(x.dtype)


#: jax.nn.gelu(approximate=True)'s constant, sqrt(2/pi) in f32
_GELU_C = float(np.float32(np.sqrt(2 / np.pi)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``: the tanh formula, in its order
    of operations, in x.dtype."""
    cdf = 0.5 * (1.0 + torch.tanh(_GELU_C * (x + 0.044715 * (x * x * x))))
    return x * cdf
