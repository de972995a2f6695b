"""GELU as the encoder kernels compute it (port of
``edgevisiontransformer_tpu/ops/pallas/mathlib.gelu_kernel``).

The TPU kernel computes exact GELU through a polynomial erf because Mosaic
has no erf; CUDA has ``erff``, so the port uses the true erf (the two differ
by at most 7.2e-7 in erf).  Both forms evaluate in fp32 and cast once.
"""

from __future__ import annotations

import math

import torch

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu_kernel(x: torch.Tensor, approx: bool) -> torch.Tensor:
    """GELU in fp32, cast back to ``x.dtype``: the tanh form when ``approx``,
    else ``0.5 x (1 + erf(x / sqrt 2))``."""
    xf = x.float()
    if approx:
        y = xf * (0.5 * (1.0 + torch.tanh(
            _SQRT_2_OVER_PI * (xf + 0.044715 * (xf * xf * xf)))))
    else:
        y = 0.5 * xf * (1.0 + torch.erf(xf * 0.7071067811865476))
    return y.to(x.dtype)
