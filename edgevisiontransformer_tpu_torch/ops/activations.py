"""Activation functions (port of ``edgevisiontransformer_tpu/ops/activations.py``).

Written out as the same formulas as ``jax.nn.gelu`` so the two packages
round alike: the tanh form is ``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x +
0.044715 x^3)))``, the exact form ``x * (erf(x / sqrt 2) + 1) / 2``.
"""

from __future__ import annotations

import math

import torch

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximated GELU (the TF reference's form)."""
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * (x ** 3))))
    return x * cdf


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return x * (torch.erf(x / math.sqrt(2.0)) + 1) / 2


def get_gelu(approx: bool):
    return gelu_tanh if approx else gelu_exact


def get_act(cfg):
    """Config-selected MLP activation: ReLU for GeLU2ReLU-compiled models,
    else the configured GELU."""
    if getattr(cfg, "act", "gelu") == "relu":
        return torch.relu
    return get_gelu(cfg.gelu_approx)
