"""LayerNorm over the last axis of any shape (port of
``edgevisiontransformer_tpu/ops/pallas/layernorm.py``, K15 ``layer_norm``).

K15 computes two-pass fp32 statistics (the mean, then the mean of squared
deviations), ``rsqrt(var + eps) * g + b`` in fp32 and one cast to the input
dtype, over row tiles.  csrc/ln_rows.cu computes exactly that, so
:func:`layer_norm` reshapes to rows and launches ``ln_rows`` once: no new
kernel, and the launch counts under ``fused_encoder.LAUNCHES["ln_rows"]``.
"""

from __future__ import annotations

import torch

from .fused_encoder import ln_rows, ln_rows_plain


def layer_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """:func:`layer_norm` through ``ln_rows``' plain twin, on any device."""
    dim = x.shape[-1]
    return ln_rows_plain(x.reshape(-1, dim), gamma, beta, eps).reshape(x.shape)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm of ``x [..., dim]`` with the affine ``gamma``, ``beta``
    ``[dim]``: one ``ln_rows`` launch on a CUDA tensor (bf16 or fp16 ``x``,
    an affine of its dtype or fp32, ``dim`` a multiple of 8), its twin on a
    CPU tensor."""
    dim = x.shape[-1]
    return ln_rows(x.reshape(-1, dim), gamma, beta, eps).reshape(x.shape)
