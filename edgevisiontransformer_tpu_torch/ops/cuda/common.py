"""Shared helpers for the encoder kernels (port of the numerics half of
``edgevisiontransformer_tpu/ops/pallas/common.py``)."""

from __future__ import annotations

import torch


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Max-free softmax clamp: normalisation is deferred past the PV product, so
# the row-max subtract is redundant and exp2(min(s, 60)) is the overflow
# guard.  2^60 keeps even a row of a few hundred clamped keys far below the
# fp32 maximum in both the row sum and the PV accumulator.
SOFTMAX_CLAMP = 60.0


def softmax_unnorm(s: torch.Tensor, dtype: torch.dtype, *, nomax: bool = True,
                   clamp: float = SOFTMAX_CLAMP):
    """Unnormalised exp2 probabilities ``p`` (fp32) and row sums ``r`` of the
    log2-scaled scores ``s``; the caller divides after the PV product.

    The max-free path serves bf16 / fp32 and floors ``r`` at 1e-30, so a
    row whose keys are all masked (scores near -1e30) gives zeros.  float16
    takes the row-max subtract instead, because ``p`` would overflow its
    range when cast; that branch has no floor (a fully masked row there
    gives uniform weights, as in the reference).
    """
    if nomax and dtype != torch.float16:
        p = torch.exp2(torch.clamp(s, max=clamp))
        r = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    else:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
        r = p.sum(dim=-1, keepdim=True)
    return p, r
