"""LayerNorm, MLP and patch embedding as plain tensor functions (port of
``edgevisiontransformer_tpu/ops/layers.py``).

Weights keep the JAX layout: a dense kernel is ``[in, out]`` and applied as
``x @ w``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics, whatever the
    compute dtype: mean, then the mean of squared deviations."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def mlp_block(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: Optional[torch.Tensor],
    w2: torch.Tensor,
    b2: Optional[torch.Tensor],
    act: Callable[[torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """Dense(hidden, act) -> Dense(out)."""
    h = x @ w1
    if b1 is not None:
        h = h + b1
    h = act(h)
    y = h @ w2
    if b2 is not None:
        y = y + b2
    return y


def patch_embed(img: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                patch_size: int) -> torch.Tensor:
    """Patch extraction as reshape + matmul.

    ``img`` is NCHW ``[b, c, H, W]``; ``w`` is ``[p*p*c, dim]`` with rows in
    ``(p1 p2 c)`` order (``b c (gh p1) (gw p2) -> b (gh gw) (p1 p2 c)``).
    The product accumulates in fp32 and is cast to the input dtype once.
    """
    b_, c, hh, ww = img.shape
    p = patch_size
    gh, gw = hh // p, ww // p
    x = img.reshape(b_, c, gh, p, gw, p).permute(0, 2, 4, 3, 5, 1)
    x = x.reshape(b_, gh * gw, p * p * c)
    y = (x.float() @ w.float()).to(img.dtype)
    if b is not None:
        y = y + b
    return y
