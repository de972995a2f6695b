"""Sliding-window patch extraction (port of ``edgevisiontransformer_tpu/ops/unfold.py``).

``torch.nn.functional.unfold`` is ``torch.nn.Unfold``, whose per-patch
feature order (c, kh, kw) is the JAX package's default ``"torch"`` order;
``"tf"`` reorders to (kh, kw, c), as ``tf.image.extract_patches`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def unfold(x: torch.Tensor, kernel_size: int, stride: int, padding: int,
           channel_order: str = "torch") -> torch.Tensor:
    """Patches of the NCHW input ``x [b, c, h, w]`` as ``[b, n_patches,
    c * k * k]``, patches in row-major spatial order."""
    if channel_order not in ("torch", "tf"):
        raise ValueError(f"unknown channel_order {channel_order!r}")
    b, c = x.shape[:2]
    k = kernel_size
    patches = F.unfold(x, k, padding=padding, stride=stride).transpose(1, 2)  # [b, n, c*k*k]
    if channel_order == "tf":
        n = patches.shape[1]
        patches = patches.reshape(b, n, c, k * k).transpose(2, 3).reshape(b, n, c * k * k)
    return patches


def unfold_output_size(size: int, kernel_size: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - kernel_size) // stride + 1
