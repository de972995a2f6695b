"""The GELU MLP ``gelu(x @ w1 + b1) @ w2 + b2`` on one hand-written Hopper
kernel (port of ``edgevisiontransformer_tpu/ops/pallas/fused_mlp.py``, K14
``mlp``).

K14 serves the ViT module's ``kernel_mode="pallas"`` forward for every
``act`` but ``"relu"``: both products run in the kernel and the hidden
activation never leaves the chip.  Its cast points are its own: GELU reads
the fp32 ``x @ w1 + f32(b1)`` with no rounding before it, its result is
cast once to the compute dtype, and the output is ``bf16(h @ w2 +
f32(b2))``.

:func:`mlp` launches csrc/mlp.cu for CUDA tensors and takes
:func:`mlp_plain` for CPU tensors only.  Every launch adds one to
:data:`LAUNCHES`.
"""

from __future__ import annotations

import torch

from . import build
from .fused_encoder import _on_cpu, _ptr, _stream
from .mathlib import gelu_kernel

# Kernel launches since the last reset_launches().
LAUNCHES = {"mlp": 0}

# csrc/mlp.cu keeps a block's 64 rows of x in shared memory beside its
# weight tiles, in at most 232,448 bytes: dim up to 1,152.
MAX_DIM = 1152


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def mlp_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, *, approx_gelu: bool = False) -> torch.Tensor:
    """K14's function in fp32 with its cast points: ``h = gelu(f32(x @ w1)
    + f32(b1))`` cast once to ``x.dtype``, then ``f32(h @ w2) + f32(b2)``
    cast to ``x.dtype``.  GELU is the tanh form when ``approx_gelu``, else
    the exact one."""
    dt = x.dtype
    h = gelu_kernel(x.float() @ w1.float() + b1.float(), approx_gelu).to(dt)
    return (h.float() @ w2.float() + b2.float()).to(dt)


def mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
        b2: torch.Tensor, *, approx_gelu: bool = False) -> torch.Tensor:
    """``x [..., dim] -> [..., dim]`` with ``w1 [dim, hidden]``, ``w2
    [hidden, dim]``: :func:`mlp_plain` as one kernel (csrc/mlp.cu), one
    thread block per (64 rows, 256 output columns).  On the GPU every tensor
    is bf16 and contiguous, ``x`` 16-byte aligned, ``dim`` a multiple of 8
    up to :data:`MAX_DIM`; ``hidden`` is any width."""
    dim = x.shape[-1]
    hidden = w1.shape[-1]
    if (w1.shape != (dim, hidden) or b1.shape != (hidden,) or w2.shape != (hidden, dim)
            or b2.shape != (dim,)):
        raise ValueError(f"mlp: bad shapes x{tuple(x.shape)} w1{tuple(w1.shape)} "
                         f"b1{tuple(b1.shape)} w2{tuple(w2.shape)} b2{tuple(b2.shape)}")
    x2 = x.reshape(-1, dim)
    if _on_cpu("mlp", x2, w1, b1, w2, b2, aligned=False):
        return mlp_plain(x, w1, b1, w2, b2, approx_gelu=approx_gelu)
    if dim % 8 or dim > MAX_DIM:
        raise ValueError(f"mlp: dim must be a multiple of 8 up to {MAX_DIM}, got {dim}")
    if x2.data_ptr() % 16:
        raise ValueError("mlp: the CUDA kernel needs x 16-byte aligned")
    y = torch.empty_like(x2)
    if x2.shape[0]:
        lib = build.load()
        rc = lib.evt_mlp(_ptr(x2), _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2), _ptr(y),
                         x2.shape[0], dim, hidden, int(approx_gelu), _stream(x2))
        build.check(rc, "mlp")
        LAUNCHES["mlp"] += 1
    return y.reshape(x.shape)
