"""Swin patch merging on a hand-written Hopper kernel (port of
``edgevisiontransformer_tpu/ops/pallas/swin_merge.py``, ``swin_merge_forward``).

The TPU kernel K10 keeps the tokens window-major and gathers each output
token's 2x2 neighbourhood with a banded one-hot matmul, then runs the
LayerNorm over 4C and the [4C, 2C] reduction in the same pass.  The port
keeps the tokens in raster order, so the gather is addressing:
:func:`swin_merge` (csrc/swin_merge.cu) writes, for output token
``(y', x')`` of an image at ``res``, the LayerNorm of the concatenated input
rows ``(2y'+dy, 2x'+dx)`` in the order ``(0,0), (0,1), (1,0), (1,1)`` (the
prepared ``(dy, dx, c)`` feature order, K10's ``g = 2 dy + dx``), and
``fused_encoder.linear(., W_red, 0, CAST_THEN_BIAS)`` does the reduction:
with a zero bias that epilogue is exactly K10's ``bf16(acc)``.

:func:`swin_merge_plain` is the kernel's twin, which the wrapper takes for
CPU tensors only.  Every launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .common import no_backward
from .fused_encoder import _COMPUTE_F32, _entry, _on_cpu, _ptr, _stream, ln_rows_plain

# Kernel launches since the last reset_launches().
LAUNCHES = {"swin_merge": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(x: torch.Tensor, res: int) -> int:
    if x.dim() != 2 or res % 2 or x.shape[0] % (res * res):
        raise ValueError(f"swin_merge: x{tuple(x.shape)} is not [b*{res}*{res}, C] rows "
                         f"of an even resolution")
    return x.shape[0] // (res * res)


def merge_gather(x: torch.Tensor, res: int) -> torch.Tensor:
    """``[b*res*res, C]`` raster rows -> ``[b*(res/2)^2, 4C]``: output token
    ``(y', x')`` holds the rows ``(2y'+dy, 2x'+dx)`` in ``(dy, dx)`` order."""
    bsz, c = _check(x, res), x.shape[1]
    h = res // 2
    t = x.reshape(bsz, h, 2, h, 2, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(bsz * h * h, 4 * c)


def swin_merge_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, *, res: int,
                     eps: float) -> torch.Tensor:
    """The kernel's function: :func:`merge_gather`, then the LayerNorm over
    4C with fp32 two-pass statistics and the affine in fp32, one cast to
    ``x.dtype``."""
    return ln_rows_plain(merge_gather(x, res), g, b, eps)


@no_backward
def swin_merge(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, *, res: int,
               eps: float) -> torch.Tensor:
    """:func:`swin_merge_plain` as one kernel (csrc/swin_merge.cu): one warp
    per output token.  On the GPU ``x`` is bf16 or fp16 with ``C % 8 == 0``
    and the affine ``g``, ``b [4C]`` of its dtype or fp32 (both alike)."""
    if _on_cpu("swin_merge", x, g, b, dtypes={1: _COMPUTE_F32, 2: _COMPUTE_F32}):
        return swin_merge_plain(x, g, b, res=res, eps=eps)
    bsz = _check(x, res)
    c = x.shape[1]
    if c % 8:
        raise ValueError(f"swin_merge: C must be a multiple of 8, got {c}")
    if g.shape != (4 * c,) or b.shape != (4 * c,) or g.dtype != b.dtype:
        raise ValueError(f"swin_merge: g and b must be [{4 * c}] of one dtype, got "
                         f"g{tuple(g.shape)} {g.dtype}, b{tuple(b.shape)} {b.dtype}")
    out = torch.empty((bsz * (res // 2) ** 2, 4 * c), dtype=x.dtype, device=x.device)
    if bsz == 0:
        return out
    rc = _entry("evt_swin_merge", x)(_ptr(x), _ptr(g), _ptr(b), _ptr(out), bsz, res, c,
                                     ctypes.c_float(eps), int(g.dtype == torch.float32),
                                     _stream(x))
    build.check(rc, "swin_merge")
    LAUNCHES["swin_merge"] += 1
    return out
