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

from typing import NamedTuple

import torch

from . import build
from .common import no_backward
from .fused_encoder import _entry, _on_cpu, _ptr, _sm_count, _stream
from .mathlib import gelu_kernel

# Kernel launches since the last reset_launches().
LAUNCHES = {"mlp": 0}

# csrc/mlp.cu keeps a block's rows of x in shared memory beside its weight
# rings, in at most 232,448 bytes (MAX_SMEM): 128 rows up to dim 512, 64
# rows up to dim 1,152, 32 rows up to dim 2,048 (ViT-H's 1,280, ViT-g's
# 1,408 and ViT-G's 1,664 among them).
MAX_DIM = 2048
WIDE_ROWS_DIM = 512
MID_ROWS_DIM = 1152
MAX_SMEM = 232448
# csrc/mlp.cu: the W1 ring's stages, the most rows of dim in a W1 slab, the
# most blocks in a cluster, the output column tiles it is compiled for
STAGES = 3
KMAX = 192
MAX_SPLIT = 8
TILE_WIDTHS = (64, 128, 192, 256)


class Plan(NamedTuple):
    """How csrc/mlp.cu covers one call: ``rows`` per block (16 a warp),
    ``split`` blocks of a cluster sharing the hidden chunks, ``nt`` output
    columns per block (``col_tiles`` of them cover ``dim``, each recomputing
    fc1), ``hc`` hidden units per chunk."""
    rows: int
    split: int
    nt: int
    hc: int
    col_tiles: int


def _smem_bytes(dim: int, rows: int, nt: int, hc: int) -> int:
    """The dynamic shared memory of one block (csrc/mlp.cu ``Layout``)."""
    ks = -(-dim // KMAX)  # W1 slabs a chunk
    kslab = -(-dim // ks)
    kslab = -(-kslab // 16) * 16  # rows of dim a slab, whole k16 steps
    nw2 = 1 + -(-(STAGES - 1) // ks)  # W2 buffers
    x, ring1, ring2 = rows * (ks * kslab + 8), STAGES * kslab * (hc + 8), nw2 * hc * (nt + 8)
    end = 2 * (x + ring1 + ring2)
    return max(end, rows * (nt + 4) * 4)


def plan(m: int, dim: int, hidden: int, sms: int, *, rows: int | None = None,
         split: int | None = None, hc: int | None = None) -> Plan:
    """The kernel's grid for ``m`` rows on a card of ``sms`` SMs.

    128 rows per block (each block streams all of its column tile's weights
    from L2, so more rows a block read them fewer times) where ``dim`` lets
    them fit and the row blocks fill at least half the card, else 64, and
    32 above ``dim`` 1,152, where 64 rows of x no longer fit beside the
    rings.
    Columns in the fewest tiles of at most 256.  Where the blocks leave the
    card mostly idle (small ``m``), a cluster of up to 8 blocks splits the
    hidden chunks, and the column tiles narrow (to 64) until the clusters
    reach half the SMs.  Chunks of 64 hidden units at 128 rows with no
    split, where shared memory holds them (half the barriers and X
    fragment loads of 32), else 32.  ``rows``, ``split`` and ``hc`` force
    those choices."""
    nt = -(-dim // -(-dim // TILE_WIDTHS[-1]) // 64) * 64  # fewest tiles, evenly wide
    if rows is None:
        rows = 128 if dim <= WIDE_ROWS_DIM and -(-m // 128) * -(-dim // nt) * 2 >= sms else 64
        rows = rows if dim <= MID_ROWS_DIM else 32
    row_tiles = -(-m // rows)
    if split is None:
        most = min(MAX_SPLIT, -(-hidden // 32))
        while nt > TILE_WIDTHS[0] and row_tiles * -(-dim // nt) * most * 2 < sms:
            nt -= 64
        split = max(1, min(most, sms // (row_tiles * -(-dim // nt))))
    if hc is None:
        hc = 64 if rows == 128 and split == 1 and _smem_bytes(dim, rows, nt, 64) <= MAX_SMEM else 32
    return Plan(rows, split, nt, hc, -(-dim // nt))


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


@no_backward
def mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
        b2: torch.Tensor, *, approx_gelu: bool = False) -> torch.Tensor:
    """``x [..., dim] -> [..., dim]`` with ``w1 [dim, hidden]``, ``w2
    [hidden, dim]``: :func:`mlp_plain` as one kernel launch (csrc/mlp.cu) on
    the grid :func:`plan` picks: blocks of 128 or 64 rows by up to 256 output
    columns, and at small row counts clusters of blocks that split the
    hidden width.  On the GPU every tensor is bf16 (or every one fp16) and
    contiguous, ``x``
    16-byte aligned, ``dim`` a multiple of 8 up to :data:`MAX_DIM` (2,048);
    ``hidden`` is any width."""
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
        p = plan(x2.shape[0], dim, hidden, _sm_count(x2.device.index or 0))
        rc = _entry("evt_mlp", x2)(_ptr(x2), _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2), _ptr(y),
                                   x2.shape[0], dim, hidden, int(approx_gelu), p.rows, p.split,
                                   p.nt, p.hc, _stream(x2))
        build.check(rc, "mlp")
        LAUNCHES["mlp"] += 1
    return y.reshape(x.shape)
