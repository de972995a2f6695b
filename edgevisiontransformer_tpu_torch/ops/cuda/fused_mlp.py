"""The GELU MLP ``gelu(x @ w1 + b1) @ w2 + b2`` on one hand-written Hopper
kernel (port of ``edgevisiontransformer_tpu/ops/pallas/fused_mlp.py``, K14
``mlp``).

K14 serves the ViT module's ``kernel_mode="pallas"`` forward for every
``act`` but ``"relu"``: both products run in the kernel.  Its cast points
are its own: GELU reads the fp32 ``x @ w1 + f32(b1)`` with no rounding
before it, its result is cast once to the compute dtype, and the output is
``bf16(h @ w2 + f32(b2))``.

:func:`mlp` launches csrc/mlp.cu for CUDA tensors up to ``dim`` 1,152 (the
hidden activation never leaves the SM; grid from :func:`plan`) and
csrc/mlp_wide.cu above (one persistent launch on ``wgmma`` fed by TMA, the
hidden activation in a workspace that stays in L2; grid from
:func:`wide_plan`), and takes :func:`mlp_plain` for CPU tensors only.  Every
launch adds one to :data:`LAUNCHES`.
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
# rows up to dim 1,152 (MID_ROWS_DIM); every wider dim (ViT-H's 1,280,
# ViT-g's 1,408, ViT-G's 1,664, ...) runs csrc/mlp_wide.cu.
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
    """mlp.cu's grid for ``m`` rows on a card of ``sms`` SMs (``dim`` up to
    :data:`MID_ROWS_DIM`; :func:`wide_plan` above).

    128 rows per block (each block streams all of its column tile's weights
    from L2, so more rows a block read them fewer times) where ``dim`` lets
    them fit and the row blocks fill at least half the card, else 64.
    Columns in the fewest tiles of at most 256.  Where the blocks leave the
    card mostly idle (small ``m``), a cluster of up to 8 blocks splits the
    hidden chunks, and the column tiles narrow (to 64) until the clusters
    reach half the SMs.  Chunks of 64 hidden units at 128 rows with no
    split, where shared memory holds them (half the barriers and X
    fragment loads of 32), else 32.  ``rows``, ``split`` and ``hc`` force
    those choices."""
    if dim > MID_ROWS_DIM:
        raise ValueError(f"mlp: dim {dim} > {MID_ROWS_DIM} runs mlp_wide.cu (wide_plan)")
    nt = -(-dim // -(-dim // TILE_WIDTHS[-1]) // 64) * 64  # fewest tiles, evenly wide
    if rows is None:
        rows = 128 if dim <= WIDE_ROWS_DIM and -(-m // 128) * -(-dim // nt) * 2 >= sms else 64
    row_tiles = -(-m // rows)
    if split is None:
        most = min(MAX_SPLIT, -(-hidden // 32))
        while nt > TILE_WIDTHS[0] and row_tiles * -(-dim // nt) * most * 2 < sms:
            nt -= 64
        split = max(1, min(most, sms // (row_tiles * -(-dim // nt))))
    if hc is None:
        hc = 64 if rows == 128 and split == 1 and _smem_bytes(dim, rows, nt, 64) <= MAX_SMEM else 32
    return Plan(rows, split, nt, hc, -(-dim // nt))


# csrc/mlp_wide.cu: a tile's rows (one 64-row wgmma block; the two
# warpgroups split the columns) and columns, the depth of a ring step, the
# ring's steps, the most shares of fc2's K, the blocks an SM (its ring takes
# more than half the SM's shared memory)
WIDE_BM = 64
WIDE_BN = 256
WIDE_BK = 64
WIDE_STAGES = 4
WIDE_MAX_SPLIT = 8
WIDE_BLOCKS_PER_SM = 1
# wide_plan's cost of a split, in rounds of ring steps (~0.55 us each on
# the H100 at ViT-H/14 b8): the second grid barrier, and the bytes of
# partials one round writes and reads back (S x M x D fp32, each written and
# read once, at ~2 TB/s), fitted to bench/mlp_ab.py's splits 1, 2 and 4 at
# ViT-H/14 b1 and b8 (PERF.md section 6)
WIDE_SPLIT_SYNC_STEPS = 5
WIDE_SPLIT_BYTES_PER_STEP = 1.1e6


class WidePlan(NamedTuple):
    """How csrc/mlp_wide.cu covers one call: tiles of ``bm`` x ``bn`` in
    both phases, K in ``bk``-deep steps; ``row_tiles`` x ``hidden_tiles``
    fc1 tiles over the hidden width padded to ``hp``; ``row_tiles`` x
    ``dim_tiles`` fc2 tiles, each cut into ``split`` shares of fc2's K;
    ``grid`` blocks; the workspaces ``h_bytes`` (H [m, hp]) and
    ``part_bytes`` (the fp32 partials [split, m, dim], 0 at split 1); the
    dynamic shared memory ``smem`` of a block."""
    bm: int
    bn: int
    bk: int
    split: int
    grid: int
    row_tiles: int
    hidden_tiles: int
    dim_tiles: int
    hp: int
    h_bytes: int
    part_bytes: int
    smem: int


def wide_smem_bytes() -> int:
    """The dynamic shared memory of one block (csrc/mlp_wide.cu ``SMEM``):
    the ring of A [bm, bk] and B [bk, bn] steps, 1,024 bytes to align it to
    the swizzle's period, and a full and an empty mbarrier (8 bytes each) a
    step."""
    return WIDE_STAGES * (WIDE_BM * WIDE_BK + WIDE_BK * WIDE_BN) * 2 + 1024 + 2 * WIDE_STAGES * 8


def wide_shares(steps: int, split: int) -> list:
    """The K steps ``[s0, s1)`` of fc2 that share s of ``split`` takes (csrc/
    mlp_wide.cu: ``s * ks / S``), for each s."""
    return [(s * steps // split, (s + 1) * steps // split) for s in range(split)]


def wide_plan(m: int, dim: int, hidden: int, sms: int, *, split: int | None = None,
              itemsize: int = 2) -> WidePlan:
    """The wide kernel's grid for ``m`` rows on a card of ``sms`` SMs.

    The split of fc2's K is the one of least cost in rounds of ring steps:
    the rounds of units the grid runs, each ``hp / bk / split`` steps long,
    plus, past one share, :data:`WIDE_SPLIT_SYNC_STEPS` and the partials'
    bytes over :data:`WIDE_SPLIT_BYTES_PER_STEP` (the fewer shares on a
    tie); at most :data:`WIDE_MAX_SPLIT` and one share a step.  The grid is
    one block an SM, fewer where neither phase has as many units.  ``split``
    forces the shares; ``itemsize`` is the compute dtype's."""
    rt = -(-m // WIDE_BM)
    ht = -(-hidden // WIDE_BN)
    hp = ht * WIDE_BN
    dt = -(-dim // WIDE_BN)
    steps = hp // WIDE_BK
    slots = sms * WIDE_BLOCKS_PER_SM

    def cost(s: int) -> float:
        rounds = -(-rt * dt * s // slots) * -(-steps // s)
        return rounds + (s > 1) * (WIDE_SPLIT_SYNC_STEPS
                                   + s * m * dim * 8 / WIDE_SPLIT_BYTES_PER_STEP)

    if split is None:
        split = min(range(1, min(WIDE_MAX_SPLIT, steps) + 1), key=cost)
    if not 1 <= split <= min(WIDE_MAX_SPLIT, steps):
        raise ValueError(f"mlp: a split of {split} shares of {steps} steps")
    grid = min(slots, max(rt * ht, rt * dt * split))
    return WidePlan(WIDE_BM, WIDE_BN, WIDE_BK, split, grid, rt, ht, dt, hp, m * hp * itemsize,
                    split * m * dim * 4 if split > 1 else 0, wide_smem_bytes())


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
    [hidden, dim]``: :func:`mlp_plain` as one kernel launch.  Up to ``dim``
    1,152 csrc/mlp.cu on the grid :func:`plan` picks: blocks of 128 or 64
    rows by up to 256 output columns, and at small row counts clusters of
    blocks that split the hidden width.  Above, csrc/mlp_wide.cu on
    :func:`wide_plan`'s grid, with the workspaces it names allocated here.
    On the GPU every tensor is bf16 (or every one fp16) and contiguous,
    ``x`` 16-byte aligned, ``dim`` a multiple of 8; ``hidden`` is any
    width."""
    dim = x.shape[-1]
    hidden = w1.shape[-1]
    if (w1.shape != (dim, hidden) or b1.shape != (hidden,) or w2.shape != (hidden, dim)
            or b2.shape != (dim,)):
        raise ValueError(f"mlp: bad shapes x{tuple(x.shape)} w1{tuple(w1.shape)} "
                         f"b1{tuple(b1.shape)} w2{tuple(w2.shape)} b2{tuple(b2.shape)}")
    x2 = x.reshape(-1, dim)
    if _on_cpu("mlp", x2, w1, b1, w2, b2, aligned=False):
        return mlp_plain(x, w1, b1, w2, b2, approx_gelu=approx_gelu)
    if dim % 8:
        raise ValueError(f"mlp: dim must be a multiple of 8, got {dim}")
    if x2.data_ptr() % 16:
        raise ValueError("mlp: the CUDA kernel needs x 16-byte aligned")
    y = torch.empty_like(x2)
    if x2.shape[0]:
        m, sms = x2.shape[0], _sm_count(x2.device.index or 0)
        if dim > MID_ROWS_DIM:
            rc = wide_call(_entry("evt_mlp_wide", x2), x2, w1, b1, w2, b2, y, approx_gelu,
                           wide_plan(m, dim, hidden, sms, itemsize=x2.element_size()))
        else:
            p = plan(m, dim, hidden, sms)
            rc = _entry("evt_mlp", x2)(_ptr(x2), _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2), _ptr(y),
                                       m, dim, hidden, int(approx_gelu), p.rows, p.split, p.nt,
                                       p.hc, _stream(x2))
        build.check(rc, "mlp")
        LAUNCHES["mlp"] += 1
    return y.reshape(x.shape)


def wide_call(fn, x2, w1, b1, w2, b2, y, approx_gelu: bool, p: WidePlan) -> int:
    """``fn`` (an ``evt_mlp_wide`` entry point) on ``x2 [m, dim]`` into ``y``
    under the plan ``p``, with the workspaces it names; returns the CUDA
    error code."""
    m, dim = x2.shape
    h = torch.empty(m, p.hp, dtype=x2.dtype, device=x2.device)
    part = torch.empty(p.split, m, dim, dtype=torch.float32, device=x2.device) \
        if p.split > 1 else None
    return fn(_ptr(x2), _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2), _ptr(y), _ptr(h),
              None if part is None else _ptr(part), m, dim, w1.shape[1], int(approx_gelu),
              p.split, p.grid, _stream(x2))
