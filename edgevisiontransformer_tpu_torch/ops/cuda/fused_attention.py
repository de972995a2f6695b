"""Multi-head self-attention with its softmax chain on a hand-written Hopper
kernel (port of ``edgevisiontransformer_tpu/ops/pallas/fused_attention.py``,
K13 ``sdpa``).

K13 serves the ViT module's ``kernel_mode="pallas"`` forward:
:func:`attention` keeps the qkv and output projections as plain matmuls in
the compute dtype, as the reference leaves them to XLA, and runs the
softmax chain of every (image, head) in :func:`sdpa`.  Its math is not the
fused encoder's: the score is ``f32(q.k) * scale``, the softmax subtracts
the row max, uses ``exp`` and normalises ``p`` before the PV product, and
``p`` is rounded to ``v``'s dtype after normalising.

:func:`sdpa` launches one kernel for CUDA tensors: csrc/sdpa.cu up to
:func:`res_keys` keys, csrc/sdpa_long.cu beyond (on :func:`long_plan`'s
grid); it takes :func:`sdpa_plain` for CPU tensors only.  Every launch adds
one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..attention import qkv_split
from . import build
from .common import no_backward
from .fused_encoder import (COMPUTE_DTYPES, _entry, _ptr, _sm_count, _stream, check_head_dim,
                            head_dim_instance)

# Kernel launches since the last reset_launches().
LAUNCHES = {"sdpa": 0}


# csrc/sdpa_long.cu: query rows of a consumer warpgroup (one wgmma M), keys
# a tile, head_dim columns of a 128-byte-swizzled panel (one 64 x 64 TMA box
# of 16-bit values), a block's dynamic shared memory on the H100
LONG_ROWS = 64
LONG_KEYS = 64
LONG_PANEL = 64
LONG_MAX_SMEM = 232448
# A block holds 1, 2 or 3 consumer warpgroups (64, 128 or 192 query rows);
# a streamed block a ring of LONG_RING tiles.  An H100 SM holds 233,472
# bytes of shared memory (1,024 more a block than it asks for) and 65,536
# registers, given out 8 a thread at a time; LONG_REGS: the registers a
# thread of the one-warpgroup kernel takes at each count of k16 steps of the
# head dim (ptxas on the H100, as chip_smoke.py phase 2 prints them; the
# wider kernels hold one block an SM whatever they take).
LONG_WARPGROUPS = (1, 2, 3)
# ptxas holds a three-warpgroup block's threads to 128 registers, and at
# head_dim 128 they spill: no such block there (csrc/sdpa_long.cu
# WIDEST_HEAD_DIM)
LONG_WIDEST_HEAD_DIM = 112
LONG_RING = 2
LONG_SM_SMEM = 233472
LONG_SM_REGS = 65536
LONG_REGS = {1: 128, 2: 128, 3: 122, 4: 127, 5: 128, 6: 152, 7: 160, 8: 158}
# The time of one wave of blocks when an SM runs c warpgroups at once,
# relative to one: the chains of loads, products and softmax of several
# warpgroups overlap (bench/sdpa_ab.py's 64-, 128- and 192-row blocks at
# ViT-H/14 b1 on the H100: 13.4, 18.3 and 21.8 us)
LONG_WAVE_COST = {1: 1.0, 2: 1.37, 3: 1.63}


def res_keys(head_dim: int) -> int:
    """The longest ``n`` csrc/sdpa.cu's resident form holds at ``head_dim``
    (``Tile<HD>::RES_KEYS`` of its instance): 256, or 128 above 96; a longer
    ``n`` runs on csrc/sdpa_long.cu."""
    return 128 if head_dim_instance(head_dim) > 96 else 256


def long_panels(head_dim: int) -> int:
    """The 64-column panels of a tile row of csrc/sdpa_long.cu."""
    return -(-head_dim // LONG_PANEL)


def long_smem_bytes(rows: int, head_dim: int, stages: int) -> int:
    """The dynamic shared memory of a csrc/sdpa_long.cu block (its
    ``smem_bytes``): up to 1,024 bytes to align it, ``rows / 64`` Q tiles
    and ``stages`` K / V tiles of 64 rows x :func:`long_panels` panels of 64
    x 128 bytes, and a full and an empty mbarrier a slot and Q's (8 bytes
    each)."""
    return (1024 + (rows // LONG_ROWS + stages) * long_panels(head_dim) * LONG_KEYS * 128
            + (2 * stages + 1) * 8)


def long_tensor_map(t: torch.Tensor) -> tuple:
    """The 4-D tensor map csrc/sdpa_long.cu encodes for a ``[b, h, n, d]``
    operand view: its extents innermost first ``(d, n, h, b)``, the byte
    strides of ``n``, ``h`` and ``b`` (the view's own, so a box never runs
    into the next head's columns or the next image's rows: past an extent
    TMA loads zeros and stores nothing) and the box ``(64, 64, 1, 1)``: one
    panel of 64 columns of 64 query or key rows of one (image, head)."""
    b, h, n, d = t.shape
    sb, sh, sn, _ = t.stride()
    e = t.element_size()
    return (d, n, h, b), (sn * e, sh * e, sb * e), (LONG_PANEL, LONG_KEYS, 1, 1)


class LongPlan(NamedTuple):
    """How csrc/sdpa_long.cu covers one call: ``rows`` query rows a block
    (64, 128 or 192: one to three consumer warpgroups), a ring of ``stages``
    tiles, ``resident`` when it holds every K and V tile (``stages`` = 2 x
    ``tiles``: pass 2 reads K where pass 1 left it), the dynamic shared
    memory ``smem`` of a block and the ``grid`` (batch x heads, query
    blocks)."""
    rows: int
    stages: int
    resident: bool
    tiles: int
    smem: int
    grid: tuple


def long_blocks_per_sm(rows: int, d: int, stages: int) -> int:
    """The csrc/sdpa_long.cu blocks of ``rows`` query rows and a ring of
    ``stages`` tiles that one H100 SM holds at once, by shared memory and
    registers (:data:`LONG_REGS`), at most three warpgroups in all
    (:data:`LONG_WAVE_COST`'s reach)."""
    wg = rows // LONG_ROWS
    regs = -(-LONG_REGS[-(-d // 16)] // 8) * 8
    by_smem = LONG_SM_SMEM // (long_smem_bytes(rows, d, stages) + 1024)
    by_regs = LONG_SM_REGS // ((128 * wg + 32) * regs)
    return max(1, min(by_smem, by_regs, 3 // wg))


@functools.lru_cache(maxsize=256)
def long_plan(b: int, h: int, n: int, d: int, sms: int, *, rows: Optional[int] = None,
              resident: Optional[bool] = None) -> LongPlan:
    """csrc/sdpa_long.cu's plan for ``[b, h, n, d]`` on a card of ``sms``
    SMs: of the blocks of 64, 128 or 192 query rows, with K and V resident
    (where all their tiles fit beside the Q tiles in :data:`LONG_MAX_SMEM`)
    or streamed through a ring of :data:`LONG_RING` tiles, the form of least
    cost: its waves of blocks (:func:`long_blocks_per_sm` an SM in each)
    times :data:`LONG_WAVE_COST` of the warpgroups an SM runs at once; on a
    tie the fewer rows, then resident.  No 192-row block above
    :data:`LONG_WIDEST_HEAD_DIM`.  ``rows`` and ``resident`` force a
    form.  The plan moves no row's arithmetic: every form gives the same
    bits."""
    tiles = -(-n // LONG_KEYS)
    widths = tuple(LONG_ROWS * w for w in LONG_WARPGROUPS
                   if w < 3 or d <= LONG_WIDEST_HEAD_DIM)
    if rows is not None and rows not in widths:
        raise ValueError(f"sdpa: {rows} query rows a block at head_dim {d} (one of {widths})")
    if resident and long_smem_bytes(rows or LONG_ROWS, d, 2 * tiles) > LONG_MAX_SMEM:
        raise ValueError(f"sdpa: K and V of {n} keys at head_dim {d} do not fit in shared memory")
    best = None
    for r in (rows,) if rows else widths:
        for res in (resident,) if resident is not None else (True, False):
            stages = 2 * tiles if res else LONG_RING
            if long_smem_bytes(r, d, stages) > LONG_MAX_SMEM:
                continue
            blocks, bps = b * h * -(-n // r), long_blocks_per_sm(r, d, stages)
            waves = -(-blocks // (sms * bps))
            together = r // LONG_ROWS * min(bps, -(-blocks // sms))
            key = (waves * LONG_WAVE_COST[together], r, not res)
            if best is None or key < best[0]:
                best = (key, LongPlan(r, stages, res, tiles, long_smem_bytes(r, d, stages),
                                      (b * h, -(-n // r))))
    return best[1]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: Optional[float] = None, *, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """K13's function in fp32 with its cast points: ``[b, h, n, d]``
    operands, ``s = f32(q.k) * scale``, ``p = exp(s - max s) / sum``, ``o =
    f32(p cast to v.dtype) @ v``, cast to ``q.dtype``; written into ``out``
    when given, as :func:`sdpa` does."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = (p.to(v.dtype).float() @ v.float()).to(q.dtype)
    return o if out is None else out.copy_(o)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU; False when all are bf16, or all
    fp16, on one CUDA device with rows of 16-byte vectors (the last stride
    1, the others multiples of 8, 16-byte aligned); raise otherwise."""
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"sdpa: tensors must all be on the CPU or all on one CUDA device, "
                         f"got {sorted(map(str, devs))}")
    dt = tensors[0].dtype
    if dt not in COMPUTE_DTYPES:
        raise TypeError(f"sdpa: the CUDA kernel takes bfloat16 or float16, got {dt}")
    for t in tensors:
        if t.dtype != dt:
            raise TypeError(f"sdpa: the CUDA kernel takes one dtype, got {dt} and {t.dtype}")
        if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1])
                or t.data_ptr() % 16):
            raise ValueError("sdpa: the CUDA kernel needs d contiguous, the other strides "
                             f"multiples of 8 and 16-byte alignment, got strides {t.stride()}")
    return False


@no_backward
def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         scale: Optional[float] = None, *, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention ``[b, h, n, d] -> [b, h, n, d]``: K13 as
    one kernel launch, its scores in registers.  Up to :func:`res_keys`
    keys (256, 128 above ``d`` = 96) csrc/sdpa.cu, one block per (image *
    head, 64-query tile) holding every key in shared memory; beyond,
    csrc/sdpa_long.cu on :func:`long_plan`'s grid (wgmma fed by TMA, two
    passes over 64-key tiles), so any ``n`` runs.  The operands are read through their strides,
    so views of a fused qkv activation need no copy; ``out``, when given, is
    the ``[b, h, n, d]`` view the result is written into (and returned).  On
    the GPU all are bf16 or all fp16 and ``d`` is a multiple of 8 from 16 to
    128 (``fused_encoder.ATTENTION_HEAD_DIMS``, each on the instance of the
    next multiple of 16)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape or (
            out is not None and out.shape != q.shape):
        raise ValueError(f"sdpa: q, k, v (and out) must be one [b, h, n, d] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    tensors = (q, k, v) + ((out,) if out is not None else ())
    if _on_cpu(*tensors):
        return sdpa_plain(q, k, v, scale, out=out)
    b, h, n, d = q.shape
    check_head_dim("sdpa", d)
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    args = (_ptr(q), _ptr(k), _ptr(v), _ptr(out), strides, b, h, n, d, ctypes.c_float(scale))
    if n > res_keys(d):
        p = long_plan(b, h, n, d, _sm_count(q.device.index or 0))
        rc = _entry("evt_sdpa_long", q)(*args, p.rows, p.stages, _stream(q))
    else:
        rc = _entry("evt_sdpa", q)(*args, _stream(q))
    build.check(rc, "sdpa")
    LAUNCHES["sdpa"] += 1
    return out


def attention(x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: Optional[torch.Tensor],
              w_out: torch.Tensor, b_out: Optional[torch.Tensor], heads: int,
              head_dim: int) -> torch.Tensor:
    """The attention block ``[b, n, dim] -> [b, n, dim]`` with :func:`sdpa`
    as its core: ``qkv = x @ w_qkv (+ b_qkv)`` and ``o @ w_out (+ b_out)``
    stay plain matmuls in the compute dtype, as in the reference.  The
    kernel reads q, k and v as views of ``qkv`` and writes the merged heads
    ``[b, n, heads * head_dim]`` in place."""
    qkv = x @ w_qkv
    if b_qkv is not None:
        qkv = qkv + b_qkv
    q, k, v = qkv_split(qkv, heads, head_dim)
    bsz, n = x.shape[0], x.shape[1]
    o = torch.empty((bsz, n, heads * head_dim), dtype=qkv.dtype, device=qkv.device)
    sdpa(q, k, v, head_dim ** -0.5, out=o.view(bsz, n, heads, head_dim).transpose(1, 2))
    o = o @ w_out
    if b_out is not None:
        o = o + b_out
    return o
