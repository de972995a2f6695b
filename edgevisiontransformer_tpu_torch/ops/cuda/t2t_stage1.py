"""The T2T-ViT stage-1 tokenizer on a hand-written Hopper kernel (port of
``edgevisiontransformer_tpu/ops/pallas/t2t_stage1.py``, ``stage1_kqv_kernel``).

The first soft split of T2T-ViT, ``unfold(img, k7 s4 p2)`` (147 features for
each of the 56x56 tokens), feeds performer1 only through its LayerNorm and
``kqv`` projection.  ``models/t2t_vit.build_stage1_weights`` folds both into
a shift-expanded weight: after a space-to-depth relayout of the image
(``[56, 56, 48]``, padded by one token on each side), the 147 features of a
token are 147 of the 432 values of its 9 neighbouring s2d cells, so::

    big = the 9 shifted s2d views, concatenated     # [b, 3136, 432]
    out = big @ W9                                  # [432, d], fp32 accumulation
    mu  = sum(big * M9) / 147,  sq = sum(big^2 * M9) / 147   (M9: 0/1 mask)
    y   = (out - mu * c1) * rsqrt(sq - mu^2 + eps) + c2

:func:`stage1_kqv` runs that in one kernel (csrc/t2t_stage1.cu), reading
the NCHW image itself; :func:`stage1_kqv_plain` is its plain twin, which the
wrapper takes for CPU tensors only.  Every launch adds one to
:data:`LAUNCHES`.  The geometry is that of a 224x224 image.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build
from .common import no_backward
from .fused_encoder import _on_cpu, _ptr, _sm_count, _stream

# Kernel launches since the last reset_launches().
LAUNCHES = {"stage1_kqv": 0}

IMAGE = 224
GRID = 56                  # tokens per side: unfold_output_size(224, 7, 4, 2)
TOKENS = GRID * GRID       # 3136
S2D = 48                   # 3 channels x 4 x 4 phases per s2d cell
SHIFTS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
K9 = len(SHIFTS) * S2D     # 432 rows of W9
FEATURES = 147             # 3 x 7 x 7 unfold features (the mask's ones)
MAX_D = 256                # the widest d the kernel takes
STAGE1_COLS = (64, 96)     # the columns a block of the kernel may take


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_image(img: torch.Tensor, what: str) -> None:
    if img.dim() != 4 or tuple(img.shape[1:]) != (3, IMAGE, IMAGE):
        raise ValueError(f"{what}: the stage-1 tokenizer is built for [b, 3, {IMAGE}, {IMAGE}] "
                         f"images, got {tuple(img.shape)} (use fast=False for other sizes)")


def stage1_plan(batch: int, d: int, sms: int) -> int:
    """The columns each block of csrc/t2t_stage1.cu takes for ``batch``
    images of ``d`` columns on a card of ``sms`` SMs: 96 where 64-column
    blocks would put two blocks on some SM and 96-column blocks would not
    (t2t_vit_14 b1: 112 blocks against 168), else 64.
    ``bench/stage1_ab.py`` times both; a token's output does not depend on
    the plan."""
    blocks = lambda cols: batch * GRID * -(-d // cols)  # noqa: E731
    return 96 if blocks(64) > sms >= blocks(96) else 64


def _smem_bytes(cols: int) -> int:
    """The dynamic shared memory of one block (csrc/t2t_stage1.cu
    ``smem_bytes``): the W9 slice [432, cols + 8] bf16, the three staged s2d
    rows [3, 66, 56] bf16, the mask and the statistics in fp32, and the
    eight warps' patches [16, cols / 2 + 8] bf16."""
    return K9 * (cols + 8) * 2 + 3 * 66 * 56 * 2 + (K9 + 2 * 64) * 4 + 8 * 16 * (cols // 2 + 8) * 2


def shift_concat(img: torch.Tensor) -> torch.Tensor:
    """``[b, 3, 224, 224]`` -> the 9 shifted views of the padded s2d image,
    concatenated: ``[b, 3136, 432]`` in ``img.dtype``."""
    check_image(img, "shift_concat")
    bsz = img.shape[0]
    t = img.reshape(bsz, 3, GRID, 4, GRID, 4).permute(0, 2, 4, 1, 3, 5)
    tp = F.pad(t.reshape(bsz, GRID, GRID, S2D), (0, 0, 1, 1, 1, 1))
    parts = [tp[:, 1 + dy:GRID + 1 + dy, 1 + dx:GRID + 1 + dx, :] for dy, dx in SHIFTS]
    return torch.cat(parts, dim=-1).reshape(bsz, TOKENS, K9)


def stage1_kqv_plain(img: torch.Tensor, W9: torch.Tensor, M9: torch.Tensor,
                     c1: torch.Tensor, c2: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The kernel's function in fp32 with its cast points: ``W9`` rounded to
    ``img.dtype``, exact products, fp32 sums (squares included), one-pass
    variance, one cast of the result to ``img.dtype``."""
    dt = img.dtype
    bigf = shift_concat(img).float()
    out = bigf @ W9.to(dt).float()
    m = M9.reshape(-1).float()
    mu = (bigf * m).sum(dim=-1, keepdim=True) / float(FEATURES)
    sq = (bigf * bigf * m).sum(dim=-1, keepdim=True) / float(FEATURES)
    var = sq - mu * mu
    y = (out - mu * c1.float()) * torch.rsqrt(var + eps) + c2.float()
    return y.to(dt)


@no_backward
def stage1_kqv(img: torch.Tensor, W9: torch.Tensor, M9: torch.Tensor, c1: torch.Tensor,
               c2: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """:func:`stage1_kqv_plain` as one kernel (csrc/t2t_stage1.cu): one thread
    block per (image, token row, the columns :func:`stage1_plan` picks),
    products on ``mma.sync``.  On the GPU ``img [b, 3, 224, 224]`` and
    ``W9 [432, d]`` are bf16, ``M9 [432, 1]``, ``c1`` and ``c2 [d]`` fp32,
    and ``d`` a multiple of 16 up to 256; the result is ``[b, 3136, d]``."""
    f32 = (torch.float32,)
    if _on_cpu("stage1_kqv", img, W9, M9, c1, c2, dtypes={2: f32, 3: f32, 4: f32}):
        return stage1_kqv_plain(img, W9, M9, c1, c2, eps)
    check_image(img, "stage1_kqv")
    if W9.dim() != 2 or W9.shape[0] != K9 or M9.numel() != K9:
        raise ValueError(f"stage1_kqv: W9 must be [{K9}, d] and M9 hold {K9} values, got "
                         f"W9{tuple(W9.shape)} M9{tuple(M9.shape)}")
    d = W9.shape[1]
    if d % 16 or not 16 <= d <= MAX_D:
        raise ValueError(f"stage1_kqv: d must be a multiple of 16 in [16, {MAX_D}], got {d}")
    if c1.shape != (d,) or c2.shape != (d,):
        raise ValueError(f"stage1_kqv: c1 and c2 must be [{d}], got {tuple(c1.shape)} "
                         f"{tuple(c2.shape)}")
    bsz = img.shape[0]
    out = torch.empty((bsz, TOKENS, d), dtype=img.dtype, device=img.device)
    if bsz == 0:
        return out
    lib = build.load()
    cols = stage1_plan(bsz, d, _sm_count(img.device.index or 0))
    rc = lib.evt_t2t_stage1(_ptr(img), _ptr(W9), _ptr(M9), _ptr(c1), _ptr(c2), _ptr(out),
                            bsz, d, ctypes.c_float(eps), cols, _stream(img))
    build.check(rc, "stage1_kqv")
    LAUNCHES["stage1_kqv"] += 1
    return out
