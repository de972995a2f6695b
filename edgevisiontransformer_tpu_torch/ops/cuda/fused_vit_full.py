"""The whole DeiT forward in one hand-written Hopper kernel (port of
``edgevisiontransformer_tpu/ops/pallas/fused_vit_full.py``).

The TPU kernels ``vit_full_forward`` (K7a: a grid over batch blocks and
layers) and ``vit_full_forward_pipelined`` (K7b: one program with
double-buffered weight DMA) run patch embedding, the encoder, the final
LayerNorm and the head in one ``pallas_call``; they differ only in TPU
blocking, so :func:`vit_full_forward` stands for both: one launch of the
persistent kernel ``csrc/vit_full.cu``, which reads the NCHW image itself
and writes ``[b, num_classes]`` logits.  Its arithmetic::

    x      = bf16(f32(patches @ patch_w) + f32(embed_bias))     # token 0: zero patches
    x      = the encoder of fused_encoder.encoder_forward, layer by layer
    logits = bf16(f32(LN(x[:, 0]) @ head_w) + f32(head_b))      # LN only with final_norm

:func:`vit_full_forward_plain` is its twin: :func:`embed_plain`, then
``fused_encoder.encoder_forward_plain``, then :func:`head_plain`, in fp32
with those cast points.  The wrapper takes the twin for CPU tensors only;
for CUDA tensors it launches the kernel or raises.  Every launch adds one to
:data:`LAUNCHES`.

The kernel's phases run the per-layer kernels' own tiles (``linear``'s
``mma.sync`` GEMM tile, ``attention_rows``' query strip, ``ln_rows``' row)
on warp groups of its persistent blocks; :func:`vit_full_plan` picks each
GEMM phase's tile, the attention strip's warps and the grid.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from . import build
from .common import no_backward
from .fused_encoder import (COMPUTE, _LOG2E, _entry, _linear_smem_bytes, _on_cpu, _sm_count,
                            _stream,
                            attention_plan, encoder_forward_plain, ln_rows_plain)

# Kernel launches since the last reset_launches().
LAUNCHES = {"vit_full": 0}

# The per-layer stack keys (fused_encoder.stack_vit_layer_params) and the
# rest of a prepared dict (models/vit.prepare_vit_full), in the kernel's
# pointer order.
STACK_KEYS = ("ln1_g", "ln1_b", "qkv_w", "qkv_b", "out_w", "out_b", "ln2_g", "ln2_b",
              "fc1_w", "fc1_b", "fc2_w", "fc2_b")
WEIGHT_KEYS = ("patch_w", "embed_bias", *STACK_KEYS, "fnorm_g", "fnorm_b", "head_w", "head_b")
# The block count of the last launch (the resident blocks, capped by the
# plan's grid).
LAST_GRID = {"blocks": 0}

# csrc/vit_full.cu: threads a block, the head dims it is compiled for, the
# GEMM tile shapes by code ((rows, cols, warp groups a block), in the
# kernel's order) and the phases that take one
VIT_FULL_THREADS = 256
VIT_FULL_HEAD_DIMS = (16, 32, 64, 128)
VIT_FULL_TILES = ((128, 96, 1), (16, 32, 4))
GEMM_PHASES = ("embed", "qkv", "out", "fc1", "fc2")
# The H100's shared memory an SM (228 KB) and the runtime's reserve a block
SM_SHARED_BYTES = 233472
BLOCK_RESERVE_BYTES = 1024


def barriers(depth: int) -> int:
    """Grid barriers in one forward: after the embedding, seven a layer
    (before LN1, qkv, attention, out, LN2, fc1, fc2), before the head."""
    return 1 + 7 * depth


@dataclass(frozen=True)
class VitFullPlan:
    """What one launch of csrc/vit_full.cu runs: the tile code
    (:data:`VIT_FULL_TILES`) of each GEMM phase in :data:`GEMM_PHASES`
    order, the warps of an attention strip (4 or 8), the grid cap and the
    blocks an SM of the kernel instance (2: at most 128 registers a thread;
    1: up to 255)."""

    tiles: tuple
    attn_warps: int
    grid: int
    blocks: int


def _gemm_tile(m: int, n: int, sms: int, rows: int | None) -> int:
    """The tile code of a GEMM phase ``[m, n]``: 128 x 96 where those tiles
    number at least the SMs, else 16 x 32 on four warp groups a block;
    ``rows`` (128 or 16) forces one or the other."""
    if rows is None:
        rows = 128 if -(-m // 128) * -(-n // 96) >= sms else 16
    return 0 if rows == 128 else 1


def gemm_shapes(batch: int, tokens: int, dim: int, heads: int, head_dim: int,
                mlp: int) -> tuple:
    """``(M, N)`` of each GEMM phase, in :data:`GEMM_PHASES` order."""
    m, inner = batch * tokens, heads * head_dim
    return (m, dim), (m, 3 * inner), (m, dim), (m, mlp), (m, dim)


def phase_blocks(plan: VitFullPlan, batch: int, tokens: int, dim: int, heads: int,
                 head_dim: int, mlp: int, classes: int) -> dict:
    """The blocks each phase's work fills: its tiles (GEMMs), 16-row query
    strips (attention), rows (LayerNorm, 8 a block) or head tiles (8 images
    by 256 classes) over the units a block runs at once."""
    out = {}
    for name, code, (m, n) in zip(GEMM_PHASES, plan.tiles,
                                  gemm_shapes(batch, tokens, dim, heads, head_dim, mlp)):
        rows, cols, groups = VIT_FULL_TILES[code]
        out[name] = -(-(-(-m // rows) * -(-n // cols)) // groups)
    strips = -(-tokens // (16 * plan.attn_warps)) * heads * batch
    out["attention"] = -(-strips // (VIT_FULL_THREADS // (32 * plan.attn_warps)))
    out["ln"] = -(-(batch * tokens) // (VIT_FULL_THREADS // 32))
    out["head"] = -(-batch // 8) * -(-classes // VIT_FULL_THREADS)
    return out


def vit_full_plan(batch: int, tokens: int, dim: int, heads: int, head_dim: int, mlp: int,
                  classes: int, sms: int, *, rows: int | None = None, grid: int | None = None,
                  blocks: int | None = None) -> VitFullPlan:
    """The plan of one csrc/vit_full.cu launch on a card of ``sms`` SMs.

    Each GEMM phase takes 128 x 96 tiles where they number at least the
    SMs, else 16 x 32 tiles, four a block on their own warp groups, so that
    a b1 phase spreads over the card (deit_tiny b1 fc1: 312 tiles where
    128 x 128 gave 12).  ``linear_plan`` takes 128 columns at N = 576 and
    768; here a 128 x 128 tile spilled at the kernel's 128 registers and
    lost to 128 x 96 (PERF.md section 6).  The attention strip takes
    ``attention_plan``'s warps: 8, or two strips of 4 a block.  The kernel
    instance holds two blocks an SM where a GEMM phase takes 128-row tiles
    (serving batches) and head_dim is at most 64, else one with twice the
    registers: at b1 it ran faster, at b128 slower, and at head_dim 128 the
    strip needs ~174 registers (``bench/vit_full_ab.py``, PERF.md section
    6).  The grid is the blocks the card holds at once capped by the phase
    that fills the most; ``grid`` caps it further and ``rows`` and
    ``blocks`` force a tile height and an instance (``bench/vit_full_ab.py``,
    the card tests).  No tile splits K and no strip splits the keys, so a
    row's output depends neither on the batch nor on the plan."""
    shapes = gemm_shapes(batch, tokens, dim, heads, head_dim, mlp)
    tiles = tuple(_gemm_tile(m, n, sms, rows) for m, n in shapes)
    if blocks is None:
        blocks = 2 if head_dim <= 64 and 0 in tiles else 1
    plan = VitFullPlan(tiles, attention_plan(batch, heads, tokens, sms), 0, blocks)
    need = max(phase_blocks(plan, batch, tokens, dim, heads, head_dim, mlp, classes).values())
    cap = min(blocks * sms, need, grid or need)
    return VitFullPlan(plan.tiles, plan.attn_warps, max(1, cap), blocks)


def vit_full_smem_bytes(plan: VitFullPlan, head_dim: int, dim: int) -> int:
    """The dynamic shared memory of one block (csrc/vit_full.cu
    ``smem_of``): the largest of its GEMM phases' rings (one per warp group,
    ``fused_encoder._linear_smem_bytes``), its attention strips' (Q rows and
    a 2-stage ring of 64-key K and V tiles at a row stride of head_dim + 8)
    and the head's fp32 cls rows."""
    most = 8 * dim * 4
    for code in plan.tiles:
        rows, cols, groups = VIT_FULL_TILES[code]
        most = max(most, groups * _linear_smem_bytes(rows, cols))
    strip = (plan.attn_warps * 16 + 2 * 2 * 64) * (head_dim + 8) * 2
    return max(most, VIT_FULL_THREADS // (32 * plan.attn_warps) * strip)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def patch_size(img: torch.Tensor, patch_w: torch.Tensor) -> int:
    """The patch side that makes ``patch_w``'s rows a patch of ``img``'s
    channels; raise when there is none or it does not tile the image."""
    b, c, hgt, wid = img.shape
    p = math.isqrt(patch_w.shape[0] // c) if patch_w.shape[0] % c == 0 else 0
    if p == 0 or p * p * c != patch_w.shape[0] or hgt != wid or hgt % p:
        raise ValueError(f"vit_full: image {tuple(img.shape)} does not cut into patches of "
                         f"patch_w{tuple(patch_w.shape)}")
    return p


def embed_plain(img: torch.Tensor, patch_w: torch.Tensor, embed_bias: torch.Tensor) -> torch.Tensor:
    """K7's embedding: the image rounded to ``patch_w.dtype`` and cut into
    ``(p1 p2 c)`` patches, an fp32 product, ``+ f32(embed_bias)`` (row 0,
    the cls token, has zero patches) and one cast: ``[b, tokens, dim]``."""
    dt = patch_w.dtype
    p = patch_size(img, patch_w)
    b, c, hgt, _ = img.shape
    g = hgt // p
    rows = img.to(dt).reshape(b, c, g, p, g, p).permute(0, 2, 4, 3, 5, 1).reshape(b, g * g, -1)
    emb = rows.float() @ patch_w.float()
    emb = torch.cat([emb.new_zeros(b, 1, emb.shape[2]), emb], dim=1)
    return (emb + embed_bias.float()).to(dt)


def head_plain(x: torch.Tensor, fnorm_g: torch.Tensor, fnorm_b: torch.Tensor,
               head_w: torch.Tensor, head_b: torch.Tensor, *, eps: float,
               final_norm: bool) -> torch.Tensor:
    """K7's head on the cls rows of ``x [b, tokens, dim]``: the final
    LayerNorm (``final_norm`` only), then ``f32(cls @ head_w) +
    f32(head_b)`` cast once."""
    cls = x[:, 0]
    if final_norm:
        cls = ln_rows_plain(cls, fnorm_g, fnorm_b, eps)
    return (cls.float() @ head_w.float() + head_b.float()).to(x.dtype)


def vit_full_forward_plain(img: torch.Tensor, prepared: dict, *, heads: int, head_dim: int,
                           eps: float, reference_residual: bool, approx_gelu: bool,
                           final_norm: bool) -> torch.Tensor:
    """:func:`vit_full_forward` through the plain twins on any device."""
    x = embed_plain(img, prepared["patch_w"], prepared["embed_bias"])
    x = encoder_forward_plain(x, prepared, heads=heads, head_dim=head_dim, eps=eps,
                              reference_residual=reference_residual, approx_gelu=approx_gelu)
    return head_plain(x, prepared["fnorm_g"], prepared["fnorm_b"], prepared["head_w"],
                      prepared["head_b"], eps=eps, final_norm=final_norm)


@no_backward
def vit_full_forward(img: torch.Tensor, prepared: dict, *, heads: int, head_dim: int,
                     eps: float, reference_residual: bool, approx_gelu: bool,
                     final_norm: bool) -> torch.Tensor:
    """The whole forward of ``img [b, c, H, H]`` (fp32 or the weights' dtype,
    NCHW) with the weights of ``models/vit.prepare_vit_full``: one launch of
    csrc/vit_full.cu on the plan of :func:`vit_full_plan` on a CUDA tensor,
    :func:`vit_full_forward_plain` on a CPU tensor.  Returns ``[b,
    num_classes]`` logits in the weights' dtype.

    On the GPU the weights are bf16 (or all fp16: the kernel's fp16
    instance), every width (dim, heads * head_dim, the
    MLP's) a multiple of 8 and ``head_dim`` 16, 32, 64 or 128.  The launch
    allocates its activation scratch with ``torch.empty`` and launches
    nothing else."""
    weights = [prepared[k] for k in WEIGHT_KEYS]
    if _on_cpu("vit_full", img, *weights, dtypes={0: (torch.float32, COMPUTE)},
               compute=weights[0].dtype):
        return vit_full_forward_plain(img, prepared, heads=heads, head_dim=head_dim, eps=eps,
                                      reference_residual=reference_residual,
                                      approx_gelu=approx_gelu, final_norm=final_norm)
    logits, grid = launch(_entry("evt_vit_full", weights[0]), img, prepared, heads=heads,
                          head_dim=head_dim, eps=eps, reference_residual=reference_residual,
                          approx_gelu=approx_gelu, final_norm=final_norm)
    LAUNCHES["vit_full"] += 1
    LAST_GRID["blocks"] = grid
    return logits


def launch(fn, img: torch.Tensor, prepared: dict, *, heads: int, head_dim: int, eps: float,
           reference_residual: bool, approx_gelu: bool, final_norm: bool,
           plan: VitFullPlan | None = None) -> tuple:
    """Check the shapes, allocate the scratch and the logits, and call ``fn``
    (``evt_vit_full`` of a built library, or its ``_f16`` instance for fp16
    weights) once on ``plan`` (default
    :func:`vit_full_plan`'s): ``(logits, grid)``.  Counts nothing:
    :func:`vit_full_forward` counts its launches, ``bench/vit_full_ab.py``
    calls other builds through this too."""
    if img.dim() != 4:
        raise ValueError(f"vit_full: img must be [b, c, H, W], got {tuple(img.shape)}")
    p = patch_size(img, prepared["patch_w"])
    bsz, chans, image, _ = img.shape
    tokens = (image // p) ** 2 + 1
    depth, dim, _ = prepared["qkv_w"].shape
    inner, mlp = heads * head_dim, prepared["fc1_w"].shape[2]
    classes = prepared["head_w"].shape[1]
    want = {"patch_w": (p * p * chans, dim), "embed_bias": (tokens, dim),
            "ln1_g": (depth, 1, dim), "ln1_b": (depth, 1, dim), "qkv_w": (depth, dim, 3 * inner),
            "qkv_b": (depth, 1, 3 * inner), "out_w": (depth, inner, dim),
            "out_b": (depth, 1, dim), "ln2_g": (depth, 1, dim), "ln2_b": (depth, 1, dim),
            "fc1_w": (depth, dim, mlp), "fc1_b": (depth, 1, mlp), "fc2_w": (depth, mlp, dim),
            "fc2_b": (depth, 1, dim), "fnorm_g": (dim,), "fnorm_b": (dim,),
            "head_w": (dim, classes), "head_b": (classes,)}
    for k, shape in want.items():
        if tuple(prepared[k].shape) != shape:
            raise ValueError(f"vit_full: {k}{tuple(prepared[k].shape)}, expected {shape} for "
                             f"heads={heads} head_dim={head_dim}")
    if head_dim not in VIT_FULL_HEAD_DIMS:
        raise ValueError(f"vit_full: head_dim must be 16, 32, 64 or 128, got {head_dim}")
    if dim % 8 or mlp % 8:
        raise ValueError(f"vit_full: dim ({dim}) and the MLP width ({mlp}) must be multiples "
                         f"of 8")
    if plan is None:
        plan = vit_full_plan(bsz, tokens, dim, heads, head_dim, mlp, classes,
                             _sm_count(img.device.index or 0))
    rows = bsz * tokens
    # one scratch allocation, cut into x, h, qkv, att, hid (every width a
    # multiple of 8, so each part starts on a 16-byte boundary)
    widths = (dim, dim, 3 * inner, inner, mlp)
    dt = prepared["patch_w"].dtype
    scratch = torch.empty(rows * sum(widths), dtype=dt, device=img.device)
    parts, start = [], 0
    for w in widths:
        parts.append(scratch[start:start + rows * w])
        start += rows * w
    logits = torch.empty((bsz, classes), dtype=dt, device=img.device)
    weights = [prepared[k] for k in WEIGHT_KEYS]
    ptrs = (ctypes.c_void_p * 25)(*(t.data_ptr() for t in (img, *weights, *parts, logits)))
    ints = (ctypes.c_int * 23)(bsz, depth, dim, heads, head_dim, mlp, classes, image, p, chans,
                               int(img.dtype == torch.float32), int(reference_residual),
                               int(approx_gelu), int(final_norm), *plan.tiles, plan.attn_warps,
                               plan.grid, plan.blocks, 0)
    floats = (ctypes.c_float * 2)(eps, head_dim ** -0.5 * _LOG2E)
    build.check(fn(ptrs, ints, floats, _stream(img)), "vit_full")
    return logits, ints[22]


def resident_blocks_per_sm(head_dim: int, blocks: int, smem: int,
                           dtype: torch.dtype = torch.bfloat16) -> int:
    """The blocks of csrc/vit_full.cu's instance for ``head_dim`` built for
    ``blocks`` an SM (at the element type ``dtype``) that one SM of the
    current card holds at once with ``smem`` bytes of shared memory each
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; ``chip_smoke.py``
    phase 2 prints it)."""
    out = ctypes.c_int(0)
    rc = build.entry("evt_vit_full_blocks_per_sm", dtype == torch.float16)(
        head_dim, blocks, smem, ctypes.byref(out))
    build.check(rc, "vit_full occupancy")
    return out.value


def barrier_probe(device, blocks: int, count: int) -> None:
    """Launch ``count`` grid barriers of csrc/vit_full.cu, and nothing else,
    on ``blocks`` blocks: what one barrier costs at a forward's block count
    (``chip_smoke.py`` times it).  Not a step of any forward, so not counted
    in :data:`LAUNCHES`."""
    rc = build.load().evt_vit_full_barrier_probe(
        blocks, count, ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    build.check(rc, "vit_full barrier probe")
