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
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .fused_encoder import _LOG2E, _on_cpu, _stream, encoder_forward_plain, ln_rows_plain

# Kernel launches since the last reset_launches().
LAUNCHES = {"vit_full": 0}

# The per-layer stack keys (fused_encoder.stack_vit_layer_params) and the
# rest of a prepared dict (models/vit.prepare_vit_full), in the kernel's
# pointer order.
STACK_KEYS = ("ln1_g", "ln1_b", "qkv_w", "qkv_b", "out_w", "out_b", "ln2_g", "ln2_b",
              "fc1_w", "fc1_b", "fc2_w", "fc2_b")
WEIGHT_KEYS = ("patch_w", "embed_bias", *STACK_KEYS, "fnorm_g", "fnorm_b", "head_w", "head_b")
# The block count of the last launch (the resident blocks, capped by the
# largest phase's tile count).
LAST_GRID = {"blocks": 0}


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


def vit_full_forward(img: torch.Tensor, prepared: dict, *, heads: int, head_dim: int,
                     eps: float, reference_residual: bool, approx_gelu: bool,
                     final_norm: bool) -> torch.Tensor:
    """The whole forward of ``img [b, c, H, H]`` (fp32 or bf16, NCHW) with
    the weights of ``models/vit.prepare_vit_full``: one launch of
    csrc/vit_full.cu on a CUDA tensor, :func:`vit_full_forward_plain` on a
    CPU tensor.  Returns ``[b, num_classes]`` logits in the weights' dtype.

    On the GPU the weights are bf16, every width (dim, heads * head_dim, the
    MLP's) a multiple of 8 and ``head_dim`` 32, 64 or 128.  The launch
    allocates its activation scratch with ``torch.empty`` and launches
    nothing else."""
    weights = [prepared[k] for k in WEIGHT_KEYS]
    if _on_cpu("vit_full", img, *weights, dtypes={0: (torch.float32, torch.bfloat16)}):
        return vit_full_forward_plain(img, prepared, heads=heads, head_dim=head_dim, eps=eps,
                                      reference_residual=reference_residual,
                                      approx_gelu=approx_gelu, final_norm=final_norm)
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
    if head_dim not in (32, 64, 128):
        raise ValueError(f"vit_full: head_dim must be 32, 64 or 128, got {head_dim}")
    if dim % 8 or mlp % 8:
        raise ValueError(f"vit_full: dim ({dim}) and the MLP width ({mlp}) must be multiples "
                         f"of 8")
    rows = bsz * tokens
    # one scratch allocation, cut into x, h, qkv, att, hid (every width a
    # multiple of 8, so each part starts on a 16-byte boundary)
    widths = (dim, dim, 3 * inner, inner, mlp)
    scratch = torch.empty(rows * sum(widths), dtype=torch.bfloat16, device=img.device)
    parts, start = [], 0
    for w in widths:
        parts.append(scratch[start:start + rows * w])
        start += rows * w
    logits = torch.empty((bsz, classes), dtype=torch.bfloat16, device=img.device)
    ptrs = (ctypes.c_void_p * 25)(*(t.data_ptr() for t in (img, *weights, *parts, logits)))
    ints = (ctypes.c_int * 15)(bsz, depth, dim, heads, head_dim, mlp, classes, image, p, chans,
                               int(img.dtype == torch.float32), int(reference_residual),
                               int(approx_gelu), int(final_norm), 0)
    floats = (ctypes.c_float * 2)(eps, head_dim ** -0.5 * _LOG2E)
    lib = build.load()
    rc = lib.evt_vit_full(ptrs, ints, floats, _stream(img))
    build.check(rc, "vit_full")
    LAUNCHES["vit_full"] += 1
    LAST_GRID["blocks"] = ints[14]
    return logits


def barrier_probe(device, blocks: int, count: int) -> None:
    """Launch ``count`` grid barriers of csrc/vit_full.cu, and nothing else,
    on ``blocks`` blocks: what one barrier costs at a forward's block count
    (``chip_smoke.py`` times it).  Not a step of any forward, so not counted
    in :data:`LAUNCHES`."""
    rc = build.load().evt_vit_full_barrier_probe(
        blocks, count, ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    build.check(rc, "vit_full barrier probe")
