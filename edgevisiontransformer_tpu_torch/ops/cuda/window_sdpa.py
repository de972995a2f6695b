"""Swin window attention on window-major tokens, on a hand-written Hopper
kernel (port of ``edgevisiontransformer_tpu/ops/pallas/window_attention.py``,
K12 ``window_sdpa``).

K12 serves the Swin module's ``kernel_mode="pallas"`` forward: the module
computes the fused qkv Dense on windows ``[b*nW, n, dim]`` and K12 does the
attention of every (window, head) in one program, with the
relative-position bias and, on shifted blocks, the window mask.  Its math is
not K9's: the score is ``f32(q.k) * hd^-1/2`` plus the bias (in the compute
dtype) and the mask (cast to the compute dtype), the softmax subtracts the
row max, uses ``exp`` and normalises ``p`` before the PV product, with
``p`` rounded to the compute dtype after normalising.

:func:`window_sdpa` launches csrc/window_sdpa.cu for CUDA tensors and takes
:func:`window_sdpa_plain` for CPU tensors only.  Every launch adds one to
:data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .common import no_backward
from .fused_encoder import _on_cpu, _ptr, _stream

# Kernel launches since the last reset_launches().
LAUNCHES = {"window_sdpa": 0}

MAX_TOKENS = 144  # tokens per window the kernel holds (w <= 12)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(qkv: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor | None, heads: int,
           head_dim: int) -> None:
    if qkv.dim() != 3 or qkv.shape[2] != 3 * heads * head_dim:
        raise ValueError(f"window_sdpa: qkv{tuple(qkv.shape)} is not [windows, n, "
                         f"{3 * heads * head_dim}] for heads={heads} head_dim={head_dim}")
    bw, n = qkv.shape[0], qkv.shape[1]
    if bias.shape != (heads, n, n):
        raise ValueError(f"window_sdpa: bias must be [{heads}, {n}, {n}], got {tuple(bias.shape)}")
    if mask is not None and (mask.dim() != 3 or mask.shape[1:] != (n, n) or mask.shape[0] == 0
                             or bw % mask.shape[0]):
        raise ValueError(f"window_sdpa: mask must be [nW, {n}, {n}] with nW dividing the "
                         f"{bw} windows, got {tuple(mask.shape)}")


def window_sdpa_plain(qkv: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor | None, *,
                      heads: int, head_dim: int) -> torch.Tensor:
    """K12's function in fp32 with its cast points.

    ``qkv [windows, n, 3*heads*head_dim]`` (columns ordered (qkv, head,
    hd)), ``bias [heads, n, n]``, ``mask [nW, n, n]`` or None, window ``j``
    taking ``mask[j % nW]``.  Per (window, head): ``s = f32(q.k) *
    hd^-1/2 + f32(bias[h]) (+ f32(mask[j % nW] cast to qkv.dtype))``, ``p =
    exp(s - max s) / sum``, ``o = bf16(p) @ v`` in fp32, cast to
    ``qkv.dtype``.  Returns ``[windows, n, heads*head_dim]``."""
    _check(qkv, bias, mask, heads, head_dim)
    dt = qkv.dtype
    bw, n = qkv.shape[0], qkv.shape[1]
    parts = qkv.float().reshape(bw, n, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
    q, k, v = parts[0], parts[1], parts[2]  # [bw, h, n, hd]
    s = (q @ k.transpose(-1, -2)) * head_dim ** -0.5 + bias.float()
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(bw // nw, nw, heads, n, n)
             + mask.to(dt).float()[None, :, None]).reshape(bw, heads, n, n)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = p.to(dt).float() @ v
    return o.permute(0, 2, 1, 3).reshape(bw, n, heads * head_dim).to(dt)


@no_backward
def window_sdpa(qkv: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor | None, *,
                heads: int, head_dim: int) -> torch.Tensor:
    """:func:`window_sdpa_plain` as one kernel (csrc/window_sdpa.cu): one
    thread block per (window, head).  On the GPU ``qkv`` and ``bias`` are
    bf16, ``mask`` fp32 (the module's constant), ``head_dim`` 32 or 64 and
    ``n <= 144``."""
    tensors = (qkv, bias) + ((mask,) if mask is not None else ())
    if _on_cpu("window_sdpa", *tensors, dtypes={2: (torch.float32,)}):
        return window_sdpa_plain(qkv, bias, mask, heads=heads, head_dim=head_dim)
    _check(qkv, bias, mask, heads, head_dim)
    if head_dim not in (32, 64):
        raise ValueError(f"window_sdpa: head_dim must be 32 or 64, got {head_dim}")
    bw, n = qkv.shape[0], qkv.shape[1]
    if n > MAX_TOKENS:
        raise ValueError(f"window_sdpa: {n} tokens per window; the kernel holds at most "
                         f"{MAX_TOKENS}")
    out = torch.empty((bw, n, heads * head_dim), dtype=qkv.dtype, device=qkv.device)
    if bw == 0:
        return out
    lib = build.load()
    rc = lib.evt_window_sdpa(_ptr(qkv), _ptr(bias), _ptr(mask) if mask is not None else None,
                             _ptr(out), bw, n, heads, head_dim,
                             mask.shape[0] if mask is not None else 0,
                             ctypes.c_float(head_dim ** -0.5), _stream(qkv))
    build.check(rc, "window_sdpa")
    LAUNCHES["window_sdpa"] += 1
    return out
