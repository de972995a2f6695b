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

:func:`sdpa` launches csrc/sdpa.cu for CUDA tensors and takes
:func:`sdpa_plain` for CPU tensors only.  Every launch adds one to
:data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..attention import qkv_split
from . import build
from .common import no_backward
from .fused_encoder import COMPUTE_DTYPES, _entry, _ptr, _stream, check_head_dim

# Kernel launches since the last reset_launches().
LAUNCHES = {"sdpa": 0}


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
    one kernel (csrc/sdpa.cu), one thread block per (image * head, 64-query
    tile), its scores in registers; up to 256 keys (128 above ``d`` = 96) it
    holds every key in shared memory, beyond that it streams 64-key tiles
    twice, so any ``n`` runs.  The operands are read through their strides,
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
    rc = _entry("evt_sdpa", q)(_ptr(q), _ptr(k), _ptr(v), _ptr(out), strides, b, h, n, d,
                               ctypes.c_float(scale), _stream(q))
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
