"""The T2T tokenizer's TokenPerformer after kqv on hand-written Hopper
kernels (port of ``edgevisiontransformer_tpu/ops/pallas/performer.py``,
``performer_rest``, K16).

The sums over every token (``kp_sum``, ``kptv``) are a reduction across
thread blocks, so :func:`performer_rest` is two launches::

    partial = performer_reduce(x_kqv, w)       # per (image, 256-token chunk): kp_sum, kptv
    out     = performer_rows(x_kqv, partial)   # per (image, 64-token tile): the rest

Each wrapper has its plain twin (``*_plain``) with K16's cast points, which
are not ``models/t2t_vit._performer_rest``'s: the kernel divides by
``max(d, 1e-8)`` where the eager chain adds ``1e-8``, and its
``attn_output`` product runs on the bf16-cast ``y`` against bf16 weights.
A wrapper takes its twin for CPU tensors only; for CUDA tensors it launches
its kernel or raises.  Every launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .fused_encoder import _on_cpu, _ptr, _stream, ln_rows_plain
from .mathlib import gelu_kernel

# Kernel launches since the last reset_launches(), by kernel.
LAUNCHES = {"performer_reduce": 0, "performer_rows": 0}

# The widths csrc/performer.cu is built for: t2t_vit's token size 64 and
# kernel_ratio 0.5 (m = 32 random features), an MLP of 64 hidden units.
TOKEN_SIZE, FEATURES = 64, 32
CHUNK = 256  # tokens per performer_reduce block


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _chunks(n: int) -> int:
    return -(-n // CHUNK)


def performer_reduce_plain(x_kqv: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reduction of K16 in fp32: for each image and 256-token chunk,
    ``kp_sum [m]`` then ``kptv [ts, m]`` of ``kp = exp(k w^T - |k|^2 / 2) /
    sqrt(m)``, as ``[b, chunks, m + ts m]`` (``w`` rounded to
    ``x_kqv.dtype``, as the kernel takes it)."""
    bsz, n, _ = x_kqv.shape
    k, _, v = x_kqv.chunk(3, dim=-1)
    wf = w.to(x_kqv.dtype).float()
    kf = k.float()
    kp = torch.exp(kf @ wf.T - (kf * kf).sum(dim=-1, keepdim=True) * 0.5) \
        * (1.0 / math.sqrt(w.shape[0]))
    pad = _chunks(n) * CHUNK - n
    kp = torch.nn.functional.pad(kp, (0, 0, 0, pad)).reshape(bsz, -1, CHUNK, kp.shape[-1])
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad)).reshape(bsz, -1, CHUNK, v.shape[-1])
    kptv = vf.transpose(2, 3) @ kp                                   # [b, chunks, ts, m]
    return torch.cat([kp.sum(dim=2), kptv.flatten(2)], dim=2)


def performer_rows_plain(x_kqv: torch.Tensor, partial: torch.Tensor, p: dict, w: torch.Tensor, *,
                         eps_ln: float, approx_gelu: bool) -> torch.Tensor:
    """The rest of K16 in fp32 with its cast points, from the chunk partials
    of :func:`performer_reduce_plain`: ``qp``, ``d = qp . kp_sum``, ``y =
    (qp kptv^T) / max(d, 1e-8)``, ``y2 = bf16(v + bf16(y) @ wo + bo)`` (the
    skip from v), the LayerNorm, the MLP on the bf16-cast hidden and the
    residual from ``y2``.  Returns ``[b, n, ts]`` in ``x_kqv.dtype``."""
    dt = x_kqv.dtype
    _, q, v = x_kqv.chunk(3, dim=-1)
    m, ts = w.shape
    wf = w.to(dt).float()
    sums = partial.sum(dim=1)                                        # [b, m + ts m]
    kp_sum, kptv = sums[:, None, :m], sums[:, m:].reshape(-1, ts, m)
    qf = q.float()
    qp = torch.exp(qf @ wf.T - (qf * qf).sum(dim=-1, keepdim=True) * 0.5) \
        * (1.0 / math.sqrt(m))
    d = (qp * kp_sum).sum(dim=-1, keepdim=True)                      # [b, n, 1]
    y = (qp @ kptv.transpose(1, 2)) / torch.clamp(d, min=1e-8)
    vf = v.float()
    ao = y.to(dt).float() @ p["attn_output"]["kernel"].to(dt).float() \
        + p["attn_output"]["bias"].float()
    y2 = (vf + ao).to(dt)
    h = ln_rows_plain(y2.float(), p["norm2_scale"], p["norm2_bias"], eps_ln).to(dt)
    hid = h.float() @ p["mlp_fc1_kernel"].to(dt).float() + p["mlp_fc1_bias"].float()
    hid = gelu_kernel(hid.to(dt), approx_gelu)
    o = hid.float() @ p["mlp_fc2_kernel"].to(dt).float() + p["mlp_fc2_bias"].float()
    return (y2.float() + o).to(dt)


def performer_rest_plain(x_kqv: torch.Tensor, p: dict, w: torch.Tensor, *, eps_ln: float,
                         approx_gelu: bool) -> torch.Tensor:
    """K16 in fp32 with its cast points: :func:`performer_rows_plain` on
    :func:`performer_reduce_plain`.  ``x_kqv [b, n, 3 ts]`` holds k, q, v;
    ``p`` is the performer's param subtree (``attn_output``, ``norm2_*``,
    ``mlp_fc*``) and ``w [m, ts]`` its random-feature matrix."""
    return performer_rows_plain(x_kqv, performer_reduce_plain(x_kqv, w), p, w, eps_ln=eps_ln,
                                approx_gelu=approx_gelu)


def _check_x(x_kqv: torch.Tensor, what: str) -> None:
    if x_kqv.dim() != 3 or x_kqv.shape[2] != 3 * TOKEN_SIZE:
        raise ValueError(f"{what}: x_kqv must be [b, n, {3 * TOKEN_SIZE}], got "
                         f"{tuple(x_kqv.shape)}")


def _check_shapes(what: str, tensors, shapes) -> None:
    for t, shape in zip(tensors, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: the kernels are built for ts = {TOKEN_SIZE}, m = "
                             f"{FEATURES} and a {TOKEN_SIZE}-unit MLP; got a weight of shape "
                             f"{tuple(t.shape)}")


def performer_reduce(x_kqv: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`performer_reduce_plain` as one kernel (csrc/performer.cu): one
    block per (image, 256-token chunk).  On the GPU ``x_kqv [b, n, 192]`` is
    bf16 and ``w [32, 64]`` is taken in bf16."""
    wb = w.to(torch.bfloat16)
    if _on_cpu("performer_reduce", x_kqv, wb):
        return performer_reduce_plain(x_kqv, w)
    _check_x(x_kqv, "performer_reduce")
    _check_shapes("performer_reduce", (wb,), ((FEATURES, TOKEN_SIZE),))
    bsz, n, _ = x_kqv.shape
    partial = torch.empty((bsz, _chunks(n), FEATURES * (1 + TOKEN_SIZE)), dtype=torch.float32,
                          device=x_kqv.device)
    if bsz == 0 or n == 0:
        return partial
    rc = build.load().evt_performer_reduce(_ptr(x_kqv), _ptr(wb), _ptr(partial), bsz, n,
                                           _stream(x_kqv))
    build.check(rc, "performer_reduce")
    LAUNCHES["performer_reduce"] += 1
    return partial


def performer_rows(x_kqv: torch.Tensor, partial: torch.Tensor, p: dict, w: torch.Tensor, *,
                   eps_ln: float, approx_gelu: bool) -> torch.Tensor:
    """:func:`performer_rows_plain` as one kernel (csrc/performer.cu): one
    block per (image, 64-token tile).  On the GPU the weight matrices are
    taken in bf16 and the biases and LayerNorm affine in fp32 (cast here
    when they are not)."""
    dt = torch.bfloat16
    weights = [w.to(dt), p["attn_output"]["kernel"].to(dt), p["mlp_fc1_kernel"].to(dt),
               p["mlp_fc2_kernel"].to(dt)]
    vectors = [p["attn_output"]["bias"].float(), p["norm2_scale"].float(),
               p["norm2_bias"].float(), p["mlp_fc1_bias"].float(), p["mlp_fc2_bias"].float()]
    f32 = (torch.float32,)
    if _on_cpu("performer_rows", x_kqv, partial, *weights, *vectors,
               dtypes={i: f32 for i in (1, 6, 7, 8, 9, 10)}):
        return performer_rows_plain(x_kqv, partial, p, w, eps_ln=eps_ln, approx_gelu=approx_gelu)
    _check_x(x_kqv, "performer_rows")
    ts, m = TOKEN_SIZE, FEATURES
    _check_shapes("performer_rows", weights + vectors,
                  [(m, ts), (ts, ts), (ts, ts), (ts, ts)] + [(ts,)] * 5)
    bsz, n, _ = x_kqv.shape
    if tuple(partial.shape) != (bsz, _chunks(n), m * (1 + ts)):
        raise ValueError(f"performer_rows: partial{tuple(partial.shape)} is not "
                         f"performer_reduce's for x_kqv{tuple(x_kqv.shape)}")
    out = torch.empty((bsz, n, ts), dtype=dt, device=x_kqv.device)
    if bsz == 0 or n == 0:
        return out
    wb, wo, w1, w2 = weights
    bo, g2, be2, b1, b2 = vectors
    ptrs = (ctypes.c_void_p * 12)(*(t.data_ptr() for t in (
        x_kqv, wb, partial, wo, bo, g2, be2, w1, b1, w2, b2, out)))
    rc = build.load().evt_performer_rows(ptrs, bsz, n, ctypes.c_float(eps_ln), int(approx_gelu),
                                         _stream(x_kqv))
    build.check(rc, "performer_rows")
    LAUNCHES["performer_rows"] += 1
    return out


def performer_rest(x_kqv: torch.Tensor, p: dict, w: torch.Tensor, *, eps_ln: float,
                   approx_gelu: bool) -> torch.Tensor:
    """K16: :func:`performer_rows` on :func:`performer_reduce`, two kernels
    on a CUDA tensor (``x_kqv [b, n, 192]`` bf16, ts = 64, m = 32 and a
    64-unit MLP), the twins on a CPU tensor."""
    return performer_rows(x_kqv, performer_reduce(x_kqv, w), p, w, eps_ln=eps_ln,
                          approx_gelu=approx_gelu)
