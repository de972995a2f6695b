"""The T2T tokenizer's TokenPerformer after kqv on hand-written Hopper
kernels (port of ``edgevisiontransformer_tpu/ops/pallas/performer.py``,
``performer_rest``, K16).

The sums over every token (``kp_sum``, ``kptv``) are a reduction across
thread blocks, so :func:`performer_rest` is two launches::

    sums = performer_reduce(x_kqv, w)      # per image: kp_sum, kptv
    out  = performer_rows(x_kqv, sums)     # per 16 tokens a warp: the rest

``performer_reduce`` runs one block per (image, 64-token tile) and adds an
image's tile partials once, in a fixed order: the last block of each group
of :data:`GROUP` tiles adds the group's in tile order, the last group the
groups' in group order; so an image's sums do not depend on the batch.  Its
integer arrival counters (one per image and group) are allocated zeroed for
each call, on the call's stream: no state outlives a launch, so calls on
several streams at once, and CUDA graphs captured over the wrapper (the
zeroing is captured with the launch), need no care.
``performer_rows`` runs blocks of four warps.

The weights enter the kernels as :func:`performer_operands`: ``w``, ``wo``,
``w1`` and ``w2`` in one bf16 matrix and the five vectors in one fp32
matrix, which ``models/t2t_vit.prepare_t2t_fused`` builds once per model;
a caller that passes none has them cast on every call.

Each wrapper has its plain twin (``*_plain``) with K16's cast points, which
are not ``models/t2t_vit._performer_rest``'s: the kernel divides by
``max(d, 1e-8)`` where the eager chain adds ``1e-8``, and its
``attn_output`` product runs on the bf16-cast ``y`` against bf16 weights.
A wrapper takes its twin for CPU tensors only; for CUDA tensors it launches
its kernel or raises.  Every launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import math

import torch

from . import build
from .common import no_backward
from .fused_encoder import _on_cpu, _ptr, _stream, ln_rows_plain
from .mathlib import gelu_kernel

# Kernel launches since the last reset_launches(), by kernel.
LAUNCHES = {"performer_reduce": 0, "performer_rows": 0}

# The widths csrc/performer.cu is built for: t2t_vit's token size 64 and
# kernel_ratio 0.5 (m = 32 random features), an MLP of 64 hidden units.
TOKEN_SIZE, FEATURES = 64, 32
SUMS = FEATURES * (1 + TOKEN_SIZE)  # an image's kp_sum [m], then kptv [ts, m]
REDUCE_WARPS = 4                     # a performer_reduce block: 4 warps of 16 tokens
TILE = 16 * REDUCE_WARPS             # tokens per performer_reduce block
GROUP = 7                            # tiles whose partials the last of them adds
MAX_BATCH = 65535                    # the grid's y dimension
_F32 = (torch.float32,)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _groups(n: int) -> int:
    return -(-(-(-n // TILE)) // GROUP)


def performer_operands(p: dict, w: torch.Tensor) -> dict:
    """The weights in the layout the kernels read: ``{"mats": [m + 3 ts, ts]
    bf16 (w, attn_output, mlp_fc1, mlp_fc2 kernels), "vecs": [5, ts] fp32
    (attn_output bias, norm2 scale and bias, mlp_fc1 and mlp_fc2
    biases)}``.  Raises unless the widths are the kernels' (ts = 64, m = 32,
    a 64-unit MLP)."""
    ts, m = TOKEN_SIZE, FEATURES
    mats = [w, p["attn_output"]["kernel"], p["mlp_fc1_kernel"], p["mlp_fc2_kernel"]]
    vecs = [p["attn_output"]["bias"], p["norm2_scale"], p["norm2_bias"], p["mlp_fc1_bias"],
            p["mlp_fc2_bias"]]
    for t, shape in zip(mats + vecs, [(m, ts)] + [(ts, ts)] * 3 + [(ts,)] * 5):
        if tuple(t.shape) != shape:
            raise ValueError(f"the performer kernels are built for ts = {ts}, m = {m} and a "
                             f"{ts}-unit MLP; got a weight of shape {tuple(t.shape)}")
    return {"mats": torch.cat([t.to(torch.bfloat16) for t in mats]).contiguous(),
            "vecs": torch.stack([t.float() for t in vecs]).contiguous()}


def performer_reduce_plain(x_kqv: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reduction of K16 in fp32: each image's ``kp_sum [m]`` then
    ``kptv [ts, m]`` of ``kp = exp(k w^T - |k|^2 / 2) / sqrt(m)`` (padded
    rows excluded), as ``[b, m + ts m]`` (``w`` rounded to ``x_kqv.dtype``,
    as the kernel takes it).  Summed as the kernel sums: over each warp's 16
    tokens, the warps of a 64-token tile in order, the tiles of each group
    of :data:`GROUP` in order, the groups in order."""
    bsz, n, _ = x_kqv.shape
    k, _, v = x_kqv.chunk(3, dim=-1)
    m, ts = w.shape
    wf = w.to(x_kqv.dtype).float()
    kf = k.float()
    kp = torch.exp(kf @ wf.T - (kf * kf).sum(dim=-1, keepdim=True) * 0.5) \
        * (1.0 / math.sqrt(m))
    tiles = -(-n // TILE)
    if tiles == 0:
        return torch.zeros((bsz, m * (1 + ts)), dtype=torch.float32, device=x_kqv.device)
    pad = tiles * TILE - n
    kp = torch.nn.functional.pad(kp, (0, 0, 0, pad)).reshape(bsz, tiles, REDUCE_WARPS, 16, m)
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad)).reshape(bsz, tiles, REDUCE_WARPS,
                                                                     16, ts)
    warps = torch.cat([kp.sum(dim=3), (vf.transpose(3, 4) @ kp).flatten(3)], dim=3)
    tile = warps[:, :, 0]
    for i in range(1, REDUCE_WARPS):
        tile = tile + warps[:, :, i]
    groups = []
    for g0 in range(0, tiles, GROUP):
        group = tile[:, g0]
        for i in range(g0 + 1, min(g0 + GROUP, tiles)):
            group = group + tile[:, i]
        groups.append(group)
    out = groups[0]
    for group in groups[1:]:
        out = out + group
    return out


def performer_rows_plain(x_kqv: torch.Tensor, sums: torch.Tensor, p: dict, w: torch.Tensor, *,
                         eps_ln: float, approx_gelu: bool) -> torch.Tensor:
    """The rest of K16 in fp32 with its cast points, from the sums of
    :func:`performer_reduce_plain`: ``qp``, ``d = qp . kp_sum``, ``y =
    (qp kptv^T) / max(d, 1e-8)``, ``y2 = bf16(v + bf16(y) @ wo + bo)`` (the
    skip from v), the LayerNorm, the MLP on the bf16-cast hidden and the
    residual from ``y2``.  Returns ``[b, n, ts]`` in ``x_kqv.dtype``."""
    dt = x_kqv.dtype
    _, q, v = x_kqv.chunk(3, dim=-1)
    m, ts = w.shape
    wf = w.to(dt).float()
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
    if x_kqv.shape[0] > MAX_BATCH:
        raise ValueError(f"{what}: at most {MAX_BATCH} images a launch, got {x_kqv.shape[0]}")


@no_backward
def performer_reduce(x_kqv: torch.Tensor, w: torch.Tensor, *,
                     operands: dict | None = None) -> torch.Tensor:
    """:func:`performer_reduce_plain` as one kernel (csrc/performer.cu): one
    block per (image, 64-token tile), the image's sums added by its last
    blocks.  On the GPU ``x_kqv [b, n, 192]`` is
    bf16 and ``w [32, 64]`` is taken in bf16: the first rows of
    ``operands["mats"]`` where given, else cast here."""
    wb = operands["mats"][:FEATURES] if operands is not None else w.to(torch.bfloat16)
    if _on_cpu("performer_reduce", x_kqv, wb):
        return performer_reduce_plain(x_kqv, w)
    _check_x(x_kqv, "performer_reduce")
    if tuple(wb.shape) != (FEATURES, TOKEN_SIZE):
        raise ValueError(f"performer_reduce: the kernels are built for ts = {TOKEN_SIZE}, m = "
                         f"{FEATURES}; got w of shape {tuple(wb.shape)}")
    bsz, n, _ = x_kqv.shape
    sums = torch.empty((bsz, SUMS), dtype=torch.float32, device=x_kqv.device)
    if bsz == 0 or n == 0:
        return sums.zero_()
    groups = _groups(n)
    partial = torch.empty((bsz, -(-n // TILE) + groups, SUMS), dtype=torch.float32,
                          device=x_kqv.device)
    counters = torch.zeros(bsz * (1 + groups), dtype=torch.int32, device=x_kqv.device)
    rc = build.load().evt_performer_reduce(_ptr(x_kqv), _ptr(wb), _ptr(partial), _ptr(sums),
                                           _ptr(counters), bsz, n, _stream(x_kqv))
    build.check(rc, "performer_reduce")
    LAUNCHES["performer_reduce"] += 1
    return sums


@no_backward
def performer_rows(x_kqv: torch.Tensor, sums: torch.Tensor, p: dict, w: torch.Tensor, *,
                   eps_ln: float, approx_gelu: bool,
                   operands: dict | None = None) -> torch.Tensor:
    """:func:`performer_rows_plain` as one kernel (csrc/performer.cu): 16
    tokens a warp, four warps a block.  On the GPU the
    weights are :func:`performer_operands`' (``operands``, or built here
    from ``p`` and ``w``)."""
    ops = performer_operands(p, w) if operands is None else operands
    mats, vecs = ops["mats"], ops["vecs"]
    if _on_cpu("performer_rows", x_kqv, sums, mats, vecs, dtypes={1: _F32, 3: _F32}):
        return performer_rows_plain(x_kqv, sums, p, w, eps_ln=eps_ln, approx_gelu=approx_gelu)
    _check_x(x_kqv, "performer_rows")
    ts, m = TOKEN_SIZE, FEATURES
    if tuple(mats.shape) != (m + 3 * ts, ts) or tuple(vecs.shape) != (5, ts):
        raise ValueError(f"performer_rows: operands {tuple(mats.shape)}, {tuple(vecs.shape)} "
                         f"are not performer_operands' for ts = {ts}, m = {m}")
    bsz, n, _ = x_kqv.shape
    if tuple(sums.shape) != (bsz, SUMS):
        raise ValueError(f"performer_rows: sums{tuple(sums.shape)} is not "
                         f"performer_reduce's for x_kqv{tuple(x_kqv.shape)}")
    out = torch.empty((bsz, n, ts), dtype=torch.bfloat16, device=x_kqv.device)
    if bsz == 0 or n == 0:
        return out
    rc = build.load().evt_performer_rows(_ptr(x_kqv), _ptr(sums), _ptr(mats), _ptr(vecs),
                                         _ptr(out), bsz, n, eps_ln, int(approx_gelu),
                                         _stream(x_kqv))
    build.check(rc, "performer_rows")
    LAUNCHES["performer_rows"] += 1
    return out


def performer_rest(x_kqv: torch.Tensor, p: dict, w: torch.Tensor, *, eps_ln: float,
                   approx_gelu: bool, operands: dict | None = None) -> torch.Tensor:
    """K16: :func:`performer_rows` on :func:`performer_reduce`, two kernels
    on a CUDA tensor (``x_kqv [b, n, 192]`` bf16, ts = 64, m = 32 and a
    64-unit MLP), the twins on a CPU tensor.  ``operands``
    (:func:`performer_operands`, built once) spares the casts."""
    sums = performer_reduce(x_kqv, w, operands=operands)
    return performer_rows(x_kqv, sums, p, w, eps_ln=eps_ln, approx_gelu=approx_gelu,
                          operands=operands)
