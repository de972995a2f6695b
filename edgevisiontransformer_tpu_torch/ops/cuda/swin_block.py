"""A Swin stage on hand-written Hopper kernels (port of
``edgevisiontransformer_tpu/ops/pallas/swin_block.py``, bf16).

The TPU runs a Swin block as one of three kernels: ``swin_stage_forward_pipelined``
(K9, every block of a stage in one program, weights double-buffered from
HBM, the shifted-window roll + partition as a one-hot permutation matmul)
or, where K9's VMEM gate or the depth parity refuses a stage,
``swin_block_forward`` (K11a, weights resident; K11b, the MLP streamed in
1024-wide hidden chunks).  All three compute one function: a pre-norm Swin
block on windows.  The split between them is how the weights fit in VMEM.
On a GPU nothing persists across thread blocks, so :func:`swin_stage_forward`
computes that function as a chain per block, on token-major rows
``[b*res*res, C]`` in image raster order::

    h   = ln_rows(x, ln1)
    qkv = linear(h, Wqkv, b, CAST_THEN_BIAS)
    a   = window_attention(qkv, bias, mask | None, res, w, shift)   # kernel W
    x   = linear(a, Wproj, b, BIAS_RESIDUAL, res=x)
    h2  = ln_rows(x, ln2)
    t   = linear(h2, W1, b, CAST_THEN_BIAS_GELU)
    x   = linear(t, W2, b, BIAS_RESIDUAL, res=x)

These are K9's cast points.  LayerNorm and the MLP act per token, so the
roll + partition bracket around the attention becomes index arithmetic in
kernel W: window ``(wy, wx)``, token ``(ty, tx)`` reads and writes the row of
pixel ``((wy*w + ty + shift) % res, (wx*w + tx + shift) % res)``.  No
permutation pass and no pad row exist.  One implementation serves every
stage and depth, odd or even: it is the port's counterpart of K9, K11a and
K11b.

K9's int8 mode (``int8=True``: per-row dynamic or calibrated per-tensor
static activation scales, int8 weights with per-(layer, out-channel)
scales) is :func:`swin_stage_forward_int8`: the same chain with each matmul
split into ``fused_encoder.quant_rows`` and ``fused_encoder.linear_i8``,
whose epilogues are K9's int8 cast points (``BIAS`` for qkv,
``BIAS_RESIDUAL`` for proj and fc2, ``BIAS_GELU`` for fc1).  Per-row and
per-tensor quantization do not care about row order, so the raster rows
carry over unchanged.

:func:`window_attention` has a plain PyTorch twin, which the wrapper takes
for CPU tensors only; for a CUDA tensor it launches the kernel or raises.
Every launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .common import no_backward, round_up, softmax_unnorm
from .fused_encoder import (BIAS, BIAS_GELU, BIAS_RESIDUAL, CAST_THEN_BIAS, CAST_THEN_BIAS_GELU,
                            _entry, _on_cpu, _ptr, _stream, linear, linear_i8, linear_i8_plain,
                            linear_plain, ln_rows, ln_rows_plain, quant_rows, quant_rows_plain)

# Kernel launches since the last reset_launches().
LAUNCHES = {"window_attention": 0}

_LOG2E = 1.4426950408889634
MAX_TOKENS = 144  # tokens per window the kernel holds (w <= 12)
# A stage's matmul weights, in the order of the int8 stacks' ``act_inv``
# columns (JAX ``models/swin.prepare_swin_int8``'s quantize keys).
MATMUL_KEYS = ("qkv_w", "proj_w", "fc1_w", "fc2_w")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def window_rows(res: int, window: int, shift: int, device=None) -> torch.Tensor:
    """``[nW * n]`` int64: the raster row (``y * res + x``) that token ``t``
    of window ``wi`` reads, at ``wi * n + t``, for the partition of the image
    rolled by ``-shift`` (``torch.roll`` then ``window_partition``)."""
    nb = res // window
    base = torch.arange(nb, device=device)[:, None] * window + torch.arange(window, device=device)
    pos = (base + shift) % res  # [nb, w]: the source coordinate of (window, offset)
    rows = pos[:, None, :, None] * res + pos[None, :, None, :]  # [wy, wx, ty, tx]
    return rows.reshape(-1)


def _check_geometry(what: str, rows: int, res: int, window: int, shift: int) -> None:
    if res % window or rows % (res * res) or not 0 <= shift < window:
        raise ValueError(f"{what}: {rows} rows do not fit res={res}, window={window}, "
                         f"shift={shift} (res % window == 0, 0 <= shift < window)")


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor | None, *,
                           res: int, window: int, shift: int, heads: int,
                           head_dim: int) -> torch.Tensor:
    """Attention within the windows of the image rolled by ``-shift``, in
    fp32 with the kernel's cast points.

    ``qkv [b*res*res, 3*heads*head_dim]`` holds each image's rows in raster
    order, columns ordered (qkv, head, hd); ``bias [heads, n, n]`` and
    ``mask [nW, n, n]`` are fp32, pre-scaled by log2(e).  Per (image,
    window, head): ``s = (q.k) * hd^-1/2 log2(e) + bias[h] (+ mask[win])``,
    ``p = exp2(min(s, 60))``, ``r = max(sum p, 1e-30)``, ``o = (bf16(p) @ v)
    * (1 / r)`` (for fp16 ``qkv`` the row max: ``p = exp2(s - max s)``, ``r
    = sum p``, as ``common.softmax_unnorm``).  Each output row goes back to the pixel its query came
    from.  Returns ``[b*res*res, heads*head_dim]`` in ``qkv.dtype``."""
    _check_geometry("window_attention", qkv.shape[0], res, window, shift)
    dt = qkv.dtype
    bsz = qkv.shape[0] // (res * res)
    nwin, n = (res // window) ** 2, window * window
    idx = window_rows(res, window, shift, qkv.device)
    rows = qkv.reshape(bsz, res * res, -1)[:, idx].float()
    parts = rows.reshape(bsz, nwin, n, 3, heads, head_dim).permute(3, 0, 1, 4, 2, 5)
    q, k, v = parts[0], parts[1], parts[2]  # [b, nW, h, n, hd]
    s = (q @ k.transpose(-1, -2)) * (head_dim ** -0.5 * _LOG2E) + bias.float()
    if mask is not None:
        s = s + mask.float()[None, :, None]
    p, r = softmax_unnorm(s, dt)
    o = (p.to(dt).float() @ v) * (1.0 / r)
    o = o.permute(0, 1, 3, 2, 4).reshape(bsz, nwin * n, heads * head_dim).to(dt)
    out = torch.empty((bsz, res * res, heads * head_dim), dtype=dt, device=qkv.device)
    out[:, idx] = o
    return out.reshape(bsz * res * res, heads * head_dim)


@no_backward
def window_attention(qkv: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor | None, *,
                     res: int, window: int, shift: int, heads: int,
                     head_dim: int) -> torch.Tensor:
    """:func:`window_attention_plain` as one kernel (csrc/window_attention.cu):
    one thread block per (window, head, image).  On the GPU ``qkv`` is bf16
    or fp16, ``bias`` and ``mask`` fp32, ``head_dim`` 32 or 64 and ``window**2 <=
    144`` (windows up to 12)."""
    tensors = (qkv, bias) + ((mask,) if mask is not None else ())
    f32 = (torch.float32,)
    if _on_cpu("window_attention", *tensors, dtypes={1: f32, 2: f32}):
        return window_attention_plain(qkv, bias, mask, res=res, window=window, shift=shift,
                                      heads=heads, head_dim=head_dim)
    _check_geometry("window_attention", qkv.shape[0], res, window, shift)
    nwin, n = (res // window) ** 2, window * window
    if qkv.dim() != 2 or qkv.shape[1] != 3 * heads * head_dim:
        raise ValueError(f"window_attention: qkv{tuple(qkv.shape)} does not fit heads={heads} "
                         f"head_dim={head_dim}")
    if head_dim not in (32, 64):
        raise ValueError(f"window_attention: head_dim must be 32 or 64, got {head_dim}")
    if n > MAX_TOKENS:
        raise ValueError(f"window_attention: window {window} has {n} tokens; the kernel "
                         f"holds at most {MAX_TOKENS}")
    if bias.shape != (heads, n, n) or (mask is not None and mask.shape != (nwin, n, n)):
        raise ValueError(f"window_attention: bias must be [{heads}, {n}, {n}] and mask "
                         f"[{nwin}, {n}, {n}], got {tuple(bias.shape)} "
                         f"{None if mask is None else tuple(mask.shape)}")
    bsz = qkv.shape[0] // (res * res)
    out = torch.empty((qkv.shape[0], heads * head_dim), dtype=qkv.dtype, device=qkv.device)
    if bsz == 0:
        return out
    rc = _entry("evt_window_attention", qkv)(
        _ptr(qkv), _ptr(bias), _ptr(mask) if mask is not None else None, _ptr(out), bsz, res,
        window, shift, heads, head_dim, ctypes.c_float(head_dim ** -0.5 * _LOG2E), _stream(qkv))
    build.check(rc, "window_attention")
    LAUNCHES["window_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# K9's VMEM gate (ops/pallas/swin_block.py:572-623), kept because it fixes
# the result: JAX prepare_swin_int8 makes int8 only the stages it admits at
# weight itemsize 1, and JAX fused_swin_apply re-checks it before it runs a
# stage in int8, so the stages that are int8 (the model's mixed precision)
# follow from it.  Nothing on the GPU is sized by it.
# ---------------------------------------------------------------------------

_STAGE_VMEM_HEADROOM = 40 * 1024 * 1024
_STAGE_VMEM_CAP = 100 * 1024 * 1024
# one-hot transition perms above this R switch to the banded factorization
_PERM_BANDED_THRESHOLD = 1024


def swin_stage_resident_bytes(c: int, hidden: int, itemsize: int, *, nwin: int, n_pad: int,
                              heads: int, act_itemsize: int = 2) -> int:
    """The TPU whole-stage kernel's resident VMEM bytes: double-buffered
    weight and bias slots plus, for a shifted stage, the transition
    permutation (full or banded) and the window mask.  ``itemsize`` is the
    weights' (1 in int8 mode), ``act_itemsize`` the activations'."""
    c_p = round_up(c, 128)
    hid_p = round_up(hidden, 128)
    wb2 = 2 * itemsize * (c * round_up(3 * c, 128) + c * c_p + c * hid_p + hid_p * c_p)
    wb2 += 2 * 4 * heads * n_pad * round_up(n_pad, 128)  # bias slots (f32)
    if nwin > 1:
        r_tot = nwin * n_pad
        if r_tot > _PERM_BANDED_THRESHOLD:
            nb = round(nwin ** 0.5)
            rb = nb * n_pad
            wb2 += 2 * nb * rb * rb * act_itemsize   # banded perm pair
        else:
            wb2 += r_tot * r_tot * act_itemsize      # full one-hot perm
        wb2 += nwin * n_pad * n_pad * 4              # shifted window mask (f32)
    return wb2


def swin_stage_pipelined_fits(c: int, hidden: int, depth: int, itemsize: int = 2, *,
                              nwin: int = 1, n_pad: int = 56, heads: int = 1,
                              act_itemsize: int | None = None) -> bool:
    """True where the TPU runs a stage as the whole-stage kernel K9: its
    resident bytes fit the VMEM budget and the depth fits the pair loop.
    The same function as the JAX package's, so both pick the same int8
    stages."""
    if nwin > 1 and depth % 2 != 0:
        return False
    wb2 = swin_stage_resident_bytes(c, hidden, itemsize, nwin=nwin, n_pad=n_pad, heads=heads,
                                    act_itemsize=act_itemsize or max(itemsize, 2))
    return (depth % 2 == 0 or depth <= 8) and wb2 + _STAGE_VMEM_HEADROOM <= _STAGE_VMEM_CAP


# ---------------------------------------------------------------------------
# The stage chain
# ---------------------------------------------------------------------------


def _stage(x, stage, ln, mm, attn, *, res, window, heads, head_dim, eps):
    """Every block of a stage; ``mm(h, i, j, res=None)`` is block ``i``'s
    matmul ``j`` (:data:`MATMUL_KEYS` order) with its epilogue."""
    depth = stage["qkv_w"].shape[0]
    shifted_stage = res > window  # more than one window: odd blocks shift
    for i in range(depth):
        shifted = shifted_stage and i % 2 == 1
        h = ln(x, stage["ln1_g"][i], stage["ln1_b"][i], eps)
        qkv = mm(h, i, 0)
        a = attn(qkv, stage["bias"][i], stage["mask"] if shifted else None, res=res,
                 window=window, shift=window // 2 if shifted else 0, heads=heads,
                 head_dim=head_dim)
        x = mm(a, i, 1, res=x)
        h2 = ln(x, stage["ln2_g"][i], stage["ln2_b"][i], eps)
        t = mm(h2, i, 2)
        x = mm(t, i, 3, res=x)
    return x


_BF16_EPILOGUES = (CAST_THEN_BIAS, BIAS_RESIDUAL, CAST_THEN_BIAS_GELU, BIAS_RESIDUAL)
_INT8_EPILOGUES = (BIAS, BIAS_RESIDUAL, BIAS_GELU, BIAS_RESIDUAL)


def _bf16_mm(stage, lin, approx_gelu):
    def mm(h, i, j, res=None):
        key = MATMUL_KEYS[j]
        return lin(h, stage[key][i], stage[key.replace("_w", "_b")][i],
                   epilogue=_BF16_EPILOGUES[j], res=res, approx_gelu=approx_gelu)
    return mm


def _int8_mm(stage, quant, lin, approx_gelu):
    """K9's ``imm``: quantize per row (dynamic) or by ``act_inv[i, j]``
    (static, read on the device at flat index ``i * 4 + j``), then the int8
    GEMM with the int8 epilogue, out in the activations' dtype."""
    act_inv = stage.get("act_inv")

    def mm(h, i, j, res=None):
        key = MATMUL_KEYS[j]
        q, s = quant(h, act_inv, i * len(MATMUL_KEYS) + j)
        return lin(q, s, stage[key][i], stage[key.replace("_w", "_s")][i, 0],
                   stage[key.replace("_w", "_b")][i], epilogue=_INT8_EPILOGUES[j],
                   out_dtype=h.dtype, res=res, approx_gelu=approx_gelu)
    return mm


def swin_stage_forward(x: torch.Tensor, stage: dict, *, res: int, window: int, heads: int,
                       head_dim: int, eps: float, approx_gelu: bool = False) -> torch.Tensor:
    """Every block of a Swin stage on ``x [b*res*res, C]`` (raster-order
    rows), with one stage of ``models/swin.prepare_swin_fused``: the kernels
    on a CUDA tensor, their twins on a CPU tensor.  Odd blocks of a stage
    with more than one window shift by ``window // 2`` and add the stage's
    mask."""
    return _stage(x, stage, ln_rows, _bf16_mm(stage, linear, approx_gelu), window_attention,
                  res=res, window=window, heads=heads, head_dim=head_dim, eps=eps)


def swin_stage_forward_plain(x: torch.Tensor, stage: dict, *, res: int, window: int, heads: int,
                             head_dim: int, eps: float, approx_gelu: bool = False) -> torch.Tensor:
    """:func:`swin_stage_forward` through the plain twins on any device: the
    reference the kernels are held to on the GPU."""
    return _stage(x, stage, ln_rows_plain, _bf16_mm(stage, linear_plain, approx_gelu),
                  window_attention_plain, res=res, window=window, heads=heads,
                  head_dim=head_dim, eps=eps)


def swin_stage_forward_int8(x: torch.Tensor, stage_q: dict, *, res: int, window: int, heads: int,
                            head_dim: int, eps: float, approx_gelu: bool = False) -> torch.Tensor:
    """K9's int8 mode: :func:`swin_stage_forward` with every matmul on
    ``quant_rows`` + ``linear_i8``.  ``stage_q`` is a
    ``models/swin.prepare_swin_int8[_static]`` stack (int8 ``*_w``, fp32
    ``*_s [L, 1, out]``, biases in the compute dtype, LN affines, and
    ``act_inv [L, 4]`` when static) with the stage's ``bias`` and ``mask``
    of ``prepare_swin_fused`` added."""
    return _stage(x, stage_q, ln_rows, _int8_mm(stage_q, quant_rows, linear_i8, approx_gelu),
                  window_attention, res=res, window=window, heads=heads, head_dim=head_dim,
                  eps=eps)


def swin_stage_forward_int8_plain(x: torch.Tensor, stage_q: dict, *, res: int, window: int,
                                  heads: int, head_dim: int, eps: float,
                                  approx_gelu: bool = False) -> torch.Tensor:
    """:func:`swin_stage_forward_int8` through the plain twins on any
    device."""
    return _stage(x, stage_q, ln_rows_plain,
                  _int8_mm(stage_q, quant_rows_plain, linear_i8_plain, approx_gelu),
                  window_attention_plain, res=res, window=window, heads=heads,
                  head_dim=head_dim, eps=eps)
