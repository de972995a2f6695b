"""The pre-norm ViT encoder on hand-written Hopper kernels (port of
``edgevisiontransformer_tpu/ops/pallas/fused_encoder.py``, bf16, fp16 and
int8).

The TPU kernels ``encoder_forward`` (grid over batch blocks and layers) and
``encoder_forward_pipelined`` (one program, double-buffered weight DMA) keep
a block of images in VMEM across every layer.  Nothing persists across
thread blocks on a GPU, so :func:`encoder_forward` computes the same
function as a short chain of three kernels per layer::

    h   = ln_rows(x, ln1)                                 # kernel A
    qkv = linear(h, Wqkv, b, CAST_THEN_BIAS)              # kernel B
    a   = attention_rows(qkv, heads, hd, tokens)          # kernel C
    x   = linear(a, Wout, b, BIAS_RESIDUAL, res=x | h)    # kernel B
    h2  = ln_rows(x, ln2)                                 # kernel A
    t   = linear(h2, W1, b, CAST_THEN_BIAS_GELU)          # kernel B
    x   = linear(t, W2, b, BIAS_RESIDUAL, res=x | h2)     # kernel B

One implementation serves every batch, so it is the counterpart of both TPU
kernels.  Activations are ``[b*n, dim]`` rows with no token padding: the
attention kernel masks keys at and past ``seq_len`` itself.

The int8 kernels ``encoder_forward_int8`` and ``encoder_forward_int8_pipelined``
become :func:`encoder_forward_int8`, the same chain with every matmul split
into an activation quantization and an int8 GEMM::

    q, s = quant_rows(h[, act_inv[i, j]])                  # kernel D
    y    = linear_i8(q, s, Wq, w_s, b, epilogue[, res])    # kernel E

dynamic (per-row absmax scales ``s``) or static (calibrated per-tensor
``act_inv``, folded into ``w_s``), as the stack says.

Each kernel wrapper has a plain PyTorch twin (``*_plain``) that computes in
fp32 with the kernel's cast points.  A wrapper takes its twin for a CPU
tensor only; for a CUDA tensor it launches the kernel or raises.  Every
launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build
from .common import no_backward, softmax_unnorm
from .mathlib import gelu_kernel

# Kernel launches since the last reset_launches(), by kernel.
LAUNCHES = {"ln_rows": 0, "linear": 0, "attention_rows": 0, "quant_rows": 0,
            "linear_i8": 0}

# linear() epilogues, with the kernel's cast points (acc is the fp32 sum):
#   CAST_THEN_BIAS       bf16(bf16(acc) + b)
#   CAST_THEN_BIAS_GELU  bf16(gelu_f32(bf16(bf16(acc) + b)))
#   BIAS_RESIDUAL        bf16(acc + f32(b) + f32(res))
CAST_THEN_BIAS = "cast_then_bias"
CAST_THEN_BIAS_GELU = "cast_then_bias_gelu"
BIAS_RESIDUAL = "bias_residual"
# Epilogue codes of csrc/linear.cu.
_EPI_CODES = {(CAST_THEN_BIAS, False): 0, (CAST_THEN_BIAS, True): 0,
              (CAST_THEN_BIAS_GELU, True): 1, (CAST_THEN_BIAS_GELU, False): 2,
              (BIAS_RESIDUAL, False): 3, (BIAS_RESIDUAL, True): 3}
# linear_i8() epilogues on the dequantized fp32 product ``deq``: they round
# once where CAST_THEN_BIAS rounds twice (fused_encoder.py:926-951).
#   BIAS                 bf16(deq + f32(b))
#   BIAS_GELU            bf16(gelu_f32(bf16(deq + f32(b))))
#   BIAS_RESIDUAL        bf16(deq + f32(b) + f32(res))
BIAS = "bias"
BIAS_GELU = "bias_gelu"
# Epilogue codes of csrc/linear_i8.cu.
_I8_EPI_CODES = {(BIAS, False): 0, (BIAS, True): 0, (BIAS_GELU, True): 1,
                 (BIAS_GELU, False): 2, (BIAS_RESIDUAL, False): 3,
                 (BIAS_RESIDUAL, True): 3}
# The int8 stacks' matmul weights, in act_inv's column order.
INT8_KEYS = ("qkv_w", "out_w", "fc1_w", "fc2_w")

_LOG2E = 1.4426950408889634


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _entry(name: str, t: torch.Tensor):
    """The entry point ``name`` of the kernel instance for ``t``'s dtype
    (``t`` holds the call's compute dtype: bf16, or fp16 for ``name_f16``)."""
    return build.entry(name, t.dtype == torch.float16)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# The element types the kernels have an instance for (csrc/common.cuh: bf16,
# and fp16 under build.py's F16_DEFINE).  A call's compute dtype is one of
# them; in a wrapper's ``dtypes``, COMPUTE stands for it.
COMPUTE_DTYPES = (torch.bfloat16, torch.float16)
COMPUTE = "compute"
_COMPUTE = (COMPUTE,)
# what an LN affine or a bias may be: the int8 stacks keep them in fp32
_COMPUTE_F32 = (COMPUTE, torch.float32)


def _on_cpu(what: str, *tensors: torch.Tensor, dtypes: dict | None = None,
            aligned: bool = True, compute: torch.dtype | None = None) -> bool:
    """True when every tensor is on the CPU (take the twin), False when all
    are on one CUDA device, contiguous and (unless ``aligned`` is False, for
    a kernel that masks unaligned rows itself) 16-byte aligned, in the
    call's compute dtype (``compute``, by default the first tensor's: bf16
    or fp16) or the dtypes that ``dtypes`` (tensor position -> allowed
    dtypes, :data:`COMPUTE` for the compute dtype) names for a tensor
    (launch); raise otherwise (``TypeError`` for a dtype: no tensor is
    cast, so fp16 activations with bf16 weights raise)."""
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{what}: tensors must all be on the CPU or all on one "
                         f"CUDA device, got {sorted(map(str, devs))}")
    compute = tensors[0].dtype if compute is None else compute
    if compute not in COMPUTE_DTYPES:
        raise TypeError(f"{what}: the CUDA kernel computes in bfloat16 or float16, "
                        f"got {compute}")
    for i, t in enumerate(tensors):
        allowed = tuple(compute if d == COMPUTE else d for d in (dtypes or {}).get(i, _COMPUTE))
        if t.dtype not in allowed:
            names = " or ".join(str(d).removeprefix("torch.") for d in allowed)
            raise TypeError(f"{what}: the CUDA kernel takes {names} here, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the CUDA kernel needs contiguous tensors")
        if aligned and t.data_ptr() % 16:
            raise ValueError(f"{what}: the CUDA kernel needs 16-byte aligned tensors")
    return False


# ---------------------------------------------------------------------------
# Kernel A: LayerNorm over rows
# ---------------------------------------------------------------------------


def ln_rows_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """fp32 mean, fp32 mean of squared deviations, ``rsqrt(var+eps)*g+b`` in
    fp32, cast to ``x.dtype``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * g.float() + b.float()
    return y.to(x.dtype)


@no_backward
def ln_rows(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
            eps: float) -> torch.Tensor:
    """LayerNorm of each row of ``x [rows, dim]`` (csrc/ln_rows.cu).  On the
    GPU ``x`` is bf16 or fp16 and the affine ``g``, ``b`` of its dtype or
    fp32 (both alike)."""
    if _on_cpu("ln_rows", x, g, b, dtypes={1: _COMPUTE_F32, 2: _COMPUTE_F32}):
        return ln_rows_plain(x, g, b, eps)
    if x.dim() != 2 or g.shape != (x.shape[1],) or b.shape != (x.shape[1],):
        raise ValueError(f"ln_rows: bad shapes x{tuple(x.shape)} "
                         f"g{tuple(g.shape)} b{tuple(b.shape)}")
    if g.dtype != b.dtype:
        raise TypeError(f"ln_rows: g and b differ in dtype ({g.dtype}, {b.dtype})")
    rows, dim = x.shape
    if dim % 8:
        raise ValueError(f"ln_rows: dim must be a multiple of 8, got {dim}")
    y = torch.empty_like(x)
    rc = _entry("evt_ln_rows", x)(_ptr(x), _ptr(g), _ptr(b), _ptr(y), rows, dim,
                                  ctypes.c_float(eps), int(g.dtype == torch.float32), _stream(x))
    build.check(rc, "ln_rows")
    LAUNCHES["ln_rows"] += 1
    return y


# ---------------------------------------------------------------------------
# Kernel B: GEMM with the encoder's epilogues
# ---------------------------------------------------------------------------

# csrc/linear_tile.cuh: the K step and ring depth, and the block shapes
# csrc/linear*.cu compile (rows by columns)
LINEAR_BK = 64
LINEAR_STAGES = 3
LINEAR_ROWS = (128, 64, 32, 16)
LINEAR_COLS = (32, 64, 96, 128)


def _linear_smem_bytes(rows: int, cols: int) -> int:
    """The dynamic shared memory of one block (csrc/linear_tile.cuh
    ``smem_bytes``): the ring of A tiles [rows, BK + 8] and W tiles [BK,
    cols + 8], bf16."""
    return LINEAR_STAGES * (rows * (LINEAR_BK + 8) + LINEAR_BK * (cols + 8)) * 2


def linear_plan(m: int, n: int, k: int, sms: int) -> tuple[int, int]:
    """The ``(rows, cols)`` of each block of csrc/linear.cu for ``x [m, k] @
    w [k, n]`` on a card of ``sms`` SMs.

    Columns in the fewest even tiles of at most 128, each of a compiled
    width (32, 64, 96 or 128), and 128 rows.  Where the blocks would be fewer
    than the SMs (small ``m``), the columns narrow to 32, then the rows to
    64, 32 and 16, until they are not.  ``bench/linear_ab.py`` chose these
    rules on the H100 (PERF.md section 6): wider tiles take more registers
    than two blocks an SM allow, and at b1 the most blocks win, since each
    walks its K alone.  ``k`` never changes the grid: every block walks all
    of it, so a row's output does not depend on the plan."""
    del k  # the plan never splits K
    tiles = -(-n // LINEAR_COLS[-1])
    rows, cols = LINEAR_ROWS[0], min(c for c in LINEAR_COLS if c * tiles >= n)

    def blocks() -> int:
        return -(-m // rows) * -(-n // cols)

    while cols > LINEAR_COLS[0] and blocks() < sms:
        cols = max(c for c in LINEAR_COLS if c < cols)
    while rows > LINEAR_ROWS[-1] and blocks() < sms:
        rows //= 2
    return rows, cols


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def linear_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                 epilogue: str, res: torch.Tensor | None = None,
                 approx_gelu: bool = False) -> torch.Tensor:
    """``x [M, K] @ w [K, N]`` in fp32 with the epilogue's cast points."""
    dt = x.dtype
    acc = x.float() @ w.float()
    if epilogue == BIAS_RESIDUAL:
        return (acc + b.float() + res.float()).to(dt)
    y = (acc.to(dt).float() + b.float()).to(dt)
    if epilogue == CAST_THEN_BIAS_GELU:
        y = gelu_kernel(y, approx_gelu)
    return y


@no_backward
def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
           epilogue: str, res: torch.Tensor | None = None,
           approx_gelu: bool = False) -> torch.Tensor:
    """Tiled bf16 or fp16 GEMM with fp32 accumulation and a fused epilogue
    (csrc/linear.cu, one launch on the grid :func:`linear_plan` picks), at
    any K and N.  ``res`` is required by ``BIAS_RESIDUAL`` only."""
    if (epilogue, approx_gelu) not in _EPI_CODES:
        raise ValueError(f"linear: unknown epilogue {epilogue!r}")
    if (res is not None) != (epilogue == BIAS_RESIDUAL):
        raise ValueError("linear: res is given exactly for BIAS_RESIDUAL")
    tensors = (x, w, b) + ((res,) if res is not None else ())
    if _on_cpu("linear", *tensors, aligned=False):
        return linear_plain(x, w, b, epilogue=epilogue, res=res,
                            approx_gelu=approx_gelu)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"linear: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if b.shape != (n,) or (res is not None and res.shape != (m, n)):
        raise ValueError(f"linear: bad bias/residual shape for N={n}")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m and n:
        rows, cols = linear_plan(m, n, k, _sm_count(x.device.index or 0))
        rc = _entry("evt_linear", x)(_ptr(x), _ptr(w), _ptr(b),
                                     _ptr(res) if res is not None else None, _ptr(y),
                                     m, n, k, _EPI_CODES[(epilogue, approx_gelu)], rows, cols,
                                     _stream(x))
        build.check(rc, "linear")
        LAUNCHES["linear"] += 1
    return y


# ---------------------------------------------------------------------------
# Kernel C: attention over the fused qkv columns
# ---------------------------------------------------------------------------


# csrc/attention_rows.cu, sdpa.cu and vit_full.cu: the head dims they take
# (every multiple of 8 from 16 to 128: ViT-H/14's 80, ViT-g/14's 88 and
# ViT-G/14's 104 among them), each run on the instance of the next multiple
# of 16 (head_dim_instance); and the warps (16-row query strips) a block of
# attention_rows.cu is compiled for
ATTENTION_HEAD_DIMS = tuple(range(16, 129, 8))
ATTENTION_WARPS = (4, 8)
# 8-warp blocks from this many blocks an SM on (bench/attention_ab.py)
ATTENTION_WIDE_BLOCKS_PER_SM = 1.5


def head_dim_instance(head_dim: int) -> int:
    """The head_dim of the kernel instance that runs ``head_dim`` (one of
    :data:`ATTENTION_HEAD_DIMS`): the next multiple of 16.  Its q, k and v
    rows are zero-filled to that width in shared memory, so the scores are
    unchanged, and the extra output columns are never stored."""
    return -(-head_dim // 16) * 16


def check_head_dim(what: str, head_dim: int) -> None:
    """Raise ``ValueError`` naming the limit unless a kernel instance runs
    ``head_dim``."""
    if head_dim not in ATTENTION_HEAD_DIMS:
        raise ValueError(f"{what}: head_dim must be a multiple of 8 from 16 to 128, "
                         f"got {head_dim}")


def attention_plan(batch: int, heads: int, tokens: int, sms: int) -> int:
    """The warps a block of csrc/attention_rows.cu holds for ``batch``
    images of ``tokens`` rows and ``heads`` heads on a card of ``sms`` SMs:
    8 where 8-warp blocks still number 1.5 an SM, else 4.

    Every block loads all of its (image, head)'s K and V, so more warps a
    block load less in all; but fewer, larger blocks spread less evenly
    over the SMs.  ``bench/attention_ab.py`` set the rule on the H100
    (PERF.md section 6): 8 warps won at deit_tiny b128, the pruned model's
    one head at b128 and deit_base at 384, 4 at b1 and deit_base b8 (1.45
    8-warp blocks an SM), and 1 or 2 warps nowhere, b1 included.  Each warp
    owns 16 query rows and walks all of its keys alone, so a row's output
    does not depend on the plan."""
    wide = -(-tokens // (16 * 8)) * heads * batch
    return 8 if wide >= ATTENTION_WIDE_BLOCKS_PER_SM * sms else 4


def attention_rows_plain(qkv: torch.Tensor, *, heads: int, head_dim: int,
                         tokens: int, seq_len: int | None = None) -> torch.Tensor:
    """Per-(image, head) exp2 attention with deferred normalisation.

    ``qkv [b*tokens, 3*heads*head_dim]`` holds each image's rows in turn;
    keys at index ``>= seq_len`` (default ``tokens``) are masked.  Returns
    ``[b*tokens, heads*head_dim]`` in ``qkv.dtype``."""
    seq_len = tokens if seq_len is None else seq_len
    dt = qkv.dtype
    rows = qkv.shape[0]
    bsz = rows // tokens
    parts = qkv.float().reshape(bsz, tokens, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
    q, k, v = parts[0], parts[1], parts[2]                   # [b, h, n, hd]
    scale2 = head_dim ** -0.5 * _LOG2E  # applied in fp32, as the kernel does
    key_bias = torch.where(torch.arange(tokens, device=qkv.device) < seq_len,
                           0.0, -1e30).to(torch.float32)
    s = (q @ k.transpose(-1, -2)) * scale2 + key_bias
    p, r = softmax_unnorm(s, dt)
    o = (p.to(dt).float() @ v) * (1.0 / r)
    return o.permute(0, 2, 1, 3).reshape(rows, heads * head_dim).to(dt)


@no_backward
def attention_rows(qkv: torch.Tensor, *, heads: int, head_dim: int,
                   tokens: int, seq_len: int | None = None) -> torch.Tensor:
    """Attention of :func:`attention_rows_plain` (csrc/attention_rows.cu):
    blocks of 16-row query strips of one (image, head), as many a block as
    :func:`attention_plan` picks.  ``head_dim`` a multiple of 8 from 16 to
    128 (:data:`ATTENTION_HEAD_DIMS`).  An fp16
    ``qkv`` takes the float16 softmax (the row max), as the twin does."""
    seq_len = tokens if seq_len is None else seq_len
    if _on_cpu("attention_rows", qkv):
        return attention_rows_plain(qkv, heads=heads, head_dim=head_dim,
                                    tokens=tokens, seq_len=seq_len)
    rows, cols = qkv.shape
    if cols != 3 * heads * head_dim or rows % tokens or not 0 <= seq_len <= tokens:
        raise ValueError(f"attention_rows: qkv{tuple(qkv.shape)} does not fit "
                         f"heads={heads} head_dim={head_dim} tokens={tokens} "
                         f"seq_len={seq_len}")
    check_head_dim("attention_rows", head_dim)
    out = torch.empty((rows, heads * head_dim), dtype=qkv.dtype, device=qkv.device)
    batch = rows // tokens
    warps = attention_plan(batch, heads, tokens, _sm_count(qkv.device.index or 0))
    rc = _entry("evt_attention_rows", qkv)(_ptr(qkv), _ptr(out), batch, tokens, seq_len, heads,
                                           head_dim, ctypes.c_float(head_dim ** -0.5 * _LOG2E),
                                           warps, _stream(qkv))
    build.check(rc, "attention_rows")
    LAUNCHES["attention_rows"] += 1
    return out


# ---------------------------------------------------------------------------
# Kernel D: int8 quantization of rows
# ---------------------------------------------------------------------------

# f32(1/127): the Pallas kernel's ``a / 127.0`` is evaluated as this product
# (fused_encoder.py:851; the JAX package's interpret mode gives it bit for bit)
_INV127 = 1.0 / 127.0


def quant_rows_plain(h: torch.Tensor, act_inv: torch.Tensor | None = None,
                     index: int = 0):
    """Symmetric int8 quantization of each row of ``h [M, K]``, in fp32.

    Dynamic (``act_inv`` None): ``s = a > 0 ? a * f32(1/127) : 1`` from the
    row absmax ``a``, ``q = clip(rint(h * (1/s)), +-127)``; returns ``(q, s)``
    with ``s [M]`` fp32 (``_quant_rows_kernel``, fused_encoder.py:844).
    Static: ``q = clip(rint(h * inv_a), +-127)`` with the calibrated scalar
    ``inv_a = act_inv.view(-1)[index]``; returns ``(q, None)``
    (``_int8_mm_static``, :873-877)."""
    hf = h.float()
    if act_inv is not None:
        inv = act_inv.reshape(-1)[index].float()
        return torch.clamp(torch.round(hf * inv), -127, 127).to(torch.int8), None
    a = hf.abs().amax(dim=-1)
    s = torch.where(a > 0, a * _INV127, torch.ones_like(a))
    q = torch.clamp(torch.round(hf * (1.0 / s)[:, None]), -127, 127).to(torch.int8)
    return q, s


@no_backward
def quant_rows(h: torch.Tensor, act_inv: torch.Tensor | None = None, index: int = 0):
    """:func:`quant_rows_plain` as one kernel (csrc/quant_rows.cu), at any
    K.  Static mode reads ``inv_a`` from ``act_inv`` on the device (flat
    ``index``: ``layer * 4 + matmul``), so a forward needs no host sync."""
    tensors = (h,) + ((act_inv,) if act_inv is not None else ())
    if _on_cpu("quant_rows", *tensors, dtypes={1: (torch.float32,)}, aligned=False):
        return quant_rows_plain(h, act_inv, index)
    if h.dim() != 2:
        raise ValueError(f"quant_rows: h must be [M, K], got {tuple(h.shape)}")
    if act_inv is not None and not 0 <= index < act_inv.numel():
        raise IndexError(f"quant_rows: index {index} outside act_inv{tuple(act_inv.shape)}")
    m, k = h.shape
    q = torch.empty((m, k), dtype=torch.int8, device=h.device)
    s = None if act_inv is not None else torch.empty(m, dtype=torch.float32, device=h.device)
    rc = _entry("evt_quant_rows", h)(_ptr(h), _ptr(q), _ptr(s) if s is not None else None,
                                     _ptr(act_inv) if act_inv is not None else None, index,
                                     m, k, _stream(h))
    build.check(rc, "quant_rows")
    LAUNCHES["quant_rows"] += 1
    return q, s


# ---------------------------------------------------------------------------
# Kernel E: int8 GEMM with the dequant and the int8 epilogues
# ---------------------------------------------------------------------------


# csrc/linear_i8_tile.cuh: the K step (int8 values) and ring depth, and the
# block shapes csrc/linear_i8.cu and i8_rows*.cu compile (rows by columns):
# linear's, since linear_i8_plan starts from linear_plan
LINEAR_I8_BK = 128
LINEAR_I8_STAGES = 3
LINEAR_I8_ROWS, LINEAR_I8_COLS = LINEAR_ROWS, LINEAR_COLS
# 128-row blocks an SM holds at once (registers and shared memory)
LINEAR_I8_BLOCKS_PER_SM = 2
# the K split at small M: at most this many blocks a cluster (the portable
# cluster size), each walking at least LINEAR_I8_SPLIT_STEPS K steps, while
# the blocks number fewer than LINEAR_I8_SPLIT_FILL an SM
LINEAR_I8_MAX_SPLIT = 8
LINEAR_I8_SPLIT_STEPS = 2
LINEAR_I8_SPLIT_FILL = 2


def _linear_i8_smem_bytes(rows: int, cols: int) -> int:
    """The dynamic shared memory of one block (csrc/linear_i8_tile.cuh
    ``smem_bytes``): the ring of Q tiles [rows, BK + 16] and W tiles [BK,
    cols + 16], int8."""
    return LINEAR_I8_STAGES * (rows * (LINEAR_I8_BK + 16) + LINEAR_I8_BK * (cols + 16))


def linear_i8_plan(m: int, n: int, k: int, sms: int) -> tuple[int, int, int]:
    """The ``(rows, cols, split)`` of csrc/linear_i8.cu's grid for ``q [m,
    k] @ w_q [k, n]`` on a card of ``sms`` SMs: each block's rows and
    columns, and the blocks of a cluster that share its K steps.

    :func:`linear_plan`'s rules over the int8 tile's block shapes (the same
    rows and column widths): columns in the fewest even tiles of at most 128
    and 128 rows; where the blocks would be fewer than the SMs, the columns
    narrow to 32, then the rows to 16, until they are not.  At 128 rows the
    grid runs in waves of two blocks an SM, and the next narrower width is
    taken where it fills the last wave better: ``bench/linear_i8_ab.py`` on
    the H100 (PERF.md section 6) found deit_tiny b128's fc1 (N = 768) 11%
    faster at 96 columns (5.97 waves) than at 128 (4.48), and qkv (N = 576)
    6% slower (4.48 waves against 3.73).  Where N is not a multiple of 16,
    W's loads and the epilogue go element by element, and narrow blocks of
    at least 32 rows took the least time (the pruned width 230: 48.7–52.1 µs
    at 128 x 32 against 53.3–53.9 at 128 x 128 at b128, 5.5 at 32 x 32
    against 6.9–7.0 at 16 x 32 at b1).

    Where the blocks still number fewer than ``LINEAR_I8_SPLIT_FILL`` an SM,
    clusters of ``split`` blocks share each tile's K steps, at least
    ``LINEAR_I8_SPLIT_STEPS`` a block, and rank 0 adds the int32 partials
    (deit_base b1's fc2, K = 3072: 24.9 µs unsplit, 14.6 at the plan's 2;
    every split lost at b128).  The sums are exact in any order, so a row's
    output does not depend on the plan or the batch."""
    rows, cols = linear_plan(m, n, k, sms)
    if rows == LINEAR_I8_ROWS[0] and cols > LINEAR_I8_COLS[0]:
        def last_wave(c: int) -> float:  # the filled share of the last wave
            waves = -(-m // rows) * -(-n // c) / (LINEAR_I8_BLOCKS_PER_SM * sms)
            return waves - math.ceil(waves) + 1
        narrower = max(c for c in LINEAR_I8_COLS if c < cols)
        if last_wave(narrower) > last_wave(cols):
            cols = narrower
    if n % 16:
        rows, cols = max(rows, 32), LINEAR_I8_COLS[0]
    blocks, steps = -(-m // rows) * -(-n // cols), -(-k // LINEAR_I8_BK)
    split = 1
    while (split < LINEAR_I8_MAX_SPLIT and blocks * split < LINEAR_I8_SPLIT_FILL * sms
           and steps // (split + 1) >= LINEAR_I8_SPLIT_STEPS):
        split += 1
    return rows, cols, split


def linear_i8_plain(q: torch.Tensor, s_row: torch.Tensor | None, w_q: torch.Tensor,
                    w_s: torch.Tensor, b: torch.Tensor, *, epilogue: str,
                    out_dtype: torch.dtype, res: torch.Tensor | None = None,
                    approx_gelu: bool = False) -> torch.Tensor:
    """``q [M, K] @ w_q [K, N]`` exactly, dequantized and finished in fp32.

    The product runs in float64, where every partial sum of int8 products
    (below 127^2 * K < 2^53) is exact, and is rounded once to fp32 as the
    int32 -> f32 cast rounds.  Dequant ``(acc * s_row) * w_s`` (dynamic) or
    ``acc * w_s`` (static, ``s_row`` None, ``w_s`` the combined scale)."""
    acc = (q.double() @ w_q.double()).float()
    deq = acc * s_row[:, None] * w_s if s_row is not None else acc * w_s
    y = deq + b.float()
    if epilogue == BIAS_RESIDUAL:
        return (y + res.float()).to(out_dtype)
    y = y.to(out_dtype)
    if epilogue == BIAS_GELU:
        y = gelu_kernel(y, approx_gelu)
    return y


@no_backward
def linear_i8(q: torch.Tensor, s_row: torch.Tensor | None, w_q: torch.Tensor,
              w_s: torch.Tensor, b: torch.Tensor, *, epilogue: str,
              out_dtype: torch.dtype, res: torch.Tensor | None = None,
              approx_gelu: bool = False) -> torch.Tensor:
    """:func:`linear_i8_plain` as one kernel (csrc/linear_i8.cu): int8
    ``mma.sync`` with int32 accumulation on the grid :func:`linear_i8_plan`
    picks, at any K and N.  On the GPU the output and ``res`` are
    ``out_dtype`` (bf16 or fp16) and ``b`` of that dtype or fp32."""
    if (epilogue, approx_gelu) not in _I8_EPI_CODES:
        raise ValueError(f"linear_i8: unknown epilogue {epilogue!r}")
    if (res is not None) != (epilogue == BIAS_RESIDUAL):
        raise ValueError("linear_i8: res is given exactly for BIAS_RESIDUAL")
    tensors = [q, w_q, w_s, b]
    dtypes = {0: (torch.int8,), 1: (torch.int8,), 2: (torch.float32,), 3: _COMPUTE_F32}
    if s_row is not None:
        dtypes[len(tensors)] = (torch.float32,)
        tensors.append(s_row)
    if res is not None:
        tensors.append(res)
    if _on_cpu("linear_i8", *tensors, dtypes=dtypes, aligned=False, compute=out_dtype):
        return linear_i8_plain(q, s_row, w_q, w_s, b, epilogue=epilogue,
                               out_dtype=out_dtype, res=res, approx_gelu=approx_gelu)
    if q.dim() != 2 or w_q.dim() != 2 or q.shape[1] != w_q.shape[0]:
        raise ValueError(f"linear_i8: bad shapes q{tuple(q.shape)} w{tuple(w_q.shape)}")
    m, k = q.shape
    n = w_q.shape[1]
    if (w_s.shape != (n,) or b.shape != (n,)
            or (s_row is not None and s_row.shape != (m,))
            or (res is not None and res.shape != (m, n))):
        raise ValueError(f"linear_i8: bad scale/bias/residual shape for M={m} N={n}")
    y = torch.empty((m, n), dtype=out_dtype, device=q.device)
    rows, cols, split = linear_i8_plan(m, n, k, _sm_count(q.device.index or 0))
    rc = _entry("evt_linear_i8", y)(_ptr(q), _ptr(s_row) if s_row is not None else None,
                                    _ptr(w_q), _ptr(w_s), _ptr(b),
                                    _ptr(res) if res is not None else None, _ptr(y), m, n, k,
                                    _I8_EPI_CODES[(epilogue, approx_gelu)],
                                    int(b.dtype == torch.float32), rows, cols, split, _stream(q))
    build.check(rc, "linear_i8")
    LAUNCHES["linear_i8"] += 1
    return y


# ---------------------------------------------------------------------------
# The encoder
# ---------------------------------------------------------------------------


def stack_vit_layer_params(params: dict, depth: int, qkv_bias: bool,
                           start: int = 0) -> dict:
    """Stack per-block params into ``[L, ...]`` tensors for
    :func:`encoder_forward`; vectors become ``[L, 1, d]``.

    ``params`` is a ViT parameter tree keyed as the Flax one
    (``params["block_0"]["attn"]["qkv_kernel"]``; ``models.vit.ViT.params()``
    gives it).  ``start`` is the first block index of the run."""
    def stack(getter):
        out = torch.stack([getter(params[f"block_{i}"])
                           for i in range(start, start + depth)])
        return out[:, None, :] if out.dim() == 2 else out

    qkv_kernel = params[f"block_{start}"]["attn"]["qkv_kernel"]
    return {
        "ln1_g": stack(lambda b: b["ln1"]["scale"]),
        "ln1_b": stack(lambda b: b["ln1"]["bias"]),
        "qkv_w": stack(lambda b: b["attn"]["qkv_kernel"]),
        "qkv_b": stack(lambda b: b["attn"]["qkv_bias"]) if qkv_bias
        else torch.zeros((depth, 1, qkv_kernel.shape[1]), dtype=qkv_kernel.dtype,
                         device=qkv_kernel.device),
        "out_w": stack(lambda b: b["attn"]["out_kernel"]),
        "out_b": stack(lambda b: b["attn"]["out_bias"]),
        "ln2_g": stack(lambda b: b["ln2"]["scale"]),
        "ln2_b": stack(lambda b: b["ln2"]["bias"]),
        "fc1_w": stack(lambda b: b["ffn"]["fc1_kernel"]),
        "fc1_b": stack(lambda b: b["ffn"]["fc1_bias"]),
        "fc2_w": stack(lambda b: b["ffn"]["fc2_kernel"]),
        "fc2_b": stack(lambda b: b["ffn"]["fc2_bias"]),
    }


def stack_vit_layer_params_packed(params: dict, heads_per_layer, mlp_per_layer,
                                  head_dim: int, qkv_bias: bool) -> dict:
    """One uniform ``[L, ...]`` stack of every layer of a layerwise-pruned
    model, each zero-padded to the largest heads and MLP width, so the whole
    depth runs as one encoder chain with the largest heads.

    Exact: a padded head has zero q, k and v columns (its attention output
    is ``p @ 0 = 0``) and zero out-projection rows; a padded MLP unit has
    zero fc1 weights and bias (``gelu(0) = 0``) and a zero fc2 row.  The
    cost is the padded layers' extra work."""
    hmax, mlp_max = max(heads_per_layer), max(mlp_per_layer)

    def pad_to(a, size, axis):
        shape = list(a.shape)
        shape[axis] = size - a.shape[axis]
        return torch.cat([a, a.new_zeros(shape)], dim=axis)

    def pad_qkv(a, h, axis):  # each of the q, k, v sections to hmax heads
        return torch.cat([pad_to(sec, hmax * head_dim, axis)
                          for sec in a.split(h * head_dim, dim=axis)], dim=axis)

    rows = []
    for i, (h, m) in enumerate(zip(heads_per_layer, mlp_per_layer)):
        b = params[f"block_{i}"]
        qkv_w = b["attn"]["qkv_kernel"]
        qkv_b = b["attn"]["qkv_bias"] if qkv_bias else qkv_w.new_zeros(3 * h * head_dim)
        rows.append({
            "ln1_g": b["ln1"]["scale"], "ln1_b": b["ln1"]["bias"],
            "qkv_w": pad_qkv(qkv_w, h, 1), "qkv_b": pad_qkv(qkv_b, h, 0),
            "out_w": pad_to(b["attn"]["out_kernel"], hmax * head_dim, 0),
            "out_b": b["attn"]["out_bias"],
            "ln2_g": b["ln2"]["scale"], "ln2_b": b["ln2"]["bias"],
            "fc1_w": pad_to(b["ffn"]["fc1_kernel"], mlp_max, 1),
            "fc1_b": pad_to(b["ffn"]["fc1_bias"], mlp_max, 0),
            "fc2_w": pad_to(b["ffn"]["fc2_kernel"], mlp_max, 0),
            "fc2_b": b["ffn"]["fc2_bias"],
        })
    out = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    return {k: v[:, None, :] if v.dim() == 2 else v for k, v in out.items()}


def _encoder(x, stacked, ln, lin, attn, *, heads, head_dim, eps,
             reference_residual, approx_gelu):
    b, n, dim = x.shape
    depth = stacked["qkv_w"].shape[0]
    x = x.reshape(b * n, dim).contiguous()
    for i in range(depth):
        h = ln(x, stacked["ln1_g"][i, 0], stacked["ln1_b"][i, 0], eps)
        qkv = lin(h, stacked["qkv_w"][i], stacked["qkv_b"][i, 0],
                  epilogue=CAST_THEN_BIAS)
        a = attn(qkv, heads=heads, head_dim=head_dim, tokens=n)
        x = lin(a, stacked["out_w"][i], stacked["out_b"][i, 0],
                epilogue=BIAS_RESIDUAL, res=h if reference_residual else x)
        h2 = ln(x, stacked["ln2_g"][i, 0], stacked["ln2_b"][i, 0], eps)
        t = lin(h2, stacked["fc1_w"][i], stacked["fc1_b"][i, 0],
                epilogue=CAST_THEN_BIAS_GELU, approx_gelu=approx_gelu)
        x = lin(t, stacked["fc2_w"][i], stacked["fc2_b"][i, 0],
                epilogue=BIAS_RESIDUAL, res=h2 if reference_residual else x)
    return x.reshape(b, n, dim)


def encoder_forward(x: torch.Tensor, stacked: dict, *, heads: int,
                    head_dim: int, eps: float, reference_residual: bool = False,
                    approx_gelu: bool = False) -> torch.Tensor:
    """Run the encoder on ``x [b, n, dim]`` with the stacked params of
    :func:`stack_vit_layer_params` (already in ``x.dtype``): the kernels on
    a CUDA tensor, their twins on a CPU tensor."""
    return _encoder(x, stacked, ln_rows, linear, attention_rows, heads=heads,
                    head_dim=head_dim, eps=eps,
                    reference_residual=reference_residual,
                    approx_gelu=approx_gelu)


def encoder_forward_plain(x: torch.Tensor, stacked: dict, *, heads: int,
                          head_dim: int, eps: float,
                          reference_residual: bool = False,
                          approx_gelu: bool = False) -> torch.Tensor:
    """:func:`encoder_forward` through the plain twins on any device: the
    reference the kernels are held to on the GPU."""
    return _encoder(x, stacked, ln_rows_plain, linear_plain,
                    attention_rows_plain, heads=heads, head_dim=head_dim,
                    eps=eps, reference_residual=reference_residual,
                    approx_gelu=approx_gelu)


# ---------------------------------------------------------------------------
# The int8 encoder
# ---------------------------------------------------------------------------


def quantize_stacked_int8(stacked: dict, keys=INT8_KEYS) -> dict:
    """Quantize the ``[L, in, out]`` weights of a stack to int8 with
    per-(layer, output-channel) fp32 scales ``*_s [L, 1, out]``
    (``ops/quant.quantize_weight_int8`` per layer); the rest is kept as it
    is.  The divisions are IEEE quotients, as JAX's eager ones are."""
    out = dict(stacked)
    for key in keys:
        w = stacked[key].float()
        absmax = w.abs().amax(dim=1, keepdim=True)
        s = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
        out[key] = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
        out[key.replace("_w", "_s")] = s
    return out


def quantize_stacked_int8_static(stacked: dict, act_scales, keys=INT8_KEYS) -> dict:
    """:func:`quantize_stacked_int8` with the calibrated per-(layer, matmul)
    activation scales ``act_scales [L, len(keys)]`` folded into the weight
    scales, and exported inverted as ``act_inv [L, len(keys)]`` fp32."""
    out = quantize_stacked_int8(stacked, keys)
    act = torch.as_tensor(act_scales, dtype=torch.float32, device=stacked[keys[0]].device)
    for j, key in enumerate(keys):
        skey = key.replace("_w", "_s")
        out[skey] = out[skey] * act[:, j][:, None, None]
    out["act_inv"] = 1.0 / act
    return out


def _encoder_int8(x, sq, ln, quant, lin, attn, *, heads, head_dim, eps,
                  reference_residual, approx_gelu):
    b, n, dim = x.shape
    dt = x.dtype
    depth = sq["qkv_w"].shape[0]
    act_inv = sq.get("act_inv")

    def mm(h, i, j, epilogue, res=None):
        key = INT8_KEYS[j]
        skey, bkey = key.replace("_w", "_s"), key.replace("_w", "_b")
        q, s = quant(h, act_inv, i * len(INT8_KEYS) + j)
        return lin(q, s, sq[key][i], sq[skey][i, 0], sq[bkey][i, 0], epilogue=epilogue,
                   out_dtype=dt, res=res, approx_gelu=approx_gelu)

    x = x.reshape(b * n, dim).contiguous()
    for i in range(depth):
        h = ln(x, sq["ln1_g"][i, 0], sq["ln1_b"][i, 0], eps)
        qkv = mm(h, i, 0, BIAS)
        a = attn(qkv, heads=heads, head_dim=head_dim, tokens=n)
        x = mm(a, i, 1, BIAS_RESIDUAL, res=h if reference_residual else x)
        h2 = ln(x, sq["ln2_g"][i, 0], sq["ln2_b"][i, 0], eps)
        t = mm(h2, i, 2, BIAS_GELU)
        x = mm(t, i, 3, BIAS_RESIDUAL, res=h2 if reference_residual else x)
    return x.reshape(b, n, dim)


def encoder_forward_int8(x: torch.Tensor, stacked_q: dict, *, heads: int,
                         head_dim: int, eps: float, reference_residual: bool = False,
                         approx_gelu: bool = False) -> torch.Tensor:
    """Run the int8 encoder on ``x [b, n, dim]`` with a
    :func:`quantize_stacked_int8` stack (dynamic per-row activation scales)
    or a :func:`quantize_stacked_int8_static` one (``act_inv`` present:
    calibrated per-tensor scales): the kernels on a CUDA tensor, their twins
    on a CPU tensor.  The counterpart of both TPU kernels
    ``encoder_forward_int8`` and ``encoder_forward_int8_pipelined``."""
    return _encoder_int8(x, stacked_q, ln_rows, quant_rows, linear_i8, attention_rows,
                         heads=heads, head_dim=head_dim, eps=eps,
                         reference_residual=reference_residual, approx_gelu=approx_gelu)


def encoder_forward_int8_plain(x: torch.Tensor, stacked_q: dict, *, heads: int,
                               head_dim: int, eps: float,
                               reference_residual: bool = False,
                               approx_gelu: bool = False) -> torch.Tensor:
    """:func:`encoder_forward_int8` through the plain twins on any device."""
    return _encoder_int8(x, stacked_q, ln_rows_plain, quant_rows_plain, linear_i8_plain,
                         attention_rows_plain, heads=heads, head_dim=head_dim, eps=eps,
                         reference_residual=reference_residual, approx_gelu=approx_gelu)
