"""The pre-norm ViT encoder on hand-written Hopper kernels (port of the bf16
half of ``edgevisiontransformer_tpu/ops/pallas/fused_encoder.py``).

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

Each kernel wrapper has a plain PyTorch twin (``*_plain``) that computes in
fp32 with the kernel's cast points.  A wrapper takes its twin for a CPU
tensor only; for a CUDA tensor it launches the kernel or raises.  Every
launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .common import softmax_unnorm
from .mathlib import gelu_kernel

# Kernel launches since the last reset_launches(), by kernel.
LAUNCHES = {"ln_rows": 0, "linear": 0, "attention_rows": 0}

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

_LOG2E = 1.4426950408889634


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _on_cpu(what: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU (take the twin), False when all
    are on one CUDA device in bf16 and contiguous (launch); raise otherwise."""
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{what}: tensors must all be on the CPU or all on one "
                         f"CUDA device, got {sorted(map(str, devs))}")
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: the CUDA kernel takes bfloat16 only, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the CUDA kernel needs contiguous tensors")
        if t.data_ptr() % 16:
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


def ln_rows(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
            eps: float) -> torch.Tensor:
    """LayerNorm of each row of ``x [rows, dim]`` (csrc/ln_rows.cu)."""
    if _on_cpu("ln_rows", x, g, b):
        return ln_rows_plain(x, g, b, eps)
    if x.dim() != 2 or g.shape != (x.shape[1],) or b.shape != (x.shape[1],):
        raise ValueError(f"ln_rows: bad shapes x{tuple(x.shape)} "
                         f"g{tuple(g.shape)} b{tuple(b.shape)}")
    rows, dim = x.shape
    if dim % 8:
        raise ValueError(f"ln_rows: dim must be a multiple of 8, got {dim}")
    y = torch.empty_like(x)
    lib = build.load()
    rc = lib.evt_ln_rows(_ptr(x), _ptr(g), _ptr(b), _ptr(y), rows, dim,
                         ctypes.c_float(eps), _stream(x))
    build.check(rc, "ln_rows")
    LAUNCHES["ln_rows"] += 1
    return y


# ---------------------------------------------------------------------------
# Kernel B: GEMM with the encoder's epilogues
# ---------------------------------------------------------------------------


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


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
           epilogue: str, res: torch.Tensor | None = None,
           approx_gelu: bool = False) -> torch.Tensor:
    """Tiled bf16 GEMM with fp32 accumulation and a fused epilogue
    (csrc/linear.cu).  ``res`` is required by ``BIAS_RESIDUAL`` only."""
    if (epilogue, approx_gelu) not in _EPI_CODES:
        raise ValueError(f"linear: unknown epilogue {epilogue!r}")
    if (res is not None) != (epilogue == BIAS_RESIDUAL):
        raise ValueError("linear: res is given exactly for BIAS_RESIDUAL")
    tensors = (x, w, b) + ((res,) if res is not None else ())
    if _on_cpu("linear", *tensors):
        return linear_plain(x, w, b, epilogue=epilogue, res=res,
                            approx_gelu=approx_gelu)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"linear: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if b.shape != (n,) or (res is not None and res.shape != (m, n)):
        raise ValueError(f"linear: bad bias/residual shape for N={n}")
    if k % 8 or n % 8:
        raise ValueError(f"linear: K and N must be multiples of 8, got K={k} N={n}")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = build.load()
    rc = lib.evt_linear(_ptr(x), _ptr(w), _ptr(b),
                        _ptr(res) if res is not None else None, _ptr(y),
                        m, n, k, _EPI_CODES[(epilogue, approx_gelu)], _stream(x))
    build.check(rc, "linear")
    LAUNCHES["linear"] += 1
    return y


# ---------------------------------------------------------------------------
# Kernel C: attention over the fused qkv columns
# ---------------------------------------------------------------------------


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


def attention_rows(qkv: torch.Tensor, *, heads: int, head_dim: int,
                   tokens: int, seq_len: int | None = None) -> torch.Tensor:
    """Attention of :func:`attention_rows_plain` (csrc/attention_rows.cu):
    one thread block per (image, head, 64-query tile)."""
    seq_len = tokens if seq_len is None else seq_len
    if _on_cpu("attention_rows", qkv):
        return attention_rows_plain(qkv, heads=heads, head_dim=head_dim,
                                    tokens=tokens, seq_len=seq_len)
    rows, cols = qkv.shape
    if cols != 3 * heads * head_dim or rows % tokens or not 0 <= seq_len <= tokens:
        raise ValueError(f"attention_rows: qkv{tuple(qkv.shape)} does not fit "
                         f"heads={heads} head_dim={head_dim} tokens={tokens} "
                         f"seq_len={seq_len}")
    if head_dim not in (32, 64, 128):
        raise ValueError(f"attention_rows: head_dim must be 32, 64 or 128, got {head_dim}")
    out = torch.empty((rows, heads * head_dim), dtype=qkv.dtype, device=qkv.device)
    lib = build.load()
    rc = lib.evt_attention_rows(_ptr(qkv), _ptr(out), rows // tokens, tokens,
                                seq_len, heads, head_dim,
                                ctypes.c_float(head_dim ** -0.5 * _LOG2E),
                                _stream(qkv))
    build.check(rc, "attention_rows")
    LAUNCHES["attention_rows"] += 1
    return out


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
