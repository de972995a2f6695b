"""Experiment generators (port of ``edgevisiontransformer_tpu/bench/experiments.py``).

* ``prune_benchmark_grid``: the ViT_Pruned benchmark grid (reference
  experiments.py:150-204 PruneBenchmark): ffn-only 10-90%, head-only 1..H,
  head+ffn combos, as prune encodings ready for the registry / bench.
* ``fusion_ab``: the TFLite fusion-test methodology (experiments.py:32-87
  FusionTestTransformer): the same op chain timed as seven separate PyTorch
  ops against the port's kernels that fuse it (``fused_encoder.linear``
  with the bias + GELU epilogue, ``linear`` with the bias + residual one,
  ``ln_rows``): it measures what the port's fusion buys, as the JAX
  package's measures what XLA's buys.
* ``quant_op_sweep``: op-size quantization sweeps (experiments.py:262-404
  quant_op_test): matmul shapes x {bf16, int8-dynamic, int8-static} latency
  table on ``ops/quant``.

Every time is ``bench/looptimer.measure_op_time``'s per-call wall time.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from .looptimer import measure_op_time

_HEADS = {"tiny": 3, "small": 6, "base": 12}
_MLP = {"tiny": 768, "small": 1536, "base": 3072}


def prune_benchmark_grid(size: str = "tiny", depth: int = 12) -> List[str]:
    """All prune encodings of the reference's PruneBenchmark grid."""
    h_full = _HEADS[size]
    grid: List[str] = []
    # 1) ffn-only: keep 90%..10%
    for keep in range(9, 0, -1):
        grid.append(f"all_head{h_full}_ffn0.{keep}")
    # 2) head-only
    for h in range(1, h_full + 1):
        grid.append(f"all_head{h}_ffn1.0")
    # 3) head+ffn combos (reference: tiny head2 x ffn 0.9/0.8/0.7, etc.)
    combo_heads = {"tiny": [2], "small": [4, 5], "base": [8]}[size]
    for h in combo_heads:
        for keep in (9, 8, 7, 6):
            grid.append(f"all_head{h}_ffn0.{keep}")
    return grid


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _normal(shape, seed: int, scale: float, dtype, device) -> torch.Tensor:
    return (torch.randn(shape, generator=_gen(seed)) * scale).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Fusion A/B
# ---------------------------------------------------------------------------


def fusion_test_transformer_stages(dim: int = 192, mlp: int = 768, *, device="cuda"):
    """The decomposed FFN pipeline the reference uses to probe fusion:
    dense -> bias-add -> gelu -> dense -> bias-add -> residual-add -> LN.

    Returns ``stages(x, barrier)``: with ``barrier`` the seven stages as
    separate PyTorch ops (each a launch of its own on the card), without it
    the port's kernels that fuse them (``linear`` with the bias + tanh-GELU
    epilogue, ``linear`` with the bias + residual epilogue, ``ln_rows``).
    ``x`` is ``[rows, dim]`` bf16 on ``device`` (the kernels compute in bf16
    or fp16, where the JAX package's chain runs fp32; on the CPU the wrappers
    take their twins)."""
    from ..models.vit import model_device
    from ..ops.activations import gelu_tanh
    from ..ops.cuda.fused_encoder import BIAS_RESIDUAL, CAST_THEN_BIAS_GELU, linear, ln_rows
    from ..ops.layers import layer_norm

    dev, dtype = model_device(device), torch.bfloat16
    w1 = _normal((dim, mlp), 0, 0.05, dtype, dev)
    b1 = torch.zeros((mlp,), dtype=dtype, device=dev)
    w2 = _normal((mlp, dim), 1, 0.05, dtype, dev)
    b2 = torch.zeros((dim,), dtype=dtype, device=dev)
    g = torch.ones((dim,), dtype=torch.float32, device=dev)
    beta = torch.zeros((dim,), dtype=torch.float32, device=dev)

    def stages(x, barrier: bool):
        if barrier:
            h = x @ w1
            h = h + b1
            h = gelu_tanh(h)
            y = h @ w2
            y = y + b2
            y = y + x
            return layer_norm(y, g, beta, 1e-5)
        h = linear(x, w1, b1, epilogue=CAST_THEN_BIAS_GELU, approx_gelu=True)
        y = linear(h, w2, b2, epilogue=BIAS_RESIDUAL, res=x)
        return ln_rows(y, g, beta, 1e-5)

    return stages


def fusion_ab(
    rows: int = 197, dim: int = 192, mlp: int = 768,
    iters: int = 100, repeats: int = 3, *, device="cuda",
) -> Dict[str, float]:
    """Time the decomposed chain fused (the port's kernels) vs unfused
    (separate PyTorch ops); the reference's keys."""
    from ..models.vit import model_device

    stages = fusion_test_transformer_stages(dim, mlp, device=device)
    x = _normal((rows, dim), 2, 1.0, torch.bfloat16, model_device(device))
    with torch.no_grad():
        fused = measure_op_time(lambda t: stages(t, False), (x,),
                                iters=iters, repeats=repeats, chain_arg=0)
        unfused = measure_op_time(lambda t: stages(t, True), (x,),
                                  iters=iters, repeats=repeats, chain_arg=0)
    return {
        "fused_ms": fused["p50_ms"],
        "unfused_ms": unfused["p50_ms"],
        "fusion_speedup": (unfused["p50_ms"] / fused["p50_ms"])
        if fused["p50_ms"] else float("nan"),
    }


# ---------------------------------------------------------------------------
# Quantized-op sweep
# ---------------------------------------------------------------------------


def quant_op_sweep(
    sizes: Sequence[int] = (256, 512, 1024, 2048),
    iters: int = 50, repeats: int = 3, *, device="cuda",
) -> List[Dict]:
    """Matmul latency per square size: bf16 vs dynamic-int8 (run-time
    per-row activation quant) vs static-int8 (calibrated scale: isolates
    the dynamic overhead), on ``ops/quant``'s functions."""
    from ..models.vit import model_device
    from ..ops.quant import int8_matmul_dynamic, int8_matmul_static, quantize_weight_int8

    dev = model_device(device)
    out = []
    with torch.no_grad():
        for n in sizes:
            x = _normal((n, n), 0, 1.0, torch.bfloat16, dev)
            w = _normal((n, n), 1, 1.0, torch.bfloat16, dev)
            wq, ws = quantize_weight_int8(w.float())
            act_s = float(x.abs().max() / 127.0)
            comb = (ws * act_s).float()
            r_bf16 = measure_op_time(lambda a, b: a @ b, (x, w),
                                     iters=iters, repeats=repeats, chain_arg=0)
            r_int8 = measure_op_time(
                lambda a, q, s: int8_matmul_dynamic(a, q, s), (x, wq, ws),
                iters=iters, repeats=repeats, chain_arg=0)
            r_stat = measure_op_time(
                lambda a, q, c: int8_matmul_static(a, q, c, act_s), (x, wq, comb),
                iters=iters, repeats=repeats, chain_arg=0)
            out.append({
                "size": n,
                "bf16_ms": r_bf16["p50_ms"],
                "int8_dynamic_ms": r_int8["p50_ms"],
                "int8_static_ms": r_stat["p50_ms"],
            })
    return out


# ---------------------------------------------------------------------------
# Micro models (reference utils.py:322-406: get_attention/ffn/dense_plus_input)
# ---------------------------------------------------------------------------


def micro_attention(dim: int = 192, heads: int = 3, n_tokens: int = 197,
                    batch: int = 1, dtype: torch.dtype = torch.float32, device="cuda"):
    """Attention-only micro model: ``(fn, args)``.  The reference exports
    these as standalone tflite / onnx models to time the op alone; here
    they are closures fed to the loop-delta timer."""
    from ..models.vit import model_device
    from ..ops.attention import attention_xla

    dev = model_device(device)
    hd = dim // heads
    x = _normal((batch, n_tokens, dim), 0, 1.0, dtype, dev)
    w_qkv = _normal((dim, 3 * dim), 1, 0.05, dtype, dev)
    w_out = _normal((dim, dim), 2, 0.05, dtype, dev)

    def fn(x, w_qkv, w_out):
        return attention_xla(x, w_qkv, None, w_out, None, heads, hd)

    return fn, (x, w_qkv, w_out)


def micro_ffn(dim: int = 192, hidden: int = 768, n_tokens: int = 197,
              batch: int = 1, dtype: torch.dtype = torch.float32, device="cuda"):
    from ..models.vit import model_device
    from ..ops.activations import gelu_tanh
    from ..ops.layers import mlp_block

    dev = model_device(device)
    x = _normal((batch, n_tokens, dim), 3, 1.0, dtype, dev)
    w1 = _normal((dim, hidden), 4, 0.05, dtype, dev)
    w2 = _normal((hidden, dim), 5, 0.05, dtype, dev)

    def fn(x, w1, w2):
        return mlp_block(x, w1, None, w2, None, gelu_tanh)

    return fn, (x, w1, w2)


def micro_dense_plus_input(dim_in: int = 192, dim_out: int = 192,
                           n_tokens: int = 197, batch: int = 1,
                           dtype: torch.dtype = torch.float32, device="cuda"):
    """Dense + residual add (the reference's dense_plus_input fusion probe)."""
    from ..models.vit import model_device

    dev = model_device(device)
    x = _normal((batch, n_tokens, dim_in), 6, 1.0, dtype, dev)
    w = _normal((dim_in, dim_out), 7, 0.05, dtype, dev)

    def fn(x, w):
        return x @ w + (x if dim_in == dim_out else 0.0)

    return fn, (x, w)


def bench_micro_models(dim: int = 192, heads: int = 3, batch: int = 1,
                       iters: int = 100, repeats: int = 3, *,
                       device="cuda") -> Dict[str, float]:
    """Time the three micro models (op-isolation methodology)."""
    out = {}
    with torch.no_grad():
        for name, (fn, args) in {
            "attention": micro_attention(dim, heads, batch=batch, device=device),
            "ffn": micro_ffn(dim, dim * 4, batch=batch, device=device),
            "dense_plus_input": micro_dense_plus_input(dim, dim, batch=batch, device=device),
        }.items():
            r = measure_op_time(fn, args, iters=iters, repeats=repeats, chain_arg=0)
            out[name] = r["p50_ms"]
    return out
