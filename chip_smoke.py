#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. require a CUDA device; print the card (``nvidia-smi``), the torch, CUDA
   and nvcc versions, and whether ``import triton`` works;
2. build the kernels from ``edgevisiontransformer_tpu_torch/csrc`` into
   ``build/torch_kernels/`` and print the build time;
3. check each kernel against its plain PyTorch twin at deit_tiny shapes
   (b1 and b128) and deit_base shapes (b8), and time both: the bf16 kernels
   within a tolerance; ``quant_rows`` (dynamic and static) and the non-GELU
   ``linear_i8`` epilogues bit for bit, its GELU epilogue within the
   tolerance;
4. run the slices: ``build_model("deit_tiny")`` at full width and depth with
   seeded random weights through ``fused_vit_apply`` on the kernels — three
   b1 requests and one b128 in standard style, one b1 in reference style,
   then one deit_base b8 request — and through ``fused_vit_apply_int8`` —
   static int8 (calibrated on 8 representative batches) three b1 and one
   b128, dynamic int8 one b1, reference-style static one b1, deit_base
   static one b8 — checking for each the logits against the plain twins on
   the card, the exact kernel launch counts, and finiteness;
5. time deit_base b1, int8 static against bf16 device p50; then the
   deit_tiny slices (kernel path and plain path) at b1 and b128, bf16 and
   int8 static and dynamic: eager p50, device p50 (CUDA-graph replay), peak
   memory, and device time by kernel from ``torch.profiler``.

The line before last is the card's name and power limit; the one before it
a JSON object with every kernel's launches, error and times; the last line
is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# |kernel - twin| <= ATOL + RTOL * |twin| for one kernel's bf16 output: both
# sides round the same fp32 values at the same points, so they differ only
# where fp32 summation order, erff/exp2f/tanhf against torch's, or the
# two-step rounding of CAST_THEN_BIAS moves a value across a bf16 rounding
# boundary: at most ~2 bf16 ulps (2^-6 relative).
KERNEL_RTOL = 2.0 ** -6
KERNEL_ATOL = 1e-2
# Logits of the whole model, kernels against twins: single-ulp flips of the
# kernels compound through 12 layers of random weights (in int8, a flip
# before a quantization moves a value into the next bucket); bound the
# largest deviation by 5% of the largest logit.
LOGIT_REL = 0.05
DEVICE = "cuda"
TPU = "edgevisiontransformer_tpu/ops/pallas/fused_encoder.py"
# The kernels, the TPU code each replaces, and the launches one layer makes.
KERNELS = {"ln_rows": f"{TPU}:54", "linear": f"{TPU}:202", "attention_rows": f"{TPU}:101",
           "quant_rows": f"{TPU}:844", "linear_i8": f"{TPU}:856"}
BF16_LAUNCHES = {"ln_rows": 2, "linear": 4, "attention_rows": 1, "quant_rows": 0, "linear_i8": 0}
INT8_LAUNCHES = {"ln_rows": 2, "linear": 0, "attention_rows": 1, "quant_rows": 4, "linear_i8": 4}
# deit_tiny b1, deit_tiny b128, deit_base b8: (rows, dim, mlp, heads)
SHAPES = {
    "deit_tiny b1": (197, 192, 768, 3),
    "deit_tiny b128": (128 * 197, 192, 768, 3),
    "deit_base b8": (8 * 197, 768, 3072, 12),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_env(torch, build) -> str:
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    nvcc = build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    print(f"nvcc: {nvcc}: {ver[-1] if ver else 'no version output'}")
    try:
        import triton
        print(f"triton {triton.__version__} imports")
    except ImportError as e:
        print(f"triton does not import: {e}")
    return card


def phase_build(build) -> float:
    t0 = time.perf_counter()
    build.load()
    dt = time.perf_counter() - t0
    print(f"kernels built and loaded in {dt:.2f} s: {build.library_path()}")
    return dt


def within(got, ref, rtol, atol):
    err = (got.float() - ref.float()).abs()
    bound = atol + rtol * ref.float().abs()
    return float(err.max()), bool((err <= bound).all())


def phase_kernels(torch, fe, harness):
    """Each kernel against its twin at the main path's shapes; returns
    ({kernel: max_abs_err}, {kernel: (ms, plain_ms)} for one deit_tiny b128
    layer)."""
    dev = DEVICE
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    errs = {"ln_rows": 0.0, "linear": 0.0, "attention_rows": 0.0}
    layer_ms = {}
    for shape_name, (m, dim, mlp, heads) in SHAPES.items():
        x = rnd(m, dim, scale=2.0)
        g, b = rnd(dim, scale=0.5) + 1, rnd(dim, scale=0.5)
        calls = {"ln_rows": [(fe.ln_rows, fe.ln_rows_plain, (x, g, b, 1e-6), {})]}
        lin = []
        for name, k, n, epi, approx, res in (
                ("qkv", dim, 3 * dim, fe.CAST_THEN_BIAS, False, None),
                ("out", dim, dim, fe.BIAS_RESIDUAL, False, x),
                ("fc1 erf", dim, mlp, fe.CAST_THEN_BIAS_GELU, False, None),
                ("fc1 tanh", dim, mlp, fe.CAST_THEN_BIAS_GELU, True, None),
                ("fc2", mlp, dim, fe.BIAS_RESIDUAL, False, x)):
            a = rnd(m, k)
            w, bias = rnd(k, n, scale=k ** -0.5), rnd(n, scale=0.5)
            lin.append((fe.linear, fe.linear_plain, (a, w, bias),
                        dict(epilogue=epi, res=res, approx_gelu=approx), name))
        calls["linear"] = [c[:4] for c in lin]
        qkv = rnd(m, 3 * dim)
        calls["attention_rows"] = [(fe.attention_rows, fe.attention_rows_plain, (qkv,),
                                    dict(heads=heads, head_dim=dim // heads, tokens=197))]
        for kname, entries in calls.items():
            for idx, (kern, plain, args, kw) in enumerate(entries):
                got = kern(*args, **kw)
                torch.cuda.synchronize()
                ref = plain(*args, **kw)
                err, ok = within(got, ref, KERNEL_RTOL, KERNEL_ATOL)
                label = kname + (f" {lin[idx][4]}" if kname == "linear" else "")
                if not ok or not torch.isfinite(got.float()).all():
                    fail(f"{label} at {shape_name}: max |kernel - twin| {err:.4g} "
                         f"over {KERNEL_ATOL} + {KERNEL_RTOL:.4g}|twin|")
                errs[kname] = max(errs[kname], err)
                t_k, t_p = time_pair(harness, shape_name, label, err,
                                     lambda: kern(*args, **kw), lambda: plain(*args, **kw))
                if shape_name == "deit_tiny b128" and label != "linear fc1 tanh":
                    # one standard-style layer: ln x2, qkv/out/fc1 erf/fc2, attention x1
                    reps = 2 if kname == "ln_rows" else 1
                    tk, tp = layer_ms.get(kname, (0.0, 0.0))
                    layer_ms[kname] = (tk + reps * t_k, tp + reps * t_p)
    return errs, layer_ms


def time_pair(harness, shape_name, label, err, call_k, call_p):
    """Print device (graph replay) and eager p50 of a kernel call and its
    twin; return the two device times."""
    t_k = harness.measure_graph_time(call_k)["p50_ms"]
    t_p = harness.measure_graph_time(call_p)["p50_ms"]
    e_k = harness.measure_op_time(call_k, ())["p50_ms"]
    e_p = harness.measure_op_time(call_p, ())["p50_ms"]
    print(f"  {shape_name:15s} {label:26s} device: kernel {t_k:.4f} ms plain "
          f"{t_p:.4f} ms | eager: kernel {e_k:.4f} ms plain {e_p:.4f} ms | "
          f"max|err| {err:.3g}")
    return t_k, t_p


def phase_kernels_int8(torch, fe, harness):
    """``quant_rows`` and ``linear_i8`` against their twins at the main
    path's shapes: bit for bit, except the GELU epilogue (tolerance).
    Returns the same as :func:`phase_kernels`; the layer times are those of
    one static-int8 deit_tiny b128 layer."""
    dev = DEVICE
    gen = torch.Generator(device=dev).manual_seed(1)

    def uniform(*shape, lo=0.5, hi=1.5):
        return torch.rand(*shape, generator=gen, device=dev) * (hi - lo) + lo

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    act_inv = (127.0 / (4.0 * uniform(12, 4))).contiguous()
    errs = {"quant_rows": 0.0, "linear_i8": 0.0}
    layer_ms = {"quant_rows": (0.0, 0.0), "linear_i8": (0.0, 0.0)}
    for shape_name, (m, dim, mlp, _) in SHAPES.items():
        b128 = shape_name == "deit_tiny b128"
        for k, reps in ((dim, 3), (mlp, 1)):  # a layer quantizes 3 dim-wide, 1 mlp-wide input
            h = (torch.randn(m, k, generator=gen, device=dev) * 2.0).to(torch.bfloat16)
            h[1] = 0  # absmax 0: the s = 1 fallback
            for mode, ai in (("dynamic", None), ("static", act_inv)):
                args = (h, ai, 5)
                (q, sc), (q_p, s_p) = fe.quant_rows(*args), fe.quant_rows_plain(*args)
                torch.cuda.synchronize()
                label = f"quant_rows {mode} K={k}"
                if not torch.equal(q, q_p) or (sc is not None and not torch.equal(sc, s_p)):
                    n_q = int((q != q_p).sum())
                    fail(f"{label} at {shape_name}: {n_q} of {q.numel()} int8 values differ "
                         "from the twin (must be bit for bit)")
                t_k, t_p = time_pair(harness, shape_name, label, 0.0,
                                     lambda: fe.quant_rows(*args),
                                     lambda: fe.quant_rows_plain(*args))
                if b128 and mode == "static":
                    tk, tp = layer_ms["quant_rows"]
                    layer_ms["quant_rows"] = (tk + reps * t_k, tp + reps * t_p)
        res = (torch.randn(m, dim, generator=gen, device=dev)).to(torch.bfloat16)
        for name, k, n, epi, approx, r in (
                ("qkv", dim, 3 * dim, fe.BIAS, False, None),
                ("out", dim, dim, fe.BIAS_RESIDUAL, False, res),
                ("fc1 erf", dim, mlp, fe.BIAS_GELU, False, None),
                ("fc1 tanh", dim, mlp, fe.BIAS_GELU, True, None),
                ("fc2", mlp, dim, fe.BIAS_RESIDUAL, False, res)):
            unit = 1.0 / (73.0 * 73.0 * k ** 0.5)  # a dequantized sum of order 1
            q, w_q = int8(m, k), int8(k, n)
            bias = torch.randn(n, generator=gen, device=dev) * 0.5
            for mode in ("dynamic", "static"):
                s_row = uniform(m) * 0.05 if mode == "dynamic" else None
                w_s = uniform(n) * (unit / 0.05 if mode == "dynamic" else unit)
                args = (q, s_row, w_q, w_s, bias)
                kw = dict(epilogue=epi, out_dtype=torch.bfloat16, res=r, approx_gelu=approx)
                got, ref = fe.linear_i8(*args, **kw), fe.linear_i8_plain(*args, **kw)
                torch.cuda.synchronize()
                label = f"linear_i8 {name} {mode}"
                err, ok = within(got, ref, KERNEL_RTOL, KERNEL_ATOL)
                if not torch.isfinite(got.float()).all():
                    fail(f"{label} at {shape_name}: non-finite output")
                if epi != fe.BIAS_GELU and not torch.equal(got, ref):
                    fail(f"{label} at {shape_name}: {int((got != ref).sum())} values differ "
                         f"from the twin, max {err:.4g} (must be bit for bit)")
                if not ok:
                    fail(f"{label} at {shape_name}: max |kernel - twin| {err:.4g} "
                         f"over {KERNEL_ATOL} + {KERNEL_RTOL:.4g}|twin|")
                errs["linear_i8"] = max(errs["linear_i8"], err)
                t_k, t_p = time_pair(harness, shape_name, label, err,
                                     lambda: fe.linear_i8(*args, **kw),
                                     lambda: fe.linear_i8_plain(*args, **kw))
                if b128 and mode == "static" and name != "fc1 tanh":
                    tk, tp = layer_ms["linear_i8"]
                    layer_ms["linear_i8"] = (tk + t_k, tp + t_p)
    return errs, layer_ms


def first_parting_layer(torch, fe, model, img, sq):
    """Run the int8 encoder one layer at a time, kernels and twins on the
    twins' input, and print each layer's largest relative deviation."""
    from edgevisiontransformer_tpu_torch.models.vit import _fused_embed

    cfg = model.config
    kw = dict(heads=cfg.heads, head_dim=cfg.resolved_head_dim, eps=cfg.layernorm_eps,
              reference_residual=cfg.reference_residual, approx_gelu=cfg.gelu_approx)
    x = _fused_embed(cfg, model.params(), img)
    for i in range(cfg.depth):
        layer = {k: v[i:i + 1] for k, v in sq.items() if k != "act_inv"}
        if "act_inv" in sq:
            layer["act_inv"] = sq["act_inv"][i:i + 1].contiguous()
        got = fe.encoder_forward_int8(x, layer, **kw)
        ref = fe.encoder_forward_int8_plain(x, layer, **kw)
        rel = float((got.float() - ref.float()).abs().max() / ref.float().abs().max())
        print(f"    layer {i}: max |kernels - twins| / max|twins| {rel:.4g}")
        x = ref


def phase_slice(torch, fe, harness):
    from edgevisiontransformer_tpu_torch.models.registry import build_model
    from edgevisiontransformer_tpu_torch.models.vit import (fused_vit_apply,
                                                             prepare_vit_fused)

    dev = DEVICE
    launches = {k: 0 for k in fe.LAUNCHES}
    worst = 0.0
    models = {}

    def request(tag, name, style, batch, seed):
        nonlocal worst
        key = (name, style)
        if key not in models:
            model, shape = build_model(name, style=style, dtype=torch.bfloat16, device=dev,
                                       generator=torch.Generator().manual_seed(0))
            models[key] = (model, shape, prepare_vit_fused(model))
        model, shape, stacked = models[key]
        depth = model.config.depth
        img = torch.randn(batch, *shape, generator=torch.Generator().manual_seed(seed))
        img = img.to(dev)
        with torch.no_grad():
            fe.reset_launches()
            logits = fused_vit_apply(model, img, stacked=stacked)
            torch.cuda.synchronize()
            counts = dict(fe.LAUNCHES)
            ref = fused_vit_apply(model, img, stacked=stacked, plain=True)
            eager = model(img)
        want = {k: v * depth for k, v in BF16_LAUNCHES.items()}
        if counts != want:
            fail(f"{tag}: launch counts {counts}, expected {want}")
        for k, v in counts.items():
            launches[k] += v
        if tuple(logits.shape) != (batch, model.config.num_classes):
            fail(f"{tag}: logits shape {tuple(logits.shape)}")
        if not torch.isfinite(logits.float()).all():
            fail(f"{tag}: non-finite logits")
        err = float((logits.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        if err > LOGIT_REL * scale:
            fail(f"{tag}: max |kernels - twins| {err:.4g} > {LOGIT_REL} * {scale:.4g}")
        worst = max(worst, err / scale)
        e_err = float((logits.float() - eager.float()).abs().max())
        agree = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
        print(f"  {tag:28s} logits {tuple(logits.shape)} max|kern-twin| {err:.4g} "
              f"(max|logit| {scale:.4g}), top-1 agreement {agree:.3f}, "
              f"max|kern-eager model| {e_err:.4g}, launches {counts}")
        return model, stacked, img

    for i in range(3):
        request(f"deit_tiny b1 #{i + 1}", "deit_tiny", "standard", 1, 100 + i)
    request("deit_tiny b128", "deit_tiny", "standard", 128, 200)
    request("deit_tiny b1 reference-style", "deit_tiny", "reference", 1, 300)
    request("deit_base b8", "deit_base", "standard", 8, 400)
    return launches, worst, models


def phase_slice_int8(torch, fe, models):
    """The int8 slice through ``fused_vit_apply_int8`` on the bf16 slice's
    models; returns (launches, worst deviation, {(name, style, mode): stack})."""
    from edgevisiontransformer_tpu_torch.models.vit import (fused_vit_apply,
                                                             fused_vit_apply_int8,
                                                             prepare_vit_int8,
                                                             prepare_vit_int8_static)
    from edgevisiontransformer_tpu_torch.ops.quant import representative_batches

    launches = {k: 0 for k in fe.LAUNCHES}
    worst = 0.0
    stacks = {}

    def request(tag, name, style, mode, batch, seed):
        nonlocal worst
        model, shape, stacked = models[(name, style)]
        key = (name, style, mode)
        if key not in stacks:
            t0 = time.perf_counter()
            with torch.no_grad():
                stacks[key] = (prepare_vit_int8_static(
                    model, calib_batches=representative_batches(n=8, shape=shape))
                    if mode == "static" else prepare_vit_int8(model))
            torch.cuda.synchronize()
            print(f"  {name} {style} {mode} int8 stack prepared in "
                  f"{time.perf_counter() - t0:.2f} s")
        sq = stacks[key]
        depth = model.config.depth
        img = torch.randn(batch, *shape, generator=torch.Generator().manual_seed(seed))
        img = img.to(DEVICE)
        with torch.no_grad():
            fe.reset_launches()
            logits = fused_vit_apply_int8(model, img, stacked_q=sq)
            torch.cuda.synchronize()
            counts = dict(fe.LAUNCHES)
            ref = fused_vit_apply_int8(model, img, stacked_q=sq, plain=True)
            bf16 = fused_vit_apply(model, img, stacked=stacked)
        want = {k: v * depth for k, v in INT8_LAUNCHES.items()}
        if counts != want:
            fail(f"{tag}: launch counts {counts}, expected {want}")
        for k, v in counts.items():
            launches[k] += v
        if tuple(logits.shape) != (batch, model.config.num_classes):
            fail(f"{tag}: logits shape {tuple(logits.shape)}")
        if not torch.isfinite(logits.float()).all():
            fail(f"{tag}: non-finite logits")
        err = float((logits.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        if err > LOGIT_REL * scale:
            print(f"  {tag}: kernels and twins part; per layer:")
            with torch.no_grad():
                first_parting_layer(torch, fe, model, img, sq)
            fail(f"{tag}: max |kernels - twins| {err:.4g} > {LOGIT_REL} * {scale:.4g}")
        worst = max(worst, err / scale)
        agree = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
        agree_bf16 = float((logits.argmax(-1) == bf16.argmax(-1)).float().mean())
        print(f"  {tag:34s} logits {tuple(logits.shape)} max|kern-twin| {err:.4g} "
              f"(max|logit| {scale:.4g}), top-1 agreement with twins {agree:.3f}, "
              f"with the bf16 path {agree_bf16:.3f}, launches {counts}")

    for i in range(3):
        request(f"deit_tiny int8 static b1 #{i + 1}", "deit_tiny", "standard", "static", 1,
                500 + i)
    request("deit_tiny int8 static b128", "deit_tiny", "standard", "static", 128, 600)
    request("deit_tiny int8 dynamic b1", "deit_tiny", "standard", "dynamic", 1, 700)
    request("deit_tiny int8 static b1 reference-style", "deit_tiny", "reference", "static", 1,
            800)
    request("deit_base int8 static b8", "deit_base", "standard", "static", 8, 900)
    return launches, worst, stacks


def phase_time_slice(torch, harness, models, stacks):
    """Eager p50 (what a caller gets: host launch work included), device
    p50 (CUDA-graph replay of the same calls), peak memory and the device
    time by kernel, for the kernel path and the plain path: bf16, then int8
    static and dynamic."""
    from edgevisiontransformer_tpu_torch.models.vit import fused_vit_apply, fused_vit_apply_int8

    model, shape, stacked = models[("deit_tiny", "standard")]
    slices = {
        "bf16": lambda img, plain: fused_vit_apply(model, img, stacked=stacked, plain=plain),
        "int8 static": lambda img, plain: fused_vit_apply_int8(
            model, img, stacked_q=stacks[("deit_tiny", "standard", "static")], plain=plain),
        "int8 dynamic": lambda img, plain: fused_vit_apply_int8(
            model, img, stacked_q=stacks[("deit_tiny", "standard", "dynamic")], plain=plain),
    }
    for slice_name, apply in slices.items():
        for batch in (1, 128):
            img = torch.randn(batch, *shape,
                              generator=torch.Generator().manual_seed(batch)).to(DEVICE)
            with torch.no_grad():
                for path, plain in (("kernels", False), ("plain", True)):
                    fn = lambda: apply(img, plain)  # noqa: E731
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    e = harness.measure_op_time(fn, (), iters=10, repeats=5)
                    peak = harness.device_mem_mb()
                    d = harness.measure_graph_time(fn, iters=10, repeats=5)
                    prof = harness.device_time_by_kernel(fn)
                    busy = sum(r[2] for r in prof)
                    print(f"  deit_tiny {slice_name} b{batch} {path:7s}: eager p50 "
                          f"{e['p50_ms']:.4f} ms (std {e['std_ms']:.4f}, "
                          f"{batch * 1e3 / e['p50_ms']:.1f} img/s), device p50 "
                          f"{d['p50_ms']:.4f} ms (std {d['std_ms']:.4f}), peak mem "
                          f"{peak:.1f} MiB, traced kernel time {busy:.4f} ms (device idle "
                          f"{max(0.0, 1 - busy / e['p50_ms']):.1%} of the eager call)")
                    for name, calls, ms in prof[:6]:
                        print(f"      {ms:9.4f} ms {calls:5d}x  {name[:90]}")


def phase_time_base(torch, harness, models, stacks):
    """deit_base b1 device p50, bf16 against int8 static: the weight-bytes
    case the TPU int8 kernel was written for."""
    from edgevisiontransformer_tpu_torch.models.vit import fused_vit_apply, fused_vit_apply_int8

    model, shape, stacked = models[("deit_base", "standard")]
    sq = stacks[("deit_base", "standard", "static")]
    img = torch.randn(1, *shape, generator=torch.Generator().manual_seed(1)).to(DEVICE)
    with torch.no_grad():
        d16 = harness.measure_graph_time(lambda: fused_vit_apply(model, img, stacked=stacked),
                                         iters=10, repeats=5)
        d8 = harness.measure_graph_time(
            lambda: fused_vit_apply_int8(model, img, stacked_q=sq), iters=10, repeats=5)
    print(f"  deit_base b1 device p50: bf16 {d16['p50_ms']:.4f} ms (std {d16['std_ms']:.4f}), "
          f"int8 static {d8['p50_ms']:.4f} ms (std {d8['std_ms']:.4f}), "
          f"int8 / bf16 {d8['p50_ms'] / d16['p50_ms']:.3f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from edgevisiontransformer_tpu_torch.bench import harness
    from edgevisiontransformer_tpu_torch.ops.cuda import build
    from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as fe

    print("== phase 1: environment")
    card = phase_env(torch, build)
    print("== phase 2: build")
    build_s = phase_build(build)
    print(f"== phase 3: kernels against twins (bf16 kernels and the int8 GELU epilogue: "
          f"|err| <= {KERNEL_ATOL} + {KERNEL_RTOL:.4g}|twin|; quant_rows and the other "
          f"linear_i8 epilogues bit for bit); times on {card}")
    errs, layer_ms = phase_kernels(torch, fe, harness)
    errs8, layer_ms8 = phase_kernels_int8(torch, fe, harness)
    errs.update(errs8)
    layer_ms.update(layer_ms8)
    print(f"== phase 4: slices through fused_vit_apply and fused_vit_apply_int8 (logits "
          f"within {LOGIT_REL} x max|logit| of the twins)")
    launches, worst, models = phase_slice(torch, fe, harness)
    launches8, worst8, stacks = phase_slice_int8(torch, fe, models)
    for k, v in launches8.items():
        launches[k] += v
    for k, v in launches.items():
        if v == 0:
            fail(f"kernel {k} was never launched on the main path")
    print(f"== phase 5: slice timing, deit_base b1 and deit_tiny standard bf16 and int8, "
          f"on {card}")
    phase_time_base(torch, harness, models, stacks)
    # deit_tiny's peak memory is read with deit_base's weights freed
    models.pop(("deit_base", "standard"))
    stacks.pop(("deit_base", "standard", "static"))
    torch.cuda.empty_cache()
    phase_time_slice(torch, harness, models, stacks)
    print(f"build {build_s:.2f} s; worst logit deviation {max(worst, worst8):.4g} of "
          f"max|logit| (bf16 {worst:.4g}, int8 {worst8:.4g})")

    src = "edgevisiontransformer_tpu_torch/csrc/"
    print("kernel ms / plain_ms: device time (CUDA-graph replay) of one deit_tiny b128 "
          "layer's launches of that kernel (int8 kernels: a static-int8 layer); launches: "
          "the bf16 and int8 slices' requests of phase 4")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": f"{src}{k}.cu", "replaces": replaces,
         "launches": launches[k], "max_abs_err": errs[k],
         "ms": layer_ms[k][0], "plain_ms": layer_ms[k][1]}
        for k, replaces in KERNELS.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
