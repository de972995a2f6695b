#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. require a CUDA device; print the card (``nvidia-smi``), the torch, CUDA
   and nvcc versions, and whether ``import triton`` works;
2. build the kernels from ``edgevisiontransformer_tpu_torch/csrc`` into
   ``build/torch_kernels/`` and print the build time;
3. check each kernel against its plain PyTorch twin in bf16 at deit_tiny
   shapes (b1 and b128) and deit_base shapes (b8), and time both;
4. run the slice: ``build_model("deit_tiny")`` at full width and depth with
   seeded random weights through ``fused_vit_apply`` on the kernels — three
   b1 requests and one b128 in standard style, one b1 in reference style,
   then one deit_base b8 request — checking for each the logits against the
   plain twins on the card, the kernel launch counts, and finiteness;
5. time the slice (kernel path and plain path) at b1 and b128: eager p50,
   device p50 (CUDA-graph replay), peak memory, and device time by kernel
   from ``torch.profiler``.

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
# kernels compound through 12 layers of random weights; bound the largest
# deviation by 5% of the largest logit.
LOGIT_REL = 0.05


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
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    shapes = {  # name: (rows, dim, mlp, heads)
        "deit_tiny b1": (197, 192, 768, 3),
        "deit_tiny b128": (128 * 197, 192, 768, 3),
        "deit_base b8": (8 * 197, 768, 3072, 12),
    }
    errs = {"ln_rows": 0.0, "linear": 0.0, "attention_rows": 0.0}
    layer_ms = {}
    for shape_name, (m, dim, mlp, heads) in shapes.items():
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
                call_k = lambda: kern(*args, **kw)  # noqa: E731
                call_p = lambda: plain(*args, **kw)  # noqa: E731
                t_k = harness.measure_graph_time(call_k)["p50_ms"]
                t_p = harness.measure_graph_time(call_p)["p50_ms"]
                e_k = harness.measure_op_time(call_k, ())["p50_ms"]
                e_p = harness.measure_op_time(call_p, ())["p50_ms"]
                print(f"  {shape_name:15s} {label:22s} device: kernel {t_k:.4f} ms plain "
                      f"{t_p:.4f} ms | eager: kernel {e_k:.4f} ms plain {e_p:.4f} ms | "
                      f"max|err| {err:.3g}")
                if shape_name == "deit_tiny b128" and label != "linear fc1 tanh":
                    # one standard-style layer: ln x2, qkv/out/fc1 erf/fc2, attention x1
                    reps = 2 if kname == "ln_rows" else 1
                    tk, tp = layer_ms.get(kname, (0.0, 0.0))
                    layer_ms[kname] = (tk + reps * t_k, tp + reps * t_p)
    return errs, layer_ms


def phase_slice(torch, fe, harness):
    from edgevisiontransformer_tpu_torch.models.registry import build_model
    from edgevisiontransformer_tpu_torch.models.vit import (fused_vit_apply,
                                                             prepare_vit_fused)

    dev = "cuda"
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
        want = {"ln_rows": 2 * depth, "linear": 4 * depth, "attention_rows": depth}
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
    models.pop(("deit_base", "standard"))
    return launches, worst, models[("deit_tiny", "standard")]


def phase_time_slice(torch, harness, model, stacked):
    """Eager p50 (what a caller gets: host launch work included), device
    p50 (CUDA-graph replay of the same calls), peak memory and the device
    time by kernel, for the kernel path and the plain path."""
    from edgevisiontransformer_tpu_torch.models.vit import fused_vit_apply

    for batch in (1, 128):
        img = torch.randn(batch, 3, 224, 224, generator=torch.Generator().manual_seed(batch))
        img = img.to("cuda")
        runs = {"kernels": lambda: fused_vit_apply(model, img, stacked=stacked),
                "plain": lambda: fused_vit_apply(model, img, stacked=stacked, plain=True)}
        with torch.no_grad():
            for path, fn in runs.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                e = harness.measure_op_time(fn, (), iters=10, repeats=5)
                peak = harness.device_mem_mb()
                d = harness.measure_graph_time(fn, iters=10, repeats=5)
                prof = harness.device_time_by_kernel(fn)
                busy = sum(r[2] for r in prof)
                print(f"  deit_tiny b{batch} {path:7s}: eager p50 {e['p50_ms']:.4f} ms "
                      f"(std {e['std_ms']:.4f}, {batch * 1e3 / e['p50_ms']:.1f} img/s), "
                      f"device p50 {d['p50_ms']:.4f} ms (std {d['std_ms']:.4f}), "
                      f"peak mem {peak:.1f} MiB, traced kernel time {busy:.4f} ms "
                      f"(device idle {max(0.0, 1 - busy / e['p50_ms']):.1%} of the eager call)")
                for name, calls, ms in prof[:6]:
                    print(f"      {ms:9.4f} ms {calls:5d}x  {name[:90]}")


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
    print(f"== phase 3: kernels against twins (bf16; |err| <= {KERNEL_ATOL} + "
          f"{KERNEL_RTOL:.4g}|twin|); times on {card}")
    errs, layer_ms = phase_kernels(torch, fe, harness)
    print(f"== phase 4: slice through fused_vit_apply (logits within {LOGIT_REL} x max|logit| "
          f"of the twins)")
    launches, worst, (model, _, stacked) = phase_slice(torch, fe, harness)
    for k, v in launches.items():
        if v == 0:
            fail(f"kernel {k} was never launched on the main path")
    print(f"== phase 5: slice timing, deit_tiny standard bf16, on {card}")
    phase_time_slice(torch, harness, model, stacked)
    print(f"build {build_s:.2f} s; worst logit deviation {worst:.4g} of max|logit|")

    src = "edgevisiontransformer_tpu_torch/csrc/"
    tpu = "edgevisiontransformer_tpu/ops/pallas/fused_encoder.py"
    replaces = {"ln_rows": f"{tpu}:54", "linear": f"{tpu}:202",
                "attention_rows": f"{tpu}:101"}
    print("kernel ms / plain_ms: device time (CUDA-graph replay) of one deit_tiny b128 "
          "layer's launches of that kernel")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": f"{src}{k}.cu", "replaces": replaces[k],
         "launches": launches[k], "max_abs_err": errs[k],
         "ms": layer_ms[k][0], "plain_ms": layer_ms[k][1]}
        for k in ("ln_rows", "linear", "attention_rows")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
