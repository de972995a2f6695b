"""What the parts of ``csrc/mlp.cu`` and ``csrc/mlp_wide.cu`` (K14) cost on
the card: each kernel as committed against variants of its source and
against other plans of its grid, each timed on the same inputs.

    python -m edgevisiontransformer_tpu_torch.bench.mlp_ab

Source variants, each built into its own library: the committed kernel; no
GELU (the helper ``gelu_act`` returns its argument: the products, the loads
and the stores only, a floor; its output is not the MLP).  Plan variants,
on the committed library: the plan ``fused_mlp.plan`` picks; the cluster
split forced to 1 (off) and to 2, at the widest column tiles; chunks of 32
hidden units; 64 and 128 rows per block (each where it fits).  Each line gives the device time per launch (``harness.measure_graph_time``: CUDA events around a CUDA graph
of 20 launches replayed, median of 5 samples; the host's ctypes loop would
time itself at b1) and the largest
difference from the committed kernel's output under its own plan.

The wide form (``mlp_wide.cu``, dim above 1,152) at ViT-H/14 b1 and b8, each
source variant under ``fused_mlp.wide_plan``'s split and with fc2's K split
forced to 1, 2 and 4 (``WIDE_VARIANTS``: the committed kernel, whose ring
TMA feeds at these shapes; no GELU; each step's products waited for before
the next step (``LAG`` 0); two floors whose output is wrong, the ring's
loads without the products and the products without the loads), beside the
library call (``addmm`` + ``gelu`` + ``addmm``) and the port's own chain MLP,
``linear`` with its GELU epilogue then ``linear``.  Needs a CUDA device and
``nvcc``; the libraries go to ``build/mlp_ab/``.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from ..ops.cuda import build
from ..ops.cuda import fused_encoder as fe
from ..ops.cuda import fused_mlp as fm
from .harness import measure_graph_time

# (rows, dim, hidden): deit_tiny b1 and b128, deit_base b8
SHAPES = {"deit_tiny b1": (197, 192, 768), "deit_tiny b128": (128 * 197, 192, 768),
          "deit_base b8": (8 * 197, 768, 3072)}
# the body of the kernel's activation helper gelu_act(h, approx)
_GELU = "return approx ? gelu_tanh_f(h) : gelu_erf_f(h);"


# mlp_wide.cu at ViT-H/14 b1 and b8
WIDE_SHAPES = {"ViT-H/14 b1": (257, 1280, 5120), "ViT-H/14 b8": (8 * 257, 1280, 5120)}
# mlp_wide.cu's variants: (anchor, replacement) pairs on its source
WIDE_VARIANTS = {
    "committed": (),
    "no GELU (products only)": ((_GELU, "return h;"),),
    "products waited each step (LAG 0)": (("constexpr int LAG = 1; ", "constexpr int LAG = 0; "),),
    "loads only (floor)": (("    wgmma_n128<T>(acc,", "    if (false) wgmma_n128<T>(acc,"),),
    "products only (floor)": (("  mbar_expect(full + slot, STEP_BYTES);\n",
                               "  mbar_arrive(full + slot);\n  return;\n"),),
}


def _substitute(src: str, pairs, what: str) -> str:
    for anchor, new in pairs:
        if src.count(anchor) != 1:
            raise ValueError(f"{what} no longer holds {anchor!r} once")
        src = src.replace(anchor, new)
    return src


def variants(src: str) -> dict:
    return {"committed": src,
            "no GELU (products only)": _substitute(src, ((_GELU, "return h;"),),
                                                   "csrc/mlp.cu")}


def wide_variants(src: str) -> dict:
    """``{name: source}`` of mlp_wide.cu's ``WIDE_VARIANTS``."""
    return {name: _substitute(src, pairs, "csrc/mlp_wide.cu")
            for name, pairs in WIDE_VARIANTS.items()}


def wide_plans(m: int, dim: int, hidden: int, sms: int) -> dict:
    """``{name: WidePlan}``: the committed plan and fc2's K split forced to
    1, 2 and 4."""
    return {"plan": fm.wide_plan(m, dim, hidden, sms),
            **{f"split {s}": fm.wide_plan(m, dim, hidden, sms, split=s) for s in (1, 2, 4)}}


def plans(m: int, dim: int, hidden: int, sms: int) -> dict:
    """``{name: Plan}``: the committed plan and the forced ones that apply."""
    out = {"plan": fm.plan(m, dim, hidden, sms), "split 1": fm.plan(m, dim, hidden, sms, split=1),
           "split 2": fm.plan(m, dim, hidden, sms, split=2),
           "hc 32": fm.plan(m, dim, hidden, sms, hc=32)}
    for rows in (64, 128):
        if rows == 64 or dim <= fm.WIDE_ROWS_DIM:
            out[f"{rows} rows"] = fm.plan(m, dim, hidden, sms, rows=rows)
    return {k: p for k, p in out.items()
            if fm._smem_bytes(dim, p.rows, p.nt, p.hc) <= fm.MAX_SMEM}


def build_variants() -> tuple:
    """``({name: evt_mlp}, {name: evt_mlp_wide})`` of each source variant of
    mlp.cu and mlp_wide.cu, compiled side by side (ptxas's registers and
    spills of each wide variant printed)."""
    out_dir = build.BUILD_DIR.parent / "mlp_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for stem, found, entry in (
            ("mlp", variants((build.CSRC / "mlp.cu").read_text()), "evt_mlp"),
            ("mlp_wide", wide_variants((build.CSRC / "mlp_wide.cu").read_text()),
             "evt_mlp_wide")):
        for i, (name, code) in enumerate(found.items()):
            cu, so = out_dir / f"{stem}_v{i}.cu", out_dir / f"lib{stem}_v{i}.so"
            cu.write_text(code)
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
                   str(build.CSRC), "-o", str(so), str(cu)]
            jobs.append((entry, name, so, subprocess.Popen(cmd, stderr=subprocess.PIPE,
                                                           text=True)))
    fns = {"evt_mlp": {}, "evt_mlp_wide": {}}
    p, i = ctypes.c_void_p, ctypes.c_int
    argtypes = {"evt_mlp": [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p],
                "evt_mlp_wide": [p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]}
    for entry, name, so, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f"{name}: {err}")
        if entry == "evt_mlp_wide":
            print(f"{name:36s} ptxas: " + "; ".join(
                line.split("info    : ")[-1].strip() for line in err.splitlines()
                if "registers" in line or "spill" in line))
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes[entry]
        fns[entry][name] = fn
    return fns["evt_mlp"], fns["evt_mlp_wide"]


def _launch(fn, p, x, w1, b1, w2, b2, y) -> None:
    m, dim = x.shape
    build.check(fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                   y.data_ptr(), m, dim, w1.shape[1], 0, p.rows, p.split, p.nt, p.hc,
                   torch.cuda.current_stream().cuda_stream), "mlp")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mlp_ab needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fns, wide_fns = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).bfloat16()

    for tag, (m, dim, hid) in SHAPES.items():
        x, b1, b2 = rnd(m, dim, scale=2.0), rnd(hid), rnd(dim)
        w1, w2 = rnd(dim, hid, scale=dim ** -0.5), rnd(hid, dim, scale=hid ** -0.5)
        runs = [(src, pname, p) for src in fns for pname, p in plans(m, dim, hid, sms).items()
                if src == "committed" or pname == "plan"]
        ref = None
        for order in (runs, runs[::-1]):  # A, B, ..., B, A
            for src, pname, p in order:
                y = torch.empty_like(x)
                ms = measure_graph_time(
                    lambda: _launch(fns[src], p, x, w1, b1, w2, b2, y))["p50_ms"]
                ref = y.clone() if ref is None else ref
                diff = float((y.float() - ref.float()).abs().max())
                print(f"{tag:15s} {src:24s} {pname:8s} rows {p.rows:3d} split {p.split} nt "
                      f"{p.nt:3d} hc {p.hc} {ms * 1e3:9.2f} us  max|diff vs committed| "
                      f"{diff:.3g}")

    for tag, (m, dim, hid) in WIDE_SHAPES.items():
        x, b1, b2 = rnd(m, dim, scale=2.0), rnd(hid), rnd(dim)
        w1, w2 = rnd(dim, hid, scale=dim ** -0.5), rnd(hid, dim, scale=hid ** -0.5)
        runs = [(src, pname, p) for src in wide_fns
                for pname, p in wide_plans(m, dim, hid, sms).items()]
        ref, times = None, {}
        for order in (runs, runs[::-1]):  # A, B, ..., B, A
            for src, pname, p in order:
                y = torch.empty_like(x)
                ms = measure_graph_time(lambda: build.check(fm.wide_call(
                    wide_fns[src], x, w1, b1, w2, b2, y, False, p), "mlp"))["p50_ms"]
                ref = y.clone() if ref is None else ref
                diff = float((y.float() - ref.float()).abs().max())
                times.setdefault((src, pname), []).append((ms, diff))
        for (src, pname), got in times.items():
            p = wide_plans(m, dim, hid, sms)[pname]
            print(f"{tag:15s} {src:36s} {pname:8s} split {p.split} grid {p.grid:3d} "
                  + " / ".join(f"{ms * 1e3:8.2f}" for ms, _ in got)
                  + f" us  max|diff vs committed| {got[0][1]:.3g}")
        yard = {"library (addmm + gelu + addmm)": lambda: torch.addmm(
                    b2, torch.nn.functional.gelu(torch.addmm(b1, x, w1)), w2),
                "the port's linear (GELU epilogue) + linear": lambda: fe.linear(
                    fe.linear(x, w1, b1, epilogue=fe.CAST_THEN_BIAS_GELU), w2, b2,
                    epilogue=fe.CAST_THEN_BIAS)}
        for name, fn in yard.items():
            print(f"{tag:15s} {name:45s} {measure_graph_time(fn)['p50_ms'] * 1e3:8.2f} us")


if __name__ == "__main__":
    main()
