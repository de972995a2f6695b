"""What the parts of ``csrc/linear.cu`` cost on the card: the kernel as
committed against variants of its tile's source, against other plans of
its grid and against ``torch.addmm``, each timed on the same inputs.

    python -m edgevisiontransformer_tpu_torch.bench.linear_ab

Source variants of ``csrc/linear_tile.cuh``, each built with the linear
sources into its own library: the committed tile; no epilogue (the helper
``epilogue`` returns the fp32 sum: the products, the loads and the bf16
stores only, a floor; its output is not the GEMM's); a 2- and a 4-stage
ring; bf16x2 stores (each thread stores its accumulator pairs straight to Y,
4 bytes at a time, instead of packing them into its warp's patch of the
idle ring for 16-byte stores).  Plan variants, on the committed library: the plan
``fused_encoder.linear_plan`` picks and every other compiled block shape.
The library yardstick is ``torch.addmm(b, x, w)`` (no epilogue).  Shapes:
the four GEMMs of one deit_tiny layer at b128 and at b1, Swin stage 0's qkv
at b1 and deit_base's fc1 at b8.  Each line gives the device time per
launch (``harness.measure_graph_time``: CUDA events around a CUDA graph of
20 launches replayed, median of 5 samples) and the largest difference from
the committed kernel's output under its own plan.  Runs go A, B, ..., B, A.
Needs a CUDA device and ``nvcc``; the libraries go to ``build/linear_ab/``.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from ..ops.cuda import build
from ..ops.cuda import fused_encoder as fe
from .harness import measure_graph_time

# (rows, K, N, epilogue code of csrc/linear.cu): deit_tiny's qkv, out, fc1
# (exact GELU) and fc2 at b128 and b1, Swin stage 0's qkv at b1, deit_base's
# fc1 at b8
SHAPES = {"deit_tiny b128 qkv": (128 * 197, 192, 576, 0),
          "deit_tiny b128 out": (128 * 197, 192, 192, 3),
          "deit_tiny b128 fc1": (128 * 197, 192, 768, 2),
          "deit_tiny b128 fc2": (128 * 197, 768, 192, 3),
          "deit_tiny b1 qkv": (197, 192, 576, 0), "deit_tiny b1 out": (197, 192, 192, 3),
          "deit_tiny b1 fc1": (197, 192, 768, 2), "deit_tiny b1 fc2": (197, 768, 192, 3),
          "swin_tiny b1 s0 qkv": (3136, 96, 288, 0), "deit_base b8 fc1": (8 * 197, 768, 3072, 2)}
# the sources of the kernel, and the anchors of the variants in the tile's:
# the body of the helper epilogue<EPI, T>(v, b, r), the ring depth, and the
# kernel's tail (the register epilogue's dispatch)
SOURCES = ("linear.cu", "linear_rows64.cu", "linear_rows32.cu", "linear_rows16.cu")
TILE = "linear_tile.cuh"
_EPILOGUE = ("  if constexpr (EPI == 3) return (v + b) + r;\n"
             "  if constexpr (EPI == ROW_BIAS) return v + r;\n"
             "  v = round_to<T>(round_to<T>(v) + b);\n"
             "  if constexpr (EPI == 1) return gelu_tanh_f(v);\n"
             "  if constexpr (EPI == 2) return gelu_erf_f(v);\n"
             "  return v;\n")
_STAGES = "constexpr int BK = 64, STAGES = 3;"
_PATCH_STORE = ("          *reinterpret_cast<uint32_t*>(patch + r * PLD + c) = "
                "pack2<T>(y0, y1);\n")
_COPY_OUT = "  if (!vb) return;\n  __syncwarp();\n"


def variants(src: str) -> dict:
    """``{name: source of linear_tile.cuh}`` for each variant of ``src``."""
    for anchor in (_EPILOGUE, _STAGES, _PATCH_STORE, _COPY_OUT):
        if src.count(anchor) != 1:
            raise ValueError(f"csrc/{TILE} no longer holds {anchor!r} once")
    direct = src.replace(_PATCH_STORE, "          if (gm < M && in) *reinterpret_cast<uint32_t*>("
                                       "Y + off) = pack2<T>(y0, y1);\n")
    direct = direct.replace(_COPY_OUT, "  return;  // the pairs went straight to Y\n")
    return {"committed": src, "no epilogue": src.replace(_EPILOGUE, "  return v;\n"),
            "2 stages": src.replace(_STAGES, _STAGES.replace("STAGES = 3", "STAGES = 2")),
            "4 stages": src.replace(_STAGES, _STAGES.replace("STAGES = 3", "STAGES = 4")),
            "bf16x2 stores": direct}


def plans(m: int, n: int, k: int, sms: int) -> dict:
    """``{name: (rows, cols)}``: the committed plan, then every other block
    shape the kernel is compiled for."""
    plan = fe.linear_plan(m, n, k, sms)
    out = {"plan": plan}
    for r in fe.LINEAR_ROWS:
        for c in fe.LINEAR_COLS:
            if (r, c) != plan:
                out[f"{r}x{c}"] = (r, c)
    return out


def build_variants() -> dict:
    """``{name: evt_linear}`` of each source variant: every variant's linear
    sources compiled side by side, one library each."""
    out_dir = build.BUILD_DIR.parent / "linear_ab"
    nvcc = build.nvcc_path()
    jobs, libs = [], {}
    for i, (name, code) in enumerate(variants((build.CSRC / TILE).read_text()).items()):
        vdir = out_dir / f"v{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / TILE).write_text(code)
        objs = []
        for src in SOURCES:  # copies beside the variant's tile, which they include
            (vdir / src).write_text((build.CSRC / src).read_text())
            obj = vdir / src.replace(".cu", ".o")
            cmd = [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-c", "-o", str(obj),
                   str(vdir / src)]
            jobs.append((name, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)))
            objs.append(obj)
        libs[name] = (vdir / f"liblinear_v{i}.so", objs)
    for name, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f"{name}: {err}")
    fns = {}
    for name, (so, objs) in libs.items():
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(so), *map(str, objs)],
                       check=True)
        fn = ctypes.CDLL(str(so)).evt_linear
        fn.restype = ctypes.c_int
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        fns[name] = fn
    return fns


def _launch(fn, plan, x, w, b, res, y, epi) -> None:
    (m, k), n = x.shape, w.shape[1]
    build.check(fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), res.data_ptr(), y.data_ptr(),
                   m, n, k, epi, *plan, torch.cuda.current_stream().cuda_stream), "linear")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("linear_ab needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fns = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).bfloat16()

    for tag, (m, k, n, epi) in SHAPES.items():
        x, w, b, res = rnd(m, k), rnd(k, n, scale=k ** -0.5), rnd(n, scale=0.5), rnd(m, n)
        runs = [(src, pname, p) for src in fns for pname, p in plans(m, n, k, sms).items()
                if src == "committed" or pname == "plan"] + [("torch.addmm", "-", None)]
        ref = None
        for order in (runs, runs[::-1]):  # A, B, ..., B, A
            for src, pname, p in order:
                y = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
                if p is None:
                    ms = measure_graph_time(lambda: torch.addmm(b, x, w, out=y))["p50_ms"]
                    print(f"{tag:20s} {src:13s} {'':26s} {ms * 1e3:9.2f} us")
                    continue
                ms = measure_graph_time(
                    lambda: _launch(fns[src], p, x, w, b, res, y, epi))["p50_ms"]
                ref = y.clone() if ref is None else ref
                diff = float((y.float() - ref.float()).abs().max())
                print(f"{tag:20s} {src:13s} {pname:8s} rows {p[0]:3d} cols {p[1]:3d} "
                      f"{ms * 1e3:9.2f} us  max|diff vs committed| {diff:.3g}")


if __name__ == "__main__":
    main()
