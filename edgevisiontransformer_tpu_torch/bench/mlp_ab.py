"""What the parts of ``csrc/mlp.cu`` (K14) cost on the card: the kernel as
committed against a variant of its source and against other plans of its
grid, each timed on the same inputs.

    python -m edgevisiontransformer_tpu_torch.bench.mlp_ab

Source variants, each built into its own library: the committed kernel; no
GELU (the helper ``gelu_act`` returns its argument: the products, the loads
and the stores only, a floor; its output is not the MLP).  Plan variants,
on the committed library: the plan ``fused_mlp.plan`` picks; the cluster
split forced to 1 (off) and to 2, at the widest column tiles; chunks of 32
hidden units; 64 and 128 rows per block (each where it fits).  Each line gives the device time per launch (``harness.measure_graph_time``: CUDA events around a CUDA graph
of 20 launches replayed, median of 5 samples; the host's ctypes loop would
time itself at b1) and the largest
difference from the committed kernel's output under its own plan.  Needs a
CUDA device and ``nvcc``; the libraries go to ``build/mlp_ab/``.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from ..ops.cuda import build
from ..ops.cuda import fused_mlp as fm
from .harness import measure_graph_time

# (rows, dim, hidden): deit_tiny b1 and b128, deit_base b8
SHAPES = {"deit_tiny b1": (197, 192, 768), "deit_tiny b128": (128 * 197, 192, 768),
          "deit_base b8": (8 * 197, 768, 3072)}
# the body of the kernel's activation helper gelu_act(h, approx)
_GELU = "return approx ? gelu_tanh_f(h) : gelu_erf_f(h);"


def variants(src: str) -> dict:
    if src.count(_GELU) != 1:
        raise ValueError(f"csrc/mlp.cu no longer holds {_GELU!r} once")
    return {"committed": src, "no GELU (products only)": src.replace(_GELU, "return h;")}


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


def build_variants() -> dict:
    """``{name: evt_mlp}`` of each source variant, compiled side by side."""
    out_dir = build.BUILD_DIR.parent / "mlp_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, (name, code) in enumerate(variants((build.CSRC / "mlp.cu").read_text()).items()):
        cu, so = out_dir / f"mlp_v{i}.cu", out_dir / f"libmlp_v{i}.so"
        cu.write_text(code)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC), "-o",
               str(so), str(cu)]
        jobs.append((name, so, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)))
    fns = {}
    for name, so, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f"{name}: {err}")
        fn = ctypes.CDLL(str(so)).evt_mlp
        fn.restype = ctypes.c_int
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fns[name] = fn
    return fns


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
    fns = build_variants()
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


if __name__ == "__main__":
    main()
