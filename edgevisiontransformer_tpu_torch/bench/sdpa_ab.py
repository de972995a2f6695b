"""What the softmax of ``csrc/sdpa.cu`` (K13) costs on the card: the kernel
as committed against variants of its source, each built into its own
library and timed on the same inputs.

    python -m edgevisiontransformer_tpu_torch.bench.sdpa_ab

Variants rewrite the kernel's softmax helpers ``exp_shifted``,
``normalise`` and ``divide_ieee``: the committed exact division ``e / l``
(two corrections of ``e * RN(1/l)``, the last Markstein's, or ``__fdiv_rn``
where a row's scores span too far); ``__fdiv_rn`` per score, which must give
the same output bit for bit; a product with the rounded reciprocal of ``l``
(off K13 by up to one bf16 spacing); ``exp2`` of a prescaled difference in
place of ``exp``; no softmax at all (the helpers return their first
argument, so the compiler drops the sums, the exps and the divisions: the
products, the loads and the stores only, a floor; its output is not
attention).  With ``--against DIR``, the ``sdpa.cu`` of another checkout's
``csrc`` directory ``DIR`` (built against its own headers) joins them, so
that a change to the shared routines can be held to the kernel it started
from bit for bit.  Each line gives the device time per launch (CUDA events
around 200 launches, median of 5 samples), the largest difference from the
committed kernel's output and the number of elements that differ.  Needs a
CUDA device and ``nvcc``; the libraries go to ``build/sdpa_ab/``.

    python -m edgevisiontransformer_tpu_torch.bench.sdpa_ab [--against DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
from pathlib import Path

import torch

from ..ops.cuda import build

# chip_smoke.py's SDPA_SHAPES: deit_tiny b128 / b1, t2t_vit_14 b1, the
# pruned model's one head at b1 and b128 and head_dim 32 (n = 197, the
# resident form), and deit_base at 384 (n = 577, the streamed form)
SHAPES = {"deit_tiny b128": (128, 3, 197, 64), "deit_tiny b1": (1, 3, 197, 64),
          "t2t_vit_14 b1": (1, 6, 197, 64), "pruned h1 b1": (1, 1, 197, 64),
          "pruned h1 b128": (128, 1, 197, 64), "head_dim 32 b8": (8, 6, 197, 32),
          "deit_base 384 b8": (8, 12, 577, 64)}
# the bodies of the kernel's helpers normalise(e, l, y), divide_ieee(e, l)
# and exp_shifted(s, m)
_DIV = """  float q = __fmul_rn(e, y);
  q = __fmaf_rn(__fmaf_rn(-l, q, e), y, q);
  return __fmaf_rn(__fmaf_rn(-l, q, e), y, q);"""
_IEEE = "return __fdiv_rn(e, l);"
_EXP = "return expf(__fsub_rn(s, m));"


def variants(src: str) -> dict:
    for anchor in (_DIV, _IEEE, _EXP):
        if src.count(anchor) != 1:
            raise ValueError(f"csrc/sdpa.cu no longer holds {anchor!r} once")
    return {
        "exact division (committed)": src,
        "__fdiv_rn per score": src.replace(_DIV, "  " + _IEEE),
        "reciprocal product": src.replace(_IEEE, "return __fmul_rn(e, __frcp_rn(l));")
                                 .replace(_DIV, "  return __fmul_rn(e, y);"),
        "exp2f of prescaled": src.replace(
            _EXP, "return exp2f(__fsub_rn(s, m) * 1.4426950408889634f);"),
        "no softmax (products only)": src.replace(_IEEE, "return e;").replace(_DIV, "  return e;")
                                         .replace(_EXP, "return s;"),
    }


def build_variants(against: Path | None = None) -> dict:
    """``{name: evt_sdpa}`` of each variant (and of ``against/sdpa.cu``, if
    given), compiled side by side."""
    out_dir = build.BUILD_DIR.parent / "sdpa_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = []
    for i, (name, code) in enumerate(variants((build.CSRC / "sdpa.cu").read_text()).items()):
        cu = out_dir / f"sdpa_v{i}.cu"
        cu.write_text(code)
        sources.append((name, cu, build.CSRC))
    if against is not None:
        sources.append((f"{against}/sdpa.cu", against / "sdpa.cu", against))
    jobs = []
    for i, (name, cu, include) in enumerate(sources):
        so = out_dir / f"libsdpa_v{i}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-I", str(include), "-o",
               str(so), str(cu)]
        jobs.append((name, so, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)))
    fns = {}
    for name, so, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f"{name}: {err}")
        fn = ctypes.CDLL(str(so)).evt_sdpa
        fn.restype = ctypes.c_int
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
        fns[name] = fn
    return fns


def _launch(fn, q, k, v, out) -> None:
    b, h, n, d = q.shape
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, b, h, n,
                   d, ctypes.c_float(d ** -0.5), torch.cuda.current_stream().cuda_stream), "sdpa")


def _time(call, iters: int = 200, repeats: int = 5) -> float:
    for _ in range(10):
        call()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="another checkout's csrc directory whose sdpa.cu joins the variants")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sdpa_ab needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    fns = build_variants(args.against)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for tag, (b, h, n, d) in SHAPES.items():
        qkv = torch.randn(b, n, 3 * h * d, generator=gen, device="cuda").bfloat16()
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        ref = None
        for order in (list(fns), list(reversed(fns))):  # A, B, ..., B, A
            for name in order:
                out = torch.empty(b, h, n, d, device="cuda", dtype=torch.bfloat16)
                ms = _time(lambda: _launch(fns[name], q, k, v, out))
                ref = out.clone() if ref is None else ref
                diff = (out.float() - ref.float()).abs()
                print(f"{tag:17s} {name:28s} {ms * 1e3:8.2f} us  max|diff vs committed| "
                      f"{float(diff.max()):.3g}  elements differing {int((diff > 0).sum())} of "
                      f"{diff.numel()}")


if __name__ == "__main__":
    main()
