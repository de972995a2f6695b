"""What K13's kernels cost on the card: ``csrc/sdpa_long.cu`` (every shape
past ``csrc/sdpa.cu``'s resident form) under its plans, beside floors, the
streamed form it replaced and SDPA; and the softmax of both
(``csrc/sdpa_softmax.cuh``) against variants of it.  Each source variant is
built into its own library and timed on the same inputs.

    python -m edgevisiontransformer_tpu_torch.bench.sdpa_ab [--against DIR]

Part 1, sdpa_long.cu at ``LONG_SHAPES`` (the ``SDPA_SHAPES`` entries of
chip_smoke.py that it takes): under ``long_plan`` and with 64, 128 and 192
query rows a block and K and V resident or streamed through the ring forced; its
floors (``LONG_VARIANTS``: without the softmax; loads only, the consumers
waiting for every tile and storing zeros; products only, no TMA load and no
softmax; neither floor's output is attention); the streamed form of sdpa.cu
that it replaced (``STREAMED_SOURCE``, kept here as source and exported as
``evt_sdpa_streamed``); SDPA on the same views.  Then sdpa_long.cu forced at
deit_tiny b128 (n = 197), where sdpa.cu's resident form runs.

Part 2, sdpa.cu at ``SHAPES`` (the resident form): the committed exact
division ``e / l`` (two corrections of ``e * RN(1/l)``, the last
Markstein's, or ``__fdiv_rn`` where a row's scores span too far);
``__fdiv_rn`` per score, which must give the same output bit for bit; a
product with the rounded reciprocal of ``l`` (off K13 by up to one bf16
spacing); ``exp2`` of a prescaled difference in place of ``exp``; no
softmax at all (the helpers return their first argument, so the compiler
drops the sums, the exps and the divisions: a floor).  With ``--against
DIR``, the ``sdpa.cu`` of another checkout's ``csrc`` directory ``DIR``
(built against its own headers) joins them.

Each line gives the device time per launch (a CUDA graph of 20 launches
replayed 5 times, ``harness.measure_graph_time``'s median), the largest
difference from the committed kernel's output and the number of elements
that differ; every configuration runs twice, in the order A, B, ..., B, A.
Needs a CUDA device and ``nvcc``; the libraries go to ``build/sdpa_ab/``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from ..ops.cuda import build
from ..ops.cuda import fused_attention as fa

# chip_smoke.py's SDPA_SHAPES on sdpa.cu's resident form: deit_tiny b128 /
# b1, t2t_vit_14 b1, the pruned model's one head at b1 and b128, head_dim 32
SHAPES = {"deit_tiny b128": (128, 3, 197, 64), "deit_tiny b1": (1, 3, 197, 64),
          "t2t_vit_14 b1": (1, 6, 197, 64), "pruned h1 b1": (1, 1, 197, 64),
          "pruned h1 b128": (128, 1, 197, 64), "head_dim 32 b8": (8, 6, 197, 32)}
# ... and on sdpa_long.cu: ViT-H/14 (257 keys, head_dim 80) at b1 and b8,
# deit_base at 384 (577 keys), ViT-g/14's head_dim 88, 112 at 197 keys
LONG_SHAPES = {"ViT-H/14 b1": (1, 16, 257, 80), "ViT-H/14 b8": (8, 16, 257, 80),
               "deit_base 384 b8": (8, 12, 577, 64), "head_dim 88 b2": (2, 16, 257, 88),
               "head_dim 112 b2": (2, 4, 197, 112)}
# sdpa_long.cu forced where sdpa.cu's resident form runs
FORCED_SHAPES = {"deit_tiny b128": (128, 3, 197, 64)}

# the bodies of the softmax helpers normalise(e, l, y), divide_ieee(e, l)
# and exp_shifted(s, m) in sdpa_softmax.cuh
_DIV = """  float q = __fmul_rn(e, y);
  q = __fmaf_rn(__fmaf_rn(-l, q, e), y, q);
  return __fmaf_rn(__fmaf_rn(-l, q, e), y, q);"""
_IEEE = "return __fdiv_rn(e, l);"
_EXP = "return expf(__fsub_rn(s, m));"
# sdpa_long.cu's consumers after Q landed, and the producer's loads
_PASSES = "  // pass 1: the running row max m and this thread's share of the row sum l\n"
_LOADS_ONLY = """  if (true) {  // loads only: wait for every tile, release it, store zeros
    float z0[Cols<KS>::N0 / 2] = {}, z1[Cols<KS>::O1] = {};
    for (int g = 0; g < (resident ? 2 : 3) * tiles; ++g) {
      mbar_wait(full + g % stages, (g / stages) & 1);
      if (!resident && signal) mbar_arrive(empty + g % stages);
    }
    store_o<KS, T>(p, z0, z1, sQ + w * TILE, q0 + w * ROWS, head, img, w);
    return;
  }
"""
_NO_LOADS = (("  mbar_expect(qbar, WG * TILE);\n", "  mbar_arrive(qbar);\n"),
             ("    mbar_expect(full + slot, TILE);\n", "    mbar_arrive(full + slot);\n"),
             ("      tma_box4(sQ + w * TILE", "      if (false) tma_box4(sQ + w * TILE"),
             ("      tma_box4(dst + c * BOX", "      if (false) tma_box4(dst + c * BOX"))
# name: ((anchor, replacement) pairs on sdpa_long.cu, the softmax header's
# "no softmax" variant with it)
LONG_VARIANTS = {
    "committed": ((), False),
    "no softmax (loads and products)": ((), True),
    "loads only (floor)": (((_PASSES, _LOADS_ONLY + _PASSES),), True),
    "products only (floor)": (_NO_LOADS, True),
}

# csrc/sdpa.cu's streamed form before csrc/sdpa_long.cu took its shapes: one
# 4-warp block per (image * head, 64-query tile), 64-key tiles of K (sweep
# 1) and then K and V (sweep 2) through a 2-stage cp.async ring behind two
# block barriers a step, mma.sync products; the same softmax
STREAMED_SOURCE = r"""
#include "sdpa_softmax.cuh"

namespace {

constexpr int QT = 64, KT = 64, WARPS = 4, THREADS = WARPS * 32;

struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, ob, oh, on;
};

template <int HD, class T>
__global__ __launch_bounds__(THREADS) void sdpa_streamed_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, Strides st, int heads, int n, int hd, float scale) {
  constexpr int LD = row_ld(HD);
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sKV = sQ + QT * LD;

  const int img = blockIdx.x / heads, head = blockIdx.x % heads;
  const int q0 = blockIdx.y * QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp * 16;
  const bool active = q0 + wr < n;
  T* sQw = sQ + wr * LD;
  const T* qp = q + img * st.qb + head * st.qh;
  const T* kp = k + img * st.kb + head * st.kh;
  const T* vp = v + img * st.vb + head * st.vh;
  T* op = out + img * st.ob + head * st.oh;
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;

  load_rows<HD, THREADS, true>(sQ, qp, st.qn, q0, QT, n, tid, hd);
  constexpr int NC = KT / 16;
  const int tiles = (n + KT - 1) / KT, steps = 2 * tiles;
  auto prefetch = [&](int i) {
    T* sK = sKV + (i & 1) * 2 * KT * LD;
    const int t = i < tiles ? i : i - tiles;
    load_rows<HD, THREADS, true>(sK, kp, st.kn, t * KT, KT, n, tid, hd);
    if (i >= tiles)
      load_rows<HD, THREADS, true>(sK + KT * LD, vp, st.vn, t * KT, KT, n, tid, hd);
  };
  prefetch(0);
  cp_async_commit();
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, lo[2] = {INFINITY, INFINITY};
  bool corrections = true;
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) prefetch(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const T* sK = sKV + (i & 1) * 2 * KT * LD;
      const int t = i < tiles ? i : i - tiles;
      float s[NC][2][4];
      qk<HD, NC>(s, sQw, sK, lane);
      scale_mask<NC>(s, t * KT, n, scale, lane, lo);
      if (i < tiles) {
        float mt[2], lt[2];
        row_max<NC>(s, mt);
#pragma unroll
        for (int r = 0; r < 2; ++r) mt[r] = fmaxf(mt[r], m[r]);
        exp_rows<NC>(s, mt, lt);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = __fadd_rn(__fmul_rn(l[r], exp_shifted(m[r], mt[r])), lt[r]);
          m[r] = mt[r];
        }
      } else {
        if (i == tiles) {
          l[0] = quad_sum(l[0]);
          l[1] = quad_sum(l[1]);
          corrections = exact_corrections(lo, m, l);
        }
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float& x = s[c][e / 4][e % 4];
            x = x == -INFINITY ? 0.0f : exp_shifted(x, m[(e % 4) / 2]);
          }
        divide_rows<NC>(s, l, corrections);
        pv<HD, NC>(o, s, sK + KT * LD, lane);
      }
    }
    __syncthreads();
  }
  if (active) store_rows<HD, true>(o, sQw, op, st.on, q0 + wr, n, lane, hd);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, const Strides& st, int bh,
           int heads, int n, int hd, float scale, cudaStream_t stream) {
  constexpr int bytes = (QT + 2 * 2 * KT) * row_ld(HD) * 2;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        sdpa_streamed_kernel<HD, bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(bh, (n + QT - 1) / QT);
  sdpa_streamed_kernel<HD, bf16><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), st, heads, n, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int evt_sdpa_streamed(const void* q, const void* k, const void* v, void* out,
                                 const long long* strides, int batch, int heads, int n,
                                 int head_dim, float scale, void* stream) {
  if (batch == 0 || heads == 0 || n == 0) return 0;
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],  strides[5],
                   strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  const int bh = batch * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((head_dim + 15) / 16) {
    case 4: return launch<64>(q, k, v, out, st, bh, heads, n, head_dim, scale, s);
    case 5: return launch<80>(q, k, v, out, st, bh, heads, n, head_dim, scale, s);
    case 6: return launch<96>(q, k, v, out, st, bh, heads, n, head_dim, scale, s);
    case 7: return launch<112>(q, k, v, out, st, bh, heads, n, head_dim, scale, s);
    case 8: return launch<128>(q, k, v, out, st, bh, heads, n, head_dim, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
"""


def _substitute(src: str, pairs, what: str) -> str:
    for anchor, new in pairs:
        if src.count(anchor) != 1:
            raise ValueError(f"{what} no longer holds {anchor!r} once")
        src = src.replace(anchor, new)
    return src


def variants(src: str) -> dict:
    """``{name: source}``: csrc/sdpa_softmax.cuh as committed and its softmax
    variants."""
    for anchor in (_DIV, _IEEE, _EXP):
        if src.count(anchor) != 1:
            raise ValueError(f"csrc/sdpa_softmax.cuh no longer holds {anchor!r} once")
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


def long_variants(src: str, softmax: str) -> dict:
    """``{name: {file: source}}``: csrc/sdpa_long.cu's ``LONG_VARIANTS``,
    each with the softmax header it is built against."""
    no_softmax = variants(softmax)["no softmax (products only)"]
    return {name: {"sdpa_long.cu": _substitute(src, pairs, "csrc/sdpa_long.cu"),
                   "sdpa_softmax.cuh": no_softmax if plain else softmax}
            for name, (pairs, plain) in LONG_VARIANTS.items()}


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = {"evt_sdpa": [_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P],
         "evt_sdpa_streamed": [_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P],
         "evt_sdpa_long": [_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P]}


def build_variants(against: Path | None = None) -> dict:
    """``{(part, name): (entry name, function)}`` of every variant, each in
    its own directory under ``build/sdpa_ab/`` (its files first on the
    include path, the committed headers after), compiled side by side."""
    out_dir = build.BUILD_DIR.parent / "sdpa_ab"
    softmax = (build.CSRC / "sdpa_softmax.cuh").read_text()
    units = [(("long", name), "sdpa_long.cu", "evt_sdpa_long", files)
             for name, files in long_variants((build.CSRC / "sdpa_long.cu").read_text(),
                                              softmax).items()]
    units.append((("long", "streamed form (replaced)"), "sdpa_streamed.cu", "evt_sdpa_streamed",
                  {"sdpa_streamed.cu": STREAMED_SOURCE}))
    units += [(("resident", name), "sdpa.cu", "evt_sdpa",
               {"sdpa.cu": (build.CSRC / "sdpa.cu").read_text(), "sdpa_softmax.cuh": code})
              for name, code in variants(softmax).items()]
    jobs = []
    for i, (key, cu, entry, files) in enumerate(units):
        vdir = out_dir / f"v{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        for fname, code in files.items():
            (vdir / fname).write_text(code)
        so = vdir / "libsdpa.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", str(vdir),
               "-I", str(build.CSRC), "-o", str(so), str(vdir / cu)]
        jobs.append((key, entry, so, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)))
    if against is not None:
        so = out_dir / "libsdpa_against.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-I", str(against), "-o",
               str(so), str(against / "sdpa.cu")]
        jobs.append((("against", f"{against}/sdpa.cu"), "evt_sdpa", so,
                     subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)))
    fns = {}
    for key, entry, so, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f"{key}: {err}")
        if key == ("long", "committed"):
            regs = sorted({line.split("info    : ")[-1].strip() for line in err.splitlines()
                           if "registers" in line or "spill" in line})
            print(f"sdpa_long.cu ptxas: {'; '.join(regs)}")
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGS[entry]
        fns[key] = (entry, fn)
    return fns


def call(entry: str, fn, q, k, v, out, plan: fa.LongPlan | None = None) -> None:
    """One launch of ``fn`` (an ``entry`` entry point) on the views."""
    b, h, n, d = q.shape
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, b, h, n, d,
            ctypes.c_float(d ** -0.5)]
    if entry == "evt_sdpa_long":
        args += [plan.rows, plan.stages]
    build.check(fn(*args, torch.cuda.current_stream().cuda_stream), entry)


def _views(b, h, n, d, gen):
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device="cuda").bfloat16()
    return qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)


def _line(tag, name, q, k, v, run, ref):
    """Time ``run(out)``, print it beside the largest difference from
    ``ref`` (set from this run's output when None); returns (ms, output)."""
    from .harness import measure_graph_time

    out = torch.empty(q.shape, device="cuda", dtype=torch.bfloat16)
    ms = measure_graph_time(lambda: run(out))["p50_ms"]
    ref = out.clone() if ref is None else ref
    diff = (out.float() - ref.float()).abs()
    print(f"{tag:17s} {name:44s} {ms * 1e3:8.2f} us  max|diff vs committed| "
          f"{float(diff.max()):.3g}  elements differing {int((diff > 0).sum())} of "
          f"{diff.numel()}", flush=True)
    return ms, out


def long_part(fns, sms: int) -> None:
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    for tag, (b, h, n, d) in {**LONG_SHAPES, **FORCED_SHAPES}.items():
        q, k, v = _views(b, h, n, d, gen)
        forced = tag in FORCED_SHAPES
        plan = fa.long_plan(b, h, n, d, sms)
        runs = {f"committed, plan {plan.rows} rows, {plan.stages} stages"
                f"{', resident' if plan.resident else ''}": ("committed", plan)}
        for rows in (64, 128, 192):
            for resident in (True, False):
                try:
                    runs[f"{rows} rows, {'resident' if resident else 'streamed'}"] = (
                        "committed", fa.long_plan(b, h, n, d, sms, rows=rows, resident=resident))
                except ValueError:
                    pass
        if not forced:
            runs.update({name: (name, plan) for name in LONG_VARIANTS if name != "committed"})
        configs = {name: (lambda out, e=fns[("long", key)], p=p: call(*e, q, k, v, out, p))
                   for name, (key, p) in runs.items()}
        if forced:
            configs["sdpa.cu resident form (the main path)"] = (
                lambda out, e=fns[("resident", "exact division (committed)")]:
                call(*e, q, k, v, out))
        else:
            configs["streamed form (replaced)"] = (
                lambda out, e=fns[("long", "streamed form (replaced)")]: call(*e, q, k, v, out))
        configs["SDPA (library)"] = lambda out: out.copy_(F.scaled_dot_product_attention(q, k, v))
        ref = None
        twin = fa.sdpa_plain(q, k, v)
        for order in (list(configs), list(reversed(configs))):
            for name in order:
                _, out = _line(tag, name, q, k, v, configs[name], ref)
                if ref is None:
                    ref = out
                    err = (out.float() - twin.float()).abs()
                    ok = bool((err <= 1e-2 + 2 ** -6 * twin.float().abs()).all())
                    print(f"{tag:17s} committed against sdpa_plain: max |err| "
                          f"{float(err.max()):.3g} ({'within' if ok else 'OUTSIDE'} 0.01 + "
                          f"2^-6 |twin|)", flush=True)


def resident_part(fns) -> None:
    gen = torch.Generator(device="cuda").manual_seed(1)
    names = [key for key in fns if key[0] in ("resident", "against")]
    for tag, (b, h, n, d) in SHAPES.items():
        q, k, v = _views(b, h, n, d, gen)
        ref = None
        for order in (names, list(reversed(names))):
            for key in order:
                _, out = _line(tag, key[1], q, k, v,
                               lambda out, e=fns[key]: call(*e, q, k, v, out), ref)
                ref = out if ref is None else ref


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="another checkout's csrc directory whose sdpa.cu joins part 2")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sdpa_ab needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    fns = build_variants(args.against)
    long_part(fns, torch.cuda.get_device_properties(0).multi_processor_count)
    resident_part(fns)


if __name__ == "__main__":
    main()
