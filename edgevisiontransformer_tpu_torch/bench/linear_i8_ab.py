"""What the parts of ``csrc/linear_i8.cu`` cost on the card: the kernel as
committed against variants of its tile's source, against other plans of its
grid, against the WMMA kernel it replaced and against ``torch._int_mm``, each
timed on the same inputs.

    python -m edgevisiontransformer_tpu_torch.bench.linear_i8_ab [--against DIR]

Source variants of ``csrc/linear_i8_tile.cuh``, each built with the int8
sources into its own library: the committed tile; no epilogue (the helper
``epilogue`` returns the converted int32 sum: the products, the loads and
the bf16 stores only, a floor; its output is not the GEMM's); no byte
permutes (``frag_b`` hands the ldmatrix.trans registers to the product as
they come, so the output is not the GEMM's either: this is the inner loop
that a weight copy stored [N, K] at prepare time would run, ldmatrix then
mma with nothing between, so its time against the committed one is what the
in-kernel transpose costs); a warp patch (each thread packs its four bf16
results into its warp's patch of the idle ring, after a barrier, and the
warp copies the patch to Y as 16-byte vectors, as ``linear`` does, instead
of storing them straight to Y 8 bytes at a time); a 4-stage ring.  Plan
variants, on the committed library: the plan ``fused_encoder.linear_i8_plan``
picks, every other compiled block shape unsplit, and the plan's block shape
at every other split of K (1, 2, 3, 4, 6 or 8 blocks a cluster, none
without a K step).  The WMMA kernel (:data:`WMMA_SOURCE`, exported
as ``evt_linear_i8_wmma``) is ``csrc/linear_i8.cu`` before its redesign,
built beside; with ``--against DIR`` the int8 sources of another checkout's
``csrc`` directory ``DIR`` (``linear_i8.cu`` and any ``i8_rows*.cu``, built
against its own headers) join them.  The library yardstick is
``torch._int_mm(q, w)`` (no dequant, no epilogue; it takes no width that is
not a multiple of 8).  Shapes: the four GEMMs of one static-int8 deit_tiny
layer at b128 and at b1, deit_base's fc2 at b1, Swin stage 1's qkv and fc2
at b32, and the pruned width 230 at b1 and b128.  Each line gives the device
time per launch (``harness.measure_graph_time``: CUDA events around a CUDA
graph of 20 launches replayed, median of 5 samples), the largest difference
from the committed kernel's output under its own plan and the number of
elements that differ.  Runs go A, B, ..., B, A.  Needs a CUDA device and
``nvcc``; the libraries go to ``build/linear_i8_ab/``.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import re
import subprocess
from pathlib import Path

import torch

from ..ops.cuda import build
from ..ops.cuda import fused_encoder as fe
from .harness import measure_graph_time

# (rows, K, N, epilogue code of csrc/linear_i8.cu): deit_tiny's qkv, out,
# fc1 (exact GELU) and fc2 at b128 and b1, deit_base's fc2 at b1, Swin stage
# 1 (28 x 28 tokens of width 192) at b32, the pruned hidden width 230
SHAPES = {"deit_tiny b128 qkv": (128 * 197, 192, 576, 0),
          "deit_tiny b128 out": (128 * 197, 192, 192, 3),
          "deit_tiny b128 fc1": (128 * 197, 192, 768, 2),
          "deit_tiny b128 fc2": (128 * 197, 768, 192, 3),
          "deit_tiny b1 qkv": (197, 192, 576, 0), "deit_tiny b1 out": (197, 192, 192, 3),
          "deit_tiny b1 fc1": (197, 192, 768, 2), "deit_tiny b1 fc2": (197, 768, 192, 3),
          "deit_base b1 fc2": (197, 3072, 768, 3),
          "swin_tiny b32 s1 qkv": (32 * 784, 192, 576, 0),
          "swin_tiny b32 s1 fc2": (32 * 784, 768, 192, 3),
          "pruned b1 fc1 230": (197, 192, 230, 2), "pruned b1 fc2 230": (197, 230, 192, 3),
          "pruned b128 fc1 230": (128 * 197, 192, 230, 2)}
# the sources of the kernel, and the anchors of the variants in the tile's:
# the body of the helper epilogue<EPI>, frag_b's byte permutes, the ring
# depth, the vector store, store_tile's first line and its end, the wait
# after the products
SOURCES = ("linear_i8.cu", "i8_rows64.cu", "i8_rows32.cu", "i8_rows16.cu")
TILE = "linear_i8_tile.cuh"
COMMITTED = "committed"
WMMA = "WMMA kernel (parent)"
INT_MM = "torch._int_mm"
_EPILOGUE = ("  const float accf = __int2float_rn(acc);\n"
             "  const float deq = dynamic ? __fmul_rn(__fmul_rn(accf, sr), ws) : "
             "__fmul_rn(accf, ws);\n"
             "  const float v = __fadd_rn(deq, b);\n"
             "  if constexpr (EPI == 3) return __fadd_rn(v, r);\n"
             "  if constexpr (EPI == 1) return gelu_tanh_f(round_to<T>(v));\n"
             "  if constexpr (EPI == 2) return gelu_erf_f(round_to<T>(v));\n"
             "  return v;\n")
_PERMUTES = ("  b[0] = __byte_perm(r[0], r[1], sel);\n"
             "  b[1] = __byte_perm(r[2], r[3], sel);\n"
             "  b[2] = __byte_perm(r[0], r[1], sel + 0x1111);\n"
             "  b[3] = __byte_perm(r[2], r[3], sel + 0x1111);\n")
_STAGES = "constexpr int BK = 128, STAGES = 3;"
_STORE = ("          if (gm < M && gn < N)\n"
          "            *reinterpret_cast<uint2*>(Y + off) =\n"
          "                make_uint2(pack2<T>(y[0], y[1]), pack2<T>(y[2], y[3]));\n")
_STORE_HEAD = "  const int g = lane >> 2, t = lane & 3;\n  const bool dynamic"
_STORE_END = "        }\n      }\n  }\n}\n\n// A block of WM"
_WAIT = "  cp_async_wait<0>();  // no copy outlives the block (the last groups are empty)\n"

# csrc/linear_i8.cu before its redesign: int8 WMMA 16x16x16 fragments on a
# fixed 128 x 128 tile, 16-column panels in shared memory, the int32 tile
# staged in shared memory for the epilogue; its export renamed
WMMA_SOURCE = r"""#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3, THREADS = 256;
// Panel p of the A tile holds columns [16p, 16p + 16) of its BM rows, row r
// at byte 16r; the B tile likewise in BN / 16 panels of BK rows.  The 32
// spare bytes per panel spread the panels over the shared-memory banks and
// keep every panel 32-byte aligned.
constexpr int A_PANEL = BM * 16 + 32;
constexpr int B_PANEL = BK * 16 + 32;
constexpr int A_STAGE = (BK / 16) * A_PANEL;
constexpr int B_STAGE = (BN / 16) * B_PANEL;
constexpr int PIPE_BYTES = STAGES * (A_STAGE + B_STAGE);
constexpr int CS = BN + 4;  // int32 output tile row stride (elements)
constexpr int C_BYTES = BM * CS * 4;
constexpr int SMEM_BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
static_assert(A_STAGE % 32 == 0 && B_STAGE % 32 == 0, "panels must stay 32-byte aligned");

// One K step of the A (Q) and B (W) tiles into their panels.  VA / VB: the
// operand's rows are 16-byte aligned (cp.async of 16 values, all in or all
// out); otherwise each value is loaded and masked on its own.
template <bool VA, bool VB>
__device__ __forceinline__ void load_stage(int8_t* sA, int8_t* sB, const int8_t* __restrict__ Q,
                                           const int8_t* __restrict__ W, int M, int N, int K,
                                           int m0, int n0, int k0, int tid) {
  if constexpr (VA) {
#pragma unroll
    for (int i = tid; i < BM * (BK / 16); i += THREADS) {
      const int r = i / (BK / 16), c = i % (BK / 16);
      const int gm = m0 + r, gk = k0 + c * 16;
      const bool ok = gm < M && gk < K;
      cp_async16(sA + c * A_PANEL + r * 16, ok ? Q + static_cast<size_t>(gm) * K + gk : Q, ok);
    }
  } else {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      sA[(c >> 4) * A_PANEL + r * 16 + (c & 15)] =
          gm < M && gk < K ? Q[static_cast<size_t>(gm) * K + gk] : int8_t(0);
    }
  }
  if constexpr (VB) {
#pragma unroll
    for (int i = tid; i < BK * (BN / 16); i += THREADS) {
      const int r = i / (BN / 16), c = i % (BN / 16);
      const int gk = k0 + r, gn = n0 + c * 16;
      const bool ok = gk < K && gn < N;
      cp_async16(sB + c * B_PANEL + r * 16, ok ? W + static_cast<size_t>(gk) * N + gn : W, ok);
    }
  } else {
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      sB[(c >> 4) * B_PANEL + r * 16 + (c & 15)] =
          gk < K && gn < N ? W[static_cast<size_t>(gk) * N + gn] : int8_t(0);
    }
  }
}

// The dequant and epilogue of one int32 sum: deq = (f32(acc) * sr) * ws
// (dynamic) or f32(acc) * ws (static), then bias, and GELU or residual.
__device__ __forceinline__ float epilogue(int acc, bool dynamic, float sr, float ws, float b,
                                          float r, int epi) {
  const float accf = __int2float_rn(acc);
  const float deq = dynamic ? __fmul_rn(__fmul_rn(accf, sr), ws) : __fmul_rn(accf, ws);
  const float v = __fadd_rn(deq, b);
  if (epi == 3) return __fadd_rn(v, r);
  if (epi == 1) return gelu_tanh_f(round_bf16(v));
  if (epi == 2) return gelu_erf_f(round_bf16(v));
  return v;
}

template <bool VA, bool VB>
__global__ __launch_bounds__(THREADS) void linear_i8_kernel(
    const int8_t* __restrict__ Q, const float* __restrict__ s_row, const int8_t* __restrict__ W,
    const float* __restrict__ w_s, const void* __restrict__ bias, const bf16* __restrict__ res,
    bf16* __restrict__ Y, int M, int N, int K, int epi, int bias_f32) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* sA = reinterpret_cast<int8_t*>(smem);
  int8_t* sB = sA + STAGES * A_STAGE;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_stage<VA, VB>(sA + s * A_STAGE, sB + s * B_STAGE, Q, W, M, N, K, m0, n0, s * BK, tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt-1
    const int nk = kt + STAGES - 1;
    if (nk < KT) {
      const int s = nk % STAGES;
      load_stage<VA, VB>(sA + s * A_STAGE, sB + s * B_STAGE, Q, W, M, N, K, m0, n0, nk * BK,
                         tid);
    }
    cp_async_commit();
    const int8_t* a = sA + (kt % STAGES) * A_STAGE;
    const int8_t* b = sB + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], reinterpret_cast<const signed char*>(
                                          a + kk * A_PANEL + (wm + i * 16) * 16), 16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], reinterpret_cast<const signed char*>(
                                          b + ((wn >> 4) + j) * B_PANEL + kk * 16 * 16), 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // the pipeline buffers become the int32 output tile
  int* sC = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(sC + (wm + i * 16) * CS + wn + j * 16, acc[i][j], CS,
                              wmma::mem_row_major);
  __syncthreads();

  const bool dynamic = s_row != nullptr;
  if constexpr (VB) {
    for (int i = tid; i < BM * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int gm = m0 + r, gn = n0 + c;
      if (gm >= M || gn >= N) continue;  // N % 16 == 0: a vector is all in or all out
      const int4 a0 = *reinterpret_cast<const int4*>(sC + r * CS + c);
      const int4 a1 = *reinterpret_cast<const int4*>(sC + r * CS + c + 4);
      const int av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float4 s0 = *reinterpret_cast<const float4*>(w_s + gn);
      const float4 s1 = *reinterpret_cast<const float4*>(w_s + gn + 4);
      const float wv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      float bv[8], v[8], rv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      load8_either(bias, gn / 8, bias_f32, bv);
      const float sr = dynamic ? s_row[gm] : 0.f;
      const size_t off = static_cast<size_t>(gm) * N + gn;
      if (epi == 3) unpack8(*reinterpret_cast<const uint4*>(res + off), rv);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = epilogue(av[e], dynamic, sr, wv[e], bv[e], rv[e], epi);
      *reinterpret_cast<uint4*>(Y + off) = pack8(v);
    }
  } else {
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gm = m0 + r, gn = n0 + c;
      if (gm >= M || gn >= N) continue;
      const size_t off = static_cast<size_t>(gm) * N + gn;
      const float b = bias_f32 ? static_cast<const float*>(bias)[gn]
                               : __bfloat162float(static_cast<const bf16*>(bias)[gn]);
      const float rv = epi == 3 ? __bfloat162float(res[off]) : 0.f;
      Y[off] = __float2bfloat16_rn(
          epilogue(sC[r * CS + c], dynamic, dynamic ? s_row[gm] : 0.f, w_s[gn], b, rv, epi));
    }
  }
}

template <bool VA, bool VB>
int launch(const void* q, const void* s_row, const void* w, const void* w_s, const void* bias,
           const void* res, void* y, int M, int N, int K, int epi, int bias_f32,
           cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        linear_i8_kernel<VA, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  linear_i8_kernel<VA, VB><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s_row),
      static_cast<const int8_t*>(w), static_cast<const float*>(w_s), bias,
      static_cast<const bf16*>(res), static_cast<bf16*>(y), M, N, K, epi, bias_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// s_row == nullptr: static dequant (w_s holds the combined scale).
extern "C" int evt_linear_i8_wmma(const void* q, const void* s_row, const void* w, const void* w_s,
                             const void* bias, const void* res, void* y, int M, int N, int K,
                             int epi, int bias_f32, void* stream) {
  if (M == 0 || N == 0) return 0;
  const bool va = K % 16 == 0 && aligned16(q);
  const bool vb = N % 16 == 0 && aligned16(w) && aligned16(w_s) && aligned16(bias) &&
                  aligned16(res) && aligned16(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (va && vb) return launch<true, true>(q, s_row, w, w_s, bias, res, y, M, N, K, epi, bias_f32, s);
  if (va) return launch<true, false>(q, s_row, w, w_s, bias, res, y, M, N, K, epi, bias_f32, s);
  if (vb) return launch<false, true>(q, s_row, w, w_s, bias, res, y, M, N, K, epi, bias_f32, s);
  return launch<false, false>(q, s_row, w, w_s, bias, res, y, M, N, K, epi, bias_f32, s);
}
"""


def variants(src: str) -> dict:
    """``{name: source of linear_i8_tile.cuh}`` for each variant of ``src``."""
    for anchor in (_EPILOGUE, _PERMUTES, _STAGES, _STORE, _STORE_HEAD, _STORE_END, _WAIT):
        if src.count(anchor) != 1:
            raise ValueError(f"csrc/{TILE} no longer holds {anchor!r} once")
    patch = src.replace(_STORE_HEAD, (
        "  constexpr int TM = FM * 16, TN = FN * 8, PLD = TN + 8;\n"
        "  extern __shared__ __align__(128) unsigned char smem[];\n"
        "  T* patch = reinterpret_cast<T*>(smem) + (threadIdx.x >> 5) * TM * PLD;\n"
        + _STORE_HEAD))
    patch = patch.replace(_STORE, (
        "          *reinterpret_cast<uint2*>(patch + (gm - r0) * PLD + c) =\n"
        "              make_uint2(pack2<T>(y[0], y[1]), pack2<T>(y[2], y[3]));\n"))
    patch = patch.replace(_STORE_END, (
        "        }\n      }\n  }\n  if (!vb) return;\n  __syncwarp();\n"
        "  for (int i = lane; i < TM * (TN / 8); i += 32) {\n"
        "    const int r = i / (TN / 8), c = (i % (TN / 8)) * 8;\n"
        "    if (r0 + r < M && c0 + c < N)\n"
        "      *reinterpret_cast<uint4*>(Y + static_cast<size_t>(r0 + r) * N + c0 + c) =\n"
        "          *reinterpret_cast<const uint4*>(patch + r * PLD + c);\n"
        "  }\n}\n\n// A block of WM"))
    patch = patch.replace(_WAIT, _WAIT + "  __syncthreads();  // the ring holds the warps' patches\n")
    raw = "  b[0] = r[0];\n  b[1] = r[2];\n  b[2] = r[1];\n  b[3] = r[3];\n"
    return {COMMITTED: src,
            "no epilogue": src.replace(_EPILOGUE, "  return __int2float_rn(acc);\n"),
            "no byte permutes": src.replace(_PERMUTES, raw),
            "warp patch": patch,
            "4 stages": src.replace(_STAGES, _STAGES.replace("STAGES = 3", "STAGES = 4"))}


SPLITS = (1, 2, 3, 4, 6, 8)


def plans(m: int, n: int, k: int, sms: int) -> dict:
    """``{name: (rows, cols, split)}``: the committed plan, every other
    block shape the kernel is compiled for (unsplit), and the plan's block
    shape at every other split of K's steps."""
    plan = fe.linear_i8_plan(m, n, k, sms)
    out = {"plan": plan}
    for r in fe.LINEAR_I8_ROWS:
        for c in fe.LINEAR_I8_COLS:
            if (r, c, 1) != plan:
                out[f"{r}x{c}"] = (r, c, 1)
    for s in SPLITS:
        if s not in (1, plan[2]) and s <= -(-k // fe.LINEAR_I8_BK):
            out[f"split {s}"] = (*plan[:2], s)
    return out


def _bind(so: Path, name: str, planned: bool):
    """``name`` of library ``so``, typed: the committed signature (with the
    plan's rows and columns) or the WMMA kernel's (without)."""
    fn = getattr(ctypes.CDLL(str(so)), name)
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 7 + [i] * (8 if planned else 5) + [p]
    return fn


def _compile(jobs: list, objs: dict, out_dir: Path) -> dict:
    """Wait for ``jobs`` (name, Popen), then link each name's objects."""
    for name, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f"{name}: {err}")
    libs = {}
    for i, (name, files) in enumerate(objs.items()):
        so = out_dir / f"liblinear_i8_v{i}.so"
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", str(so),
                        *map(str, files)], check=True)
        libs[name] = so
    return libs


def build_libraries(source_variants: bool = True, against: Path | None = None) -> tuple:
    """``({name: (evt_linear_i8, planned)}, evt_linear_i8_wmma)``: each
    source variant (only the committed one unless ``source_variants``), the
    sources of ``against`` if given (``planned``: its entry takes the plan's
    rows and columns), and the WMMA kernel, all compiled side by side."""
    out_dir = build.BUILD_DIR.parent / "linear_i8_ab"
    nvcc = build.nvcc_path()
    srcs = variants((build.CSRC / TILE).read_text())
    if not source_variants:
        srcs = {COMMITTED: srcs[COMMITTED]}
    jobs, objs = [], {}

    def compile_one(name, cu, include):
        obj = cu.with_suffix(".o")
        cmd = [nvcc, *build.NVCC_FLAGS, "-I", str(include), "-c", "-o", str(obj), str(cu)]
        jobs.append((name, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)))
        objs.setdefault(name, []).append(obj)

    for i, (name, code) in enumerate(srcs.items()):
        vdir = out_dir / f"v{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / TILE).write_text(code)
        for src in SOURCES:  # copies beside the variant's tile, which they include
            (vdir / src).write_text((build.CSRC / src).read_text())
            compile_one(name, vdir / src, build.CSRC)
    wdir = out_dir / "wmma"
    wdir.mkdir(parents=True, exist_ok=True)
    (wdir / "linear_i8_wmma.cu").write_text(WMMA_SOURCE)
    compile_one(WMMA, wdir / "linear_i8_wmma.cu", build.CSRC)
    planned = {}
    if against is not None:
        name = f"{against}"
        entry = (against / "linear_i8.cu").read_text()
        planned[name] = re.search(r"evt_linear_i8\([^)]*int split", entry) is not None
        adir = out_dir / "against"
        adir.mkdir(parents=True, exist_ok=True)
        for src in sorted(against.glob("*.cu")):
            if src.name == "linear_i8.cu" or src.name.startswith("i8_rows"):
                (adir / src.name).write_text(src.read_text())
                compile_one(name, adir / src.name, against)
    libs = _compile(jobs, objs, out_dir)
    wmma = _bind(libs.pop(WMMA), "evt_linear_i8_wmma", planned=False)
    fns = {name: (_bind(so, "evt_linear_i8", planned.get(name, True)), planned.get(name, True))
           for name, so in libs.items()}
    return fns, wmma


@functools.lru_cache(maxsize=None)
def wmma_kernel():
    """The WMMA kernel alone, built once (the card tests hold the committed
    kernel to it bit for bit)."""
    return build_libraries(source_variants=False)[1]


def launch(fn, q, s_row, w_q, w_s, b, res, y, epi, plan=None) -> None:
    """One launch of a built ``evt_linear_i8`` (``plan``: its rows, columns
    and split) or of the WMMA kernel (``plan`` None)."""
    (m, k), n = q.shape, w_q.shape[1]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = [ptr(q), ptr(s_row), ptr(w_q), ptr(w_s), ptr(b), ptr(res), ptr(y), m, n, k, epi,
            int(b.dtype == torch.float32)]
    if plan is not None:
        args += list(plan)
    build.check(fn(*args, torch.cuda.current_stream().cuda_stream), "linear_i8")


def inputs(m: int, k: int, n: int, epi: int, *, static: bool = True, seed: int = 0) -> tuple:
    """``(q, s_row, w_q, w_s, b, res)`` on the card: int8 operands, scales
    that give a dequantized sum of order 1, an fp32 bias, a bf16 residual
    for epilogue 3."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    unit = 1.0 / (73.0 * 73.0 * k ** 0.5)
    q = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    w_q = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    s_row = None if static else torch.rand(m, generator=gen, device="cuda") * 0.05 + 0.025
    w_s = (torch.rand(n, generator=gen, device="cuda") + 0.5) * (unit if static else unit / 0.05)
    b = torch.randn(n, generator=gen, device="cuda") * 0.5
    res = (torch.randn(m, n, generator=gen, device="cuda").bfloat16() if epi == 3 else None)
    return q, s_row, w_q, w_s, b, res


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="another checkout's csrc directory, whose int8 kernel joins")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("linear_i8_ab needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fns, wmma = build_libraries(against=args.against)
    layer = {}  # (tag prefix, run name) -> summed ms of a layer's four GEMMs
    for tag, (m, k, n, epi) in SHAPES.items():
        q, s_row, w_q, w_s, b, res = inputs(m, k, n, epi)
        runs = [(src, pname, p) for src in fns
                for pname, p in (plans(m, n, k, sms).items() if src == COMMITTED
                                 else [("plan", fe.linear_i8_plan(m, n, k, sms))])]
        runs += [(WMMA, "-", None)] + ([(INT_MM, "-", None)] if k % 8 == 0 == n % 8 else [])
        ref = None
        for order in (runs, runs[::-1]):  # A, B, ..., B, A
            for src, pname, p in order:
                y = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
                if src == INT_MM:
                    ms = measure_graph_time(lambda: torch._int_mm(q, w_q))["p50_ms"]
                    print(f"{tag:22s} {src:17s} {'':34s} {ms * 1e3:9.2f} us")
                else:
                    fn, planned = (wmma, False) if src == WMMA else fns[src]
                    use = p if planned else None
                    ms = measure_graph_time(
                        lambda: launch(fn, q, s_row, w_q, w_s, b, res, y, epi, use))["p50_ms"]
                    ref = y.clone() if ref is None else ref
                    diff = (y.float() - ref.float()).abs()
                    shape = f"rows {p[0]:3d} cols {p[1]:3d} split {p[2]}" if use else ""
                    print(f"{tag:22s} {src:17s} {pname:8s} {shape:25s} {ms * 1e3:9.2f} us  "
                          f"max|diff vs committed| {float(diff.max()):.3g}  "
                          f"elements differing {int((diff > 0).sum())} of {diff.numel()}")
                if pname in ("plan", "-") and tag.startswith("deit_tiny"):
                    key = (tag.rsplit(" ", 1)[0], src)
                    layer[key] = layer.get(key, 0.0) + ms / 2
    print("one static-int8 deit_tiny layer (qkv, out, fc1 erf, fc2), ms, mean of the A and B runs")
    for (prefix, src), ms in layer.items():
        print(f"  {prefix:15s} {src:17s} {ms:.4f}")


if __name__ == "__main__":
    main()
