"""What the parts of ``csrc/t2t_stage1.cu`` (K8, the T2T stage-1
tokenizer ``kqv(LN(unfold(img, k7 s4 p2)))``) cost on the card, against
the kernel it replaced, each timed on the same inputs.

    python -m edgevisiontransformer_tpu_torch.bench.stage1_ab

Variants, each built into its own library: the committed kernel (one
8-warp block per (image, token row, 64 columns), the staged rows and the
whole W9 column slice by cp.async in two groups, the LN statistics while W9
flies, products on mma.sync, the epilogue from registers; 64 or 96 columns
a block, as ``t2t_stage1.stage1_plan`` picks, and each line also times it
under the other); three floors,
whose output is not K8's: without the LN statistics (anchor: the head of
their loop; the epilogue reads zeros), without the W9 wait (anchor: the
copy of W9's slice; the products read whatever the shared memory holds),
and without the products and the epilogue (anchor: the return of a warp
past d, made unconditional: the staging and the statistics alone); and the
parent's kernel (:data:`OLD_SOURCE`, exported as ``evt_t2t_stage1_old``:
one block per (image, token row) of d / 16 warps, W9 in nine 48-row slabs
through a two-slot ring, WMMA, the fp32 output tile through shared
memory).

Shapes: t2t_vit_14's stage 1 (d = 192) at b1, b4, b8 and b32, random
normal images and the weights ``chip_smoke.py`` builds.  Each line gives
the device time (``harness.measure_graph_time``: CUDA events around a CUDA
graph of 20 calls replayed, median of 5 samples), the largest difference
from the committed kernel's output and the number of elements that differ.
Runs go A, B, C, C, B, A; each time is the mean of both passes.  Last, how
many of the 1000 logits of one t2t_vit_14 b1 forward (``fused_t2t_apply``,
seeded random weights) move when the parent's kernel takes the committed
kernel's place, and by how much.  Needs a CUDA device and ``nvcc``; the
libraries go to ``build/stage1_ab/``.
"""

from __future__ import annotations

import ctypes
import subprocess
from collections import defaultdict

import numpy as np
import torch

from ..ops.cuda import build
from ..ops.cuda import t2t_stage1 as ts
from .harness import measure_graph_time

D = 192  # t2t_vit_14's stage-1 kqv width (3 x 64)
BATCHES = (1, 4, 8, 32)
EPS = 1e-5
# Anchors: the head of the LN statistics' loop, the copy of W9's slice and
# the return of a warp wholly past d.
_STATS = "  for (int t = tid; t < GRID * 4; t += THREADS) {\n"
_W9_COPY = ("    cp_async16(sW + r * WS + c, ok ? W9 + static_cast<size_t>(r) * d + n0 + c : W9, "
            "ok);\n")
_PRODUCTS = "  if (n0 + wn >= d) return;  // a warp wholly past d (d < 64)\n"
COMMITTED = "committed"
NO_STATS = "floor: no LN statistics"
NO_W9 = "floor: no W9 wait"
STAGE_ONLY = "floor: staging + statistics"
OLD = "parent kernel"
# csrc/t2t_stage1.cu before its redesign, its entry point renamed.
OLD_SOURCE = r"""// t2t_stage1: the T2T-ViT stage-1 tokenizer, kqv(LN(unfold(img, k7 s4 p2))),
// in one kernel, from the NCHW bf16 image to the [b, 3136, d] kqv rows.
//
// Replaces: edgevisiontransformer_tpu/ops/pallas/t2t_stage1.py
//   `stage1_kqv_kernel` (K8, pallas_call :82; body `_stage1_kernel` :39-58).
//   With W9 [432, d], M9 [432] (0/1), c1, c2 [d] from build_stage1_weights:
//     big = the 9 shifted views of the padded space-to-depth image  [3136, 432]
//     out = big @ W9                      bf16 operands, fp32 accumulation
//     mu  = sum(big * M9) / 147,  sq = sum(big * big * M9) / 147    (fp32)
//     y   = (out - mu * c1) * rsqrt(sq - mu * mu + eps) + c2, cast once
//   The one-pass variance is the TPU kernel's (:54-56).  The TPU version
//   leaves the s2d relayout and pad to XLA; here the kernel reads the NCHW
//   image itself and zero-fills the borders.
//
// Bound on the card: per image 3136 x 432 x d x 2 = 0.52 GFLOP (d = 192) on
// 0.3 MB of image and 166 KB of W9, ~1,000 flop/byte: above the H100's
// balance point, so the tensor cores bound it at serving batches; at b1 its
// 56 blocks leave most of the 132 SMs idle and launch latency dominates.
//
// Design: one thread block per (image, token row y of the 56x56 grid), d / 16
// warps.  The block stages the three padded s2d rows y..y+2 it needs
// ([3][66][48] bf16: 58 padded columns and a zero tail, so 64-token tiles
// stay in range) straight from the NCHW image.  A token's 48-wide slab for
// shift (dy, dx) is then the s2d row 1 + dy read from column x + 1 + dx: a
// row-major 16x16 WMMA tile with ldm 48, no gather.  K runs over the 9 shifts
// (3 x 16 deep each) against 48 x d slabs of W9 in a double-buffered cp.async
// ring; each warp owns one 16-column tile of all 64 rows (56 real).  The LN
// sums come from the same staged rows.  The epilogue stages the fp32 tile in
// shared memory and writes 16-byte vectors.  TMA, wgmma and filling 132 SMs
// at b1 are later work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int IMG = 224;
constexpr int GRID = 56;                  // tokens per side
constexpr int CH = 48;                    // s2d channels: 3 x 4 x 4
constexpr int PCOLS = 66;                 // 58 padded columns + zero tail
constexpr int PROWS = 3;                  // padded rows y .. y + 2
constexpr int SHIFTS = 9;
constexpr int KTOT = SHIFTS * CH;         // 432
constexpr int MROWS = 64;                 // 56 tokens of one row, in 4 WMMA tiles
constexpr int MTILES = MROWS / 16;
constexpr float FEATURES = 147.0f;        // 3 x 7 x 7 unfold features
constexpr int A_ELEMS = PROWS * PCOLS * CH;
constexpr int VEC_PER_ROW = IMG / 8;      // 16-byte vectors per image row

// Dynamic shared memory for a given d: the W9 ring and the staged rows, which
// the fp32 output tile overlays after the main loop, then the mask and the
// per-token LN statistics.
__host__ __device__ constexpr int w_stride(int d) { return d + 8; }
__host__ __device__ constexpr int c_stride(int d) { return d + 4; }
__host__ __device__ constexpr int max_i(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int region0_bytes(int d) {
  return max_i(2 * CH * w_stride(d) * 2 + A_ELEMS * 2, MROWS * c_stride(d) * 4);
}
__host__ __device__ constexpr int smem_bytes(int d) {
  return region0_bytes(d) + (KTOT + 2 * MROWS) * 4;
}

__device__ __forceinline__ void load_w_slab(bf16* dst, const bf16* __restrict__ W9, int s, int d,
                                            int tid, int nthr) {
  const int vecs = d / 8;
  for (int i = tid; i < CH * vecs; i += nthr) {
    const int r = i / vecs, c = (i % vecs) * 8;
    cp_async16(dst + r * w_stride(d) + c, W9 + static_cast<size_t>(s * CH + r) * d + c, true);
  }
}

__global__ __launch_bounds__(512) void t2t_stage1_kernel(
    const bf16* __restrict__ img, const bf16* __restrict__ W9, const float* __restrict__ M9,
    const float* __restrict__ c1, const float* __restrict__ c2, bf16* __restrict__ out, int d,
    float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int WS = w_stride(d);
  bf16* sW = reinterpret_cast<bf16*>(smem);          // 2 x [48][WS]
  bf16* sA = sW + 2 * CH * WS;                       // [3][66][48]
  float* sC = reinterpret_cast<float*>(smem);        // [64][d + 4], after the main loop
  float* sM = reinterpret_cast<float*>(smem + region0_bytes(d));  // [432]
  float* sMu = sM + KTOT;                            // [64]
  float* sRs = sMu + MROWS;                          // [64]

  const int y = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5;

  load_w_slab(sW, W9, 0, d, tid, nthr);
  cp_async_commit();

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < A_ELEMS / 8; i += nthr) reinterpret_cast<uint4*>(sA)[i] = zero;
  for (int i = tid; i < KTOT; i += nthr) sM[i] = M9[i];
  __syncthreads();

  // Padded row prow holds s2d row iy = y + prow - 1; its cell (ix, c*16 + phy*4 +
  // phx) is pixel (c, 4*iy + phy, 4*ix + phx), stored at column ix + 1.  One
  // 16-byte vector of an image row is 8 pixels: two cells' 4 phases.
  const bf16* im = img + static_cast<size_t>(b) * 3 * IMG * IMG;
  for (int i = tid; i < PROWS * 12 * VEC_PER_ROW; i += nthr) {
    const int prow = i / (12 * VEC_PER_ROW), rem = i % (12 * VEC_PER_ROW);
    const int cp = rem / VEC_PER_ROW, j = rem % VEC_PER_ROW;
    const int iy = y + prow - 1;
    if (iy < 0 || iy >= GRID) continue;  // the zero padding rows
    const int c = cp >> 2, phy = cp & 3;
    const uint4 v = *reinterpret_cast<const uint4*>(
        im + (static_cast<size_t>(c) * IMG + iy * 4 + phy) * IMG + j * 8);
    bf16* dst = sA + (prow * PCOLS + 2 * j + 1) * CH + c * 16 + phy * 4;
    *reinterpret_cast<uint2*>(dst) = make_uint2(v.x, v.y);
    *reinterpret_cast<uint2*>(dst + CH) = make_uint2(v.z, v.w);
  }
  __syncthreads();

  // LN statistics of token x over the 147 masked columns: 4 lanes per token.
  // 224 and the block size are multiples of 32, so every warp of the loop
  // runs whole.  Rounded as the twin rounds: no contraction into FMAs.
  for (int t = tid; t < GRID * 4; t += nthr) {
    const int x = t >> 2, part = t & 3;
    float s1 = 0.0f, s2 = 0.0f;
    for (int k = part; k < KTOT; k += 4) {
      const int s = k / CH, ch = k % CH;
      const float v = __bfloat162float(sA[((s / 3) * PCOLS + x + s % 3) * CH + ch]);
      const float m = sM[k];
      s1 = __fadd_rn(s1, __fmul_rn(v, m));
      s2 = __fadd_rn(s2, __fmul_rn(__fmul_rn(v, v), m));
    }
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
    if (part == 0) {
      const float mu = __fdiv_rn(s1, FEATURES), sq = __fdiv_rn(s2, FEATURES);
      sMu[x] = mu;
      sRs[x] = rsqrtf(__fadd_rn(__fsub_rn(sq, __fmul_rn(mu, mu)), eps));
    }
  }

  // out = big @ W9: K over the 9 shifts, 3 WMMA steps of 16 each.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MTILES];
#pragma unroll
  for (int mt = 0; mt < MTILES; ++mt) wmma::fill_fragment(acc[mt], 0.0f);
  const int n0 = warp * 16;
  for (int s = 0; s < SHIFTS; ++s) {
    if (s + 1 < SHIFTS) load_w_slab(sW + ((s + 1) & 1) * CH * WS, W9, s + 1, d, tid, nthr);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // slab s landed (and the staged rows, on the first pass)
    const bf16* w = sW + (s & 1) * CH * WS;
    const bf16* a = sA + ((s / 3) * PCOLS + s % 3) * CH;  // row 1 + dy, column x + 1 + dx
#pragma unroll
    for (int kk = 0; kk < CH; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, w + kk * WS + n0, WS);
#pragma unroll
      for (int mt = 0; mt < MTILES; ++mt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, a + mt * 16 * CH + kk, CH);
        wmma::mma_sync(acc[mt], fa, fb, acc[mt]);
      }
    }
    __syncthreads();  // every warp is done with slab s before it is overwritten
  }

  cp_async_wait<0>();
  __syncthreads();  // the ring and the staged rows become the fp32 output tile
  const int CS = c_stride(d);
#pragma unroll
  for (int mt = 0; mt < MTILES; ++mt)
    wmma::store_matrix_sync(sC + mt * 16 * CS + n0, acc[mt], CS, wmma::mem_row_major);
  __syncthreads();

  const int vecs = d / 8;
  bf16* o = out + (static_cast<size_t>(b) * GRID * GRID + static_cast<size_t>(y) * GRID) * d;
  for (int i = tid; i < GRID * vecs; i += nthr) {
    const int r = i / vecs, c = (i % vecs) * 8;
    const float mu = sMu[r], rs = sRs[r];
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float centred = __fsub_rn(sC[r * CS + c + e], __fmul_rn(mu, c1[c + e]));
      v[e] = __fadd_rn(__fmul_rn(centred, rs), c2[c + e]);
    }
    *reinterpret_cast<uint4*>(o + static_cast<size_t>(r) * d + c) = pack8(v);
  }
}

}  // namespace

extern "C" int evt_t2t_stage1_old(const void* img, const void* w9, const void* m9,
                                  const void* c1, const void* c2, void* out, int batch, int d,
                                  float eps, void* stream) {
  if (d < 16 || d > 256 || d % 16) return static_cast<int>(cudaErrorInvalidValue);
  static int configured = 0;  // the largest dynamic shared memory allowed so far
  const int smem = smem_bytes(d);
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        t2t_stage1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  if (batch == 0) return 0;
  const dim3 grid(GRID, batch);
  t2t_stage1_kernel<<<grid, d * 2, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(img), static_cast<const bf16*>(w9), static_cast<const float*>(m9),
      static_cast<const float*>(c1), static_cast<const float*>(c2), static_cast<bf16*>(out), d,
      eps);
  return static_cast<int>(cudaGetLastError());
}
"""
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P]  # the parent's takes no cols


def variants(src: str) -> dict:
    """``{name: source of t2t_stage1.cu}``: the committed kernel and the
    floors (whose output is not K8's: what is left out costs the
    difference)."""
    for anchor in (_STATS, _W9_COPY, _PRODUCTS):
        if src.count(anchor) != 1:
            raise ValueError(f"csrc/t2t_stage1.cu no longer holds {anchor!r} once")
    return {COMMITTED: src,
            NO_STATS: src.replace(_STATS, _STATS.replace("t < GRID * 4", "t < 0")),
            NO_W9: src.replace(_W9_COPY, ""),
            STAGE_ONLY: src.replace(_PRODUCTS, "  return;\n")}


def build_libraries() -> tuple:
    """``({name: evt_t2t_stage1}, evt_t2t_stage1_old)``: each variant and the
    parent's kernel, compiled side by side; prints ptxas's registers and
    spills of each."""
    out_dir = build.BUILD_DIR.parent / "stage1_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = variants((build.CSRC / "t2t_stage1.cu").read_text())
    srcs[OLD] = OLD_SOURCE
    jobs = []
    for i, (name, code) in enumerate(srcs.items()):
        cu, so = out_dir / f"stage1_v{i}.cu", out_dir / f"libstage1_v{i}.so"
        cu.write_text(code)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
               str(build.CSRC), "-o", str(so), str(cu)]
        jobs.append((name, so, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)))
    fns = {}
    for name, so, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f"{name}: {err}")
        for line in err.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.split('info    : ')[-1].strip()}")
        entry = "evt_t2t_stage1_old" if name == OLD else "evt_t2t_stage1"
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGS[:9] + _ARGS[10:] if name == OLD else _ARGS
        fns[name] = fn
    return fns, fns.pop(OLD)


def call(fn, img, w, eps=EPS, cols=None):
    """``(run, out)``: one library's kernel on ``img`` with the weights
    ``w = (W9, M9, c1, c2)`` and ``cols`` columns a block (None: the
    plan's; 0 for the parent's kernel, which takes no plan)."""
    bsz, d = img.shape[0], w[0].shape[1]
    out = torch.empty(bsz, ts.TOKENS, d, dtype=img.dtype, device=img.device)
    if cols is None:
        cols = ts.stage1_plan(bsz, d, torch.cuda.get_device_properties(0).multi_processor_count)
    plan = (cols,) if cols else ()

    def run():
        build.check(fn(img.data_ptr(), *(t.data_ptr() for t in w), out.data_ptr(), bsz, d, eps,
                       *plan, torch.cuda.current_stream().cuda_stream), "stage1_kqv")

    return run, out


def stage1_weights(d: int = D, seed: int = 3) -> tuple:
    """W9, M9, c1, c2 on the card, as ``chip_smoke.py`` builds them."""
    from ..models.t2t_vit import build_stage1_weights

    rng = np.random.RandomState(seed)
    w = build_stage1_weights(rng.randn(147, d) * 147 ** -0.5, rng.randn(d) * 0.1,
                             1.0 + 0.1 * rng.randn(147), 0.1 * rng.randn(147))
    return w[0].cuda().bfloat16(), w[1].cuda(), w[2].cuda(), w[3].cuda()


def logits_against_old(old) -> tuple:
    """``(logits that move, logits, largest move, max|logit|)``: one t2t_vit_14
    b1 forward through ``fused_t2t_apply`` (bf16, reference style, seeded
    random weights and image, as ``chip_smoke.py`` phase 4 builds them) with
    the committed kernel, and again with the parent's kernel in its place."""
    from ..models import t2t_vit as t2t
    from ..models.registry import build_model

    model, shape = build_model("t2t_vit_14", style="reference", dtype=torch.bfloat16,
                               device="cuda", generator=torch.Generator().manual_seed(0))
    prepared = t2t.prepare_t2t_fused(model)
    img = torch.randn(1, *shape, generator=torch.Generator().manual_seed(1000)).cuda()

    def parent(img, W9, M9, c1, c2, eps=EPS):
        run, out = call(old, img.contiguous(), (W9, M9, c1, c2), eps, cols=0)
        run()
        torch.cuda.synchronize()  # the weights' views go out of scope here
        return out

    with torch.no_grad():
        new = t2t.fused_t2t_apply(model, img, prepared=prepared)
        kernel, t2t.stage1_kqv = t2t.stage1_kqv, parent
        try:
            prev = t2t.fused_t2t_apply(model, img, prepared=prepared)
        finally:
            t2t.stage1_kqv = kernel
    diff = (new.float() - prev.float()).abs()
    return int((diff > 0).sum()), diff.numel(), float(diff.max()), float(prev.float().abs().max())


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("stage1_ab needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    fns, old = build_libraries()
    fns[OLD] = old
    w = stage1_weights()
    gen = torch.Generator(device="cuda").manual_seed(21)
    for batch in BATCHES:
        img = torch.randn(batch, 3, ts.IMAGE, ts.IMAGE, generator=gen, device="cuda").bfloat16()
        calls = {name: call(fn, img, w, cols=0 if name == OLD else None)
                 for name, fn in fns.items()}
        plan = ts.stage1_plan(batch, D, torch.cuda.get_device_properties(0).multi_processor_count)
        other = 64 if plan == 96 else 96
        calls[f"committed, {other} columns a block"] = call(fns[COMMITTED], img, w, cols=other)
        runs = list(calls)
        times = defaultdict(float)
        ref, diffs = None, {}
        for order in (runs, runs[::-1]):  # A, B, C, C, B, A
            for name in order:
                run, out = calls[name]
                run()
                torch.cuda.synchronize()
                if ref is None:
                    ref = out.clone()
                d = (out.float() - ref.float()).abs()
                diffs[name] = (float(d.max()), int((d > 0).sum()), d.numel())
                times[name] += measure_graph_time(run)["p50_ms"] / 2
        for name in runs:
            most, moved, total = diffs[name]
            print(f"t2t_vit_14 stage 1 b{batch:<2d} d{D} {name:33s} {times[name] * 1e3:8.2f} us  "
                  f"max|diff vs committed| {most:.3g}  elements differing {moved} of {total}")
    moved, total, most, scale = logits_against_old(old)
    print(f"t2t_vit_14 b1 logits, committed kernel against the parent's: {moved} of {total} "
          f"move, by at most {most:.4g} (max|logit| {scale:.4g})")


if __name__ == "__main__":
    main()
