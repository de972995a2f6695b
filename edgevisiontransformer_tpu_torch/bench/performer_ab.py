"""What the parts of ``csrc/performer.cu`` (K16, the T2T tokenizer's
TokenPerformer) cost on the card: the kernels as committed against the
other way to add an image's sums and against the kernels they replaced,
each timed on the same inputs.

    python -m edgevisiontransformer_tpu_torch.bench.performer_ab

Variants, each built into its own library: the committed kernels
(``performer_reduce`` one 4-warp block per (image, 64-token tile), an
image's tile partials added by its last blocks in two levels, groups of
seven tiles then the groups; ``performer_rows`` blocks of four warps);
chunk partials (a ``performer_reduce`` block walks four tiles, 256 tokens,
:data:`_CHUNK_TOKENS` in place of :data:`_TILE_TOKENS`, and writes its
chunk's partial, and every ``performer_rows`` block adds the image's chunk
partials in its preamble, 16-byte loads issued before their adds
(:data:`_ADD_PARTIALS`); anchors: the reduce's tile and grid, the first
line of its image sums and the rows' staging of them); ``performer_rows``
in blocks of two warps and of one (anchor: ``constexpr int ROWS_WARPS =
4, ...``; a token's bits do not depend on the block); three floors, whose
output is not K16's:
``performer_reduce`` without the image sums (each block writes its tile
partial and returns), ``performer_rows`` that returns after its
preamble (anchor: ``if (row0 >= n) return;``) and without GELU (anchor:
the line that applies it); the old kernels (:data:`OLD_SOURCE`, exported as
``evt_performer_reduce_old`` / ``evt_performer_rows_old``):
``csrc/performer.cu`` before its redesign, one block per (image, 256-token
chunk) computing kp on the CUDA cores, and one 256-thread block per (image,
64-token tile) that adds every chunk partial itself and runs the three
64 x 64 products as WMMA through shared memory.

Shapes: t2t_vit_14's two performers (stage 1, n = 3136; stage 2, n = 784)
at b1, b8 and b32, tanh GELU (the reference style's), random weights made
as ``chip_smoke.py`` makes them.  Each line gives the device time of
``performer_reduce``, of ``performer_rows`` on that variant's sums, and of
the two in turn (``harness.measure_graph_time``: CUDA events around a CUDA
graph of 20 calls replayed, median of 5 samples), the largest difference
from the committed kernels' output and the number of elements that differ.
Runs go A, B, C, C, B, A; each time is the mean of both passes.  Then, per
variant, the sum over one t2t_vit_14 tokenizer's two performers at each
batch.  Last, how many of the 1000 logits of one t2t_vit_14 b1 forward
(``fused_t2t_apply``, seeded random weights) move when the old kernels take
the committed kernels' place, and by how much.  Needs a CUDA device and
``nvcc``; the libraries go to ``build/performer_ab/``.
"""

from __future__ import annotations

import ctypes
import subprocess
from collections import defaultdict

import torch

from ..ops.cuda import build
from ..ops.cuda import performer as pf
from .harness import measure_graph_time

# t2t_vit_14's two performers: tokens per image (56 x 56, 28 x 28)
STAGES = (3136, 784)
BATCHES = (1, 8, 32)
EPS_LN = 1e-5
# Anchors: a performer_reduce block's tile and its grid; the first line of
# its image sums (a return before it leaves each block's partial unsummed);
# performer_rows' warps a block, its staging of the image's sums, its work
# after the preamble and its GELU.
_TILE_TOKENS = r"""  const int row0 = blk * TILE + warp * 16;
  load_rows<TS, 32>(sKw, xi, XLD, row0, 16, n, lane);
  load_rows<TS, 32>(sVw, xi + 2 * TS, XLD, row0, 16, n, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // w and the warp's rows landed
  float acc[2][MF], ksum = 0.0f;  // kptv rows lane and lane + 32; kp_sum[lane]
#pragma unroll
  for (int j = 0; j < MF; ++j) acc[0][j] = acc[1][j] = 0.0f;
  add_tokens(acc, ksum, sKw, sVw, sW, lane, n - row0);
"""
_GRID = "  const dim3 grid((n + TILE - 1) / TILE, batch);\n"
_ROWS_WARPS = "constexpr int ROWS_WARPS = 4, "
_SUMS = "  // the image's counters: its image counter, then one per group\n"
_STAGE = ("  const float* si = sums + static_cast<long long>(img) * SUMS;\n"
          "  for (int c = tid; c < SUMS / 4; c += ROWS_THREADS)\n"
          "    cp_async16(sSum + sums_at(4 * c), si + 4 * c, true);\n")
_CHAIN = "  if (row0 >= n) return;\n"
_GELU = "hid[j][e] = approx ? gelu_tanh_f(v) : gelu_erf_f(v);"
# The chunk-partials variant: a reduce block walks CHUNK_TILES tiles in
# place of _TILE_TOKENS (on a grid as many times narrower), and the rows'
# staging in place of _STAGE: sums holds the image's block partials (at
# performer_reduce's per-image stride of blocks and groups), added in
# order, eight loads issued before their adds.
CHUNK_TILES = 4
_CHUNK_TOKENS = r"""  float acc[2][MF], ksum = 0.0f;  // kptv rows lane and lane + 32; kp_sum[lane]
#pragma unroll
  for (int j = 0; j < MF; ++j) acc[0][j] = acc[1][j] = 0.0f;
  for (int tile = 0; tile < CHUNK_TILES; ++tile) {
    const int row0 = (blk * CHUNK_TILES + tile) * TILE + warp * 16;
    __syncwarp();  // the previous tile's reads of sKw and sVw are done
    load_rows<TS, 32>(sKw, xi, XLD, row0, 16, n, lane);
    load_rows<TS, 32>(sVw, xi + 2 * TS, XLD, row0, 16, n, lane);
    cp_async_commit();
    cp_async_wait<0>();
    if (tile == 0)
      __syncthreads();  // w and the warp's rows landed
    else
      __syncwarp();
    add_tokens(acc, ksum, sKw, sVw, sW, lane, n - row0);
  }
"""
_CHUNK_GRID = "  const dim3 grid((n + CHUNK_TILES * TILE - 1) / (CHUNK_TILES * TILE), batch);\n"
_ADD_PARTIALS = r"""  const int parts = (n + CHUNK_TILES * TILE - 1) / (CHUNK_TILES * TILE);
  const float4* si = reinterpret_cast<const float4*>(sums) +
                     static_cast<long long>(img) * (parts + (parts + GROUP - 1) / GROUP) * (SUMS / 4);
  for (int c = tid; c < SUMS / 4; c += ROWS_THREADS) {
    float4 acc = __ldcg(si + c);
    for (int i0 = 1; i0 < parts; i0 += 8) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i0 + u < parts) v[u] = __ldcg(si + c + static_cast<long long>(i0 + u) * (SUMS / 4));
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i0 + u < parts) acc = add4(acc, v[u]);
    }
    *reinterpret_cast<float4*>(sSum + sums_at(4 * c)) = acc;
  }
"""
COMMITTED = "committed"
CHUNKS = "chunk partials, rows add"
ROWS_2 = "rows in blocks of 2 warps"
ROWS_1 = "rows in blocks of 1 warp"
NO_SUMS = "floor: reduce, no image sums"
PREAMBLE = "floor: rows, preamble only"
NO_GELU = "floor: rows, no GELU"
OLD = "old kernels (parent)"
OLD_CHUNK = 256  # tokens per block of the old performer_reduce
# csrc/performer.cu before its redesign, its entry points renamed.
OLD_SOURCE = r"""
// performer_reduce + performer_rows: the T2T tokenizer's TokenPerformer
// after norm1 and kqv, in two launches.
//
// Replaces: edgevisiontransformer_tpu/ops/pallas/performer.py
//   `_performer_kernel` / `performer_rest` (K16, :46-110), with its cast
//   points.  Input x_kqv [b, n, 3 ts] bf16 holds k, q, v in that order;
//   w [m, ts] is the fixed random-feature matrix (in bf16, as the kernel
//   takes it).  In fp32:
//     prm(t) = exp(t w^T - |t|^2 / 2) * (1 / sqrt m)      kp = prm(k), qp = prm(q)
//     kp_sum = sum over tokens of kp,  kptv = v^T kp      (padded rows excluded)
//     y      = (qp kptv^T) / max(qp . kp_sum, 1e-8)
//   then  y2  = bf16(v + (f32(bf16(y) @ wo) + bo))        (the skip is from v)
//         h   = bf16(LN(y2))                               (fp32 statistics)
//         g   = bf16(gelu(bf16(f32(h @ w1) + b1)))
//         out = bf16(y2 + (f32(g @ w2) + b2))
//   At t2t_vit_14: ts = 64, m = 32, n = 3136 (stage 1) or 784 (stage 2).
//
// Bound on the card: device-memory bytes.  Per token it reads 3 ts bf16
// values and writes ts (512 bytes) and does ~20 kflop in fp32: t2t_vit_14
// b1 stage 1 moves 1.6 MB (0.5 us at 3.35 TB/s) and does 63 MFLOP (0.9 us
// at the 67 TFLOP/s fp32 rate).  The sums over all tokens are a reduction
// across blocks.
//
// Design: performer_reduce runs one block per (image, 256-token chunk): for
// each 64-token tile it computes kp in fp32 on the CUDA cores (the TPU kernel
// keeps prm_exp, D and kptv in fp32) and adds the tile to the chunk's
// kp_sum [m] and kptv [ts, m], which it writes as a partial in fp32 (no
// atomics, so the result does not depend on block order).  performer_rows
// runs one block per (image, 64-token tile): it sums the image's partials in
// chunk order, computes qp, d and y in fp32, and runs attn_output, the skip,
// the LayerNorm and the ts -> ts -> ts MLP as 64x64x64 WMMA bf16 products
// (fp32 accumulate) with the weights in shared memory, then writes its rows.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int TS = 64, MF = 32;          // token size, random features
constexpr int TILE = 64, CHUNK = 256;    // tokens per tile, per reduce block
constexpr int THREADS = 256;
constexpr int FLD = TS + 1;              // fp32 token-row stride (conflict-free columns)
constexpr int PLD = MF + 1;              // fp32 feature-row stride
constexpr int HLD = TS + 8;              // bf16 row stride of the WMMA operands
constexpr int CLD = TS + 4;              // fp32 row stride of a WMMA result
constexpr int PARTIAL = MF + TS * MF;    // kp_sum then kptv [ts, m], per chunk
constexpr float kInvSqrtM = 0.17677669529663687f;  // f32(1 / sqrt(32)), as the reference's constant

// rows [t0, t0 + TILE) of columns [col, col + TS) of one image's x_kqv into
// fp32 shared memory; rows past n are zeros
__device__ __forceinline__ void load_tile(float* dst, const bf16* __restrict__ x, int t0, int n,
                                          int col) {
  for (int i = threadIdx.x; i < TILE * (TS / 8); i += THREADS) {
    const int r = i / (TS / 8), c = (i % (TS / 8)) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (t0 + r < n)
      unpack8(*reinterpret_cast<const uint4*>(x + static_cast<size_t>(t0 + r) * 3 * TS + col + c),
              f);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[r * FLD + c + e] = f[e];
  }
}

// w [m, ts] bf16 -> fp32 shared memory
__device__ __forceinline__ void load_w(float* sw, const bf16* __restrict__ w) {
  for (int i = threadIdx.x; i < MF * TS; i += THREADS) sw[i] = __bfloat162float(w[i]);
}

// prm of the TILE rows of t (fp32, stride FLD) into p [TILE, MF] (stride
// PLD); rows at or past `valid` become 0 when `mask`.  td holds |t|^2 / 2.
__device__ __forceinline__ void prm_exp(const float* t, const float* sw, float* td, float* p,
                                        int valid, bool mask) {
  const int tid = threadIdx.x;
  if (tid < TILE) {
    float s = 0.f;
    for (int i = 0; i < TS; ++i) s += t[tid * FLD + i] * t[tid * FLD + i];
    td[tid] = s * 0.5f;
  }
  __syncthreads();
  const int r = tid % TILE, j0 = (tid / TILE) * (MF / 4);
#pragma unroll
  for (int e = 0; e < MF / 4; ++e) {
    const int j = j0 + e;
    float s = 0.f;
    for (int i = 0; i < TS; ++i) s += t[r * FLD + i] * sw[j * TS + i];
    p[r * PLD + j] = (mask && r >= valid) ? 0.f : expf(s - td[r]) * kInvSqrtM;
  }
}

__global__ __launch_bounds__(THREADS) void performer_reduce_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, float* __restrict__ partial, int n) {
  extern __shared__ __align__(16) float sm[];
  float* sw = sm;                    // [MF, TS]
  float* sk = sw + MF * TS;          // [TILE, FLD]
  float* sv = sk + TILE * FLD;       // [TILE, FLD]
  float* sp = sv + TILE * FLD;       // [TILE, PLD]
  float* td = sp + TILE * PLD;       // [TILE]
  const int chunk = blockIdx.x, img = blockIdx.y, tid = threadIdx.x;
  const bf16* xi = x + static_cast<size_t>(img) * n * 3 * TS;
  load_w(sw, w);

  const int i = tid / 4, j0 = (tid % 4) * (MF / 4);  // this thread's kptv[i, j0:j0+8]
  float acc[MF / 4] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float ksum = 0.f;                                   // kp_sum[tid], tid < MF
  const int c0 = chunk * CHUNK, c1 = min(c0 + CHUNK, n);
  for (int t0 = c0; t0 < c1; t0 += TILE) {
    __syncthreads();  // the previous tile's sums are done with sk, sv, sp
    load_tile(sk, xi, t0, n, 0);
    load_tile(sv, xi, t0, n, 2 * TS);
    __syncthreads();
    prm_exp(sk, sw, td, sp, n - t0, true);
    __syncthreads();
    for (int t = 0; t < TILE; ++t) {
      const float vi = sv[t * FLD + i];
#pragma unroll
      for (int e = 0; e < MF / 4; ++e) acc[e] += vi * sp[t * PLD + j0 + e];
    }
    if (tid < MF)
      for (int t = 0; t < TILE; ++t) ksum += sp[t * PLD + tid];
  }
  float* out = partial + (static_cast<size_t>(img) * gridDim.x + chunk) * PARTIAL;
  if (tid < MF) out[tid] = ksum;
#pragma unroll
  for (int e = 0; e < MF / 4; ++e) out[MF + i * MF + j0 + e] = acc[e];
}

// C [64, 64] fp32 (stride CLD) = A [64, 64] @ B [64, 64], bf16 operands in
// shared memory (stride HLD); warp w owns rows 16 (w / 2), columns 32 (w % 2).
__device__ __forceinline__ void mm64(const bf16* A, const bf16* B, float* C) {
  const int warp = threadIdx.x >> 5, r0 = (warp >> 1) * 16, n0 = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
#pragma unroll
  for (int k = 0; k < TS; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + r0 * HLD + k, HLD);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, B + k * HLD + n0 + j * 16, HLD);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(C + r0 * CLD + n0 + j * 16, acc[j], CLD, wmma::mem_row_major);
}

__device__ __forceinline__ void load_weight(bf16* dst, const bf16* __restrict__ src) {
  for (int i = threadIdx.x; i < TS * (TS / 8); i += THREADS) {
    const int r = i / (TS / 8), c = (i % (TS / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * HLD + c) =
        *reinterpret_cast<const uint4*>(src + r * TS + c);
  }
}

__global__ __launch_bounds__(THREADS) void performer_rows_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const float* __restrict__ partial,
    int chunks, const bf16* __restrict__ wo, const float* __restrict__ bo,
    const float* __restrict__ g2, const float* __restrict__ be2, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2, const float* __restrict__ b2,
    bf16* __restrict__ out, int n, float eps, int approx) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* swo = reinterpret_cast<bf16*>(smem);   // [TS, HLD] x 3
  bf16* sw1 = swo + TS * HLD;
  bf16* sw2 = sw1 + TS * HLD;
  bf16* sa = sw2 + TS * HLD;                   // [TILE, HLD]: bf16(y), then the GELU output
  bf16* sh = sa + TILE * HLD;                  // [TILE, HLD]: bf16(LN(y2))
  float* sw = reinterpret_cast<float*>(sh + TILE * HLD);  // [MF, TS]
  float* skv = sw + MF * TS;                   // kp_sum [MF], then kptv [TS, MF]
  float* sq = skv + PARTIAL;                   // [TILE, CLD]: q, then each product
  float* sv = sq + TILE * CLD;                 // [TILE, FLD]: v, then y2
  float* sp = sv + TILE * FLD;                 // [TILE, PLD]: qp
  float* td = sp + TILE * PLD;                 // [TILE]
  float* sd = td + TILE;                       // [TILE]: 1 / max(d, 1e-8)
  const int img = blockIdx.y, t0 = blockIdx.x * TILE, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bf16* xi = x + static_cast<size_t>(img) * n * 3 * TS;

  load_w(sw, w);
  load_weight(swo, wo);
  load_weight(sw1, w1);
  load_weight(sw2, w2);
  const float* pi = partial + static_cast<size_t>(img) * chunks * PARTIAL;
  for (int k = tid; k < PARTIAL; k += THREADS) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += pi[static_cast<size_t>(c) * PARTIAL + k];
    skv[k] = s;
  }
  // q into the product buffer (stride CLD >= FLD: read back with FLD below)
  for (int i = tid; i < TILE * (TS / 8); i += THREADS) {
    const int r = i / (TS / 8), c = (i % (TS / 8)) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (t0 + r < n)
      unpack8(*reinterpret_cast<const uint4*>(xi + static_cast<size_t>(t0 + r) * 3 * TS + TS + c),
              f);
#pragma unroll
    for (int e = 0; e < 8; ++e) sq[r * FLD + c + e] = f[e];
  }
  load_tile(sv, xi, t0, n, 2 * TS);
  __syncthreads();
  prm_exp(sq, sw, td, sp, n - t0, false);
  __syncthreads();

  // d = qp . kp_sum, then y = (qp kptv^T) / max(d, 1e-8) -> bf16
  if (tid < TILE) {
    float d = 0.f;
    for (int j = 0; j < MF; ++j) d += sp[tid * PLD + j] * skv[j];
    sd[tid] = fmaxf(d, 1e-8f);
  }
  __syncthreads();
  const float* kptv = skv + MF;
  for (int o = tid; o < TILE * TS; o += THREADS) {
    const int r = o / TS, i = o % TS;
    float s = 0.f;
    for (int j = 0; j < MF; ++j) s += sp[r * PLD + j] * kptv[i * MF + j];
    sa[r * HLD + i] = __float2bfloat16_rn(s / sd[r]);
  }
  __syncthreads();

  // y2 = bf16(v + (f32(bf16(y) @ wo) + bo)), kept as fp32 in sv
  mm64(sa, swo, sq);
  __syncthreads();
  for (int o = tid; o < TILE * TS; o += THREADS) {
    const int r = o / TS, i = o % TS;
    sv[r * FLD + i] = round_bf16(sv[r * FLD + i] + (sq[r * CLD + i] + bo[i]));
  }
  __syncthreads();

  // h = bf16(LN(y2)): one warp per row, two values a lane
  for (int r = warp; r < TILE; r += THREADS / 32) {
    const float a = sv[r * FLD + lane], b = sv[r * FLD + lane + 32];
    const float mean = warp_sum(a + b) / static_cast<float>(TS);
    const float da = a - mean, db = b - mean;
    const float var = warp_sum(da * da + db * db) / static_cast<float>(TS);
    const float rs = rsqrtf(var + eps);
    sh[r * HLD + lane] = __float2bfloat16_rn(da * rs * g2[lane] + be2[lane]);
    sh[r * HLD + lane + 32] = __float2bfloat16_rn(db * rs * g2[lane + 32] + be2[lane + 32]);
  }
  __syncthreads();

  // g = bf16(gelu(bf16(f32(h @ w1) + b1)))
  mm64(sh, sw1, sq);
  __syncthreads();
  for (int o = tid; o < TILE * TS; o += THREADS) {
    const int r = o / TS, i = o % TS;
    const float v = round_bf16(sq[r * CLD + i] + b1[i]);
    sa[r * HLD + i] = __float2bfloat16_rn(approx ? gelu_tanh_f(v) : gelu_erf_f(v));
  }
  __syncthreads();

  // out = bf16(y2 + (f32(g @ w2) + b2))
  mm64(sa, sw2, sq);
  __syncthreads();
  bf16* oi = out + static_cast<size_t>(img) * n * TS;
  for (int o = tid; o < TILE * (TS / 8); o += THREADS) {
    const int r = o / (TS / 8), c = (o % (TS / 8)) * 8;
    if (t0 + r >= n) continue;
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = sv[r * FLD + c + e] + (sq[r * CLD + c + e] + b2[c + e]);
    *reinterpret_cast<uint4*>(oi + static_cast<size_t>(t0 + r) * TS + c) = pack8(f);
  }
}

constexpr int REDUCE_SMEM = (MF * TS + 2 * TILE * FLD + TILE * PLD + TILE) * 4;
constexpr int ROWS_SMEM = (3 * TS + 2 * TILE) * HLD * 2 +
                          (MF * TS + PARTIAL + TILE * CLD + TILE * FLD + TILE * PLD + 2 * TILE) * 4;

int configure(const void* kernel, int bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  *done = true;
  return 0;
}

}  // namespace

// partial: [b, ceil(n / 256), m + ts * m] fp32 scratch.
extern "C" int evt_performer_reduce_old(const void* x, const void* w, void* partial, int batch, int n,
                                    void* stream) {
  if (batch == 0 || n == 0) return 0;
  static bool done = false;
  const int rc = configure(reinterpret_cast<const void*>(performer_reduce_kernel), REDUCE_SMEM,
                           &done);
  if (rc != 0) return rc;
  const dim3 grid((n + CHUNK - 1) / CHUNK, batch);
  performer_reduce_kernel<<<grid, THREADS, REDUCE_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<float*>(partial), n);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: x, w, partial, wo, bo, g2, be2, w1, b1, w2, b2, out (the vectors fp32).
extern "C" int evt_performer_rows_old(void* const* ptrs, int batch, int n, float eps, int approx,
                                  void* stream) {
  if (batch == 0 || n == 0) return 0;
  static bool done = false;
  const int rc = configure(reinterpret_cast<const void*>(performer_rows_kernel), ROWS_SMEM, &done);
  if (rc != 0) return rc;
  const dim3 grid((n + TILE - 1) / TILE, batch);
  auto b = [&](int i) { return static_cast<const bf16*>(ptrs[i]); };
  auto f = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  performer_rows_kernel<<<grid, THREADS, ROWS_SMEM, static_cast<cudaStream_t>(stream)>>>(
      b(0), b(1), f(2), (n + CHUNK - 1) / CHUNK, b(3), f(4), f(5), f(6), b(7), f(8), b(9), f(10),
      static_cast<bf16*>(ptrs[11]), n, eps, approx);
  return static_cast<int>(cudaGetLastError());
}
"""
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def variants(src: str) -> dict:
    """``{name: source of performer.cu}``: the committed kernels, the
    chunk-partials and block-size variants of ``src`` and the floors (whose
    outputs are not K16's: what is left out costs the difference)."""
    for anchor in (_TILE_TOKENS, _GRID, _ROWS_WARPS, _SUMS, _STAGE, _CHAIN, _GELU):
        if src.count(anchor) != 1:
            raise ValueError(f"csrc/performer.cu no longer holds {anchor!r} once")
    no_sums = src.replace(_SUMS, "  return;\n" + _SUMS)
    chunks = (no_sums.replace(_TILE_TOKENS, _CHUNK_TOKENS).replace(_GRID, _CHUNK_GRID)
              .replace(_STAGE, _ADD_PARTIALS)
              .replace(_ROWS_WARPS, f"constexpr int CHUNK_TILES = {CHUNK_TILES};\n{_ROWS_WARPS}"))
    return {COMMITTED: src, CHUNKS: chunks,
            ROWS_2: src.replace(_ROWS_WARPS, "constexpr int ROWS_WARPS = 2, "),
            ROWS_1: src.replace(_ROWS_WARPS, "constexpr int ROWS_WARPS = 1, "),
            NO_SUMS: no_sums,
            PREAMBLE: src.replace(_CHAIN, "  return;\n"),
            NO_GELU: src.replace(_GELU, "hid[j][e] = v;")}


def _fn(lib, name: str, argtypes: list):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def build_libraries(source_variants: bool = True) -> tuple:
    """``({name: (evt_performer_reduce, evt_performer_rows)}, (old reduce,
    old rows))``: each source variant (only the committed one unless
    ``source_variants``) and the old kernels, compiled side by side; prints
    ptxas's registers and spills of each."""
    out_dir = build.BUILD_DIR.parent / "performer_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = variants((build.CSRC / "performer.cu").read_text())
    if not source_variants:
        srcs = {COMMITTED: srcs[COMMITTED]}
    srcs[OLD] = OLD_SOURCE
    jobs = []
    for i, (name, code) in enumerate(srcs.items()):
        cu, so = out_dir / f"performer_v{i}.cu", out_dir / f"libperformer_v{i}.so"
        cu.write_text(code)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
               str(build.CSRC), "-o", str(so), str(cu)]
        jobs.append((name, so, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, so, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f"{name}: {err}")
        if source_variants:
            for line in err.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.split('info    : ')[-1].strip()}")
        libs[name] = ctypes.CDLL(str(so))
    old = libs.pop(OLD)
    new = {name: (_fn(lib, "evt_performer_reduce", [_P, _P, _P, _P, _P, _I, _I, _P]),
                  _fn(lib, "evt_performer_rows", [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P]))
           for name, lib in libs.items()}
    return new, (_fn(old, "evt_performer_reduce_old", [_P, _P, _P, _I, _I, _P]),
                 _fn(old, "evt_performer_rows_old", [_P, _I, _I, _F, _I, _P]))


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def new_calls(fns, x, ops, *, approx: bool, rows_read_partials: bool, eps: float = EPS_LN):
    """``(reduce, rows, out, buffers)`` of a library with the committed entry
    points on ``x [b, n, 192]``: ``rows`` reads the sums, or, for the
    chunk-partials variant, the block partials.  ``reduce`` zeroes the
    arrival counters before each launch, as the wrapper allocates them
    zeroed."""
    reduce, rows = fns
    b, n, _ = x.shape
    groups = pf._groups(n)
    partial = torch.empty(b, -(-n // pf.TILE) + groups, pf.SUMS, device=x.device)
    sums = torch.empty(b, pf.SUMS, device=x.device)
    out = torch.empty(b, n, pf.TOKEN_SIZE, dtype=torch.bfloat16, device=x.device)
    counters = torch.zeros(b * (1 + groups), dtype=torch.int32, device=x.device)
    w = ops["mats"][:pf.FEATURES]
    src = partial if rows_read_partials else sums

    def run_reduce():
        counters.zero_()
        build.check(reduce(x.data_ptr(), w.data_ptr(), partial.data_ptr(), sums.data_ptr(),
                           counters.data_ptr(), b, n, _stream()), "performer_reduce")

    def run_rows():
        build.check(rows(x.data_ptr(), src.data_ptr(), ops["mats"].data_ptr(),
                         ops["vecs"].data_ptr(), out.data_ptr(), b, n, eps, int(approx),
                         _stream()), "performer_rows")

    return run_reduce, run_rows, out, (partial, sums)


def old_calls(fns, x, p, w, *, approx: bool, eps: float = EPS_LN):
    """``(reduce, rows, out, buffers)`` of the old kernels on ``x``."""
    reduce, rows = fns
    b, n, _ = x.shape
    dt = torch.bfloat16
    partial = torch.empty(b, -(-n // OLD_CHUNK), pf.SUMS, device=x.device)
    out = torch.empty(b, n, pf.TOKEN_SIZE, dtype=dt, device=x.device)
    keep = [x, w.to(dt), partial, p["attn_output"]["kernel"].to(dt),
            p["attn_output"]["bias"].float(), p["norm2_scale"].float(), p["norm2_bias"].float(),
            p["mlp_fc1_kernel"].to(dt), p["mlp_fc1_bias"].float(), p["mlp_fc2_kernel"].to(dt),
            p["mlp_fc2_bias"].float(), out]
    ptrs = (ctypes.c_void_p * 12)(*(t.data_ptr() for t in keep))

    def run_reduce():
        build.check(reduce(x.data_ptr(), keep[1].data_ptr(), partial.data_ptr(), b, n,
                           _stream()), "performer_reduce (old)")

    def run_rows():
        build.check(rows(ptrs, b, n, eps, int(approx), _stream()), "performer_rows (old)")

    return run_reduce, run_rows, out, (keep, ptrs)


def performer_params(gen: torch.Generator) -> tuple:
    """Random TokenPerformer params (fp32) and ``w [32, 64]`` on the card,
    as ``chip_smoke.py`` makes them."""
    def r(*shape, scale=0.1, base=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale + base
    p = {"attn_output": {"kernel": r(64, 64), "bias": r(64)}, "norm2_scale": r(64, base=1.0),
         "norm2_bias": r(64), "mlp_fc1_kernel": r(64, 64), "mlp_fc1_bias": r(64),
         "mlp_fc2_kernel": r(64, 64), "mlp_fc2_bias": r(64)}
    return p, r(32, 64, scale=0.3)


def logits_against_old(old) -> tuple:
    """``(logits that move, logits, largest move, max|logit|)``: one t2t_vit_14
    b1 forward through ``fused_t2t_apply`` (bf16, reference style, seeded
    random weights and image, as ``chip_smoke.py`` phase 4 builds them) with
    the committed kernels, and again with the old kernels in their place."""
    from ..models import t2t_vit as t2t
    from ..models.registry import build_model

    model, shape = build_model("t2t_vit_14", style="reference", dtype=torch.bfloat16,
                               device="cuda", generator=torch.Generator().manual_seed(0))
    prepared = t2t.prepare_t2t_fused(model)
    img = torch.randn(1, *shape, generator=torch.Generator().manual_seed(1000)).cuda()

    def parent(x, p, w, *, eps_ln, approx_gelu, operands=None):
        run_reduce, run_rows, out, _ = old_calls(old, x, p, w, approx=approx_gelu, eps=eps_ln)
        run_reduce()
        run_rows()
        torch.cuda.synchronize()  # the buffers go out of scope here
        return out

    with torch.no_grad():
        new = t2t.fused_t2t_apply(model, img, prepared=prepared)
        kernel, t2t.performer_rest = t2t.performer_rest, parent
        try:
            prev = t2t.fused_t2t_apply(model, img, prepared=prepared)
        finally:
            t2t.performer_rest = kernel
    diff = (new.float() - prev.float()).abs()
    return int((diff > 0).sum()), diff.numel(), float(diff.max()), float(prev.float().abs().max())


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("performer_ab needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    fns, old = build_libraries()
    gen = torch.Generator(device="cuda").manual_seed(17)
    p, w = performer_params(gen)
    ops = pf.performer_operands(p, w)
    tokenizer = defaultdict(lambda: defaultdict(float))  # batch -> variant -> ms
    for batch in BATCHES:
        for n in STAGES:
            x = (torch.randn(batch, n, 3 * pf.TOKEN_SIZE, generator=gen, device="cuda")
                 * 0.5).bfloat16()
            calls = {name: new_calls(f, x, ops, approx=True, rows_read_partials=name == CHUNKS)
                     for name, f in fns.items()}
            calls[OLD] = old_calls(old, x, p, w, approx=True)
            runs = list(calls)
            times = defaultdict(lambda: [0.0, 0.0, 0.0])
            ref, diffs = None, {}
            for order in (runs, runs[::-1]):  # A, B, C, C, B, A
                for name in order:
                    run_reduce, run_rows, out, _ = calls[name]
                    run_reduce()
                    run_rows()
                    torch.cuda.synchronize()
                    if ref is None:
                        ref = out.clone()
                    d = (out.float() - ref.float()).abs()
                    diffs[name] = (float(d.max()), int((d > 0).sum()), d.numel())
                    t = times[name]
                    t[0] += measure_graph_time(run_reduce)["p50_ms"] / 2
                    t[1] += measure_graph_time(run_rows)["p50_ms"] / 2
                    t[2] += measure_graph_time(lambda: (run_reduce(), run_rows()))["p50_ms"] / 2
            for name in runs:
                (tr, tw, tp), (most, moved, total) = times[name], diffs[name]
                print(f"t2t_vit_14 b{batch:<2d} n{n:<4d} {name:26s} reduce {tr * 1e3:8.2f} us  "
                      f"rows {tw * 1e3:8.2f} us  both {tp * 1e3:8.2f} us  max|diff vs "
                      f"committed| {most:.3g}  elements differing {moved} of {total}")
                tokenizer[batch][name] += tp
    print("one t2t_vit_14 tokenizer's two performers (reduce + rows, n = 3136 and 784), ms")
    for batch, per in tokenizer.items():
        print(f"  b{batch:<2d} " + ", ".join(f"{name} {ms:.4f}" for name, ms in per.items()))
    moved, total, most, scale = logits_against_old(old)
    print(f"t2t_vit_14 b1 logits, committed kernels against the old kernels: {moved} of {total} "
          f"move, by at most {most:.4g} (max|logit| {scale:.4g})")


if __name__ == "__main__":
    main()
