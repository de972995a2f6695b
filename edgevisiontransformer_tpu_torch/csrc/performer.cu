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
// Bound on the card: per token the two kernels read 3 ts bf16 values and
// write ts (512 bytes) and do ~43 kflop, 33k of it on bf16 operands:
// t2t_vit_14 b1 stage 1 moves 1.6 MB (0.5 us at 3.35 TB/s) and does 31
// MFLOP in fp32 (0.5 us at 67 TFLOP/s).  In practice
// each block's chain of loads, products and sums decides the time, and the
// sums over all tokens are a reduction across blocks.
//
// Design (bench/performer_ab.py times its choices; PERF.md section 6 has
// the numbers), on the mma.sync routines of mma_tiles.cuh and
// attn_tiles.cuh:
// - A warp owns 16 tokens.  t w^T runs on mma.sync.m16n8k16: the product
//   of two bf16 values is exact in fp32, so it is the TPU kernel's fp32
//   product summed in another order.  The token rows are the A operand
//   (ldmatrix), w [m, ts] row-major the col-major B, as attention takes K
//   (prm_exp); |t|^2 comes from the same A fragments, each lane adding its
//   16 columns of rows g and g + 8, then the quad; exp and 1 / sqrt m act on
//   the accumulators.  kp_sum, v^T kp, d and y stay fp32 products on the
//   CUDA cores: kp and qp are fp32 exp outputs.
// - performer_reduce: one 4-warp block per (image, 64-token tile), a
//   partition that does not depend on the batch.  A warp stages its kp in
//   shared memory and adds kp_sum and v^T kp token by token (lane l owns
//   kptv rows l and l + 32); the warps' partials are added in warp order
//   into the tile's partial.  An image's sums [m + ts m] are added in one
//   fixed order over two levels, each staged through shared memory by
//   cp.async (add_partials): the last block of each group of GROUP tiles
//   to finish (an integer counter per group, __threadfence) adds the
//   group's tile partials in tile order into the group's partial, and the
//   last group of the image to finish adds the group partials in group
//   order.  The counters are zero at each launch (the wrapper allocates
//   them zeroed for each call).  With one block adding all 49 tile
//   partials, t2t_vit_14 b1 stage 1 took 19.6 us a launch on the H100; in
//   two levels 13.0, and 5.0 without the sums (bench/performer_ab.py).  No
//   float atomics: an image's sums are the same bits alone and in a batch.
// - performer_rows: blocks of ROWS_WARPS = 4 warps (bench/performer_ab.py's
//   variants of 1 and 2 warps ran slower at every t2t_vit_14 shape, b1
//   included).  A preamble stages the image's sums, the four bf16 weights
//   and the five fp32 vectors by cp.async, and each warp its q and v rows;
//   its barrier is the block's only one.  Then each warp carries its 16
//   tokens through the chain in registers: qp as above; d over the quad;
//   y = qp kptv^T in fp32, each lane computing the values at its own places
//   of the accumulator layout, so that bf16(y) is the A fragment of y @ wo
//   (attention's PV step, pv); the skip, the LayerNorm's two-pass fp32
//   statistics over the quad, fc1, GELU and fc2 the same way; the output
//   leaves through the warp's q rows as 16-byte stores.  A token's bits do
//   not depend on the batch.
#include <math.h>

#include "attn_tiles.cuh"

namespace {

constexpr int TS = 64, MF = 32;              // token size, random features
constexpr int LD = row_ld(TS);               // row stride of staged rows and weights
constexpr int FLD = MF + 4;                  // fp32 row stride of kp, qp and kptv in shared memory
constexpr int XLD = 3 * TS;                  // x_kqv row stride
constexpr int SUMS = MF + TS * MF;           // one image's sums: kp_sum [m], then kptv [ts, m]
constexpr int SUMS_SMEM = MF + TS * FLD;     // the same in shared memory (kptv rows at stride FLD)
constexpr int MATS = MF + 3 * TS;            // rows of the operand matrix: w, wo, w1, w2
constexpr int VECS = 5 * TS;                 // bo, g2, be2, b1, b2
constexpr int RED_WARPS = 4, RED_THREADS = RED_WARPS * 32, TILE = 16 * RED_WARPS;
constexpr int ROWS_WARPS = 4, ROWS_THREADS = ROWS_WARPS * 32;
constexpr float kInvSqrtM = 0.17677669529663687f;  // f32(1 / sqrt(32)), as the reference's constant
// Tiles whose partials the last of them adds: seven partials fill the
// reduce block's shared memory; stage 1 of t2t_vit_14 has 7 x 7 tiles.
constexpr int GROUP = 7;

// Element e of an image's sums in shared memory (kptv rows at stride FLD).
__device__ __forceinline__ int sums_at(int e) {
  return e < MF ? e : MF + (e - MF) / MF * FLD + (e - MF) % MF;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Whether this block is the last of `count` blocks to add one to *counter:
// every thread's writes before the call are visible to that block, and the
// last block sees the others' (__threadfence).
__device__ __forceinline__ bool arrive_last(int* counter, int count, int tid, bool* flag) {
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(counter, 1) == count - 1;
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// dst = src[0] + src[1] + ... + src[count - 1] in that order, for `count`
// partials SUMS floats apart that other blocks wrote, staged GROUP at a time
// in shared memory by cp.async (through L2): a thread's loads are all
// issued before its adds.  Every thread of the block calls it.
template <int NT>
__device__ __forceinline__ void add_partials(float* dst, const float* src, int count,
                                             float* stage, int tid) {
  constexpr int PER = (SUMS / 4 + NT - 1) / NT;  // float4 columns a thread adds
  float4 acc[PER];
  for (int i0 = 0; i0 < count; i0 += GROUP) {
    const int k = min(GROUP, count - i0);
    __syncthreads();  // the previous batch's adds are done with the stage
    for (int i = tid; i < k * SUMS / 4; i += NT)
      cp_async16(stage + 4 * i, src + static_cast<long long>(i0) * SUMS + 4 * i, true);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int c = tid + q * NT;
      if (c < SUMS / 4)
        for (int i = 0; i < k; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(stage + i * SUMS + 4 * c);
          acc[q] = i0 + i == 0 ? v : add4(acc[q], v);
        }
    }
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int c = tid + q * NT;
    if (c < SUMS / 4) reinterpret_cast<float4*>(dst)[c] = acc[q];
  }
}

// prm(t) of the warp's 16 token rows sT (bf16, stride LD) in the
// accumulator layout of qk: s[c][j][e] is feature 16 c + 8 j + 2 t + (e & 1)
// of row g + 8 (e >> 1), for lane (g = lane / 4, t = lane % 4).  sW is w
// [m, ts] (stride LD).  |t|^2: each lane adds the squares of its 16 columns
// of a row (per k16 step: 2t, 2t + 1, 2t + 8, 2t + 9), then the quad adds
// its four lanes.  Rows at or past `valid` become 0 where `mask`.
template <class T>
__device__ __forceinline__ void prm_exp(float (&s)[2][2][4], const T* sT, const T* sW,
                                        int lane, int valid, bool mask) {
  float sq[2] = {0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) s[c][e / 4][e % 4] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < TS / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, sT + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // a[0], a[2]: row g; a[1], a[3]: row g + 8
      const float2 f = Elem<T>::to_float2(*reinterpret_cast<const typename Elem<T>::x2*>(&a[r]));
      sq[r & 1] = fmaf(f.x, f.x, sq[r & 1]);
      sq[r & 1] = fmaf(f.y, f.y, sq[r & 1]);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      uint32_t b[4];
      ldsm_x4(b, sW + (c * 16 + ((lane >> 4) << 3) + (lane & 7)) * LD + kk * 16 +
                     ((lane >> 3) & 1) * 8);
      mma16<T>(s[c][0], a, b[0], b[1]);
      mma16<T>(s[c][1], a, b[2], b[3]);
    }
  }
  const float td[2] = {quad_sum(sq[0]) * 0.5f, quad_sum(sq[1]) * 0.5f};
  const int g = lane >> 2;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int r = (e % 4) >> 1;
      float& x = s[c][e / 4][e % 4];
      x = (mask && g + 8 * r >= valid) ? 0.0f : expf(x - td[r]) * kInvSqrtM;
    }
}

// The accumulators of prm_exp into a [16, FLD] fp32 tile.
__device__ __forceinline__ void store_prm(float* sP, const float (&s)[2][2][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 16 * c + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(sP + g * FLD + col) = make_float2(s[c][j][0], s[c][j][1]);
      *reinterpret_cast<float2*>(sP + (g + 8) * FLD + col) = make_float2(s[c][j][2], s[c][j][3]);
    }
}

// Adds the warp's 16 tokens (k rows sK, v rows sV, bf16 at stride LD; rows
// at or past `valid` left out) to kp_sum[lane] in ksum and to kptv rows
// lane and lane + 32 in acc, token by token.  kp takes sK's place.
template <class T>
__device__ __forceinline__ void add_tokens(float (&acc)[2][MF], float& ksum, T* sK,
                                         const T* sV, const T* sW, int lane, int valid) {
  float* sKp = reinterpret_cast<float*>(sK);  // 16 x FLD fp32: the size of 16 x LD T
  float s[2][2][4];
  prm_exp(s, sK, sW, lane, valid, true);
  __syncwarp();  // every lane's ldmatrix of k is done before kp takes its place
  store_prm(sKp, s, lane);
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    ksum += sKp[r * FLD + lane];
    const float v0 = Elem<T>::to_float(sV[r * LD + lane]);
    const float v1 = Elem<T>::to_float(sV[r * LD + lane + 32]);
#pragma unroll
    for (int j4 = 0; j4 < MF / 4; ++j4) {
      const float4 p = *reinterpret_cast<const float4*>(sKp + r * FLD + 4 * j4);
      acc[0][4 * j4] = fmaf(v0, p.x, acc[0][4 * j4]);
      acc[0][4 * j4 + 1] = fmaf(v0, p.y, acc[0][4 * j4 + 1]);
      acc[0][4 * j4 + 2] = fmaf(v0, p.z, acc[0][4 * j4 + 2]);
      acc[0][4 * j4 + 3] = fmaf(v0, p.w, acc[0][4 * j4 + 3]);
      acc[1][4 * j4] = fmaf(v1, p.x, acc[1][4 * j4]);
      acc[1][4 * j4 + 1] = fmaf(v1, p.y, acc[1][4 * j4 + 1]);
      acc[1][4 * j4 + 2] = fmaf(v1, p.z, acc[1][4 * j4 + 2]);
      acc[1][4 * j4 + 3] = fmaf(v1, p.w, acc[1][4 * j4 + 3]);
    }
  }
}

// Dynamic shared memory: w [m, LD]; per warp its k rows (then its kp, fp32
// at stride FLD) and its v rows; per warp its partial (SUMS_SMEM).
template <class T>
__global__ __launch_bounds__(RED_THREADS) void performer_reduce_kernel(
    const T* __restrict__ x, const T* __restrict__ w, float* __restrict__ partial,
    float* __restrict__ sums, int* __restrict__ counters, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* sW = reinterpret_cast<T*>(smem);
  T* sK = sW + MF * LD;
  T* sV = sK + RED_WARPS * 16 * LD;
  float* sPart = reinterpret_cast<float*>(sV + RED_WARPS * 16 * LD);
  __shared__ bool last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int blk = blockIdx.x, img = blockIdx.y, blocks = gridDim.x;
  const T* xi = x + static_cast<long long>(img) * n * XLD;
  T* sKw = sK + warp * 16 * LD;
  T* sVw = sV + warp * 16 * LD;

  for (int i = tid; i < MF * TS / 8; i += RED_THREADS)
    cp_async16(sW + (i / 8) * LD + (i % 8) * 8, w + 8 * i, true);
  const int row0 = blk * TILE + warp * 16;
  load_rows<TS, 32>(sKw, xi, XLD, row0, 16, n, lane);
  load_rows<TS, 32>(sVw, xi + 2 * TS, XLD, row0, 16, n, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // w and the warp's rows landed
  float acc[2][MF], ksum = 0.0f;  // kptv rows lane and lane + 32; kp_sum[lane]
#pragma unroll
  for (int j = 0; j < MF; ++j) acc[0][j] = acc[1][j] = 0.0f;
  add_tokens(acc, ksum, sKw, sVw, sW, lane, n - row0);
  float* sp = sPart + warp * SUMS_SMEM;
  sp[lane] = ksum;
#pragma unroll
  for (int j4 = 0; j4 < MF / 4; ++j4) {
    *reinterpret_cast<float4*>(sp + MF + lane * FLD + 4 * j4) =
        make_float4(acc[0][4 * j4], acc[0][4 * j4 + 1], acc[0][4 * j4 + 2], acc[0][4 * j4 + 3]);
    *reinterpret_cast<float4*>(sp + MF + (lane + 32) * FLD + 4 * j4) =
        make_float4(acc[1][4 * j4], acc[1][4 * j4 + 1], acc[1][4 * j4 + 2], acc[1][4 * j4 + 3]);
  }
  __syncthreads();
  // the block's partial: its warps' in warp order.  An image's rows of
  // partial: its blocks', then its groups'.
  const int groups = (blocks + GROUP - 1) / GROUP, grp = blk / GROUP;
  float* ip = partial + static_cast<long long>(img) * (blocks + groups) * SUMS;
  for (int c = tid; c < SUMS / 4; c += RED_THREADS) {
    const int at = sums_at(4 * c);
    float4 v = *reinterpret_cast<const float4*>(sPart + at);
#pragma unroll
    for (int wp = 1; wp < RED_WARPS; ++wp)
      v = add4(v, *reinterpret_cast<const float4*>(sPart + wp * SUMS_SMEM + at));
    reinterpret_cast<float4*>(ip + static_cast<long long>(blk) * SUMS)[c] = v;
  }
  // the image's counters: its image counter, then one per group
  int* cnt = counters + static_cast<long long>(img) * (1 + groups);
  float* stage = reinterpret_cast<float*>(smem);
  float* si = sums + static_cast<long long>(img) * SUMS;
  const int in_group = min(GROUP, blocks - grp * GROUP);
  if (!arrive_last(cnt + 1 + grp, in_group, tid, &last)) return;
  add_partials<RED_THREADS>(groups == 1 ? si : ip + static_cast<long long>(blocks + grp) * SUMS,
                            ip + static_cast<long long>(grp) * GROUP * SUMS, in_group, stage, tid);
  if (groups == 1 || !arrive_last(cnt, groups, tid, &last)) return;
  add_partials<RED_THREADS>(si, ip + static_cast<long long>(blocks) * SUMS, groups, stage, tid);
}

// o = bf16(a) @ B for the warp's 16 rows, a and o in the m16n8 accumulator
// layout over 64 columns (o[j][e]: column 8 j + 2 t + (e & 1) of row
// g + 8 (e >> 1)); B [ts, ts] row-major at stride LD.  Two neighbouring n8
// tiles of a are one k16 A fragment: attention's PV step (pv).
template <class T>
__device__ __forceinline__ void mm(float (&o)[TS / 8][4], const float (&a)[TS / 8][4],
                                   const T* sB, int lane) {
#pragma unroll
  for (int j = 0; j < TS / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  pv<TS, TS / 16>(o, reinterpret_cast<const float(&)[TS / 16][2][4]>(a), sB, lane);
}

// Dynamic shared memory: the image's sums (SUMS_SMEM fp32), the vectors
// (VECS fp32), the weights (MATS rows at stride LD), then per warp its q
// rows (then its qp, fp32 at stride FLD, then its output patch) and its v
// rows.  ROWS_WARPS warps, each 16 tokens.
template <class T>
__global__ __launch_bounds__(ROWS_THREADS) void performer_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ sums, const T* __restrict__ mats,
    const float* __restrict__ vecs, T* __restrict__ out, int n, float eps, int approx) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sSum = reinterpret_cast<float*>(smem);
  float* sVec = sSum + SUMS_SMEM;
  T* sMat = reinterpret_cast<T*>(sVec + VECS);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int img = blockIdx.y, row0 = (blockIdx.x * ROWS_WARPS + warp) * 16;
  const T* xi = x + static_cast<long long>(img) * n * XLD;
  T* sQw = sMat + MATS * LD + warp * 32 * LD;
  T* sVw = sQw + 16 * LD;

  const float* si = sums + static_cast<long long>(img) * SUMS;
  for (int c = tid; c < SUMS / 4; c += ROWS_THREADS)
    cp_async16(sSum + sums_at(4 * c), si + 4 * c, true);
  for (int i = tid; i < VECS / 4; i += ROWS_THREADS) cp_async16(sVec + 4 * i, vecs + 4 * i, true);
  for (int i = tid; i < MATS * TS / 8; i += ROWS_THREADS)
    cp_async16(sMat + (i / 8) * LD + (i % 8) * 8, mats + 8 * i, true);
  load_rows<TS, 32>(sQw, xi + TS, XLD, row0, 16, n, lane);
  load_rows<TS, 32>(sVw, xi + 2 * TS, XLD, row0, 16, n, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // the only block barrier
  if (row0 >= n) return;

  const T* sWo = sMat + MF * LD;
  const T* sW1 = sWo + TS * LD;
  const T* sW2 = sW1 + TS * LD;
  const float* kptv = sSum + MF;
  const int g = lane >> 2, t = lane & 3;

  // qp, then d = qp . kp_sum: each lane over its 8 features, then the quad
  float s[2][2][4];
  prm_exp(s, sQw, sMat, lane, n, false);
  float d[2] = {0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int r = (e % 4) >> 1;
      d[r] = fmaf(s[c][e / 4][e % 4], sSum[16 * c + 8 * (e / 4) + 2 * t + (e & 1)], d[r]);
    }
  d[0] = fmaxf(quad_sum(d[0]), 1e-8f);
  d[1] = fmaxf(quad_sum(d[1]), 1e-8f);
  float* sQp = reinterpret_cast<float*>(sQw);  // 16 x FLD fp32: the size of 16 x LD T
  __syncwarp();  // every lane's ldmatrix of q is done before qp takes its place
  store_prm(sQp, s, lane);
  __syncwarp();

  // y = (qp kptv^T) / d at this lane's places: column 8 j + 2 t + (e & 1)
  // of row g + 8 (e >> 1), the features in order
  float y[TS / 8][4];
#pragma unroll
  for (int j = 0; j < TS / 8; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.0f;
#pragma unroll
  for (int f4 = 0; f4 < MF / 4; ++f4) {
    const float4 q0 = *reinterpret_cast<const float4*>(sQp + g * FLD + 4 * f4);
    const float4 q1 = *reinterpret_cast<const float4*>(sQp + (g + 8) * FLD + 4 * f4);
#pragma unroll
    for (int j = 0; j < TS / 8; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float4 k =
            *reinterpret_cast<const float4*>(kptv + (8 * j + 2 * t + b) * FLD + 4 * f4);
        float& y0 = y[j][b];
        float& y1 = y[j][2 + b];
        y0 = fmaf(q0.x, k.x, y0);
        y0 = fmaf(q0.y, k.y, y0);
        y0 = fmaf(q0.z, k.z, y0);
        y0 = fmaf(q0.w, k.w, y0);
        y1 = fmaf(q1.x, k.x, y1);
        y1 = fmaf(q1.y, k.y, y1);
        y1 = fmaf(q1.z, k.z, y1);
        y1 = fmaf(q1.w, k.w, y1);
      }
  }
#pragma unroll
  for (int j = 0; j < TS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[j][e] = y[j][e] / d[e >> 1];

  // y2 = bf16(v + (bf16(y) @ wo + bo)), kept in fp32 in y
  float o[TS / 8][4];
  mm(o, y, sWo, lane);
#pragma unroll
  for (int j = 0; j < TS / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 v0 =
        load_x2((sVw + g * LD + col));
    const float2 v1 =
        load_x2((sVw + (g + 8) * LD + col));
    y[j][0] = round_to<T>(v0.x + (o[j][0] + sVec[col]));
    y[j][1] = round_to<T>(v0.y + (o[j][1] + sVec[col + 1]));
    y[j][2] = round_to<T>(v1.x + (o[j][2] + sVec[col]));
    y[j][3] = round_to<T>(v1.y + (o[j][3] + sVec[col + 1]));
  }

  // h = LN(y2) into o: the fp32 mean and variance of each row, each lane
  // over its 16 columns in order, then the quad
  float mean[2] = {0.0f, 0.0f}, var[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < TS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mean[e >> 1] += y[j][e];
  mean[0] = quad_sum(mean[0]) / static_cast<float>(TS);
  mean[1] = quad_sum(mean[1]) / static_cast<float>(TS);
#pragma unroll
  for (int j = 0; j < TS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float dv = y[j][e] - mean[e >> 1];
      var[e >> 1] = fmaf(dv, dv, var[e >> 1]);
    }
  const float rs[2] = {rsqrtf(quad_sum(var[0]) / static_cast<float>(TS) + eps),
                       rsqrtf(quad_sum(var[1]) / static_cast<float>(TS) + eps)};
  const float* g2 = sVec + TS;
  const float* be2 = sVec + 2 * TS;
#pragma unroll
  for (int j = 0; j < TS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * t + (e & 1);
      o[j][e] = __fadd_rn(__fmul_rn(__fmul_rn(y[j][e] - mean[e >> 1], rs[e >> 1]), g2[col]),
                          be2[col]);
    }

  // g = gelu(bf16(bf16(h) @ w1 + b1)) (rounded to bf16 as fc2's A)
  float hid[TS / 8][4];
  mm(hid, o, sW1, lane);
  const float* b1 = sVec + 3 * TS;
#pragma unroll
  for (int j = 0; j < TS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = round_to<T>(hid[j][e] + b1[8 * j + 2 * t + (e & 1)]);
      hid[j][e] = approx ? gelu_tanh_f(v) : gelu_erf_f(v);
    }

  // out = bf16(y2 + (bf16(g) @ w2 + b2)), through the warp's q rows
  mm(o, hid, sW2, lane);
  const float* b2 = sVec + 4 * TS;
#pragma unroll
  for (int j = 0; j < TS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = y[j][e] + (o[j][e] + b2[8 * j + 2 * t + (e & 1)]);
  store_rows<TS>(o, sQw, out + static_cast<long long>(img) * n * TS, TS, row0, n, lane);
}

constexpr int REDUCE_SMEM = (MF * LD + 2 * RED_WARPS * 16 * LD) * 2 + RED_WARPS * SUMS_SMEM * 4;
static_assert(GROUP * SUMS * 4 <= REDUCE_SMEM, "a group's partials fill the reduce block's stage");
constexpr int ROWS_SMEM = (SUMS_SMEM + VECS) * 4 + (MATS + ROWS_WARPS * 32) * LD * 2;

int configure(const void* kernel, int bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  *done = true;
  return 0;
}

}  // namespace

// x [b, n, 3 ts] bf16, w [m, ts] bf16 (both fp16 in the fp16 instance);
// partial [b, t + ceil(t / GROUP), m + ts m] fp32 scratch for t = ceil(n /
// 64) blocks an image; sums [b, m + ts m] fp32, the image's sums; counters [b
// (1 + ceil(t / GROUP))] int32, zeros.  All 16-byte aligned.
extern "C" int EVT_EXPORT(evt_performer_reduce)(const void* x, const void* w, void* partial,
                                                void* sums, void* counters, int batch, int n,
                                                void* stream) {
  if (batch == 0 || n == 0) return 0;
  if (batch < 0 || batch > 65535 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  static bool done = false;
  const int rc = configure(reinterpret_cast<const void*>(performer_reduce_kernel<elem>),
                           REDUCE_SMEM, &done);
  if (rc != 0) return rc;
  const dim3 grid((n + TILE - 1) / TILE, batch);
  performer_reduce_kernel<elem>
      <<<grid, RED_THREADS, REDUCE_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const elem*>(x), static_cast<const elem*>(w), static_cast<float*>(partial),
      static_cast<float*>(sums), static_cast<int*>(counters), n);
  return static_cast<int>(cudaGetLastError());
}

// x [b, n, 3 ts] bf16; sums: performer_reduce's output; mats [m + 3 ts, ts]
// bf16 (w, wo, w1, w2) and vecs [5, ts] fp32 (bo, g2, be2, b1, b2); out
// [b, n, ts] bf16 (x, mats and out fp16 in the fp16 instance).  All 16-byte
// aligned.
extern "C" int EVT_EXPORT(evt_performer_rows)(const void* x, const void* sums, const void* mats,
                                              const void* vecs, void* out, int batch, int n,
                                              float eps, int approx, void* stream) {
  if (batch == 0 || n == 0) return 0;
  if (batch < 0 || batch > 65535 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  static bool done = false;
  const int rc =
      configure(reinterpret_cast<const void*>(performer_rows_kernel<elem>), ROWS_SMEM, &done);
  if (rc != 0) return rc;
  const dim3 grid((n + 16 * ROWS_WARPS - 1) / (16 * ROWS_WARPS), batch);
  performer_rows_kernel<elem>
      <<<grid, ROWS_THREADS, ROWS_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const elem*>(x), static_cast<const float*>(sums),
      static_cast<const elem*>(mats), static_cast<const float*>(vecs), static_cast<elem*>(out), n,
      eps, approx);
  return static_cast<int>(cudaGetLastError());
}
