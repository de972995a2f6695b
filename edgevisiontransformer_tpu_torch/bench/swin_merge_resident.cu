// A second fused form of K10 (Swin patch merging: the 2x2 gather, the
// LayerNorm over 4C and the [4C, 2C] reduction in one launch), which
// bench/swin_merge_ab.py builds and times against the port's chain
// (csrc/swin_merge.cu, then linear): a block's merged rows resident in
// shared memory.  Its output equals linear(ln_rows(merge_gather(x)), W_red,
// 0, CAST_THEN_BIAS) bit for bit at any block shape and group.
//
// Input x is [b * res * res, C] bf16, W_red [4C, 2C] bf16, zero [2C] bf16
// zeros (store_tile's bias); output [b * (res/2)^2, 2C] bf16.
//
// Design:
// - A block takes `rows` merged rows and `group` column tiles of `cols`
//   output columns in turn, so its rows are gathered and normalized once for
//   all of them.
// - It first copies its merged rows whole into shared memory (the resident
//   A operand, [rows][4C + 8] bf16) by cp.async, at offsets from two small
//   tables (each row's (0,0) source row, each chunk's place in the 2x2
//   block); all copies are in flight together, and the first two W steps
//   behind them.
// - Then each warp normalizes its rows in place, four at a time, with
//   ln_rows' arithmetic from ln_row.cuh's helpers, so the A values equal
//   ln_rows(merge_gather(x)) bit for bit.
// - The products are linear_tile.cuh's mma_step on the resident rows, W by
//   load_w_async through a 3-stage ring; the epilogue of each column tile is
//   store_tile with CAST_THEN_BIAS on the zero bias.
#include "linear_tile.cuh"
#include "ln_row.cuh"

namespace {

constexpr int STAT_ROWS = 4;  // rows a warp normalizes at once

// The row stride of the resident rows for K = 4C: K rounded up to whole
// 64-deep steps (zeros past K), plus 8 (an odd multiple of 16 bytes, so
// ldmatrix's eight row addresses fall in eight bank groups).
__host__ __device__ constexpr int merge_lda(int C) { return (4 * C + BK - 1) / BK * BK + 8; }

// Dynamic shared memory of one block: the resident rows [rows][merge_lda]
// bf16, the W ring STAGES x [BK][cols + 8] bf16 (after each tile's
// products, the warps' output patches), the int offset tables (each row's
// (0,0) source row in x, each 8-value chunk's offset from it) and the
// affine g, b [4C] (fp32 or bf16, room for fp32).
// bench/swin_merge_ab.py:resident_smem_bytes mirrors it.
__host__ __device__ constexpr int merge_smem_bytes(int rows, int cols, int C) {
  return rows * merge_lda(C) * 2 + STAGES * BK * (cols + 8) * 2 + rows * 4 +
         (merge_lda(C) - 8) / 8 * 4 + 2 * 4 * C * 4;
}

// Rows r0 .. r0 + STAT_ROWS - 1 of the resident tile, normalized in place by
// one warp with ln_rows' arithmetic: lane-strided chunks, warp_sum, the
// mean, then the squared deviations, rsqrt(var + eps), (f - mean) * rs * g
// + b (ln_row.cuh's helpers), one cast to bf16.  Rows at and past M stay as
// they are (zeros).
__device__ __forceinline__ void normalize_rows(bf16* sA, int lda, int r0, int live, int K,
                                               const void* g, const void* b, int affine_f32,
                                               float eps, int lane) {
  const int chunks = K / 8;
  float sum[STAT_ROWS], sq[STAT_ROWS], mean[STAT_ROWS], rs[STAT_ROWS], f[8];
#pragma unroll
  for (int u = 0; u < STAT_ROWS; ++u) sum[u] = sq[u] = 0.f;
  for (int c = lane; c < chunks; c += 32) {
#pragma unroll
    for (int u = 0; u < STAT_ROWS; ++u) {
      unpack8(*reinterpret_cast<const uint4*>(sA + (r0 + u) * lda + c * 8), f);
      ln_add_sum(sum[u], f);
    }
  }
#pragma unroll
  for (int u = 0; u < STAT_ROWS; ++u) mean[u] = ln_mean(sum[u], K);
  for (int c = lane; c < chunks; c += 32) {
#pragma unroll
    for (int u = 0; u < STAT_ROWS; ++u) {
      unpack8(*reinterpret_cast<const uint4*>(sA + (r0 + u) * lda + c * 8), f);
      ln_add_sq(sq[u], f, mean[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < STAT_ROWS; ++u) rs[u] = ln_rstd(sq[u], K, eps);
  float gf[8], bf[8];
  for (int c = lane; c < chunks; c += 32) {
    load8_either(g, c, affine_f32, gf);
    load8_either(b, c, affine_f32, bf);
#pragma unroll
    for (int u = 0; u < STAT_ROWS; ++u) {
      if (u >= live) break;
      uint4* p = reinterpret_cast<uint4*>(sA + (r0 + u) * lda + c * 8);
      unpack8(*p, f);
      ln_affine(f, mean[u], rs[u], gf, bf);
      *p = pack8(f);
    }
  }
}

// One block: merged rows m0 .. m0 + BM - 1 of y = bf16(bf16(LN(gather(x))) @
// W) on WM x WN warps of TM x TN, for `group` column tiles of BN in turn
// (blockIdx.x * group onwards): the rows are gathered and normalized once.
template <int WM, int TM, int TN>
__global__ __launch_bounds__(WM * WN * 32, min_blocks(WM * WN * 32, TM / 16 * TN / 8 * 4))
void swin_merge_resident_kernel(const bf16* __restrict__ x, const void* __restrict__ g,
                                const void* __restrict__ b, const bf16* __restrict__ W,
                                const bf16* __restrict__ zero, bf16* __restrict__ Y, int M,
                                int res, int C, float eps, int affine_f32, int group) {
  constexpr int THREADS = WM * WN * 32, WARPS = THREADS / 32, BM = WM * TM, BN = WN * TN;
  constexpr int BS = BN + 8, FM = TM / 16, FN = TN / 8;
  static_assert(BM % (WARPS * STAT_ROWS) == 0, "whole row groups a warp");
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = 4 * C, N = 2 * C, lda = merge_lda(C), KP = lda - 8, KT = KP / BK;
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + BM * lda;
  int* rowoff = reinterpret_cast<int*>(sB + STAGES * BK * BS);
  int* chunkoff = rowoff + BM;
  unsigned char* affine = reinterpret_cast<unsigned char*>(chunkoff + KP / 8);  // g, then b
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM;

  // The offset tables: merged row m = (image, y', x') starts at input row
  // (2y', 2x'); chunk c lies in group q = c / (C/8), row (dy, dx) = (q >> 1,
  // q & 1) of the 2x2 block.  -1 past M and K.
  const int ho = res / 2, per_row = C / 8;
  for (int r = tid; r < BM; r += THREADS) {
    const int m = m0 + r, img = m / (ho * ho), yo = (m / ho) % ho, xo = m % ho;
    rowoff[r] = m < M ? ((img * res + 2 * yo) * res + 2 * xo) * C : -1;
  }
  for (int c = tid; c < KP / 8; c += THREADS) {
    const int q = c / per_row;
    chunkoff[c] = c < K / 8 ? ((q >> 1) * res + (q & 1)) * C + (c - q * per_row) * 8 : -1;
  }
  __syncthreads();

  // One group of copies for the rows and the affine, all in flight together.
  for (int i = tid; i < BM * (KP / 8); i += THREADS) {
    const int r = i / (KP / 8), c = i % (KP / 8), ro = rowoff[r], co = chunkoff[c];
    const bool ok = ro >= 0 && co >= 0;
    cp_async16(sA + r * lda + c * 8, ok ? x + ro + co : x, ok);
  }
  const int vec = affine_f32 ? 4 * C * 4 / 16 : 4 * C * 2 / 16;  // 16-byte copies of g (and b)
  for (int i = tid; i < 2 * vec; i += THREADS)
    cp_async16(affine + i * 16, static_cast<const unsigned char*>(i < vec ? g : b) + (i % vec) * 16,
               true);
  cp_async_commit();
  const void* sg = affine;
  const void* sb = affine + vec * 16;

  // The block's `group` column tiles in turn, each on the resident rows.
  const int wm = (warp / WN) * TM, wn = (warp % WN) * TN;
  const bool active = m0 + wm < M;  // warps wholly past M skip the products
  for (int t = 0; t < group; ++t) {
    const int n0 = (blockIdx.x * group + t) * BN;
    if (n0 >= N) break;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {  // W's first STAGES - 1 steps
      if (s < KT) load_w_async<THREADS, BN>(sB + s * BK * BS, W, N, K, n0, s * BK, tid);
      cp_async_commit();
    }
    if (t == 0) {
      cp_async_wait<STAGES - 1>();  // the rows landed (W's steps may still fly)
      __syncthreads();
      for (int r0 = warp * STAT_ROWS; r0 < BM; r0 += WARPS * STAT_ROWS)
        normalize_rows(sA, lda, r0, M - (m0 + r0), K, sg, sb, affine_f32, eps, lane);
      // (the barrier that opens step 0 publishes the normalized rows)
    }

    float acc[FM][FN][4];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // step kt landed; every warp is done with step kt - 1
      const int nk = kt + STAGES - 1;
      if (nk < KT)
        load_w_async<THREADS, BN>(sB + (nk % STAGES) * BK * BS, W, N, K, n0, nk * BK, tid);
      cp_async_commit();
      if (!active) continue;
      mma_step(acc, sA + wm * lda + kt * BK, sB + (kt % STAGES) * BK * BS + wn, lane, lda);
    }
    cp_async_wait<0>();  // no copy outlives the tile (the last groups are empty)
    __syncthreads();     // every warp is done with the ring: it holds the warps' patches
    if (active)
      store_tile<0, FM, FN>(acc, zero, nullptr, Y, M, N, M, m0 + wm, n0 + wn, true, lane,
                            sB + warp * TM * (TN + 8));
    __syncthreads();  // the patches are written out before the next tile's copies
  }
}

template <int WM, int TM, int TN>
int merge_launch(const void* x, const void* g, const void* b, const void* w, const void* zero,
                 void* y, int M, int res, int C, float eps, int affine_f32, int group,
                 cudaStream_t stream) {
  constexpr int BM = WM * TM, BN = WN * TN;
  static_assert(BM * (BN + 16) <= STAGES * BK * (BN + 8), "the patches fit in the ring");
  const int bytes = merge_smem_bytes(BM, BN, C);
  if (bytes > MAX_SMEM || group < 1) return static_cast<int>(cudaErrorInvalidValue);
  static int configured = 0;  // the most dynamic shared memory allowed so far
  if (bytes > configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(swin_merge_resident_kernel<WM, TM, TN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = bytes;
  }
  const int tiles = (2 * C + BN - 1) / BN;
  const dim3 grid((tiles + group - 1) / group, (M + BM - 1) / BM);
  swin_merge_resident_kernel<WM, TM, TN><<<grid, WM * WN * 32, bytes, stream>>>(
      static_cast<const bf16*>(x), g, b, static_cast<const bf16*>(w),
      static_cast<const bf16*>(zero), static_cast<bf16*>(y), M, res, C, eps, affine_f32, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The (rows, cols) block shapes compiled: every one of linear's.
#define EVT_MERGE_TILES(X)                                                                   \
  X(128, 32) X(128, 64) X(128, 96) X(128, 128) X(64, 32) X(64, 64) X(64, 96) X(64, 128)     \
  X(32, 32) X(32, 64) X(32, 96) X(32, 128) X(16, 32) X(16, 64) X(16, 96) X(16, 128)

// x [batch * res * res, C] (fewer than 2^31 values), w [4C, 2C], zero [2C],
// y [batch * (res/2)^2, 2C] bf16; g, b [4C] bf16 or fp32 (affine_f32); every
// pointer 16-byte aligned.  rows x cols: the block shape; group: the column
// tiles a block takes in turn.
extern "C" int evt_swin_merge_resident(const void* x, const void* g, const void* b,
                                       const void* w, const void* zero, void* y, int batch,
                                       int res, int C, float eps, int affine_f32, int rows,
                                       int cols, int group, void* stream) {
  if (batch == 0) return 0;
  if (res % 2 != 0 || C % 8 != 0 || !aligned16(x) || !aligned16(g) || !aligned16(b) ||
      !aligned16(w) || !aligned16(zero) || !aligned16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  const int M = batch * (res / 2) * (res / 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EVT_MERGE_CASE(R, CO)                                                              \
  if (rows == R && cols == CO)                                                             \
    return merge_launch<(R >= 64 ? R / 32 : R / 16), (R >= 64 ? 32 : 16), CO / WN>(        \
        x, g, b, w, zero, y, M, res, C, eps, affine_f32, group, s);
  EVT_MERGE_TILES(EVT_MERGE_CASE)
#undef EVT_MERGE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
