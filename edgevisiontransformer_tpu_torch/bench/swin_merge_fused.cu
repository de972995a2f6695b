// A fused form of K10 (Swin patch merging: the 2x2 gather, the LayerNorm
// over 4C and the [4C, 2C] reduction in one launch), which
// bench/swin_merge_ab.py builds and times against the port's chain
// (csrc/swin_merge.cu, then linear): linear's tile with the merged rows as
// its A operand, normalized on their way into shared memory.  It computes
// K10's y = bf16(bf16(LN(gather(x))) @ W_red) at K10's cast points, and
// its output equals linear(ln_rows(merge_gather(x)), W_red, 0,
// CAST_THEN_BIAS) bit for bit at any block shape.
//
// Input x is [b * res * res, C] bf16, W_red [4C, 2C] bf16, zero [2C] bf16
// zeros (store_tile's bias); output [b * (res/2)^2, 2C] bf16.  Merged row
// (y', x') concatenates the input rows (2y'+dy, 2x'+dx) in the order (0,0),
// (0,1), (1,0), (1,1), as csrc/swin_merge.cu does.
//
// Design:
// - One block a (rows x cols) output tile, of the shapes EVT_MERGE_TILES
//   compiles (rows are WM x TM: 128: 4 x 32, 64: 2 x 32, 32: 2 x 16, 16:
//   1 x 16).
// - A block first computes its rows' LayerNorm statistics, one warp a few
//   rows at once: each lane loads its chunks lane, lane + 32, ... of every
//   row into registers (all in flight together) and adds them with ln_rows'
//   helpers in ln_rows' order (csrc/ln_row.cuh), so mean and rs are
//   ln_rows'.  Meanwhile the first three K steps and the affine g, b are
//   copied by cp.async.
// - The K loop is linear's: 64-deep steps through a cp.async ring, the
//   products by csrc/linear_tile.cuh:mma_step (the same k16 steps in the same
//   order into one fp32 accumulator), W by load_w_async.  The A step is
//   gathered: 8-value chunk ch of merged row m comes from input row (2y'+dy,
//   2x'+dx), (dy, dx) = (q >> 1, q & 1) of group q = ch / (C/8), so a step
//   may straddle two groups (C = 96).
// - Each thread normalizes, in place, the A chunks it copied itself, with
//   ln_row.cuh's ln_affine and one cast.  A copy is visible to its own
//   thread once cp.async.wait_group returns, so this needs no barrier of its
//   own: the ring is four deep, a thread normalizes step kt + 1 while the
//   warps multiply step kt, and the barrier that opens step kt + 1
//   publishes it.
// - The epilogue is linear's store_tile with CAST_THEN_BIAS on the zero
//   bias: bf16(bf16(acc) + 0) = bf16(acc).
#include "linear_tile.cuh"
#include "ln_row.cuh"

namespace {

constexpr int MERGE_STAGES = 4;  // ring depth: a step is normalized a step before its products

// Dynamic shared memory of one block: the ring of MERGE_STAGES x (A [rows,
// AS], W [BK, cols + 8]) bf16, each row's (mean, rs) in fp32, and the affine
// g, b [4C] (room for fp32).  bench/swin_merge_ab.py:fused_smem_bytes
// mirrors it.
__host__ __device__ constexpr int merge_smem_bytes(int rows, int cols, int C) {
  return MERGE_STAGES * (rows * AS + BK * (cols + 8)) * 2 + rows * 8 + 2 * 4 * C * 4;
}

// The offset in x of merged row m's (0,0) input row, -1 at and past M.
__device__ __forceinline__ int row_offset(int m, int M, int res, int C) {
  const int ho = res / 2, img = m / (ho * ho), yo = (m / ho) % ho, xo = m % ho;
  return m < M ? ((img * res + 2 * yo) * res + 2 * xo) * C : -1;
}

// The offset of chunk ch (8 values) of a merged row from its (0,0) input
// row: group q = ch / (C/8) lies in input row (dy, dx) = (q >> 1, q & 1).
__device__ __forceinline__ int chunk_offset(int ch, int res, int C) {
  const int per_row = C / 8, q = ch / per_row;
  return ((q >> 1) * res + (q & 1)) * C + (ch - q * per_row) * 8;
}

// The LayerNorm statistics of merged rows m0 + r0 .. m0 + r0 + R - 1, one
// warp: each lane's chunks lane, lane + 32, ... (at most J: 4C <= 256 J) of
// all R rows are loaded at once, then added in ln_rows' order; lane 0
// writes each row's (mean, rs).
template <int R, int J>
__device__ __forceinline__ void row_stats(const bf16* __restrict__ x, float2* stats, int m0,
                                          int r0, int M, int res, int C, float eps, int lane) {
  const int K = 4 * C;
  int off[J];
#pragma unroll
  for (int j = 0; j < J; ++j)
    off[j] = lane + 32 * j < K / 8 ? chunk_offset(lane + 32 * j, res, C) : -1;
  uint4 v[R][J];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int ro = row_offset(m0 + r0 + u, M, res, C);
#pragma unroll
    for (int j = 0; j < J; ++j)
      v[u][j] = ro >= 0 && off[j] >= 0 ? *reinterpret_cast<const uint4*>(x + ro + off[j])
                                       : make_uint4(0u, 0u, 0u, 0u);
  }
  float f[8], sum[R], mean[R];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    sum[u] = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (off[j] >= 0) {
        unpack8(v[u][j], f);
        ln_add_sum(sum[u], f);
      }
  }
#pragma unroll
  for (int u = 0; u < R; ++u) mean[u] = ln_mean(sum[u], K);
#pragma unroll
  for (int u = 0; u < R; ++u) {
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (off[j] >= 0) {
        unpack8(v[u][j], f);
        ln_add_sq(sq, f, mean[u]);
      }
    const float rs = ln_rstd(sq, K, eps);
    if (lane == 0) stats[r0 + u] = make_float2(mean[u], rs);
  }
}

// One block: Y[m0:m0+BM, n0:n0+BN] = bf16(bf16(LN(gather(x))) @ W) on WM x
// WN warps of TM x TN.
template <int WM, int TM, int TN>
__global__ __launch_bounds__(WM * WN * 32, min_blocks(WM * WN * 32, TM / 16 * TN / 8 * 4))
void swin_merge_fused_kernel(const bf16* __restrict__ x, const void* __restrict__ g,
                             const void* __restrict__ b, const bf16* __restrict__ W,
                             const bf16* __restrict__ zero, bf16* __restrict__ Y, int M, int res,
                             int C, float eps, int affine_f32) {
  constexpr int THREADS = WM * WN * 32, WARPS = THREADS / 32, BM = WM * TM, BN = WN * TN;
  constexpr int FM = TM / 16, FN = TN / 8, A_STAGE = BM * AS, B_STAGE = BK * (BN + 8);
  constexpr int STEP = BK / 8, ROWS_T = BM * STEP / THREADS;  // a thread's A chunks a step
  static_assert(ROWS_T >= 1 && BM * STEP % THREADS == 0, "whole chunks a thread");
  static_assert(BM / WARPS % 8 == 0, "whole groups of rows a warp");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + MERGE_STAGES * A_STAGE;
  float2* stats = reinterpret_cast<float2*>(sB + MERGE_STAGES * B_STAGE);
  unsigned char* affine = reinterpret_cast<unsigned char*>(stats + BM);  // g, then b
  const int K = 4 * C, N = 2 * C, KT = (K + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // A thread copies and normalizes chunk column cc of rows rr + j * THREADS /
  // STEP (j < ROWS_T) of every step.
  const int cc = tid % STEP, rr = tid / STEP;
  int ro[ROWS_T];
#pragma unroll
  for (int j = 0; j < ROWS_T; ++j) ro[j] = row_offset(m0 + rr + j * (THREADS / STEP), M, res, C);
  auto load_a = [&](bf16* a, int kt) {
    const int ch = kt * STEP + cc, co = ch < K / 8 ? chunk_offset(ch, res, C) : -1;
#pragma unroll
    for (int j = 0; j < ROWS_T; ++j) {
      const bool ok = ro[j] >= 0 && co >= 0;
      cp_async16(a + (rr + j * (THREADS / STEP)) * AS + cc * 8, ok ? x + ro[j] + co : x, ok);
    }
  };

  // The affine, then the first steps, all in flight during the statistics.
  const int vec = (affine_f32 ? 4 : 2) * K / 16;  // 16-byte copies of g (and of b)
  for (int i = tid; i < 2 * vec; i += THREADS)
    cp_async16(affine + i * 16,
               static_cast<const unsigned char*>(i < vec ? g : b) + (i % vec) * 16, true);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < MERGE_STAGES - 1; ++s) {
    if (s < KT) {
      load_a(sA + s * A_STAGE, s);
      load_w_async<THREADS, BN>(sB + s * B_STAGE, W, N, K, n0, s * BK, tid);
    }
    cp_async_commit();
  }

  // The warp's rows' statistics, as many rows at once as keep 16 chunks a
  // lane in registers.
  const int J = (K / 8 + 31) / 32, r0 = warp * (BM / WARPS);
  for (int r = r0; r < r0 + BM / WARPS; r += J <= 2 ? 8 : J <= 4 ? 4 : 2) {
    if (J <= 2) row_stats<8, 2>(x, stats, m0, r, M, res, C, eps, lane);
    else if (J <= 4) row_stats<4, 4>(x, stats, m0, r, M, res, C, eps, lane);
    else row_stats<2, 8>(x, stats, m0, r, M, res, C, eps, lane);
  }

  cp_async_wait<MERGE_STAGES - 2>();  // this thread's copies of the affine and step 0 landed
  __syncthreads();                    // the statistics and the affine are in shared memory
  float mean[ROWS_T], rs[ROWS_T];
#pragma unroll
  for (int j = 0; j < ROWS_T; ++j) {
    const float2 s = stats[rr + j * (THREADS / STEP)];
    mean[j] = s.x;
    rs[j] = s.y;
  }
  const void* sg = affine;
  const void* sb = affine + vec * 16;
  auto normalize = [&](bf16* a, int kt) {  // this thread's chunks of step kt, in place
    const int ch = kt * STEP + cc;
    if (ch >= K / 8) return;
    float gf[8], bf[8], f[8];
    load8_either(sg, ch, affine_f32, gf);
    load8_either(sb, ch, affine_f32, bf);
#pragma unroll
    for (int j = 0; j < ROWS_T; ++j) {
      if (ro[j] < 0) continue;  // rows past M stay zeros
      uint4* p = reinterpret_cast<uint4*>(a + (rr + j * (THREADS / STEP)) * AS + cc * 8);
      unpack8(*p, f);
      ln_affine(f, mean[j], rs[j], gf, bf);
      *p = pack8(f);
    }
  };
  normalize(sA, 0);

  const int wm = (warp / WN) * TM, wn = (warp % WN) * TN;
  const bool active = m0 + wm < M;  // warps wholly past M skip the products
  float acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<MERGE_STAGES - 3>();  // this thread's copies of step kt + 1 landed
    __syncthreads();  // step kt is normalized; every warp is done with step kt - 1
    const int nk = kt + MERGE_STAGES - 1;
    if (nk < KT) {
      load_a(sA + (nk % MERGE_STAGES) * A_STAGE, nk);
      load_w_async<THREADS, BN>(sB + (nk % MERGE_STAGES) * B_STAGE, W, N, K, n0, nk * BK, tid);
    }
    cp_async_commit();
    if (kt + 1 < KT) normalize(sA + ((kt + 1) % MERGE_STAGES) * A_STAGE, kt + 1);
    if (active)
      mma_step(acc, sA + (kt % MERGE_STAGES) * A_STAGE + wm * AS,
               sB + (kt % MERGE_STAGES) * B_STAGE + wn, lane);
  }
  cp_async_wait<0>();  // no copy outlives the tile (the last groups are empty)
  __syncthreads();     // every warp is done with the ring: it holds the warps' patches
  if (active)
    store_tile<0, FM, FN>(acc, zero, nullptr, Y, M, N, M, m0 + wm, n0 + wn, true, lane,
                          sA + warp * TM * (TN + 8));
}

template <int WM, int TM, int TN>
int merge_launch(const void* x, const void* g, const void* b, const void* w, const void* zero,
                 void* y, int M, int res, int C, float eps, int affine_f32, cudaStream_t stream) {
  constexpr int BM = WM * TM, BN = WN * TN;
  static_assert(BM * (BN + 16) <= MERGE_STAGES * BM * AS, "the patches fit in the ring");
  const int bytes = merge_smem_bytes(BM, BN, C);
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  static int configured = 0;  // the most dynamic shared memory allowed so far
  if (bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        swin_merge_fused_kernel<WM, TM, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = bytes;
  }
  const dim3 grid((2 * C + BN - 1) / BN, (M + BM - 1) / BM);
  swin_merge_fused_kernel<WM, TM, TN><<<grid, WM * WN * 32, bytes, stream>>>(
      static_cast<const bf16*>(x), g, b, static_cast<const bf16*>(w),
      static_cast<const bf16*>(zero), static_cast<bf16*>(y), M, res, C, eps, affine_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The (rows, cols) block shapes compiled: every one of linear's.
#define EVT_MERGE_TILES(X)                                                                   \
  X(128, 32) X(128, 64) X(128, 96) X(128, 128) X(64, 32) X(64, 64) X(64, 96) X(64, 128)     \
  X(32, 32) X(32, 64) X(32, 96) X(32, 128) X(16, 32) X(16, 64) X(16, 96) X(16, 128)

// x [batch * res * res, C] (fewer than 2^31 values), w [4C, 2C], zero [2C],
// y [batch * (res/2)^2, 2C] bf16; g, b [4C] bf16 or fp32 (affine_f32);
// every pointer 16-byte aligned; C % 8 == 0 and C <= 512.  rows x cols: the
// block shape.
extern "C" int evt_swin_merge_fused(const void* x, const void* g, const void* b, const void* w,
                                    const void* zero, void* y, int batch, int res, int C,
                                    float eps, int affine_f32, int rows, int cols,
                                    void* stream) {
  if (batch == 0) return 0;
  if (res % 2 != 0 || C % 8 != 0 || C > 512 || !aligned16(x) || !aligned16(g) ||
      !aligned16(b) || !aligned16(w) || !aligned16(zero) || !aligned16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  const int M = batch * (res / 2) * (res / 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EVT_MERGE_CASE(R, CO)                                                              \
  if (rows == R && cols == CO)                                                             \
    return merge_launch<(R >= 64 ? R / 32 : R / 16), (R >= 64 ? 32 : 16), CO / WN>(        \
        x, g, b, w, zero, y, M, res, C, eps, affine_f32, s);
  EVT_MERGE_TILES(EVT_MERGE_CASE)
#undef EVT_MERGE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
