// The tile of csrc/linear_i8.cu (its header comment has the design): an
// mma.sync.m16n8k32 int8 GEMM block of WM x 2 warps, each owning TM rows by
// TN columns, with the dequant and epilogue from the int32 accumulator
// registers.  linear_i8.cu and i8_rows{64,32,16}.cu each compile the blocks
// of one row count (one nvcc process each, side by side); linear_i8.cu
// dispatches on the plan.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 128, STAGES = 3;  // K step (int8 values, 128 bytes), ring depth
constexpr int WN = 2;                // warps across the columns of a block
constexpr int AS = BK + 16;          // A tile row stride (bytes): 144, an odd multiple of 16
constexpr int MAX_SMEM = 232448;     // the most dynamic shared memory a block may use
constexpr int MAX_SPLIT = 8;         // the portable cluster size

// Shared memory of one block: the ring of STAGES x (A [rows, AS], W [BK,
// cols + 16]) int8, W as it lies in memory (k-major).
// fused_encoder.py:_linear_i8_smem_bytes mirrors this.
__host__ __device__ constexpr int smem_bytes(int rows, int cols) {
  return STAGES * (rows * AS + BK * (cols + 16));
}

// The blocks an SM should hold at once, for ptxas's register budget (as
// linear_tile.cuh's): the 64K registers over the block's threads at acc + 64
// registers a thread but never fewer than 88 (the epilogue's addresses and
// vectors; 80 spilled at 128 x 32), at least 1 and at most 8.
constexpr int regs_estimate(int acc) { return acc + 64 < 88 ? 88 : acc + 64; }
constexpr int min_blocks(int threads, int acc) {
  return 65536 / (threads * regs_estimate(acc)) < 1   ? 1
         : 65536 / (threads * regs_estimate(acc)) > 8 ? 8
                                                      : 65536 / (threads * regs_estimate(acc));
}

// The dequant and epilogue of one int32 sum, in the parent kernel's order:
// deq = (f32(acc) * sr) * ws (dynamic) or f32(acc) * ws (static), then the
// bias, then GELU or the residual (bench/linear_i8_ab.py builds a variant
// without it).  __fmul_rn / __fadd_rn keep nvcc from contracting into FMAs.
template <int EPI, class T>
__device__ __forceinline__ float epilogue(int acc, bool dynamic, float sr, float ws, float b,
                                          float r) {
  const float accf = __int2float_rn(acc);
  const float deq = dynamic ? __fmul_rn(__fmul_rn(accf, sr), ws) : __fmul_rn(accf, ws);
  const float v = __fadd_rn(deq, b);
  if constexpr (EPI == 3) return __fadd_rn(v, r);
  if constexpr (EPI == 1) return gelu_tanh_f(round_to<T>(v));
  if constexpr (EPI == 2) return gelu_erf_f(round_to<T>(v));
  return v;
}

// A ROWS x COLS tile of a row-major int8 matrix (row stride sld) into shared
// memory (row stride dld), byte by byte: zeros at and past row `rows` and
// column `cols` of src.  Each thread keeps 16 loads in flight before it
// stores them, so a stage waits for one round trip, not one a byte.
template <int THREADS, int ROWS, int COLS>
__device__ __forceinline__ void load_masked(int8_t* dst, int dld, const int8_t* __restrict__ src,
                                            size_t sld, int rows, int cols, int tid) {
  constexpr int PER = ROWS * COLS / THREADS;
  static_assert(PER % 16 == 0, "whole batches of 16 bytes a thread");
  for (int j0 = 0; j0 < PER; j0 += 16) {
    int8_t v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int i = tid + (j0 + u) * THREADS, r = i / COLS, c = i % COLS;
      v[u] = r < rows && c < cols ? src[r * sld + c] : int8_t(0);
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int i = tid + (j0 + u) * THREADS;
      dst[(i / COLS) * dld + i % COLS] = v[u];
    }
  }
}

// One K step: Q[m0:m0+BM, k0:k0+BK] and W[k0:k0+BK, n0:n0+BN] into stage
// buffers a and b, zeros past M, K and N.  va / vb: Q's / W's rows are 16-byte
// aligned (cp.async of 16 values, all in or all out); otherwise each byte is
// loaded and masked.
template <int THREADS, int BM, int BN>
__device__ __forceinline__ void load_stage(int8_t* a, int8_t* b, const int8_t* __restrict__ Q,
                                           const int8_t* __restrict__ W, int M, int N, int K,
                                           int m0, int n0, int k0, bool va, bool vb, int tid) {
  constexpr int BS = BN + 16;
  if (va) {
#pragma unroll
    for (int i = tid; i < BM * (BK / 16); i += THREADS) {
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      const bool ok = m0 + r < M && k0 + c < K;
      cp_async16(a + r * AS + c, ok ? Q + static_cast<size_t>(m0 + r) * K + k0 + c : Q, ok);
    }
  } else {
    load_masked<THREADS, BM, BK>(a, AS, Q + static_cast<size_t>(m0) * K + k0, K, M - m0, K - k0,
                                 tid);
  }
  if (vb) {
#pragma unroll
    for (int i = tid; i < BK * (BN / 16); i += THREADS) {
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async16(b + r * BS + c, ok ? W + static_cast<size_t>(k0 + r) * N + n0 + c : W, ok);
    }
  } else {
    load_masked<THREADS, BK, BN>(b, BS, W + static_cast<size_t>(k0) * N + n0, N, K - k0, N - n0,
                                 tid);
  }
}

// The W row (k, within a k32 step) whose address lane `lane` gives the
// ldmatrix.trans of frag_b: matrices 0 and 1 cover k 0-15, 2 and 3 k 16-31;
// matrix 0's rows are k {0, 1, 4, 5, 10, 11, 14, 15}, matrix 1's the rest
// ({2, 3, 6, 7, 8, 9, 12, 13}), so that thread t receives k 4t..4t+3 of its
// two columns in the two matrices, and each matrix's eight rows fall in
// eight distinct 16-byte bank groups at any row stride that is an odd
// multiple of 16 bytes.
__device__ __forceinline__ int frag_b_row(int lane) {
  const int r = lane & 7, mat = lane >> 3;
  return (mat >> 1) * 16 + ((((r & 6) << 1) | (r & 1)) ^ ((((r >> 2) ^ mat) & 1) << 1));
}

// The B fragments of one k32 step for 16 columns of the k-major W tile (p:
// this lane's row, frag_b_row, at the first column): ldmatrix.trans hands
// thread (g, t) k-pairs of columns 2g and 2g + 1, and two byte permutes per
// matrix pair gather k 4t..4t+3 of each column (sel: 0x6420 for t < 2,
// whose first matrix holds the lower k pair, else 0x2064).  b[0], b[1]: the
// even columns' n8 tile (fragment column g is column 2g); b[2], b[3]: the
// odd columns' (2g + 1).  int32 sums are exact, so only the k order of A
// and B must agree, not any particular one.
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const int8_t* p, uint32_t sel) {
  uint32_t r[4];
  ldsm_x4_trans(r, p);
  b[0] = __byte_perm(r[0], r[1], sel);
  b[1] = __byte_perm(r[2], r[3], sel);
  b[2] = __byte_perm(r[0], r[1], sel + 0x1111);
  b[3] = __byte_perm(r[2], r[3], sel + 0x1111);
}

// w_s, the bias (fp32 or T) and the residual (T) at 4 columns, read as one
// vector (v4: 16-byte path) or element by element, masked at N.
__device__ __forceinline__ void load4_f32(const float* p, int n, int N, bool v4, float (&f)[4]) {
  if (v4) {
    if (n >= N) { f[0] = f[1] = f[2] = f[3] = 0.0f; return; }
    const float4 v = *reinterpret_cast<const float4*>(p + n);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = n + e < N ? p[n + e] : 0.0f;
}

template <class T>
__device__ __forceinline__ void load4(const T* p, int n, int N, bool v4, float (&f)[4]) {
  if (v4) {
    if (n >= N) { f[0] = f[1] = f[2] = f[3] = 0.0f; return; }
    const uint2 v = *reinterpret_cast<const uint2*>(p + n);
    const float2 lo = load_x2(reinterpret_cast<const T*>(&v.x));
    const float2 hi = load_x2(reinterpret_cast<const T*>(&v.y));
    f[0] = lo.x; f[1] = lo.y; f[2] = hi.x; f[3] = hi.y;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = n + e < N ? Elem<T>::to_float(p[n + e]) : 0.0f;
}

// A warp's FM x FN accumulator fragments through the dequant and epilogue
// EPI to Y.  Thread (g, t) holds, of the 16 columns of each frag_b pair
// (fragments 2p and 2p + 1: even and odd columns), rows g and g + 8 of m16
// tile i at columns 4t..4t+3: acc[i][2p][2h], acc[i][2p + 1][2h],
// acc[i][2p][2h + 1], acc[i][2p + 1][2h + 1] for row g + 8h.  It reads w_s and
// the bias once per 4 columns and s_row once per row.  On the vector path
// (vb: N % 16 == 0 and every pointer 16-byte aligned, so 4 columns are all
// in or all out) it stores its four results (T) as one 8-byte vector: the
// four threads of a row fill a whole 32-byte sector of Y.  Otherwise it
// reads and writes element by element, masked.  r0, c0: the warp's first
// row and column.  s_row == nullptr: the static dequant.
template <int EPI, int FM, int FN, class T>
__device__ __forceinline__ void store_tile(const int (&acc)[FM][FN][4],
                                           const float* __restrict__ s_row,
                                           const float* __restrict__ w_s, const void* bias,
                                           bool bias_f32, const T* res, T* Y, int M, int N,
                                           int r0, int c0, bool vb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool dynamic = s_row != nullptr;
#pragma unroll
  for (int p = 0; p < FN / 2; ++p) {
    const int c = p * 16 + 4 * t, gn = c0 + c;
    float ws[4], bv[4];
    load4_f32(w_s, gn, N, vb, ws);
    if (bias_f32) load4_f32(static_cast<const float*>(bias), gn, N, vb, bv);
    else load4(static_cast<const T*>(bias), gn, N, vb, bv);
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = r0 + i * 16 + g + 8 * h;
        const size_t off = static_cast<size_t>(gm) * N + gn;
        const float sr = dynamic && gm < M ? s_row[gm] : 0.0f;
        float rv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if constexpr (EPI == 3) {
          if (gm < M) load4(res + static_cast<size_t>(gm) * N, gn, N, vb, rv);
        }
        const int a[4] = {acc[i][2 * p][2 * h], acc[i][2 * p + 1][2 * h],
                          acc[i][2 * p][2 * h + 1], acc[i][2 * p + 1][2 * h + 1]};
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[e] = epilogue<EPI, T>(a[e], dynamic, sr, ws[e], bv[e], rv[e]);
        if (vb) {
          if (gm < M && gn < N)
            *reinterpret_cast<uint2*>(Y + off) =
                make_uint2(pack2<T>(y[0], y[1]), pack2<T>(y[2], y[3]));
        } else if (gm < M) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (gn + e < N) Y[off + e] = Elem<T>::from_float(y[e]);
        }
      }
  }
}

// A block of WM x WN warps, each owning TM rows by TN columns (TN a multiple
// of 16); grid (split x column tiles, row tiles).  With split > 1 the split
// blocks of a column tile are one cluster: block `rank` walks the rank-th
// contiguous share of the K steps, and rank 0 adds the others' int32
// partials from their shared memory (exact in any order) before its
// epilogue.  bias, res and Y carry no __restrict__: Y may be res.
template <int WM, int TM, int TN, class T>
__global__ __launch_bounds__(WM * WN * 32, min_blocks(WM * WN * 32, TM / 16 * TN / 8 * 4))
void linear_i8_kernel(
    const int8_t* __restrict__ Q, const float* __restrict__ s_row, const int8_t* __restrict__ W,
    const float* __restrict__ w_s, const void* bias, const T* res, T* Y, int M, int N,
    int K, int epi, int split, bool bias_f32, bool va, bool vb) {
  constexpr int THREADS = WM * WN * 32, BM = WM * TM, BN = WN * TN, BS = BN + 16;
  constexpr int FM = TM / 16, FN = TN / 8;  // a warp's m16 and n8 fragments
  constexpr int A_STAGE = BM * AS, B_STAGE = BK * BS;
  static_assert(TN % 16 == 0, "frag_b covers 16 columns");
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* sA = reinterpret_cast<int8_t*>(smem);
  int8_t* sB = sA + STAGES * A_STAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = blockIdx.x % split;
  const int m0 = blockIdx.y * BM, n0 = (blockIdx.x / split) * BN;
  const int wm = (warp / WN) * TM, wn = (warp % WN) * TN;
  const bool active = m0 + wm < M;  // warps wholly past M skip the products
  const uint32_t sel = (lane & 3) < 2 ? 0x6420u : 0x2064u;
  const int brow = frag_b_row(lane);

  int acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int KT = (K + BK - 1) / BK;
  const int kt0 = rank * KT / split, nkt = (rank + 1) * KT / split - kt0;  // this block's share
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkt)
      load_stage<THREADS, BM, BN>(sA + s * A_STAGE, sB + s * B_STAGE, Q, W, M, N, K, m0, n0,
                                  (kt0 + s) * BK, va, vb, tid);
    cp_async_commit();
  }

  for (int j = 0; j < nkt; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step j landed; every warp is done with step j - 1
    const int nj = j + STAGES - 1;
    if (nj < nkt) {
      const int s = nj % STAGES;
      load_stage<THREADS, BM, BN>(sA + s * A_STAGE, sB + s * B_STAGE, Q, W, M, N, K, m0, n0,
                                  (kt0 + nj) * BK, va, vb, tid);
    }
    cp_async_commit();
    if (!active) continue;
    const int kt = kt0 + j;
    const int8_t* ta = sA + (j % STAGES) * A_STAGE + wm * AS;
    const int8_t* tb = sB + (j % STAGES) * B_STAGE + wn;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      if (kt * BK + kk >= K) break;  // k32 steps wholly past K (K = 192: half the last step)
      uint32_t a[FM][4];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        ldsm_x4(a[i], ta + (i * 16 + (lane & 15)) * AS + kk + (lane >> 4) * 16);
#pragma unroll
      for (int p = 0; p < TN / 16; ++p) {
        uint32_t b[4];
        frag_b(b, tb + (kk + brow) * BS + p * 16, sel);
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          mma_s8(acc[i][2 * p], a[i], b[0], b[1]);
          mma_s8(acc[i][2 * p + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (the last groups are empty)
  if (split > 1) {
    __syncthreads();  // every warp is done with the ring: it holds the partials
    int* part = reinterpret_cast<int*>(smem);  // [FM * FN * 4][THREADS]
    if (active && rank > 0) {
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[((i * FN + j) * 4 + e) * THREADS + tid] = acc[i][j][e];
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every partial of the cluster is written
    if (active && rank == 0) {
      for (int p = 1; p < split; ++p) {
        const int* peer = cluster.map_shared_rank(part, p);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][j][e] += peer[((i * FN + j) * 4 + e) * THREADS + tid];
      }
    }
    cluster.sync();  // no block leaves while rank 0 may still read its partial
    if (rank > 0) return;
  }
  if (!active) return;

  const int r0 = m0 + wm, c0 = n0 + wn;
#define EVT_I8_STORE(E) \
  store_tile<E, FM, FN, T>(acc, s_row, w_s, bias, bias_f32, res, Y, M, N, r0, c0, vb, lane)
  switch (epi) {
    case 0: EVT_I8_STORE(0); break;
    case 1: EVT_I8_STORE(1); break;
    case 2: EVT_I8_STORE(2); break;
    default: EVT_I8_STORE(3);
  }
#undef EVT_I8_STORE
}

// The block shape's launch at the translation unit's element type.
template <int WM, int TM, int TN>
int launch(const void* q, const void* s_row, const void* w, const void* w_s, const void* bias,
           const void* res, void* y, int M, int N, int K, int epi, int split, bool bias_f32,
           bool va, bool vb, cudaStream_t stream) {
  constexpr int BM = WM * TM, BN = WN * TN, BYTES = smem_bytes(BM, BN);
  static_assert(BYTES <= MAX_SMEM, "the ring must fit in shared memory");
  static_assert(BM * BN * 4 <= BYTES, "the int32 partials must fit in the ring");
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        linear_i8_kernel<WM, TM, TN, elem>, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split * ((N + BN - 1) / BN), (M + BM - 1) / BM);
  cfg.blockDim = dim3(WM * WN * 32);
  cfg.dynamicSmemBytes = BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, linear_i8_kernel<WM, TM, TN, elem>, static_cast<const int8_t*>(q),
      static_cast<const float*>(s_row), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_s), bias, static_cast<const elem*>(res), static_cast<elem*>(y),
      M, N, K, epi, split, bias_f32, va, vb);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of one row count (WM x 2 warps of TM rows) at each column
// width the plan may pick.
template <int WM, int TM>
int launch_cols(const void* q, const void* s_row, const void* w, const void* w_s,
                const void* bias, const void* res, void* y, int M, int N, int K, int epi,
                bool bias_f32, int cols, int split, bool va, bool vb, cudaStream_t s) {
  switch (cols) {
#define EVT_LINEAR_I8_COLS(C)                                                               \
    case C: return launch<WM, TM, C / WN>(q, s_row, w, w_s, bias, res, y, M, N, K, epi,   \
                                          split, bias_f32, va, vb, s);
    EVT_LINEAR_I8_COLS(32)
    EVT_LINEAR_I8_COLS(64)
    EVT_LINEAR_I8_COLS(96)
    EVT_LINEAR_I8_COLS(128)
#undef EVT_LINEAR_I8_COLS
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The launches of 128-, 64-, 32- and 16-row blocks (4 x 32, 2 x 32, 2 x 16
// and 1 x 16 warps' rows), each defined in the source that compiles it, in
// the namespace of its instance (the element type of its translation unit).
#define EVT_LINEAR_I8_ARGS                                                                  \
  const void *q, const void *s_row, const void *w, const void *w_s, const void *bias,      \
      const void *res, void *y, int M, int N, int K, int epi, bool bias_f32, int cols,     \
      int split, bool va, bool vb, cudaStream_t s
namespace EVT_INSTANCE {
int linear_i8_rows128(EVT_LINEAR_I8_ARGS);
int linear_i8_rows64(EVT_LINEAR_I8_ARGS);
int linear_i8_rows32(EVT_LINEAR_I8_ARGS);
int linear_i8_rows16(EVT_LINEAR_I8_ARGS);
}  // namespace EVT_INSTANCE
using namespace EVT_INSTANCE;
