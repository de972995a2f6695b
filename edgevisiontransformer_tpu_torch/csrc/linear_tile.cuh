// The tile of csrc/linear.cu (its header comment has the design): an
// mma.sync GEMM tile of WM x 2 warps, each owning TM rows by TN columns,
// with its epilogue from the accumulator registers.  linear.cu and
// linear_rows{64,32,16}.cu each compile the blocks of one row count (one
// nvcc process each, side by side); linear.cu dispatches on the plan.
// gemm_tile is the tile as a __device__ routine over one output tile, run
// by a group of WM x 2 warps on its own named barrier: linear_kernel runs
// it once with the whole block, vit_full.cu for every tile its warp groups
// take in a GEMM phase of the whole forward.  A K step's W copy
// (load_w_async) and products (mma_step) are routines of their own, which
// bench/swin_merge_fused.cu and bench/swin_merge_resident.cu (fused forms
// of Swin patch merging, timed by bench/swin_merge_ab.py) share.
#pragma once

#include "common.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr int BK = 64, STAGES = 3;  // K step, ring depth
constexpr int WN = 2;               // warps across the columns of a block
constexpr int AS = BK + 8;          // A tile row stride (elements): 144 bytes
constexpr int MAX_SMEM = 232448;    // the most dynamic shared memory a block may use
constexpr int ROW_BIAS = 4;

// Shared memory of one block: the ring of STAGES x (A [rows, AS], B [BK,
// cols + 8]) 16-bit values (bf16 or fp16: the element type T of every
// routine below); after the products it holds each warp's output patch
// (rows x (cols + 16) values in all, always smaller).
// fused_encoder.py:_linear_smem_bytes mirrors this.
__host__ __device__ constexpr int smem_bytes(int rows, int cols) {
  return STAGES * (rows * AS + BK * (cols + 8)) * 2;
}

// The blocks an SM should hold at once, for ptxas's register budget: the
// 64K registers over the block's threads at an estimated acc + 64 registers
// a thread (the accumulators, fragments, addresses and the epilogue's
// temporaries; acc + 48 spilled a few bytes), at least 1 and at most 8.
// More resident blocks overlap one block's loads and epilogue with another's
// products.
constexpr int min_blocks(int threads, int acc) {
  return 65536 / (threads * (acc + 64)) < 1   ? 1
         : 65536 / (threads * (acc + 64)) > 8 ? 8
                                              : 65536 / (threads * (acc + 64));
}

// The epilogue of one fp32 sum v with its bias b and residual r, at the
// reference's cast points (bench/linear_ab.py builds a variant without it).
// EPI is a template argument: the epilogue of a whole warp tile is unrolled
// straight-line code, one copy per epilogue, with no branch per element.
// The roundings are to T.
template <int EPI, class T>
__device__ __forceinline__ float epilogue(float v, float b, float r) {
  if constexpr (EPI == 3) return (v + b) + r;
  if constexpr (EPI == ROW_BIAS) return v + r;
  v = round_to<T>(round_to<T>(v) + b);
  if constexpr (EPI == 1) return gelu_tanh_f(v);
  if constexpr (EPI == 2) return gelu_erf_f(v);
  return v;
}

// A ROWS x COLS tile of a row-major matrix (row stride sld) into shared
// memory (row stride dld), element by element: zeros at and past row `rows`
// and column `cols` of src.  Each thread keeps 8 loads in flight before it
// stores them, so a stage waits for one round trip, not one a load.
template <int THREADS, int ROWS, int COLS, class T>
__device__ __forceinline__ void load_masked(T* dst, int dld, const T* __restrict__ src,
                                            size_t sld, int rows, int cols, int tid) {
  constexpr int PER = ROWS * COLS / THREADS;
  static_assert(PER % 8 == 0, "whole batches of 8 elements a thread");
  for (int j0 = 0; j0 < PER; j0 += 8) {
    T v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = tid + (j0 + u) * THREADS, r = i / COLS, c = i % COLS;
      v[u] = r < rows && c < cols ? src[r * sld + c] : Elem<T>::from_float(0.0f);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = tid + (j0 + u) * THREADS;
      dst[(i / COLS) * dld + i % COLS] = v[u];
    }
  }
}

// A barrier of the NT threads of one warp group: named barrier `id` (0, with
// NT the whole block, is __syncthreads).  Groups of one block that run
// tiles independently each take their own id.
template <int NT>
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(NT) : "memory");
}

// The A operand as the rows of X [M, K]: X[m0:m0+BM, k0:k0+BK] into stage
// buffer a, zeros past M and K.  va: X's rows are 16-byte aligned (cp.async
// of 8 values, all in or all out, read from L2); otherwise each element is
// loaded and masked.  vit_full.cu passes va = true only: its activations are
// written earlier in the same launch, which the read-only path the
// element-wise loads may take must not serve.
template <class T>
struct RowsA {
  const T* __restrict__ X;
  bool va;

  template <int THREADS, int BM>
  __device__ __forceinline__ void load(T* a, int M, int K, int m0, int k0, int tid) const {
    if (va) {
#pragma unroll
      for (int i = tid; i < BM * (BK / 8); i += THREADS) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        const bool ok = m0 + r < M && k0 + c < K;
        cp_async16(a + r * AS + c, ok ? X + static_cast<size_t>(m0 + r) * K + k0 + c : X, ok);
      }
    } else {
      load_masked<THREADS, BM, BK>(a, AS, X + static_cast<size_t>(m0) * K + k0, K, M - m0,
                                   K - k0, tid);
    }
  }
};

// W[k0:k0+BK, n0:n0+BN] into stage buffer b (row stride BN + 8) by
// cp.async, zeros past K and N; W's rows are 16-byte aligned.
template <int THREADS, int BN, class T>
__device__ __forceinline__ void load_w_async(T* b, const T* __restrict__ W, int N, int K,
                                             int n0, int k0, int tid) {
  constexpr int BS = BN + 8;
#pragma unroll
  for (int i = tid; i < BK * (BN / 8); i += THREADS) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const bool ok = k0 + r < K && n0 + c < N;
    cp_async16(b + r * BS + c, ok ? W + static_cast<size_t>(k0 + r) * N + n0 + c : W, ok);
  }
}

// One K step: the A tile [BM, BK] from `src` (an A source: RowsA, or
// vit_full.cu's patch gather) and W[k0:k0+BK, n0:n0+BN] into stage buffers a
// and b, zeros past M, K and N.  vb: W's rows are 16-byte aligned (cp.async);
// otherwise each element is loaded and masked.
template <int THREADS, int BM, int BN, class ASrc, class T>
__device__ __forceinline__ void load_stage(T* a, T* b, const ASrc& src,
                                           const T* __restrict__ W, int M, int N, int K,
                                           int m0, int n0, int k0, bool vb, int tid) {
  src.template load<THREADS, BM>(a, M, K, m0, k0, tid);
  if (vb) load_w_async<THREADS, BN>(b, W, N, K, n0, k0, tid);
  else
    load_masked<THREADS, BK, BN>(b, BN + 8, W + static_cast<size_t>(k0) * N + n0, N, K - k0,
                                 N - n0, tid);
}

// The products of one K step on a warp's FM x FN fragments: ta is the
// warp's first A row of the step (row stride lda), tb its first W column
// (row stride WN * TN + 8); four k16 steps, in order, each accumulated into
// acc by mma.sync.
template <int FM, int FN, class T>
__device__ __forceinline__ void mma_step(float (&acc)[FM][FN][4], const T* ta, const T* tb,
                                         int lane, int lda = AS) {
  constexpr int TN = FN * 8, BS = WN * TN + 8;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[FM][4];
#pragma unroll
    for (int i = 0; i < FM; ++i)
      ldsm_x4(a[i], ta + (i * 16 + (lane & 15)) * lda + kk + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < TN / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, tb + (kk + (lane & 15)) * BS + np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        mma16<T>(acc[i][2 * np], a[i], b[0], b[1]);
        mma16<T>(acc[i][2 * np + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// A warp's FM x FN fragments through the epilogue EPI to Y, from the
// accumulator registers: thread (g, t) holds, of fragment (i, j), rows g and
// g + 8 of m16 tile i and columns 2t, 2t + 1 of n8 tile j, and reads the
// bias and residual at those positions.  On the 16-byte path (vb: N % 8 ==
// 0 and every pointer 16-byte aligned, so a pair is all in or all out) it
// reads them as x2 pairs of T and packs its two results into the warp's patch
// [TM, TN + 8] of the idle ring (the row stride an odd multiple of 16
// bytes); the warp then writes its rows to Y as 16-byte vectors.  Otherwise
// it reads and writes element by element, masked.  r0, c0: the warp's first
// row and column.  ROW_BIAS reads the residual's row gm % res_rows (the ViT
// embedding's per-token bias, one row a token); the others row gm.
template <int EPI, int FM, int FN, class T>
__device__ __forceinline__ void store_tile(const float (&acc)[FM][FN][4],
                                           const typename Same<T>::type* bias,
                                           const typename Same<T>::type* res, T* Y, int M,
                                           int N, int res_rows, int r0, int c0, bool vb,
                                           int lane, typename Same<T>::type* patch) {
  constexpr int TM = FM * 16, TN = FN * 8, PLD = TN + 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < FN; ++j) {
    const int c = j * 8 + 2 * t, gn = c0 + c;
    const bool in = gn < N, pair = vb || gn + 1 < N;
    float2 bv = make_float2(0.0f, 0.0f);
    if constexpr (EPI != ROW_BIAS) {
      if (vb) bv = in ? load_x2(bias + gn) : bv;
      else if (in)
        bv = make_float2(Elem<T>::to_float(bias[gn]),
                         pair ? Elem<T>::to_float(bias[gn + 1]) : 0.0f);
    }
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = i * 16 + g + 8 * h, gm = r0 + r;
        const size_t off = static_cast<size_t>(gm) * N + gn;
        float2 rv = make_float2(0.0f, 0.0f);
        if constexpr (EPI == 3 || EPI == ROW_BIAS) {
          const size_t roff =
              EPI == ROW_BIAS ? static_cast<size_t>(gm % res_rows) * N + gn : off;
          if (gm < M && in) {
            if (vb) rv = load_x2(res + roff);
            else
              rv = make_float2(Elem<T>::to_float(res[roff]),
                               pair ? Elem<T>::to_float(res[roff + 1]) : 0.0f);
          }
        }
        const float y0 = epilogue<EPI, T>(acc[i][j][2 * h], bv.x, rv.x);
        const float y1 = epilogue<EPI, T>(acc[i][j][2 * h + 1], bv.y, rv.y);
        if (vb) {
          *reinterpret_cast<uint32_t*>(patch + r * PLD + c) = pack2<T>(y0, y1);
        } else if (gm < M && in) {
          Y[off] = Elem<T>::from_float(y0);
          if (pair) Y[off + 1] = Elem<T>::from_float(y1);
        }
      }
  }
  if (!vb) return;
  __syncwarp();
  for (int i = lane; i < TM * (TN / 8); i += 32) {
    const int r = i / (TN / 8), c = (i % (TN / 8)) * 8;
    if (r0 + r < M && c0 + c < N)
      *reinterpret_cast<uint4*>(Y + static_cast<size_t>(r0 + r) * N + c0 + c) =
          *reinterpret_cast<const uint4*>(patch + r * PLD + c);
  }
}

// Y[m0:m0+BM, n0:n0+BN] = epilogue(A @ W) on a group of WM x WN warps, each
// owning TM rows by TN columns; `tid` is the thread's index in the group,
// `bar` the group's named barrier, `smem` its ring.  Every output element
// sums its K in k16 steps, in order, into one fp32 accumulator.  On return
// the group's warps may still read their patches of the ring: a caller that
// runs another tile on the same ring passes the group's barrier first.
// bias, res and Y carry no __restrict__: Y may be res.
template <int WM, int TM, int TN, class ASrc, class T>
__device__ __forceinline__ void gemm_tile(unsigned char* smem, const ASrc& src,
                                          const T* __restrict__ W,
                                          const typename Same<T>::type* bias,
                                          const typename Same<T>::type* res, T* Y, int M, int N,
                                          int K, int epi, int res_rows, int m0, int n0, bool vb,
                                          int tid, int bar) {
  constexpr int THREADS = WM * WN * 32, BM = WM * TM, BN = WN * TN, BS = BN + 8;
  constexpr int FM = TM / 16, FN = TN / 8;  // a warp's m16 and n8 fragments
  constexpr int A_STAGE = BM * AS, B_STAGE = BK * BS;
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + STAGES * A_STAGE;

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp / WN) * TM, wn = (warp % WN) * TN;
  const bool active = m0 + wm < M;  // warps wholly past M skip the products

  float acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_stage<THREADS, BM, BN>(sA + s * A_STAGE, sB + s * B_STAGE, src, W, M, N, K, m0, n0,
                                  s * BK, vb, tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    group_sync<THREADS>(bar);  // step kt landed; every warp is done with step kt - 1
    const int nk = kt + STAGES - 1;
    if (nk < KT) {
      const int s = nk % STAGES;
      load_stage<THREADS, BM, BN>(sA + s * A_STAGE, sB + s * B_STAGE, src, W, M, N, K, m0, n0,
                                  nk * BK, vb, tid);
    }
    cp_async_commit();
    if (active)
      mma_step(acc, sA + (kt % STAGES) * A_STAGE + wm * AS, sB + (kt % STAGES) * B_STAGE + wn,
               lane);
  }
  cp_async_wait<0>();        // no copy outlives the tile (the last groups are empty)
  group_sync<THREADS>(bar);  // every warp is done with the ring: it holds the warps' patches
  if (!active) return;

  T* patch = sA + warp * TM * (TN + 8);
  const int r0 = m0 + wm, c0 = n0 + wn;
#define EVT_STORE(E) \
  store_tile<E, FM, FN, T>(acc, bias, res, Y, M, N, res_rows, r0, c0, vb, lane, patch)
  switch (epi) {
    case 0: EVT_STORE(0); break;
    case 1: EVT_STORE(1); break;
    case 2: EVT_STORE(2); break;
    case 3: EVT_STORE(3); break;
    default: EVT_STORE(ROW_BIAS);
  }
#undef EVT_STORE
}

// A block of WM x WN warps, one gemm_tile; grid (column tiles, row tiles).
template <int WM, int TM, int TN, class T>
__global__ __launch_bounds__(WM * WN * 32, min_blocks(WM * WN * 32, TM / 16 * TN / 8 * 4))
void linear_kernel(
    const T* __restrict__ X, const T* __restrict__ W, const T* bias, const T* res, T* Y, int M,
    int N, int K, int epi, bool va, bool vb) {
  extern __shared__ __align__(128) unsigned char smem[];
  gemm_tile<WM, TM, TN>(smem, RowsA<T>{X, va}, W, bias, res, Y, M, N, K, epi, M,
                        blockIdx.y * WM * TM, blockIdx.x * WN * TN, vb, threadIdx.x, 0);
}

// The block shape's launch at the translation unit's element type.
template <int WM, int TM, int TN>
int launch(const void* x, const void* w, const void* bias, const void* res, void* y, int M,
           int N, int K, int epi, bool va, bool vb, cudaStream_t stream) {
  constexpr int BM = WM * TM, BN = WN * TN, BYTES = smem_bytes(BM, BN);
  static_assert(BYTES <= MAX_SMEM, "the ring must fit in shared memory");
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        linear_kernel<WM, TM, TN, elem>, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  linear_kernel<WM, TM, TN, elem><<<grid, WM * WN * 32, BYTES, stream>>>(
      static_cast<const elem*>(x), static_cast<const elem*>(w), static_cast<const elem*>(bias),
      static_cast<const elem*>(res), static_cast<elem*>(y), M, N, K, epi, va, vb);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of one row count (WM x 2 warps of TM rows) at each column
// width the plan may pick.
template <int WM, int TM>
int launch_cols(const void* x, const void* w, const void* bias, const void* res, void* y, int M,
                int N, int K, int epi, int cols, bool va, bool vb, cudaStream_t s) {
  switch (cols) {
#define EVT_LINEAR_COLS(C) \
    case C: return launch<WM, TM, C / WN>(x, w, bias, res, y, M, N, K, epi, va, vb, s);
    EVT_LINEAR_COLS(32)
    EVT_LINEAR_COLS(64)
    EVT_LINEAR_COLS(96)
    EVT_LINEAR_COLS(128)
#undef EVT_LINEAR_COLS
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The launches of 128-, 64-, 32- and 16-row blocks (4 x 32, 2 x 32, 2 x 16
// and 1 x 16 warps' rows), each defined in the source that compiles it, in
// the namespace of its instance (the element type of its translation unit).
#define EVT_LINEAR_ARGS                                                                     \
  const void *x, const void *w, const void *bias, const void *res, void *y, int M, int N, \
      int K, int epi, int cols, bool va, bool vb, cudaStream_t s
namespace EVT_INSTANCE {
int linear_rows128(EVT_LINEAR_ARGS);
int linear_rows64(EVT_LINEAR_ARGS);
int linear_rows32(EVT_LINEAR_ARGS);
int linear_rows16(EVT_LINEAR_ARGS);
}  // namespace EVT_INSTANCE
using namespace EVT_INSTANCE;
