// mlp: Y[M, D] = bf16(f32(bf16(gelu(X @ W1 + b1))) @ W2 + b2), both products
// in one kernel, the hidden activation kept on chip: the MLP of the ViT
// module's kernel_mode="pallas" forward.
//
// Replaces: `_mlp_kernel` / `mlp` (K14) in
//   edgevisiontransformer_tpu/ops/pallas/fused_mlp.py:23-79, with its cast
//   points (:25-30):
//     h   = f32(X @ W1) + f32(b1)          (fp32 accumulation, no rounding)
//     h   = bf16(gelu(h))                  (GELU on the fp32 value, one cast)
//     out = bf16(f32(h @ W2) + f32(b2))
//   GELU is the exact form with erff (K14's mathlib.gelu_kernel evaluates erf
//   with a polynomial, erf_poly, within 7.2e-7 of erf) or the tanh form.  This
//   is neither of linear.cu's epilogues: CAST_THEN_BIAS_GELU rounds twice
//   before GELU, BIAS_RESIDUAL adds a residual.
//
// Bound on the card: a deit_tiny b128 layer (M = 25,216, D = 192, hidden
// 768) does 4 * M * D * hidden = 14.9 GFLOP on 20 MB (X and Y, the weights
// once): 0.0150 ms on the tensor cores at 989 TFLOP/s against 0.0060 ms of
// bytes, so operations bound it at serving batches.  At b1 (M = 197) the
// weights' bytes and the launch bound it, and 197 rows make 4 row tiles.
//
// Design (simple first): one thread block of 8 warps per (64-row tile,
// 256-column tile of Y).  The block's X rows stay in shared memory; the
// hidden width is walked in chunks of 64 units: fc1 of the chunk (K = D in
// steps of 64 through a 2-stage cp.async ring of W1 tiles, each warp 16 x 32
// of the 64 x 64 chunk on WMMA bf16 fragments), then bias + GELU in fp32 and
// one cast to bf16 into shared memory, then Y_tile += h_chunk @ W2[chunk, tile]
// on fp32 accumulators held in registers (each warp 32 x 64 of 64 x 256) with
// the W2 chunk loaded while fc1 runs.  A 256-wide column tile covers D <= 256
// (deit_tiny, 192) in one block column and recomputes fc1 for each further
// column tile (3x fc1 at deit_base's D = 768): holding a 64 x 768 fp32 tile
// would take 192 accumulator registers per thread.  At small M the grid is
// small (4 blocks at deit_tiny b1): the card is mostly idle there; splitting
// the hidden chunks over blocks, wgmma and TMA are later work.  Any hidden
// width: W1's rows are hidden wide (230 at a pruned ffn0.3), so where hidden
// is not a multiple of 8 or W1 is off a 16-byte boundary the host takes the
// element-wise form of W1's loads; the ragged last chunk is zero-filled in W1,
// b1 and W2, so its padded units give gelu(0) = 0 against zero rows of W2.
// D is a multiple of 8.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 256, HC = 64, BK = 64, THREADS = 256;
constexpr int MAX_SMEM = 232448;  // the most dynamic shared memory a block may use
constexpr int W1LD = HC + 8;      // W1 tile row stride (bf16)
constexpr int H32LD = HC + 4;     // fp32 hidden chunk row stride
constexpr int HLD = HC + 8;       // bf16 hidden chunk row stride
constexpr int W2LD = BN + 8;      // W2 chunk row stride (bf16)
constexpr int OLD = BN + 4;       // fp32 output tile row stride

// Shared memory, in bytes from the start: X [BM, xld], two W1 tiles, the
// fp32 and bf16 hidden chunk, the W2 chunk; at the end the fp32 output tile
// reuses the start.
struct Layout {
  int xld, w1_off, h32_off, h_off, w2_off, bytes;
  __host__ __device__ explicit Layout(int dim) {
    xld = (dim + BK - 1) / BK * BK + 8;
    w1_off = BM * xld * 2;
    h32_off = w1_off + 2 * BK * W1LD * 2;
    h_off = h32_off + BM * H32LD * 4;
    w2_off = h_off + BM * HLD * 2;
    const int end = w2_off + HC * W2LD * 2;
    bytes = end > BM * OLD * 4 ? end : BM * OLD * 4;
  }
};

// W1[k0:k0+BK, j0:j0+HC] into a tile, zeros past dim and hidden.
template <bool V1>
__device__ __forceinline__ void load_w1(bf16* dst, const bf16* __restrict__ W1, int dim,
                                        int hidden, int k0, int j0, int tid) {
  if constexpr (V1) {
    for (int i = tid; i < BK * (HC / 8); i += THREADS) {
      const int r = i / (HC / 8), c = (i % (HC / 8)) * 8;
      const bool ok = k0 + r < dim && j0 + c < hidden;
      cp_async16(dst + r * W1LD + c, ok ? W1 + static_cast<size_t>(k0 + r) * hidden + j0 + c : W1,
                 ok);
    }
  } else {
    for (int i = tid; i < BK * HC; i += THREADS) {
      const int r = i / HC, c = i % HC;
      dst[r * W1LD + c] = k0 + r < dim && j0 + c < hidden
                              ? W1[static_cast<size_t>(k0 + r) * hidden + j0 + c]
                              : __float2bfloat16_rn(0.0f);
    }
  }
}

// W2[j0:j0+HC, n0:n0+BN] into the chunk buffer, zeros past hidden and dim.
template <bool V2>
__device__ __forceinline__ void load_w2(bf16* dst, const bf16* __restrict__ W2, int dim,
                                        int hidden, int j0, int n0, int tid) {
  if constexpr (V2) {
    for (int i = tid; i < HC * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool ok = j0 + r < hidden && n0 + c < dim;
      cp_async16(dst + r * W2LD + c, ok ? W2 + static_cast<size_t>(j0 + r) * dim + n0 + c : W2,
                 ok);
    }
  } else {
    for (int i = tid; i < HC * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      dst[r * W2LD + c] = j0 + r < hidden && n0 + c < dim
                              ? W2[static_cast<size_t>(j0 + r) * dim + n0 + c]
                              : __float2bfloat16_rn(0.0f);
    }
  }
}

template <bool V1, bool V2>
__global__ __launch_bounds__(THREADS) void mlp_kernel(
    const bf16* __restrict__ X, const bf16* __restrict__ W1, const bf16* __restrict__ b1,
    const bf16* __restrict__ W2, const bf16* __restrict__ b2, bf16* __restrict__ Y, int M,
    int dim, int hidden, int approx) {
  const Layout L(dim);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sW1 = reinterpret_cast<bf16*>(smem + L.w1_off);
  float* sH32 = reinterpret_cast<float*>(smem + L.h32_off);
  bf16* sH = reinterpret_cast<bf16*>(smem + L.h_off);
  bf16* sW2 = reinterpret_cast<bf16*>(smem + L.w2_off);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int xld = L.xld, ksteps = (dim + BK - 1) / BK;
  // fc1: each warp 16 rows x 32 hidden units of the chunk; fc2: 32 rows x 64
  // columns of the output tile
  const int hm = (warp >> 1) * 16, hn = (warp & 1) * 32;
  const int om = (warp >> 2) * 32, on = (warp & 3) * 64;

  // The block's X rows, zeros past M and dim (dim % 8 == 0: a vector is all
  // in or all out).
  for (int i = tid; i < BM * (xld / 8); i += THREADS) {
    const int r = i / (xld / 8), c = (i % (xld / 8)) * 8;
    const bool ok = m0 + r < M && c < dim;
    cp_async16(sX + r * xld + c, ok ? X + static_cast<size_t>(m0 + r) * dim + c : X, ok);
  }
  cp_async_commit();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int j0 = 0; j0 < hidden; j0 += HC) {
    __syncthreads();  // every warp is done with the previous chunk's W1, h and W2
    load_w2<V2>(sW2, W2, dim, hidden, j0, n0, tid);
    load_w1<V1>(sW1, W1, dim, hidden, 0, j0, tid);
    cp_async_commit();

    // h = X @ W1[:, chunk]
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc[2];
    wmma::fill_fragment(hacc[0], 0.0f);
    wmma::fill_fragment(hacc[1], 0.0f);
    for (int kt = 0; kt < ksteps; ++kt) {
      cp_async_wait<0>();
      __syncthreads();  // step kt landed; every warp is done with step kt - 1
      if (kt + 1 < ksteps)
        load_w1<V1>(sW1 + ((kt + 1) & 1) * BK * W1LD, W1, dim, hidden, (kt + 1) * BK, j0, tid);
      cp_async_commit();
      const bf16* w1t = sW1 + (kt & 1) * BK * W1LD;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sX + hm * xld + kt * BK + kk, xld);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, w1t + kk * W1LD + hn + j * 16, W1LD);
          wmma::mma_sync(hacc[j], a, b, hacc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sH32 + hm * H32LD + hn + j * 16, hacc[j], H32LD,
                              wmma::mem_row_major);
    __syncthreads();

    // h = bf16(gelu(h + f32(b1))); units past hidden are 0
    for (int i = tid; i < BM * HC; i += THREADS) {
      const int r = i / HC, c = i % HC;
      float h = 0.0f;
      if (j0 + c < hidden) {
        h = sH32[r * H32LD + c] + __bfloat162float(b1[j0 + c]);
        h = approx ? gelu_tanh_f(h) : gelu_erf_f(h);
      }
      sH[r * HLD + c] = __float2bfloat16_rn(h);
    }
    __syncthreads();

    // Y_tile += h @ W2[chunk, tile]; fragments wholly past dim are skipped
#pragma unroll
    for (int kk = 0; kk < HC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], sH + (om + i * 16) * HLD + kk, HLD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n0 + on + j * 16 >= dim) continue;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, sW2 + kk * W2LD + on + j * 16, W2LD);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // the buffers become the fp32 output tile
  float* sO = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(sO + (om + i * 16) * OLD + on + j * 16, acc[i][j], OLD,
                              wmma::mem_row_major);
  __syncthreads();

  // Y = bf16(acc + f32(b2)), 8 columns a thread (dim % 8 == 0)
  for (int i = tid; i < BM * (BN / 8); i += THREADS) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= dim) continue;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = sO[r * OLD + c + e] + __bfloat162float(b2[gn + e]);
    *reinterpret_cast<uint4*>(Y + static_cast<size_t>(gm) * dim + gn) = pack8(v);
  }
}

template <bool V1, bool V2>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* y, int M, int dim, int hidden, int approx, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlp_kernel<V1, V2>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((dim + BN - 1) / BN, (M + BM - 1) / BM);
  mlp_kernel<V1, V2><<<grid, THREADS, Layout(dim).bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(b2), static_cast<bf16*>(y), M, dim,
      hidden, approx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, dim] and y 16-byte aligned, dim % 8 == 0; w1 [dim, hidden], b1
// [hidden], w2 [hidden, dim], b2 [dim] bf16 at any alignment.
extern "C" int evt_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* y, int M, int dim, int hidden, int approx,
                       void* stream) {
  if (M == 0) return 0;
  if (dim <= 0 || dim % 8 || hidden <= 0 || !aligned16(x) || !aligned16(y) ||
      Layout(dim).bytes > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool v1 = hidden % 8 == 0 && aligned16(w1);
  const bool v2 = aligned16(w2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v1 && v2) return launch<true, true>(x, w1, b1, w2, b2, y, M, dim, hidden, approx, s);
  if (v1) return launch<true, false>(x, w1, b1, w2, b2, y, M, dim, hidden, approx, s);
  if (v2) return launch<false, true>(x, w1, b1, w2, b2, y, M, dim, hidden, approx, s);
  return launch<false, false>(x, w1, b1, w2, b2, y, M, dim, hidden, approx, s);
}
