// linear: Y[M, N] = epilogue(X[M, K] @ W[K, N]) in bf16 with fp32 accumulation.
//
// Replaces: the four matmuls of every layer inside the TPU whole-encoder
//   kernels, edgevisiontransformer_tpu/ops/pallas/fused_encoder.py
//   `_encoder_kernel` (K1, :202-243: qkv, out-proj, fc1, fc2) and
//   `_encoder_kernel_pipelined` (K2, :661-686), with their epilogues:
//     0 CAST_THEN_BIAS          bf16(bf16(acc) + b)                  (:202-206)
//     1 CAST_THEN_BIAS_GELU     bf16(gelu_tanh(bf16(bf16(acc) + b))) (:231-235)
//     2   (exact GELU, erff)    bf16(gelu_erf(bf16(bf16(acc) + b)))
//     3 BIAS_RESIDUAL           bf16(acc + f32(b) + f32(res))        (:218-225, :236-243)
//   The roundings are the reference's, because bf16 parity depends on them.
//
// Bound on the card: at b1 (M = 197) a layer's GEMMs do 2*M*K*N flops on
// K*N weights read once, ~200 flop/byte: below the H100's ~295 flop/byte
// balance point, so weight bytes and launch latency bound them.  At serving
// batches (M = 25,216 for b128) they sit far above it and the tensor cores
// bound them (989 TFLOP/s dense bf16).
//
// Design: a plain tiled GEMM.  128x128 output tile per thread block, 8 warps
// each owning 32x64 of it as 2x4 WMMA 16x16x16 bf16 fragments (mma.sync on
// the tensor cores), K in steps of 32 through a 3-stage cp.async ring in
// shared memory (zero-filled past the ragged M, N and K edges).  The
// epilogue stages the fp32 tile in shared memory and writes 16-byte vectors.
// Any K and N: a pruned model's hidden width (int(0.3 * 768) = 230) leaves
// the rows of X (K) or of W, the bias, the residual and Y (N) off 16-byte
// boundaries.  The host picks, per operand, the 16-byte path (cp.async, and
// vector stores in the epilogue) where the width is a multiple of 8 and the
// pointers are 16-byte aligned, and otherwise an element-wise path that
// masks every element against M, N and K itself; the arithmetic is the same.
// wgmma, TMA and a persistent schedule are later work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int AS = BK + 8;  // padded smem row strides (elements)
constexpr int BS = BN + 8;
constexpr int CS = BN + 4;
constexpr int A_STAGE = BM * AS;
constexpr int B_STAGE = BK * BS;
constexpr int PIPE_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;
constexpr int C_BYTES = BM * CS * 4;
constexpr int SMEM_BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;

// One K step of the A (X) and B (W) tiles into shared memory.  VA / VB: the
// operand's rows are 16-byte aligned (cp.async of 8 values, all in or all
// out); otherwise each element is loaded and masked on its own.
template <bool VA, bool VB>
__device__ __forceinline__ void load_stage(bf16* sA, bf16* sB, const bf16* __restrict__ X,
                                           const bf16* __restrict__ W, int M, int N, int K,
                                           int m0, int n0, int k0, int tid) {
  if constexpr (VA) {
#pragma unroll
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + c;
      const bool ok = gm < M && gk < K;
      cp_async16(sA + r * AS + c, ok ? X + static_cast<size_t>(gm) * K + gk : X, ok);
    }
  } else {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      sA[r * AS + c] = gm < M && gk < K ? X[static_cast<size_t>(gm) * K + gk]
                                        : __float2bfloat16_rn(0.0f);
    }
  }
  if constexpr (VB) {
#pragma unroll
    for (int i = tid; i < BK * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + c;
      const bool ok = gk < K && gn < N;
      cp_async16(sB + r * BS + c, ok ? W + static_cast<size_t>(gk) * N + gn : W, ok);
    }
  } else {
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      sB[r * BS + c] = gk < K && gn < N ? W[static_cast<size_t>(gk) * N + gn]
                                        : __float2bfloat16_rn(0.0f);
    }
  }
}

// The epilogue of one fp32 value v (the sum) with its bias b and residual r.
__device__ __forceinline__ float epilogue(float v, float b, float r, int epi) {
  if (epi == 3) return (v + b) + r;
  v = round_bf16(round_bf16(v) + b);
  if (epi == 1) return gelu_tanh_f(v);
  if (epi == 2) return gelu_erf_f(v);
  return v;
}

template <bool VA, bool VB>
__global__ __launch_bounds__(THREADS) void linear_kernel(
    const bf16* __restrict__ X, const bf16* __restrict__ W, const bf16* __restrict__ bias,
    const bf16* __restrict__ res, bf16* __restrict__ Y, int M, int N, int K, int epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + STAGES * A_STAGE;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_stage<VA, VB>(sA + s * A_STAGE, sB + s * B_STAGE, X, W, M, N, K, m0, n0, s * BK, tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt-1
    const int nk = kt + STAGES - 1;
    if (nk < KT) {
      const int s = nk % STAGES;
      load_stage<VA, VB>(sA + s * A_STAGE, sB + s * B_STAGE, X, W, M, N, K, m0, n0, nk * BK,
                         tid);
    }
    cp_async_commit();
    const bf16* a = sA + (kt % STAGES) * A_STAGE;
    const bf16* b = sB + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], a + (wm + i * 16) * AS + kk, AS);
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(fb[j], b + kk * BS + wn + j * 16, BS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // the pipeline buffers become the fp32 output tile
  float* sC = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(sC + (wm + i * 16) * CS + wn + j * 16, acc[i][j], CS,
                              wmma::mem_row_major);
  __syncthreads();

  if constexpr (VB) {
    for (int i = tid; i < BM * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int gm = m0 + r, gn = n0 + c;
      if (gm >= M || gn >= N) continue;  // N % 8 == 0: a vector is all in or all out
      float v[8], bv[8], rv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = sC[r * CS + c + e];
      unpack8(*reinterpret_cast<const uint4*>(bias + gn), bv);
      const size_t off = static_cast<size_t>(gm) * N + gn;
      if (epi == 3) unpack8(*reinterpret_cast<const uint4*>(res + off), rv);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = epilogue(v[e], bv[e], rv[e], epi);
      *reinterpret_cast<uint4*>(Y + off) = pack8(v);
    }
  } else {
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gm = m0 + r, gn = n0 + c;
      if (gm >= M || gn >= N) continue;
      const size_t off = static_cast<size_t>(gm) * N + gn;
      const float rv = epi == 3 ? __bfloat162float(res[off]) : 0.f;
      Y[off] = __float2bfloat16_rn(epilogue(sC[r * CS + c], __bfloat162float(bias[gn]), rv, epi));
    }
  }
}

template <bool VA, bool VB>
int launch(const void* x, const void* w, const void* bias, const void* res, void* y, int M,
           int N, int K, int epi, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        linear_kernel<VA, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  linear_kernel<VA, VB><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(res), static_cast<bf16*>(y), M, N, K, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int evt_linear(const void* x, const void* w, const void* bias, const void* res,
                          void* y, int M, int N, int K, int epi, void* stream) {
  if (M == 0 || N == 0) return 0;
  const bool va = K % 8 == 0 && aligned16(x);
  const bool vb = N % 8 == 0 && aligned16(w) && aligned16(bias) && aligned16(res) &&
                  aligned16(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (va && vb) return launch<true, true>(x, w, bias, res, y, M, N, K, epi, s);
  if (va) return launch<true, false>(x, w, bias, res, y, M, N, K, epi, s);
  if (vb) return launch<false, true>(x, w, bias, res, y, M, N, K, epi, s);
  return launch<false, false>(x, w, bias, res, y, M, N, K, epi, s);
}
