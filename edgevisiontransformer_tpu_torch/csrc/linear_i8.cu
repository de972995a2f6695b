// linear_i8: Y[M, N] = epilogue(dequant(Q[M, K] @ W[K, N])) with int8
// operands, int32 accumulation on the tensor cores, and the dequant and
// epilogue in fp32.
//
// Replaces: the four int8 matmuls of every layer inside the TPU int8
//   whole-encoder kernels, edgevisiontransformer_tpu/ops/pallas/
//   fused_encoder.py `_int8_mm` (:856-862), `_int8_mm_static` (:865-881)
//   and `_int8_mm_buf` (:1103-1110), as called by `_encoder_kernel_int8`
//   (K4, :926-951) and `_encoder_kernel_int8_pipelined` (K5, :1164-1180).
//   The dequant, with acc_f = f32(acc):
//     dynamic  (acc_f * s_row) * w_s     s_row from quant_rows, w_s per column
//     static   acc_f * cs                cs = w_s * act_scale, folded at prepare time
//   and the epilogues (b is fp32 in the int8 stacks, or bf16):
//     0 BIAS           bf16(deq + b)                        (qkv, :926-927)
//     1 BIAS_GELU      bf16(gelu_tanh(bf16(deq + b)))       (fc1, :944-946)
//     2   (exact GELU, erff)
//     3 BIAS_RESIDUAL  bf16(deq + b + res)                  (out, fc2, :935-951)
//   These round once where the bf16 linear's CAST_THEN_BIAS rounds twice.
//   __fmul_rn / __fadd_rn keep nvcc from contracting the chain into FMAs,
//   so the non-GELU epilogues equal the plain twin bit for bit.
//
// Bound on the card: at b1 (M = 197) the weights (K*N bytes, read once)
// and launch latency; at serving batches (M = 25,216) the int8 tensor cores
// (1,979 TOP/s dense).  Activations move as int8 in, bf16 out.
//
// Design: the bf16 linear's tiled GEMM with int8 WMMA 16x16x16 fragments
// (mma.sync .s8 on the tensor cores, int32 accumulators).  128x128 output
// tile per thread block, 8 warps each owning 32x64 as 2x4 fragments, K in
// steps of 64 through a 3-stage cp.async ring in shared memory (zero-filled
// past the ragged M, N and K edges).  An int8
// fragment pointer must be 32-byte aligned, which a 16-byte column offset
// inside a row-major tile is not, so shared memory holds each operand tile
// as 16-column panels (ldm = 16).  The epilogue stages the int32 tile in
// shared memory and writes 16-byte vectors.  Any K and N: where K (the rows
// of Q) or N (the rows of W, the scales, bias, residual and Y) is not a
// multiple of 16, as a pruned model's hidden width 230 is, or a pointer is
// off its 16-byte boundary, the host takes the element-wise form of that
// operand's loads (and of the epilogue, for N), which masks every element
// itself; the arithmetic is the same.  wgmma, TMA and fusing the
// quantization into the neighbouring kernels are later work.
#include <mma.h>

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
extern "C" int evt_linear_i8(const void* q, const void* s_row, const void* w, const void* w_s,
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
