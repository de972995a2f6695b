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
// wgmma, TMA and a persistent schedule are later work.  The tile itself is
// gemm::tile (encoder_tiles.cuh), which vit_full.cu runs too.
#include "encoder_tiles.cuh"

namespace {

using namespace gemm;

template <bool VA, bool VB>
__global__ __launch_bounds__(THREADS) void linear_kernel(
    const bf16* __restrict__ X, const bf16* __restrict__ W, const bf16* __restrict__ bias,
    const bf16* __restrict__ res, bf16* __restrict__ Y, int M, int N, int K, int epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  tile<VB>(smem, RowsA<VA>{X}, W, bias, res, Y, M, N, K, epi, M, blockIdx.y * BM,
           blockIdx.x * BN);
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
