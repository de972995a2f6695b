// linear: Y[M, N] = epilogue(X[M, K] @ W[K, N]) in bf16 or fp16 with fp32
// accumulation.
//
// Replaces: the four matmuls of every layer inside the TPU whole-encoder
//   kernels, edgevisiontransformer_tpu/ops/pallas/fused_encoder.py
//   `_encoder_kernel` (K1, :202-243: qkv, out-proj, fc1, fc2) and
//   `_encoder_kernel_pipelined` (K2, :661-686), with their epilogues:
//     0 CAST_THEN_BIAS          bf16(bf16(acc) + b)                  (:202-206)
//     1 CAST_THEN_BIAS_GELU     bf16(gelu_tanh(bf16(bf16(acc) + b))) (:231-235)
//     2   (exact GELU, erff)    bf16(gelu_erf(bf16(bf16(acc) + b)))
//     3 BIAS_RESIDUAL           bf16(acc + f32(b) + f32(res))        (:218-225, :236-243)
//     4 ROW_BIAS                bf16(acc + f32(res)), no b
//   The roundings are the reference's, because bf16 parity depends on them.
//   The fp16 instance (build.py's -DEVT_F16 compile) rounds to fp16 at the
//   same points and runs mma.sync's f16 form: the reference's math at
//   dtype = float16.
//   The Swin stage (K9, bf16) and the merge reduction (K10) run the same GEMM.
//
// Bound on the card: at b1 (M = 197) a layer's GEMMs do 2*M*K*N flops on
// K*N weights read once, ~200 flop/byte: below the H100's ~295 flop/byte
// balance point, so weight bytes, launch latency and the serial walk over K
// bound them.  At serving batches (M = 25,216 for deit_tiny b128) the
// activations dominate: one layer's four GEMMs move ~175 MB for 22 GFLOP,
// so bytes bound them (0.052 ms at 3.35 TB/s against 0.023 ms of tensor-core
// time at 989 TFLOP/s).
//
// Design (bench/linear_ab.py times its choices; PERF.md section 6 has the numbers).
// - The grid is the host's plan (ops/cuda/fused_encoder.py:linear_plan):
//   blocks of `rows` (128, 64, 32 or 16) by `cols` (32, 64, 96 or 128)
//   output elements.  Columns come in the fewest even tiles of at most 128;
//   at small M the columns narrow, then the rows, until the blocks are as
//   many as the SMs.  Wider tiles measured slower: their accumulators leave
//   one block an SM, which then waits out its own loads and epilogue.
// - Two warps across the columns, rows / 32 (or rows / 16 below 64 rows)
//   down the rows: a warp owns a rectangle of 32 (16) rows by cols / 2
//   columns, so each B fragment feeds two (one) row fragments and each A
//   fragment cols / 16 column fragments.  The launch bounds ask ptxas for as
//   many resident blocks as an estimate of the registers allows.
// - Products on mma.sync.m16n8k16 (bf16 in, fp32 accumulators), fed by
//   ldmatrix from tiles whose row stride is an odd multiple of 16 bytes: A
//   from the rows of X, B from the row-major W tile [BK, cols] by
//   ldmatrix.trans (as mlp.cu loads W1).
// - K in steps of 64 through a 3-stage cp.async ring, zero-filled past M, N
//   and K.  Every output element sums its K in k16 steps, in order, into one
//   fp32 accumulator: K is never split, so a row's output does not depend on
//   M or on the plan (bit for bit), and it matches WMMA 16x16x16, which runs
//   the same instruction in the same k order.
// - The epilogue runs from the accumulator registers: in the m16n8 layout a
//   thread holds two neighbouring columns of two rows; it reads the bias and
//   the residual as bf16x2 at those positions, and packs its two bf16
//   results into its warp's patch of the idle ring, which the warp writes
//   to Y as 16-byte vectors (a third less time than bf16x2 stores straight
//   to Y).  No fp32 tile goes through shared memory.  Each element's
//   residual is read by the thread that computes it, before its warp writes
//   its rows, so Y may be the residual itself (in place).
// - Any K and N: a pruned model's hidden width (int(0.3 * 768) = 230)
//   leaves the rows of X (K) or of W, the bias, the residual and Y (N) off
//   16-byte boundaries.  The host picks, per operand, the 16-byte path
//   (cp.async; bf16x2 and the patch in the epilogue) where the width is a
//   multiple of 8 and the pointers are 16-byte aligned, and otherwise an
//   element-wise path that masks every element against M, N and K itself;
//   the arithmetic is the same.
// - The tile is in linear_tile.cuh; this file and linear_rows{64,32,16}.cu
//   each compile one row count, so the 16 block shapes build side by side.
// - Split-K, clusters, wgmma, TMA and a persistent schedule are later work.
//   The tile is a __device__ routine (gemm_tile): vit_full.cu runs it for
//   every GEMM tile of its persistent kernel, so the whole-model forward
//   takes the same bits.
#include "linear_tile.cuh"


namespace EVT_INSTANCE {

int linear_rows128(EVT_LINEAR_ARGS) {
  return launch_cols<4, 32>(x, w, bias, res, y, M, N, K, epi, cols, va, vb, s);
}

}  // namespace EVT_INSTANCE

// x [M, K], w [K, N], bias [N] (unread by ROW_BIAS), res [M, N] (read by
// epilogues 3 and 4; may be y), y [M, N], all bf16 (fp16 in the fp16
// instance) at any alignment.  The
// plan (ops/cuda/fused_encoder.py:linear_plan): `rows` per block (128, 64,
// 32 or 16) by `cols` (32, 64, 96 or 128).
extern "C" int EVT_EXPORT(evt_linear)(const void* x, const void* w, const void* bias,
                                      const void* res, void* y, int M, int N, int K, int epi,
                                      int rows, int cols, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K < 0 || epi < 0 || epi > ROW_BIAS) return static_cast<int>(cudaErrorInvalidValue);
  const bool va = K % 8 == 0 && aligned16(x);
  const bool vb = N % 8 == 0 && aligned16(w) && aligned16(bias) && aligned16(res) &&
                  aligned16(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 128: return linear_rows128(x, w, bias, res, y, M, N, K, epi, cols, va, vb, s);
    case 64: return linear_rows64(x, w, bias, res, y, M, N, K, epi, cols, va, vb, s);
    case 32: return linear_rows32(x, w, bias, res, y, M, N, K, epi, cols, va, vb, s);
    case 16: return linear_rows16(x, w, bias, res, y, M, N, K, epi, cols, va, vb, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
