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
//   The fp16 instance (build.py's -DEVT_F16 compile) writes fp16 at the same
//   points; the int32 product is the same.
//   __fmul_rn / __fadd_rn keep nvcc from contracting the chain into FMAs,
//   so the non-GELU epilogues equal the plain twin bit for bit.
//
// Bound on the card: at b1 (M = 197) the weights (K*N bytes, read once)
// and launch latency; at serving batches (M = 25,216) the activations'
// bytes (int8 in, bf16 out: 0.042 ms a deit_tiny b128 layer at 3.35 TB/s,
// against 0.011 ms of int8 tensor-core time at 1,979 TOP/s).
//
// Design (bench/linear_i8_ab.py times its choices; PERF.md section 6 has the
// numbers).  The tile is csrc/linear.cu's, in int8:
// - The grid is the host's plan (ops/cuda/fused_encoder.py:linear_i8_plan):
//   blocks of `rows` (128, 64, 32 or 16) by `cols` (32, 64, 96 or 128)
//   output elements, two warps across the columns, and at small M a split
//   of K's steps over a cluster of up to 8 blocks: each walks a contiguous
//   share, and rank 0 adds the others' int32 partials from their shared
//   memory before its epilogue.  int32 sums are exact in any order, so a
//   row's output depends on neither M, the plan nor the split, and equals
//   the WMMA kernel this replaced bit for bit.
// - Products on mma.sync.m16n8k32 (int8 in, int32 accumulators).  K in
//   steps of 128 bytes through a 3-stage cp.async ring, zero-filled past M,
//   N and K; a k32 step wholly past K is skipped (K = 192 is 1.5 steps).
// - A fragments by ldmatrix from the row-major Q tile (144-byte rows, an odd
//   multiple of 16 bytes: no bank conflicts), reading int8 pairs as b16.
// - B needs K contiguous per column, and W lies k-major ([K, N]); sm_90 has
//   no 8-bit ldmatrix.trans.  The W tile stays as cp.async lands it, and
//   ldmatrix.trans of b16 (column pairs) from rows chosen per lane hands
//   each thread two k-pairs of two columns; two byte permutes per matrix
//   pair (frag_b) gather four consecutive k of each column.  So the
//   transpose costs no pass, no barrier and no copy of W, and the interface
//   and the int8 stacks stay as they were.  One frag_b covers 16 columns as
//   two n8 tiles, the even and the odd columns, so each thread ends with 4
//   consecutive columns of each of its rows.
// - The dequant and epilogue run from the accumulator registers: w_s and
//   the bias read as 4-wide vectors, s_row once per row; each thread's four
//   bf16 results of a row go to Y as one 8-byte store, the four threads of
//   the row filling a 32-byte sector (faster than packing them into a warp
//   patch of the idle ring for 16-byte stores, which needs a barrier).  No
//   int32 tile goes through shared memory.  Each element's residual is read
//   by the thread that writes it, so Y may be the residual itself.
// - Any K and N: where K (the rows of Q) or N (the rows of W, the scales,
//   bias, residual and Y) is not a multiple of 16, as a pruned model's
//   hidden width 230 is, or a pointer is off its 16-byte boundary, the host
//   takes the element-wise form of that operand's loads (and of the
//   epilogue, for N), which masks every element itself; the arithmetic is
//   the same.
// - The tile is in linear_i8_tile.cuh; this file and i8_rows{64,32,16}.cu
//   each compile one row count, so the 16 block shapes build side by side.
// - wgmma, TMA and fusing the static quantization into the A loads are
//   later work.
#include "linear_i8_tile.cuh"

namespace EVT_INSTANCE {

int linear_i8_rows128(EVT_LINEAR_I8_ARGS) {
  return launch_cols<4, 32>(q, s_row, w, w_s, bias, res, y, M, N, K, epi, bias_f32, cols,
                            split, va, vb, s);
}

}  // namespace EVT_INSTANCE

// q [M, K] int8, s_row [M] fp32 (dynamic) or null (static: w_s holds the
// combined scale), w [K, N] int8, w_s [N] fp32, bias [N] fp32 (bias_f32) or
// bf16, res [M, N] bf16 (read by epilogue 3; may be y), y [M, N] bf16 (fp16
// for bias, res and y in the fp16 instance), all at any alignment.  The plan
// (ops/cuda/fused_encoder.py:linear_i8_plan): `rows` per block (128, 64, 32
// or 16) by `cols` (32, 64, 96 or 128), and `split`, the blocks of a cluster
// that share the K steps (1..8).
extern "C" int EVT_EXPORT(evt_linear_i8)(const void* q, const void* s_row, const void* w,
                                         const void* w_s, const void* bias, const void* res,
                                         void* y, int M, int N, int K, int epi, int bias_f32,
                                         int rows, int cols, int split, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K < 0 || epi < 0 || epi > 3 || split < 1 || split > MAX_SPLIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool va = K % 16 == 0 && aligned16(q);
  const bool vb = N % 16 == 0 && aligned16(w) && aligned16(w_s) && aligned16(bias) &&
                  aligned16(res) && aligned16(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = bias_f32 != 0;
  switch (rows) {
    case 128: return linear_i8_rows128(q, s_row, w, w_s, bias, res, y, M, N, K, epi, f32, cols,
                                       split, va, vb, s);
    case 64: return linear_i8_rows64(q, s_row, w, w_s, bias, res, y, M, N, K, epi, f32, cols,
                                     split, va, vb, s);
    case 32: return linear_i8_rows32(q, s_row, w, w_s, bias, res, y, M, N, K, epi, f32, cols,
                                     split, va, vb, s);
    case 16: return linear_i8_rows16(q, s_row, w, w_s, bias, res, y, M, N, K, epi, f32, cols,
                                     split, va, vb, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
