// ln_rows: LayerNorm of each row of a [rows, dim] bf16 or fp16 matrix.
//
// Replaces: the LayerNorm inside the TPU whole-encoder kernels,
//   edgevisiontransformer_tpu/ops/pallas/fused_encoder.py `_ln` (:54-62), as
//   called by `_encoder_kernel` (K1, encoder_forward) and
//   `_encoder_kernel_pipelined` (K2, encoder_forward_pipelined), and by the
//   int8 kernels K4 / K5 (`_encoder_kernel_int8[_pipelined]`), whose stacks
//   keep the affine g, b in fp32: they are read as bf16 or fp32 (affine_f32).
//
// Bound on the card: device-memory bytes.  Per row it reads dim 16-bit values
// and writes dim (2 + 2 bytes per element) and does ~10 flops per element, far
// below the H100's ~295 flop/byte balance point, so the floor is
// rows * dim * 4 bytes / 3.35 TB/s (deit_tiny b128: 25,216 x 192 -> 19 MB,
// ~6 us).
//
// Design: one warp per row, 16-byte vector loads, fp32 statistics in two
// passes exactly as the reference does (mean, then the mean of squared
// deviations), then rsqrt(var + eps) * g + b in fp32 and one cast to bf16 or fp16.
// The second and third passes re-read the row, which stays in L1.  The row
// itself is ln_row (ln_row.cuh), which vit_full.cu runs too.
#include "ln_row.cuh"

namespace {

constexpr int kWarps = 8;

template <class T>
__global__ __launch_bounds__(kWarps * 32) void ln_rows_kernel(
    const T* __restrict__ x, const void* __restrict__ g, const void* __restrict__ b,
    T* __restrict__ y, int rows, int dim, float eps, int affine_f32) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  T* yr = y + static_cast<size_t>(row) * dim;
  ln_row(x + static_cast<size_t>(row) * dim, g, b, dim, eps, affine_f32, lane,
         [yr](int c, const float f[8]) { *reinterpret_cast<uint4*>(yr + c * 8) = pack8<T>(f); });
}

}  // namespace

// x, y [rows, dim] of the instance's type; g, b [dim] of it or fp32.
extern "C" int EVT_EXPORT(evt_ln_rows)(const void* x, const void* g, const void* b, void* y,
                                       int rows, int dim, float eps, int affine_f32,
                                       void* stream) {
  if (rows == 0) return 0;
  const dim3 grid((rows + kWarps - 1) / kWarps);
  ln_rows_kernel<elem><<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const elem*>(x), g, b, static_cast<elem*>(y), rows, dim, eps, affine_f32);
  return static_cast<int>(cudaGetLastError());
}

#ifndef EVT_F16
extern "C" const char* evt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif
