// swin_merge: the gather and LayerNorm of Swin patch merging, on token-major
// rows in image raster order.
//
// Replaces: the gather and LayerNorm of `_merge_kernel` (K10, :73-97) in
//   edgevisiontransformer_tpu/ops/pallas/swin_merge.py, `swin_merge_forward`
//   (:100-155).  K10 gathers with a banded one-hot matmul on window-major
//   tokens; its reduction matmul runs here as `linear` with a zero bias
//   (CAST_THEN_BIAS, exactly K10's bf16(acc)).
//
// Input x is [b * res * res, C] bf16; output is [b * (res/2)^2, 4C] bf16
// (fp16 in and out in the fp16 instance).
// Output token (y', x') concatenates the input rows (2y'+dy, 2x'+dx) in the
// order (0,0), (0,1), (1,0), (1,1) (the prepared (dy, dx, c) feature order,
// K10's group g = 2 dy + dx), then takes the LayerNorm over the 4C values
// with fp32 statistics in two passes (mean, then the mean of squared
// deviations), rsqrt(var + eps) * g + b in fp32 and one cast to bf16.  The
// affine g, b is bf16 or fp32 (affine_f32).
//
// Bound on the card: device-memory bytes.  Each input value is read once
// and each output value written once (2 + 2 bytes per element) for ~10
// flops, far below the H100's ~295 flop/byte balance point: swin_tiny's
// first merge at b1 moves 1.2 MB, ~0.4 us at 3.35 TB/s.
//
// Design: one warp per output token, 16-byte vector loads.  Chunk c of 8
// values lies in group c / (C/8) at offset (c % (C/8)) * 8 of that group's
// source row, so the gather is address arithmetic and no permutation is
// stored or multiplied.  The second and third passes re-read the four rows,
// which stay in L1.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

// Chunk c of the output token whose (0,0) source row is x00: group
// q = c / per_row reads row (dy, dx) = (q >> 1, q & 1) of the 2x2 block.
template <class T>
__device__ __forceinline__ const T* chunk_ptr(const T* x00, int c, int per_row, int res, int C) {
  const int q = c / per_row;
  return x00 + (static_cast<size_t>(q >> 1) * res + (q & 1)) * C + (c - q * per_row) * 8;
}

template <class T>
__global__ __launch_bounds__(kWarps * 32) void swin_merge_kernel(
    const T* __restrict__ x, const void* __restrict__ g, const void* __restrict__ b,
    T* __restrict__ y, int tokens_out, int res, int C, float eps, int affine_f32) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= tokens_out) return;
  const int ho = res / 2;
  const int img = t / (ho * ho), yo = (t / ho) % ho, xo = t % ho;
  const T* x00 = x + ((static_cast<size_t>(img) * res + 2 * yo) * res + 2 * xo) * C;
  const int per_row = C / 8, chunks = 4 * per_row, dim = 4 * C;
  T* yr = y + static_cast<size_t>(t) * dim;
  float f[8];

  float sum = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    unpack8<T>(*reinterpret_cast<const uint4*>(chunk_ptr(x00, c, per_row, res, C)), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += f[i];
  }
  const float mean = warp_sum(sum) / static_cast<float>(dim);

  float sq = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    unpack8<T>(*reinterpret_cast<const uint4*>(chunk_ptr(x00, c, per_row, res, C)), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = f[i] - mean;
      sq += d * d;
    }
  }
  const float var = warp_sum(sq) / static_cast<float>(dim);
  const float rs = rsqrtf(var + eps);

  float gf[8], bf[8];
  for (int c = lane; c < chunks; c += 32) {
    unpack8<T>(*reinterpret_cast<const uint4*>(chunk_ptr(x00, c, per_row, res, C)), f);
    load8_either<T>(g, c, affine_f32, gf);
    load8_either<T>(b, c, affine_f32, bf);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = (f[i] - mean) * rs * gf[i] + bf[i];
    *reinterpret_cast<uint4*>(yr + c * 8) = pack8<T>(f);
  }
}

}  // namespace

extern "C" int EVT_EXPORT(evt_swin_merge)(const void* x, const void* g, const void* b, void* y,
                                          int batch, int res, int C, float eps, int affine_f32,
                                          void* stream) {
  if (batch == 0) return 0;
  if (res % 2 != 0 || C % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tokens_out = batch * (res / 2) * (res / 2);
  const dim3 grid((tokens_out + kWarps - 1) / kWarps);
  swin_merge_kernel<elem><<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const elem*>(x), g, b, static_cast<elem*>(y), tokens_out, res, C, eps,
      affine_f32);
  return static_cast<int>(cudaGetLastError());
}
