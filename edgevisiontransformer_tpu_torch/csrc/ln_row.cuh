// LayerNorm of one row, one warp: ln_rows.cu launches one row a warp;
// vit_full.cu walks every row of its LayerNorm phases inside its persistent
// kernel, so ln_rows and the whole-model kernel round alike.  The row's
// steps (a lane's share of the two sums, the warp's statistics, the
// normalize-and-affine of one 8-value chunk) are helpers of their own:
// swin_merge.cu computes its merged rows' statistics and normalizes their
// chunks with the same helpers, so it compiles the same rounding and
// contraction and its values equal ln_rows' bit for bit.
//
// Pointers carry no __restrict__ here: in vit_full.cu a row reads what other
// blocks wrote earlier in the same launch, which the non-coherent read-only
// cache path must not serve.
#pragma once

#include "common.cuh"

// A lane's running sum of a chunk's values, in order.
__device__ __forceinline__ void ln_add_sum(float& sum, const float f[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) sum += f[i];
}

// A lane's running sum of a chunk's squared deviations from mean, in order.
__device__ __forceinline__ void ln_add_sq(float& sq, const float f[8], float mean) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float d = f[i] - mean;
    sq += d * d;
  }
}

// The warp's mean and rsqrt(var + eps) from its lanes' shares.
__device__ __forceinline__ float ln_mean(float sum, int dim) {
  return warp_sum(sum) / static_cast<float>(dim);
}

__device__ __forceinline__ float ln_rstd(float sq, int dim, float eps) {
  const float var = warp_sum(sq) / static_cast<float>(dim);
  return rsqrtf(var + eps);
}

// (f - mean) * rs * g + b in fp32, one chunk in place.
__device__ __forceinline__ void ln_affine(float f[8], float mean, float rs, const float g[8],
                                          const float b[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = (f[i] - mean) * rs * g[i] + b[i];
}

// ---------------------------------------------------------------------------
// LayerNorm of one row (one warp): fp32 mean, fp32 mean of squared
// deviations, rsqrt(var + eps) * g + b in fp32; `store(chunk, f)` receives
// each 8-value chunk.  xr holds T (bf16 or fp16), g and b are fp32
// (affine_f32) or T.  dim % 8 == 0.
// ---------------------------------------------------------------------------
template <class T, class Store>
__device__ __forceinline__ void ln_row(const T* xr, const void* g, const void* b, int dim,
                                       float eps, int affine_f32, int lane, Store store) {
  const int chunks = dim / 8;
  float f[8];

  float sum = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    unpack8<T>(*reinterpret_cast<const uint4*>(xr + c * 8), f);
    ln_add_sum(sum, f);
  }
  const float mean = ln_mean(sum, dim);

  float sq = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    unpack8<T>(*reinterpret_cast<const uint4*>(xr + c * 8), f);
    ln_add_sq(sq, f, mean);
  }
  const float rs = ln_rstd(sq, dim, eps);

  float gf[8], bf[8];
  for (int c = lane; c < chunks; c += 32) {
    unpack8<T>(*reinterpret_cast<const uint4*>(xr + c * 8), f);
    load8_either<T>(g, c, affine_f32, gf);
    load8_either<T>(b, c, affine_f32, bf);
    ln_affine(f, mean, rs, gf, bf);
    store(c, f);
  }
}
