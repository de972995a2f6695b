// LayerNorm of one row, one warp: ln_rows.cu launches one row a warp;
// vit_full.cu walks every row of its LayerNorm phases inside its persistent
// kernel, so ln_rows and the whole-model kernel round alike.
//
// Pointers carry no __restrict__ here: in vit_full.cu a row reads what other
// blocks wrote earlier in the same launch, which the non-coherent read-only
// cache path must not serve.
#pragma once

#include "common.cuh"

// ---------------------------------------------------------------------------
// LayerNorm of one row (one warp): fp32 mean, fp32 mean of squared
// deviations, rsqrt(var + eps) * g + b in fp32; `store(chunk, f)` receives
// each 8-value chunk.  g and b are fp32 (affine_f32) or bf16.  dim % 8 == 0.
// ---------------------------------------------------------------------------
template <class Store>
__device__ __forceinline__ void ln_row(const bf16* xr, const void* g, const void* b, int dim,
                                       float eps, int affine_f32, int lane, Store store) {
  const int chunks = dim / 8;
  float f[8];

  float sum = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += f[i];
  }
  const float mean = warp_sum(sum) / static_cast<float>(dim);

  float sq = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
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
    unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
    load8_either(g, c, affine_f32, gf);
    load8_either(b, c, affine_f32, bf);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = (f[i] - mean) * rs * gf[i] + bf[i];
    store(c, f);
  }
}
