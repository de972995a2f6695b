// Shared device helpers for the encoder kernels (ln_rows.cu, linear.cu,
// attention_rows.cu).  Plain CUDA C++ for sm_90a; no PyTorch headers, so the
// library builds in seconds and binds through a C interface (ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// 8 bf16 values <-> one 16-byte vector.
__device__ __forceinline__ void unpack8(const uint4 v, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float f[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// Round an fp32 value to bf16 and back (a cast point of the reference).
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16-byte asynchronous copy global -> shared; pred == false writes zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// GELU in fp32, the formulas of the reference (jax.nn.gelu's tanh form; the
// exact form with the true erf).
__device__ __forceinline__ float gelu_tanh_f(float x) {
  return x * (0.5f * (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x)))));
}

__device__ __forceinline__ float gelu_erf_f(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}
