// Shared device helpers for the kernels (ln_rows.cu, linear.cu,
// attention_rows.cu, quant_rows.cu, linear_i8.cu, t2t_stage1.cu,
// window_attention.cu, swin_merge.cu, window_sdpa.cu, sdpa.cu, mlp.cu,
// vit_full.cu, performer.cu; the encoder's tiles are in encoder_tiles.cuh,
// the mma.sync / ldmatrix tiles of sdpa.cu, mlp.cu, linear.cu and
// attention_rows.cu in mma_tiles.cuh, the attention routines that sdpa.cu,
// attention_rows.cu and window_sdpa.cu share in attn_tiles.cuh).
// Plain CUDA C++ for sm_90a; no PyTorch headers, so the library builds in
// seconds and binds through a C interface (ctypes).
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

// 8 consecutive values of a vector that is fp32 (f32 != 0) or bf16, from
// element 8 * chunk on: an LN affine or a bias, which the int8 stacks keep
// in fp32.  The address must be 16-byte aligned.
__device__ __forceinline__ void load8_either(const void* p, int chunk, int f32, float f[8]) {
  if (f32) {
    const float4* v = reinterpret_cast<const float4*>(static_cast<const float*>(p) + chunk * 8);
    const float4 a = v[0], b = v[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
    unpack8(*reinterpret_cast<const uint4*>(static_cast<const bf16*>(p) + chunk * 8), f);
  }
}

// A pointer on a 16-byte boundary (null counts as one): the kernels take
// their 16-byte vector paths only then.
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Round an fp32 value to bf16 and back (a cast point of the reference).
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
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
