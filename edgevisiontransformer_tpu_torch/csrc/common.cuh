// Shared device helpers for the kernels (ln_rows.cu, linear.cu,
// attention_rows.cu, quant_rows.cu, linear_i8.cu, t2t_stage1.cu,
// window_attention.cu, swin_merge.cu, window_sdpa.cu, sdpa.cu, mlp.cu,
// vit_full.cu, performer.cu; the LayerNorm row is in ln_row.cuh, the
// mma.sync / ldmatrix tiles of sdpa.cu, mlp.cu, linear.cu, attention_rows.cu
// and linear_i8.cu in mma_tiles.cuh, the attention routines that sdpa.cu,
// attention_rows.cu and window_sdpa.cu share in attn_tiles.cuh, the GEMM
// tile and the attention strip that vit_full.cu shares with linear.cu and
// attention_rows.cu in linear_tile.cuh and attention_strip.cuh).
// Plain CUDA C++ for sm_90a; no PyTorch headers, so the library builds in
// seconds and binds through a C interface (ctypes).
//
// The element type.  Activations and weights are bf16 or fp16; the tile
// headers and kernels take the type as a template parameter T, and Elem<T>
// carries what depends on it: the 2-wide pack and unpack, the conversions
// to and from fp32 (by the intrinsics, round to nearest even) and the
// mma.sync instruction (mma_tiles.cuh).  ops/cuda/build.py compiles every
// source twice: as it is, which instantiates the kernels at bf16 and exports
// its entry points under their names, and with -DEVT_F16, which
// instantiates them at fp16 and exports each entry point with an _f16
// suffix (EVT_EXPORT), so that each instance is a translation unit of its
// own and the two build side by side.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
typedef __half f16;

template <class T>
struct Elem;

// row_max: whether the attention kernels take softmax_unnorm's row-max
// branch (JAX ops/pallas/common.py): fp16, whose range 2^CLAMP overflows, does.
template <>
struct Elem<bf16> {
  typedef __nv_bfloat162 x2;
  static constexpr bool row_max = false;
  static __device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ bf16 from_float(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ float2 to_float2(x2 v) { return __bfloat1622float2(v); }
  static __device__ __forceinline__ x2 from_floats(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
};

template <>
struct Elem<f16> {
  typedef __half2 x2;
  static constexpr bool row_max = true;
  static __device__ __forceinline__ float to_float(f16 v) { return __half2float(v); }
  static __device__ __forceinline__ f16 from_float(float v) { return __float2half_rn(v); }
  static __device__ __forceinline__ float2 to_float2(x2 v) { return __half22float2(v); }
  static __device__ __forceinline__ x2 from_floats(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
};

// T where it must not take part in deducing a template's T (a parameter
// that may be passed nullptr).
template <class T>
struct Same {
  typedef T type;
};

// The instance this translation unit exports (see above), and the namespace
// of the C++ functions it shares with the other sources of its instance.
#ifdef EVT_F16
typedef f16 elem;
#define EVT_EXPORT(name) name##_f16
#define EVT_INSTANCE evt_f16
#else
typedef bf16 elem;
#define EVT_EXPORT(name) name
#define EVT_INSTANCE evt_bf16
#endif

// 8 values of T <-> one 16-byte vector.  T defaults to bf16 here and in
// load8_either, and round_bf16 keeps its name, for the bf16-only sources
// under bench/; the kernels of this directory name their T.
template <class T = bf16>
__device__ __forceinline__ void unpack8(const uint4 v, float f[8]) {
  const typename Elem<T>::x2* h = reinterpret_cast<const typename Elem<T>::x2*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = Elem<T>::to_float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <class T = bf16>
__device__ __forceinline__ uint4 pack8(const float f[8]) {
  uint4 v;
  typename Elem<T>::x2* h = reinterpret_cast<typename Elem<T>::x2*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = Elem<T>::from_floats(f[2 * i], f[2 * i + 1]);
  return v;
}

// Two fp32 values of T, as one 32-bit load.
template <class T>
__device__ __forceinline__ float2 load_x2(const T* p) {
  return Elem<T>::to_float2(*reinterpret_cast<const typename Elem<T>::x2*>(p));
}

// 8 consecutive values of a vector that is fp32 (f32 != 0) or T, from
// element 8 * chunk on: an LN affine or a bias, which the int8 stacks keep
// in fp32.  The address must be 16-byte aligned.
template <class T = bf16>
__device__ __forceinline__ void load8_either(const void* p, int chunk, int f32, float f[8]) {
  if (f32) {
    const float4* v = reinterpret_cast<const float4*>(static_cast<const float*>(p) + chunk * 8);
    const float4 a = v[0], b = v[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
    unpack8<T>(*reinterpret_cast<const uint4*>(static_cast<const T*>(p) + chunk * 8), f);
  }
}

// A pointer on a 16-byte boundary (null counts as one): the kernels take
// their 16-byte vector paths only then.
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Round an fp32 value to T and back (a cast point of the reference).
template <class T>
__device__ __forceinline__ float round_to(float x) {
  return Elem<T>::to_float(Elem<T>::from_float(x));
}

__device__ __forceinline__ float round_bf16(float x) { return round_to<bf16>(x); }

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
