// Warp-level tensor-core tiles shared by sdpa.cu, mlp.cu, linear.cu,
// attention_rows.cu (through attn_tiles.cuh) and linear_i8.cu:
// ldmatrix loads of 16-bit fragments from shared memory (int8 pairs, for
// linear_i8), the mma.sync.m16n8k16 product of bf16 or fp16 operands with
// fp32 accumulators (mma16<T>), its int8 form m16n8k32 with int32
// accumulators, and the packing of two fp32 accumulators into one x2
// register of T (pack2<T>; in the m16n8 layout, two neighbouring n8
// accumulator tiles packed this way are the A fragment of one k16 step of
// the next product).  ldmatrix and cp.async move 16-bit values whatever
// they are.
#pragma once

#include "common.cuh"

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 accumulators: the
// exact sum, in the accumulator layout of mma_bf16 (rows g and g + 8,
// columns 2t and 2t + 1).  Thread (g, t) holds bytes k = 4t..4t+3 (a[0],
// a[1]: rows g, g + 8) and 16 + 4t.. (a[2], a[3]) of A, and of B's column g
// bytes k = 4t.. (b0) and 16 + 4t.. (b1).
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16 x 16, row) * b (16 x 8, col), fp16 in, fp32 accumulators.
__device__ __forceinline__ void mma_f16(float c[4], const uint32_t a[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The product of T's operands: mma_bf16 or mma_f16.
template <class T>
__device__ __forceinline__ void mma16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma16<bf16>(float c[4], const uint32_t a[4], uint32_t b0,
                                            uint32_t b1) {
  mma_bf16(c, a, b0, b1);
}

template <>
__device__ __forceinline__ void mma16<f16>(float c[4], const uint32_t a[4], uint32_t b0,
                                           uint32_t b1) {
  mma_f16(c, a, b0, b1);
}

// Two fp32 values rounded to T, in one register (lo in the low half).
template <class T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  typename Elem<T>::x2 h = Elem<T>::from_floats(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The bf16 forms by their old names, for the bf16-only sources under bench/.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return pack2<bf16>(lo, hi);
}
