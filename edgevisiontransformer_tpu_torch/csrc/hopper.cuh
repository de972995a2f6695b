// Hopper's asynchronous machinery, shared by mlp_wide.cu and sdpa_long.cu:
// shared-memory addresses, wgmma descriptors of the 128-byte-swizzled layout,
// mbarrier slots, TMA boxes (loads counted on an mbarrier, stores in a bulk
// group) and the host's tensor maps (cuTensorMapEncodeTiled, fetched through
// cudaGetDriverEntryPoint: the library links no libcuda).
//
// The 128-byte swizzle: a tile is a column of 128-byte rows (64 16-bit
// values), 16-byte chunk c of row r at chunk c ^ (r % 8), each 8-row group
// 1,024 bytes; a TMA box of 64 x rows lands in that layout, and a wgmma
// descriptor names it (layout type 1).  A tile's base is 1,024-byte aligned
// (the swizzle's period): ring_base() aligns the dynamic shared memory.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// A wgmma shared-memory descriptor: 128-byte swizzle, the start address and
// the leading / stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | (1ull << 62);
}

// The dynamic shared memory, aligned to the swizzle's period (a kernel
// asks for 1,024 bytes more than it uses).
__device__ __forceinline__ unsigned char* ring_base() {
  extern __shared__ unsigned char smem_raw[];
  return smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}

// Wait for the phase of parity `parity` to complete; a wait that never ends
// traps (a launch error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1u << 26)) __trap();
  }
}

// One 64 x 64 box of a 2-D tensor map at (column c, row r) into `dst`, its
// bytes counted on `bar`; zeros past the tensor's edges.
__device__ __forceinline__ void tma_box(unsigned char* dst, const CUtensorMap* map, int c, int r,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)), "l"(map), "r"(c), "r"(r),
      "r"(smem_u32(bar)) : "memory");
}

// One box of a 4-D tensor map at coordinates (c0, c1, c2, c3) into `dst`,
// its bytes counted on `bar`; zeros past the tensor's extents.
__device__ __forceinline__ void tma_box4(unsigned char* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)), "l"(map), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(smem_u32(bar)) : "memory");
}

// One box of `src` to a 4-D tensor map at (c0, c1, c2, c3), in the calling
// thread's bulk group; what lies past the tensor's extents is not written.
// The threads that wrote `src` run fence.proxy.async.shared::cta first.
__device__ __forceinline__ void tma_store4(const CUtensorMap* map, const unsigned char* src, int c0,
                                           int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n"
      ::"l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(src)) : "memory");
}

// The thread's bulk stores issued so far have read their shared memory.
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

inline PFN_cuTensorMapEncodeTiled encoder() {
  static PFN_cuTensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(ptr);
  }
  return fn;
}

template <class T>
struct TmaType;

template <>
struct TmaType<bf16> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

template <>
struct TmaType<f16> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

// A tensor map of T's values of `rank` dimensions: `dims` innermost first
// (the innermost contiguous), `strides` the byte strides of dimensions 1 ..
// rank - 1, `box` the box's extents (its innermost 128 bytes at most), the
// 128-byte swizzle, zeros outside the extents; false if
// cuTensorMapEncodeTiled is missing or refuses it.
template <class T>
bool make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  const PFN_cuTensorMapEncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  return enc(map, TmaType<T>::value, rank, const_cast<void*>(base), dims, strides, box,
             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}
