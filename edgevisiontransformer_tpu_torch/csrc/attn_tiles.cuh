// Warp-level attention routines shared by sdpa.cu (K13), attention_rows.cu
// (K1's attention), window_sdpa.cu (K12) and window_attention.cu (K9's
// attention): one warp owns 16 query rows, its scores live in
// mma.sync.m16n8k16 accumulator registers, and K and V arrive in shared
// memory by cp.async (window_attention.cu gathers and scatters its rows
// through a table of source rows: load_rows_gather, store_rows_scatter;
// both window kernels stage a bias tile with load_tile).
//
// Every routine takes the element type T (bf16 or fp16) of its operands as
// a template parameter, deduced from its pointers.
//
// Shared-memory tiles hold rows of HD 16-bit values at a row stride of
// row_ld(HD) = HD + 8 elements: the 16-byte skew spreads the eight rows of an
// ldmatrix over all 32 banks.  Q's A fragments come from its rows, S = Q K^T's
// B fragments from K's rows (ldmatrix), O = P V's from V's rows
// (ldmatrix.trans).
//
// Score layout: s[c][j] is the m16n8 accumulator of keys 16c + 8j .. + 7.
// Thread (g = lane / 4, t = lane % 4) holds rows g (s[.][.][0..1]) and g + 8
// ([2..3]), keys 2t and 2t + 1 of each n8 tile, so a score row lives in the 4
// lanes of a quad (quad_sum and quad_max reduce it), and the accumulators of two
// neighbouring n8 tiles, packed to x2 pairs of T, are the A fragment of one k16 step
// of PV (FlashAttention-2's register reuse): P never goes to shared memory.
#pragma once

#include "common.cuh"
#include "mma_tiles.cuh"

__host__ __device__ constexpr int row_ld(int hd) { return hd + 8; }

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Rows [r0, r0 + rows) of one (image, head) of a [.., n, HD] operand into
// shared memory by cp.async from the NT threads of a block, zeros past token
// n (not waited for).  PAD: the operand's rows are cols (a multiple of 8
// below HD) wide, and columns [cols, HD) are zero-filled: an instance of HD
// serves a narrower head_dim, whose zero columns add nothing to Q K^T.
template <int HD, int NT, bool PAD = false, class T>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
                                          long long stride_n, int r0, int rows, int n, int tid,
                                          int cols = HD) {
  constexpr int CH = HD / 8;
  for (int i = tid; i < rows * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const int t = r0 + r;
    const bool ok = t < n && (!PAD || c < cols);
    cp_async16(dst + r * row_ld(HD) + c, ok ? src + t * stride_n + c : src, ok);
  }
}

// Rows [0, rows) of a gathered operand into shared memory by cp.async from
// the NT threads of a block: row r from src + off[r] * stride_n, zeros from
// row n on, where off is not read (not waited for).
template <int HD, int NT, class T>
__device__ __forceinline__ void load_rows_gather(T* dst, const T* __restrict__ src,
                                                 const int* off, long long stride_n, int rows,
                                                 int n, int tid) {
  constexpr int CH = HD / 8;
  for (int i = tid; i < rows * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r < n;
    cp_async16(dst + r * row_ld(HD) + c, ok ? src + off[r] * stride_n + c : src, ok);
  }
}

// Elements of T that a staged n x n tile takes: its n * n values from the
// 16-byte boundary at or below its start, in whole 16-byte chunks.
template <typename T>
__host__ __device__ constexpr int tile_elems(int n) {
  constexpr int V = 16 / sizeof(T);
  return (V - 1 + n * n + V - 1) / V * V;
}

// 16-byte cp.async of which only the first `bytes` (0-16) are read, the
// rest zero-filled.
__device__ __forceinline__ void cp_async_bytes(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

// The n x n tile that starts at element e0 of src (a bias or mask whose
// rows have the odd length n) into dst by cp.async from the NT threads of a
// block, as one flat run of 16-byte chunks (not waited for): element (q, c)
// lands at dst[e0 % V + q * n + c], V = 16 / sizeof(T).
template <typename T, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, long long e0, int n,
                                          int tid) {
  constexpr int V = 16 / sizeof(T);
  const long long a0 = e0 - e0 % V, end = e0 + static_cast<long long>(n) * n;
  for (int i = tid; i < tile_elems<T>(n) / V; i += NT) {
    const long long from = a0 + static_cast<long long>(i) * V;
    const long long left = end - from;
    const int bytes = left >= V ? 16 : (left > 0 ? static_cast<int>(left * sizeof(T)) : 0);
    cp_async_bytes(dst + i * V, bytes > 0 ? src + from : src, bytes);
  }
}

// Scores of the warp's 16 query rows (sQw) against NC 16-key chunks of sK,
// in the layout above.
template <int HD, int NC, class T>
__device__ __forceinline__ void qk(float (&s)[NC][2][4], const T* sQw, const T* sK, int lane) {
  constexpr int LD = row_ld(HD);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) s[c][e / 4][e % 4] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, sQw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      uint32_t b[4];
      ldsm_x4(b, sK + (c * 16 + ((lane >> 4) << 3) + (lane & 7)) * LD + kk * 16 +
                     ((lane >> 3) & 1) * 8);
      mma16<T>(s[c][0], a, b[0], b[1]);
      mma16<T>(s[c][1], a, b[2], b[3]);
    }
  }
}

// O += T(P) V over NC 16-key chunks of sV, P in the score registers (two
// n8 accumulators = one k16 A fragment).
template <int HD, int NC, class T>
__device__ __forceinline__ void pv(float (&o)[HD / 8][4], const float (&p)[NC][2][4],
                                   const T* sV, int lane) {
  constexpr int LD = row_ld(HD);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const uint32_t a[4] = {pack2<T>(p[c][0][0], p[c][0][1]), pack2<T>(p[c][0][2], p[c][0][3]),
                           pack2<T>(p[c][1][0], p[c][1][1]), pack2<T>(p[c][1][2], p[c][1][3])};
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, sV + (c * 16 + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8);
      mma16<T>(o[2 * dp], a, b[0], b[1]);
      mma16<T>(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// T(O) through the warp's own 16 rows of the Q tile to out, 16-byte
// stores, rows past n dropped (with PAD, columns from cols on too: see
// load_rows).
template <int HD, bool PAD = false, class T>
__device__ __forceinline__ void store_rows(const float (&o)[HD / 8][4], T* sQw,
                                           T* __restrict__ op, long long stride_n, int row0,
                                           int n, int lane, int cols = HD) {
  constexpr int LD = row_ld(HD), CH = HD / 8;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<uint32_t*>(sQw + g * LD + j * 8 + 2 * t) = pack2<T>(o[j][0], o[j][1]);
    *reinterpret_cast<uint32_t*>(sQw + (g + 8) * LD + j * 8 + 2 * t) =
        pack2<T>(o[j][2], o[j][3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    if (row0 + r < n && (!PAD || c < cols))
      *reinterpret_cast<uint4*>(op + (row0 + r) * stride_n + c) =
          *reinterpret_cast<const uint4*>(sQw + r * LD + c);
  }
}

// T(O * inv) through the warp's own 16 rows of the Q tile to out: inv[0]
// scales row g and inv[1] row g + 8 (one fp32 product an element), and the
// strip's row r goes to op + off[row0 + r] * stride_n, as 16-byte stores,
// rows past n dropped.
template <int HD, class T>
__device__ __forceinline__ void store_rows_scatter(const float (&o)[HD / 8][4],
                                                   const float (&inv)[2], T* sQw,
                                                   T* __restrict__ op, long long stride_n,
                                                   const int* off, int row0, int n, int lane) {
  constexpr int LD = row_ld(HD), CH = HD / 8;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<uint32_t*>(sQw + g * LD + j * 8 + 2 * t) =
        pack2<T>(__fmul_rn(o[j][0], inv[0]), __fmul_rn(o[j][1], inv[0]));
    *reinterpret_cast<uint32_t*>(sQw + (g + 8) * LD + j * 8 + 2 * t) =
        pack2<T>(__fmul_rn(o[j][2], inv[1]), __fmul_rn(o[j][3], inv[1]));
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(op + off[row0 + r] * stride_n + c) =
          *reinterpret_cast<const uint4*>(sQw + r * LD + c);
  }
}
