// Warp-level attention routines shared by sdpa.cu (K13), attention_rows.cu
// (K1's attention) and window_sdpa.cu (K12): one warp owns 16 query rows,
// its scores live in mma.sync.m16n8k16 accumulator registers, and K and V
// arrive in shared memory by cp.async.
//
// Shared-memory tiles hold rows of HD bf16 values at a row stride of
// row_ld(HD) = HD + 8 elements: the 16-byte skew spreads the eight rows of an
// ldmatrix over all 32 banks.  Q's A fragments come from its rows, S = Q K^T's
// B fragments from K's rows (ldmatrix), O = P V's from V's rows
// (ldmatrix.trans).
//
// Score layout: s[c][j] is the m16n8 accumulator of keys 16c + 8j .. + 7.
// Thread (g = lane / 4, t = lane % 4) holds rows g (s[.][.][0..1]) and g + 8
// ([2..3]), keys 2t and 2t + 1 of each n8 tile, so a score row lives in the 4
// lanes of a quad (quad_sum and quad_max reduce it), and the accumulators of two
// neighbouring n8 tiles, packed to bf16x2, are the A fragment of one k16 step
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
// n (not waited for).
template <int HD, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src,
                                          long long stride_n, int r0, int rows, int n, int tid) {
  constexpr int CH = HD / 8;
  for (int i = tid; i < rows * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const int t = r0 + r;
    const bool ok = t < n;
    cp_async16(dst + r * row_ld(HD) + c, ok ? src + t * stride_n + c : src, ok);
  }
}

// Scores of the warp's 16 query rows (sQw) against NC 16-key chunks of sK,
// in the layout above.
template <int HD, int NC>
__device__ __forceinline__ void qk(float (&s)[NC][2][4], const bf16* sQw, const bf16* sK,
                                   int lane) {
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
      mma_bf16(s[c][0], a, b[0], b[1]);
      mma_bf16(s[c][1], a, b[2], b[3]);
    }
  }
}

// O += bf16(P) V over NC 16-key chunks of sV, P in the score registers (two
// n8 accumulators = one k16 A fragment).
template <int HD, int NC>
__device__ __forceinline__ void pv(float (&o)[HD / 8][4], const float (&p)[NC][2][4],
                                   const bf16* sV, int lane) {
  constexpr int LD = row_ld(HD);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const uint32_t a[4] = {pack_bf16x2(p[c][0][0], p[c][0][1]),
                           pack_bf16x2(p[c][0][2], p[c][0][3]),
                           pack_bf16x2(p[c][1][0], p[c][1][1]),
                           pack_bf16x2(p[c][1][2], p[c][1][3])};
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, sV + (c * 16 + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * dp], a, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// bf16(O) through the warp's own 16 rows of the Q tile to out, 16-byte
// stores, rows past n dropped.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&o)[HD / 8][4], bf16* sQw,
                                           bf16* __restrict__ op, long long stride_n, int row0,
                                           int n, int lane) {
  constexpr int LD = row_ld(HD), CH = HD / 8;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<uint32_t*>(sQw + g * LD + j * 8 + 2 * t) = pack_bf16x2(o[j][0], o[j][1]);
    *reinterpret_cast<uint32_t*>(sQw + (g + 8) * LD + j * 8 + 2 * t) =
        pack_bf16x2(o[j][2], o[j][3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(op + (row0 + r) * stride_n + c) =
          *reinterpret_cast<const uint4*>(sQw + r * LD + c);
  }
}
