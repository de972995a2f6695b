// The softmax of K13's kernels, shared by sdpa.cu (its resident form) and
// sdpa_long.cu (every longer n), over scores in the m16n8 accumulator
// layout of attn_tiles.cuh: s[c][j] holds keys 16c + 8j .. + 7, thread (g =
// lane / 4, t = lane % 4) rows g (s[.][.][0..1]) and g + 8 ([2..3]), keys 2t
// and 2t + 1 of each n8 tile (wgmma's m64nN accumulators hold each warp's
// 16 rows in the same layout).  K13's cast points: s = f32(q . k) * scale by
// __fmul_rn, keys past n excluded, the row max and sum in fp32, p = exp(s -
// m) / l exactly (normalise where exact_corrections holds, else
// __fdiv_rn).
#pragma once

#include <math.h>

#include "attn_tiles.cuh"

// The softmax's two costly steps, each in one place (bench/sdpa_ab.py
// builds variants of them).
__device__ __forceinline__ float exp_shifted(float s, float m) {
  return expf(__fsub_rn(s, m));
}

// p = e / l correctly rounded, the value of __fdiv_rn(e, l), given y =
// __frcp_rn(l) (one per row), for l >= 1 and e / l >= 2^-101 or e = 0.
// q = RN(e y) lies within 1.5 ulp of e / l; one correction q + (e - l q) y
// brings it within one ulp; then Markstein's theorem holds: with y within
// half an ulp of 1/l and q within one ulp of e/l, the remainder r = e - l q
// is exact in one FMA and RN(q + r y) = RN(e / l).  The bound on e / l keeps
// r clear of underflow, which would break that (exact_corrections decides).
// Five fp32 operations a score, where __fdiv_rn takes a reciprocal on the
// MUFU and about ten more (tests/test_torch_sdpa_tiles.py checks this
// arithmetic against the exact quotient).
__device__ __forceinline__ float normalise(float e, float l, float y) {
  float q = __fmul_rn(e, y);
  q = __fmaf_rn(__fmaf_rn(-l, q, e), y, q);
  return __fmaf_rn(__fmaf_rn(-l, q, e), y, q);
}

// p = e / l for the rows that normalise does not take.
__device__ __forceinline__ float divide_ieee(float e, float l) {
  return __fdiv_rn(e, l);
}

__device__ __forceinline__ float quad_min(float v) {
  v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Whether normalise is exact for every score of the warp's rows: the least
// unmasked score lo gives the least nonzero numerator exp(lo - m), which must
// keep e / l >= 2^-101 (2^-100 here, a margin for expf's last ulps).  lo is
// this thread's share (quad-reduced here); l is quad-reduced.  Warp-uniform,
// so the division loops stay free of branches; a row whose scores span more
// than ~65 takes __fdiv_rn.
__device__ __forceinline__ bool exact_corrections(const float lo[2], const float m[2],
                                                  const float l[2]) {
  bool ok = true;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float least = exp_shifted(quad_min(lo[r]), m[r]);  // every lane shuffles
    ok &= least >= 0x1p-100f * l[r];
  }
  return __all_sync(0xffffffffu, ok);
}

// s = f32(q . k) * scale, -inf for keys at or past n (key0: the first key
// of chunk 0); lo[r] becomes the least unmasked score of row r in this
// thread's share, if smaller.
template <int NC>
__device__ __forceinline__ void scale_mask(float (&s)[NC][2][4], int key0, int n, float scale,
                                           int lane, float lo[2]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int key = key0 + c * 16 + (e / 4) * 8 + 2 * (lane & 3) + (e & 1);
      float& x = s[c][e / 4][e % 4];
      x = key < n ? __fmul_rn(x, scale) : -INFINITY;
      if (key < n) lo[(e % 4) / 2] = fminf(lo[(e % 4) / 2], x);
    }
}

// In place, p = e / l: by normalise where exact_corrections holds, else by
// the IEEE division.
template <int NC>
__device__ __forceinline__ void divide_rows(float (&s)[NC][2][4], const float l[2],
                                            bool corrections) {
  if (corrections) {
    const float y[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float& x = s[c][e / 4][e % 4];
        x = normalise(x, l[(e % 4) / 2], y[(e % 4) / 2]);
      }
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float& x = s[c][e / 4][e % 4];
        x = divide_ieee(x, l[(e % 4) / 2]);
      }
  }
}

// The row max of the scores (m[0]: row g, m[1]: row g + 8), quad-reduced.
template <int NC>
__device__ __forceinline__ void row_max(const float (&s)[NC][2][4], float m[2]) {
  m[0] = m[1] = -INFINITY;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) m[(e % 4) / 2] = fmaxf(m[(e % 4) / 2], s[c][e / 4][e % 4]);
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
}

// In place, s becomes exp(s - m) (0 for a masked key); returns this
// thread's share of each row's sum in l (not quad-reduced).
template <int NC>
__device__ __forceinline__ void exp_rows(float (&s)[NC][2][4], const float m[2], float l[2]) {
  l[0] = l[1] = 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float& x = s[c][e / 4][e % 4];
      const int r = (e % 4) / 2;
      x = x == -INFINITY ? 0.0f : exp_shifted(x, m[r]);
      l[r] = __fadd_rn(l[r], x);
    }
}
