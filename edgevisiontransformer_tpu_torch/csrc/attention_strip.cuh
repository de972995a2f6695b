// The query strip of csrc/attention_rows.cu (its header comment has the
// design) as a __device__ routine: W warps of one (image, head), each warp 16
// query rows, walk the 64-key tiles of that head through a cp.async ring,
// scores and p in mma.sync registers (the routines of attn_tiles.cuh).
// T is the element type (bf16 or fp16).  bf16 takes softmax_unnorm's
// max-free softmax in one sweep over the keys.  fp16 takes its row-max
// branch (p = exp2(s - max s), no clamp: exp2(min(s, 60)) overflows fp16
// once p is rounded for PV): a first sweep over the keys' tiles finds each
// row's max with the same products, so m is the max of exactly the scores
// the second sweep exponentiates, as JAX's one-pass max; the second sweep
// is the bf16 one on s - m.
// attention_rows.cu runs one strip a block; vit_full.cu runs the strips of
// its attention phase on the warp groups of its persistent blocks, each
// group on its own named barrier.
#pragma once

#include <math.h>

#include "attn_tiles.cuh"

namespace arows {

constexpr int KT = 64, STAGES = 2;
constexpr float kClamp = 60.0f;

// p of one log2-scaled score, common.softmax_unnorm's max-free softmax
// (bench/attention_ab.py builds a variant without it).
__device__ __forceinline__ float softmax_p(float s) {
  return exp2f(fminf(s, kClamp));
}

// In place over NC 16-key chunks from key key0: s becomes p = softmax_p(s *
// scale2), or with ROW_MAX p = exp2(s * scale2 - m) (m[0]: row g, m[1]: row
// g + 8), 0 for a key at or past seq_len when MASK; r[0] (row g) and r[1]
// (row g + 8) add this thread's share of p, in fp32.
template <int NC, bool MASK, bool ROW_MAX>
__device__ __forceinline__ void exp2_rows(float (&s)[NC][2][4], int key0, int seq_len,
                                          float scale2, int lane, const float (&m)[2],
                                          float (&r)[2]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float& x = s[c][e / 4][e % 4];
      if constexpr (ROW_MAX) x = exp2f(__fsub_rn(__fmul_rn(x, scale2), m[(e % 4) / 2]));
      else x = softmax_p(__fmul_rn(x, scale2));
      if (MASK && key0 + c * 16 + (e / 4) * 8 + 2 * (lane & 3) + (e & 1) >= seq_len) x = 0.0f;
      r[(e % 4) / 2] = __fadd_rn(r[(e % 4) / 2], x);
    }
}

// One tile of NC chunks: S = Q K^T, p and r, O += T(p) V.
template <int HD, int NC, bool MASK, class T>
__device__ __forceinline__ void tile_step(float (&o)[HD / 8][4], float (&r)[2], const T* sQw,
                                          const T* sK, const T* sV, int key0, int seq_len,
                                          float scale2, int lane, const float (&m)[2]) {
  float s[NC][2][4];
  qk<HD, NC>(s, sQw, sK, lane);
  exp2_rows<NC, MASK, Elem<T>::row_max>(s, key0, seq_len, scale2, lane, m, r);
  pv<HD, NC>(o, s, sV, lane);
}

// m[0] (row g) and m[1] (row g + 8) take this thread's share of the max of
// the log2-scaled scores s * scale2 of nc 16-key chunks of sK from key key0,
// keys at or past seq_len left out when MASK: one chunk's products at a
// time, each the bits tile_step computes for it.
template <int HD, bool MASK, class T>
__device__ __forceinline__ void max_steps(float (&m)[2], const T* sQw, const T* sK, int nc,
                                          int key0, int seq_len, float scale2, int lane) {
  constexpr int LD = row_ld(HD);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c >= nc) break;
    float s[1][2][4];
    qk<HD, 1>(s, sQw, sK + c * 16 * LD, lane);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (!MASK || key0 + c * 16 + (e / 4) * 8 + 2 * (lane & 3) + (e & 1) < seq_len)
        m[(e % 4) / 2] = fmaxf(m[(e % 4) / 2], __fmul_rn(s[0][e / 4][e % 4], scale2));
  }
}

// Dynamic shared memory of one strip: W * 16 Q rows, then `stages` ring
// stages of a K and a V tile (16-bit values).  fused_vit_full.py's plan
// mirrors this.
template <int HD>
__host__ __device__ constexpr int smem_bytes(int warps, int stages) {
  return (warps * 16 + stages * 2 * KT) * row_ld(HD) * 2;
}

// A barrier of the W warps of one strip: named barrier `id` (0, with the
// strip the whole block, is __syncthreads).
template <int W>
__device__ __forceinline__ void strip_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(W * 32) : "memory");
}

// The NC chunks from sK, sV of a tile, STEP at a time, masked: the same sums
// in the same order as one tile_step of NC chunks, in fewer registers.
template <int HD, int STEP, bool MASK, class T>
__device__ __forceinline__ void chunk_steps(float (&o)[HD / 8][4], float (&r)[2], const T* sQw,
                                            const T* sK, const T* sV, int nc, int key0,
                                            int seq_len, float scale2, int lane,
                                            const float (&m)[2]) {
  constexpr int LD = row_ld(HD);
#pragma unroll
  for (int c = 0; c < 4; c += STEP) {
    if (c >= nc) break;
    const T *k = sK + c * 16 * LD, *v = sV + c * 16 * LD;
    const int k0 = key0 + c * 16;
    switch (nc - c < STEP ? nc - c : STEP) {
      case 1: tile_step<HD, 1, MASK>(o, r, sQw, k, v, k0, seq_len, scale2, lane, m); break;
      case 2:
        if constexpr (STEP >= 2)
          tile_step<HD, 2, MASK>(o, r, sQw, k, v, k0, seq_len, scale2, lane, m);
        break;
      case 3:
        if constexpr (STEP >= 3)
          tile_step<HD, 3, MASK>(o, r, sQw, k, v, k0, seq_len, scale2, lane, m);
        break;
      default:
        if constexpr (STEP >= 4)
          tile_step<HD, 4, MASK>(o, r, sQw, k, v, k0, seq_len, scale2, lane, m);
    }
  }
}

// Query rows [index * W * 16, + W * 16) of (image img, head) over the fused
// qkv rows [b * tokens, 3 * heads * hd], written to the merged [b * tokens,
// heads * hd]: `tid` is the thread's index in the strip's W warps, `bar`
// their named barrier, `smem` their shared memory (smem_bytes<HD>(W,
// STAGES)).  The operands' head_dim is HD, or with PAD hd, a multiple of 8
// below HD: the rows land in shared memory HD wide, zero-filled past hd
// (load_rows), so the scores are those of hd columns, and O's columns from
// hd on are never stored.  A tile's chunks go through the products STEP at
// a time (4, a whole tile, in attention_rows.cu; fewer where registers are
// short): a row's bits do not depend on STEP.  On return the warps may still read
// their Q rows: a caller that runs another strip on the same memory passes
// the barrier first.
template <int HD, int W, int STEP = 4, bool PAD = false, class T>
__device__ __forceinline__ void strip(unsigned char* smem, const T* __restrict__ qkv,
                                      T* __restrict__ out, int tokens, int seq_len,
                                      int heads, int hd, float scale2, int index, int img,
                                      int head, int tid, int bar) {
  constexpr int NT = W * 32, LD = row_ld(HD), STAGE = 2 * KT * LD;
  T* sQ = reinterpret_cast<T*>(smem);
  T* ring = sQ + W * 16 * LD;

  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = index * W * 16, row0 = q0 + warp * 16;
  const bool active = row0 < tokens;
  const int hdv = PAD ? hd : HD;  // the operands' head_dim
  const long long ld = 3LL * heads * hdv, ldo = static_cast<long long>(heads) * hdv;
  const T* qp = qkv + static_cast<long long>(img) * tokens * ld + head * hdv;
  const T* kp = qp + heads * hdv;
  const T* vp = kp + heads * hdv;
  T* op = out + static_cast<long long>(img) * tokens * ldo + head * hdv;
  T* sQw = sQ + warp * 16 * LD;

  // the 16-key chunks that hold a key below seq_len, four to a 64-key tile
  const int chunks = (seq_len + 15) / 16, tiles = (chunks + 3) / 4;
  // a tile's K rows (and with v its V rows) into its ring stage
  auto prefetch = [&](int t, bool v) {
    T* sK = ring + (t % STAGES) * STAGE;
    const int rows = min(KT, 16 * chunks - t * KT);
    load_rows<HD, NT, PAD>(sK, kp, ld, t * KT, rows, tokens, tid, hdv);
    if (v) load_rows<HD, NT, PAD>(sK + KT * LD, vp, ld, t * KT, rows, tokens, tid, hdv);
  };
  load_rows<HD, NT, PAD>(sQ, qp, ld, q0, W * 16, tokens, tid, hdv);
  float m[2] = {-INFINITY, -INFINITY};
  if constexpr (Elem<T>::row_max) {
    // the first sweep: K alone, through the same ring, for the row max
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) {
      if (t < tiles) prefetch(t, false);
      cp_async_commit();  // group t: tile t's K (group 0 holds Q too)
    }
    for (int t = 0; t < tiles; ++t) {
      cp_async_wait<STAGES - 2>();
      strip_sync<W>(bar);  // tile t landed; every warp is done with tile t - 1
      if (t + STAGES - 1 < tiles) prefetch(t + STAGES - 1, false);
      cp_async_commit();
      if (!active) continue;
      const T* sK = ring + (t % STAGES) * STAGE;
      if (t + 1 < tiles) max_steps<HD, false>(m, sQw, sK, 4, t * KT, seq_len, scale2, lane);
      else max_steps<HD, true>(m, sQw, sK, chunks - 4 * t, t * KT, seq_len, scale2, lane);
    }
    cp_async_wait<0>();
    strip_sync<W>(bar);  // every warp is done with the ring (and Q landed)
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
  }
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < tiles) prefetch(t, true);
    cp_async_commit();  // group t: tile t (group 0 holds Q too, unless the first sweep ran)
  }

  float o[HD / 8][4], r[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    // tile t landed; every warp is done with tile t - 1, whose stage the
    // prefetch below refills
    strip_sync<W>(bar);
    if (t + STAGES - 1 < tiles) prefetch(t + STAGES - 1, true);
    cp_async_commit();
    if (!active) continue;
    const T* sK = ring + (t % STAGES) * STAGE;
    const T* sV = sK + KT * LD;
    const int key0 = t * KT;
    if (t + 1 < tiles) {
      chunk_steps<HD, STEP, false>(o, r, sQw, sK, sV, 4, key0, seq_len, scale2, lane, m);
      continue;
    }
    // the last tile, masked
    chunk_steps<HD, STEP, true>(o, r, sQw, sK, sV, chunks - 4 * t, key0, seq_len, scale2, lane,
                                m);
  }
  if (tiles == 0) {  // seq_len = 0: Q's loads were never waited for, and its rows take the output
    cp_async_wait<0>();
    strip_sync<W>(bar);
  }
  if (!active) return;

  const float inv[2] = {__frcp_rn(fmaxf(quad_sum(r[0]), 1e-30f)),
                        __frcp_rn(fmaxf(quad_sum(r[1]), 1e-30f))};
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[j][0] = __fmul_rn(o[j][0], inv[0]);
    o[j][1] = __fmul_rn(o[j][1], inv[0]);
    o[j][2] = __fmul_rn(o[j][2], inv[1]);
    o[j][3] = __fmul_rn(o[j][3], inv[1]);
  }
  store_rows<HD, PAD>(o, sQw, op, ldo, row0, tokens, lane, hdv);
}

}  // namespace arows
