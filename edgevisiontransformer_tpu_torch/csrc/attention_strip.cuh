// The query strip of csrc/attention_rows.cu (its header comment has the
// design) as a __device__ routine: W warps of one (image, head), each warp 16
// query rows, walk the 64-key tiles of that head through a cp.async ring,
// scores and p in mma.sync registers (the routines of attn_tiles.cuh).
// attention_rows.cu runs one strip a block; vit_full.cu runs the strips of
// its attention phase on the warp groups of its persistent blocks, each
// group on its own named barrier.
#pragma once

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
// scale2), 0 for a key at or past seq_len when MASK; r[0] (row g) and r[1]
// (row g + 8) add this thread's share of p, in fp32.
template <int NC, bool MASK>
__device__ __forceinline__ void exp2_rows(float (&s)[NC][2][4], int key0, int seq_len,
                                          float scale2, int lane, float (&r)[2]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float& x = s[c][e / 4][e % 4];
      x = softmax_p(__fmul_rn(x, scale2));
      if (MASK && key0 + c * 16 + (e / 4) * 8 + 2 * (lane & 3) + (e & 1) >= seq_len) x = 0.0f;
      r[(e % 4) / 2] = __fadd_rn(r[(e % 4) / 2], x);
    }
}

// One tile of NC chunks: S = Q K^T, p and r, O += bf16(p) V.
template <int HD, int NC, bool MASK>
__device__ __forceinline__ void tile_step(float (&o)[HD / 8][4], float (&r)[2], const bf16* sQw,
                                          const bf16* sK, const bf16* sV, int key0, int seq_len,
                                          float scale2, int lane) {
  float s[NC][2][4];
  qk<HD, NC>(s, sQw, sK, lane);
  exp2_rows<NC, MASK>(s, key0, seq_len, scale2, lane, r);
  pv<HD, NC>(o, s, sV, lane);
}

// Dynamic shared memory of one strip: W * 16 Q rows, then `stages` ring
// stages of a K and a V tile.  fused_vit_full.py's plan mirrors this.
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
template <int HD, int STEP, bool MASK>
__device__ __forceinline__ void chunk_steps(float (&o)[HD / 8][4], float (&r)[2], const bf16* sQw,
                                            const bf16* sK, const bf16* sV, int nc, int key0,
                                            int seq_len, float scale2, int lane) {
  constexpr int LD = row_ld(HD);
#pragma unroll
  for (int c = 0; c < 4; c += STEP) {
    if (c >= nc) break;
    const bf16 *k = sK + c * 16 * LD, *v = sV + c * 16 * LD;
    switch (nc - c < STEP ? nc - c : STEP) {
      case 1: tile_step<HD, 1, MASK>(o, r, sQw, k, v, key0 + c * 16, seq_len, scale2, lane); break;
      case 2:
        if constexpr (STEP >= 2)
          tile_step<HD, 2, MASK>(o, r, sQw, k, v, key0 + c * 16, seq_len, scale2, lane);
        break;
      case 3:
        if constexpr (STEP >= 3)
          tile_step<HD, 3, MASK>(o, r, sQw, k, v, key0 + c * 16, seq_len, scale2, lane);
        break;
      default:
        if constexpr (STEP >= 4)
          tile_step<HD, 4, MASK>(o, r, sQw, k, v, key0 + c * 16, seq_len, scale2, lane);
    }
  }
}

// Query rows [index * W * 16, + W * 16) of (image img, head) over the fused
// qkv rows [b * tokens, 3 * heads * HD], written to the merged [b * tokens,
// heads * HD]: `tid` is the thread's index in the strip's W warps, `bar`
// their named barrier, `smem` their shared memory (smem_bytes<HD>(W,
// STAGES)).  A tile's chunks go through the products STEP at a time (4, a
// whole tile, in attention_rows.cu; fewer where registers are short): a
// row's bits do not depend on STEP.  On return the warps may still read
// their Q rows: a caller that runs another strip on the same memory passes
// the barrier first.
template <int HD, int W, int STEP = 4>
__device__ __forceinline__ void strip(unsigned char* smem, const bf16* __restrict__ qkv,
                                      bf16* __restrict__ out, int tokens, int seq_len,
                                      int heads, float scale2, int index, int img, int head,
                                      int tid, int bar) {
  constexpr int NT = W * 32, LD = row_ld(HD), STAGE = 2 * KT * LD;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* ring = sQ + W * 16 * LD;

  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = index * W * 16, row0 = q0 + warp * 16;
  const bool active = row0 < tokens;
  const long long ld = 3LL * heads * HD, ldo = static_cast<long long>(heads) * HD;
  const bf16* qp = qkv + static_cast<long long>(img) * tokens * ld + head * HD;
  const bf16* kp = qp + heads * HD;
  const bf16* vp = kp + heads * HD;
  bf16* op = out + static_cast<long long>(img) * tokens * ldo + head * HD;
  bf16* sQw = sQ + warp * 16 * LD;

  // the 16-key chunks that hold a key below seq_len, four to a 64-key tile
  const int chunks = (seq_len + 15) / 16, tiles = (chunks + 3) / 4;
  auto prefetch = [&](int t) {
    bf16* sK = ring + (t % STAGES) * STAGE;
    const int rows = min(KT, 16 * chunks - t * KT);
    load_rows<HD, NT>(sK, kp, ld, t * KT, rows, tokens, tid);
    load_rows<HD, NT>(sK + KT * LD, vp, ld, t * KT, rows, tokens, tid);
  };
  load_rows<HD, NT>(sQ, qp, ld, q0, W * 16, tokens, tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < tiles) prefetch(t);
    cp_async_commit();  // group t: tile t (group 0 holds Q too)
  }

  float o[HD / 8][4], r[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    // tile t landed; every warp is done with tile t - 1, whose stage the
    // prefetch below refills
    strip_sync<W>(bar);
    if (t + STAGES - 1 < tiles) prefetch(t + STAGES - 1);
    cp_async_commit();
    if (!active) continue;
    const bf16* sK = ring + (t % STAGES) * STAGE;
    const bf16* sV = sK + KT * LD;
    const int key0 = t * KT;
    if (t + 1 < tiles) {
      chunk_steps<HD, STEP, false>(o, r, sQw, sK, sV, 4, key0, seq_len, scale2, lane);
      continue;
    }
    // the last tile, masked
    chunk_steps<HD, STEP, true>(o, r, sQw, sK, sV, chunks - 4 * t, key0, seq_len, scale2, lane);
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
  store_rows<HD>(o, sQw, op, ldo, row0, tokens, lane);
}

}  // namespace arows
