// attn::tile, the WMMA attention tile that attention_rows.cu (K1's
// attention) ran until its redesign on the mma.sync routines of
// attn_tiles.cuh, and vit_full.cu after it until its own: kept as the
// control that bench/attention_ab.py times beside attention_rows and that a
// card test holds attention_rows to.  It sums each row's p in another order
// than attention_rows (the outputs agree within the kernels' tolerance).
#pragma once

#include <mma.h>

#include "common.cuh"

// ---------------------------------------------------------------------------
// Attention tile: 64 queries of one (image, head) over the fused qkv rows
// [b * tokens, 3 * heads * HD] (columns (qkv, head, hd)), written to the
// merged [b * tokens, heads * HD].  4 warps (128 threads, `tid` 0..127) each
// own 16 query rows.  For each 64-key tile: S = q k^T on WMMA bf16 fragments
// (fp32 accumulate), p = exp2(min(S * scale2, 60)) with keys >= seq_len 0,
// fp32 row sums r += p, O += bf16(p) v; out = bf16(O * 1 / max(r, 1e-30)).
// The 4 warps synchronise on named barrier `bar` (0: the whole block, when
// the block is those 128 threads).
// ---------------------------------------------------------------------------
namespace attn {

constexpr int QT = 64, KT = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr float kClamp = 60.0f;

template <int HD>
struct Smem {
  static constexpr int LD = HD + 8;   // q, k, v row stride (bf16)
  static constexpr int SLD = KT + 4;  // scores row stride (fp32)
  static constexpr int OLD = HD + 4;  // output tile row stride (fp32)
  static constexpr int PLD = KT + 8;  // probabilities row stride (bf16)
  static constexpr int SF = SLD > OLD ? SLD : OLD;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + QT * LD * 2;
  static constexpr int V_OFF = K_OFF + KT * LD * 2;
  static constexpr int S_OFF = V_OFF + KT * LD * 2;
  static constexpr int P_OFF = S_OFF + QT * SF * 4;
  static constexpr int R_OFF = P_OFF + QT * PLD * 2;
  static constexpr int BYTES = R_OFF + QT * 4;
};

__device__ __forceinline__ void sync(int bar) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(THREADS) : "memory");
}

template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0, int tokens, int ld,
                                          int col, int tid) {
  constexpr int CH = HD / 8;
  for (int i = tid; i < 64 * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const int t = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t < tokens) v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(t) * ld + col + c);
    *reinterpret_cast<uint4*>(dst + r * Smem<HD>::LD + c) = v;
  }
}

template <int HD>
__device__ __forceinline__ void tile(unsigned char* smem, const bf16* qkv, bf16* out, int tokens,
                                     int seq_len, int heads, float scale2, int q0, int head,
                                     int img, int tid, int bar) {
  using namespace nvcuda;
  using L = Smem<HD>;
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::V_OFF);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::P_OFF);
  float* sR = reinterpret_cast<float*>(smem + L::R_OFF);

  const int warp = tid >> 5, lane = tid & 31;
  const int ld = 3 * heads * HD;
  const bf16* base = qkv + static_cast<size_t>(img) * tokens * ld;
  const int wr = warp * 16;  // this warp's first query row in the tile

  load_rows<HD>(sQ, base, q0, tokens, ld, head * HD, tid);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[HD / 16];
#pragma unroll
  for (int d = 0; d < HD / 16; ++d) wmma::fill_fragment(o[d], 0.0f);
  float rpart[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) rpart[r] = 0.0f;

  for (int k0 = 0; k0 < seq_len; k0 += KT) {
    sync(bar);  // every warp is done with the previous k, v tile
    load_rows<HD>(sK, base, k0, tokens, ld, (heads + head) * HD, tid);
    load_rows<HD>(sV, base, k0, tokens, ld, (2 * heads + head) * HD, tid);
    sync(bar);

    // S[wr:wr+16, 0:64] = q k^T
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, sQ + wr * L::LD + kk * 16, L::LD);
        wmma::load_matrix_sync(b, sK + j * 16 * L::LD + kk * 16, L::LD);
        wmma::mma_sync(s, a, b, s);
      }
      wmma::store_matrix_sync(sS + wr * L::SLD + j * 16, s, L::SLD, wmma::mem_row_major);
    }
    __syncwarp();

    // p = exp2(min(s * scale2, 60)), masked keys 0; r += p in fp32
#pragma unroll
    for (int r = 0; r < 16; ++r) {
#pragma unroll
      for (int c = lane; c < KT; c += 32) {
        const float s = sS[(wr + r) * L::SLD + c] * scale2;
        const float p = (k0 + c < seq_len) ? exp2f(fminf(s, kClamp)) : 0.0f;
        rpart[r] += p;
        sP[(wr + r) * L::PLD + c] = __float2bfloat16_rn(p);
      }
    }
    __syncwarp();

    // O += bf16(p) v
#pragma unroll
    for (int d = 0; d < HD / 16; ++d) {
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, sP + wr * L::PLD + kk * 16, L::PLD);
        wmma::load_matrix_sync(b, sV + kk * 16 * L::LD + d * 16, L::LD);
        wmma::mma_sync(o[d], a, b, o[d]);
      }
    }
  }

  // The score buffer now holds the fp32 output rows.  With HD > 64 a warp's
  // output rows overlap another warp's score rows, so wait for every warp.
  sync(bar);
  float* sO = sS;
#pragma unroll
  for (int d = 0; d < HD / 16; ++d)
    wmma::store_matrix_sync(sO + wr * L::OLD + d * 16, o[d], L::OLD, wmma::mem_row_major);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float t = warp_sum(rpart[r]);
    if (lane == 0) sR[wr + r] = 1.0f / fmaxf(t, 1e-30f);
  }
  __syncwarp();

  const int ldo = heads * HD;
  constexpr int CH = HD / 8;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    const int q = q0 + wr + r;
    if (q >= tokens) continue;
    const float inv = sR[wr + r];
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = sO[(wr + r) * L::OLD + c + e] * inv;
    *reinterpret_cast<uint4*>(out + (static_cast<size_t>(img) * tokens + q) * ldo + head * HD + c) =
        pack8(v);
  }
}

}  // namespace attn
