// The encoder's three kinds of work as __device__ functions over one tile:
// a LayerNorm row, a GEMM output tile with its epilogue, an attention query
// tile.  ln_rows.cu launches one LayerNorm row per warp; vit_full.cu walks
// every tile of a whole forward inside one persistent kernel, so ln_rows
// and the whole-model kernel round alike.  The GEMM tile gemm::tile and the
// attention tile attn::tile serve vit_full.cu alone: linear.cu has its own
// mma.sync tile, which sums each output element in the same k16 order, and
// attention_rows.cu its own on the mma.sync routines of attn_tiles.cuh,
// which sums each row's p in another order (its outputs agree with
// attn::tile's within the kernels' tolerance).
//
// Activation pointers carry no __restrict__ here: in vit_full.cu a tile
// reads what other blocks wrote earlier in the same launch, which the
// non-coherent read-only cache path must not serve.
#pragma once

#include <mma.h>

#include "common.cuh"

// ---------------------------------------------------------------------------
// LayerNorm of one row (one warp): fp32 mean, fp32 mean of squared
// deviations, rsqrt(var + eps) * g + b in fp32; `store(chunk, f)` receives
// each 8-value chunk.  g and b are fp32 (affine_f32) or bf16.  dim % 8 == 0.
// ---------------------------------------------------------------------------
template <class Store>
__device__ __forceinline__ void ln_row(const bf16* xr, const void* g, const void* b, int dim,
                                       float eps, int affine_f32, int lane, Store store) {
  const int chunks = dim / 8;
  float f[8];

  float sum = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += f[i];
  }
  const float mean = warp_sum(sum) / static_cast<float>(dim);

  float sq = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = f[i] - mean;
      sq += d * d;
    }
  }
  const float var = warp_sum(sq) / static_cast<float>(dim);
  const float rs = rsqrtf(var + eps);

  float gf[8], bf[8];
  for (int c = lane; c < chunks; c += 32) {
    unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
    load8_either(g, c, affine_f32, gf);
    load8_either(b, c, affine_f32, bf);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = (f[i] - mean) * rs * gf[i] + bf[i];
    store(c, f);
  }
}

// ---------------------------------------------------------------------------
// GEMM tile: Y[m0:m0+128, n0:n0+128] = epilogue(A @ W) in bf16 with fp32
// accumulation.  8 warps (256 threads) each own 32x64 of the tile as 2x4 WMMA
// 16x16x16 bf16 fragments; K in steps of 32 through a 3-stage ring in shared
// memory (cp.async for 16-byte aligned operands), zero-filled past the
// ragged M, N and K edges.  The epilogue stages the fp32 tile in shared
// memory.  Epilogues (acc is the fp32 sum, b the bias, r the residual):
//   0 CAST_THEN_BIAS        bf16(bf16(acc) + b)
//   1 CAST_THEN_BIAS_GELU   bf16(gelu_tanh(bf16(bf16(acc) + b)))
//   2   (exact GELU)        bf16(gelu_erf(bf16(bf16(acc) + b)))
//   3 BIAS_RESIDUAL         bf16(acc + f32(b) + f32(r))
//   4 ROW_BIAS              bf16(acc + f32(r)), r's row gm % res_rows (no b):
//                           the ViT embedding's per-token bias
// Each output element's residual is read by the thread that writes it, so
// Y may be the residual itself (in place).
// ---------------------------------------------------------------------------
namespace gemm {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int AS = BK + 8;  // padded smem row strides (elements)
constexpr int BS = BN + 8;
constexpr int CS = BN + 4;
constexpr int A_STAGE = BM * AS;
constexpr int B_STAGE = BK * BS;
constexpr int PIPE_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;
constexpr int C_BYTES = BM * CS * 4;
constexpr int SMEM_BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
constexpr int ROW_BIAS = 4;

// A as the rows of X [M, K].  V: rows 16-byte aligned (cp.async of 8
// values, all in or all out); otherwise each element is loaded and masked.
template <bool V>
struct RowsA {
  const bf16* X;

  __device__ __forceinline__ void load(bf16* sA, int M, int K, int m0, int k0, int tid) const {
    if constexpr (V) {
#pragma unroll
      for (int i = tid; i < BM * (BK / 8); i += THREADS) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        const int gm = m0 + r, gk = k0 + c;
        const bool ok = gm < M && gk < K;
        cp_async16(sA + r * AS + c, ok ? X + static_cast<size_t>(gm) * K + gk : X, ok);
      }
    } else {
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int r = i / BK, c = i % BK;
        const int gm = m0 + r, gk = k0 + c;
        sA[r * AS + c] = gm < M && gk < K ? X[static_cast<size_t>(gm) * K + gk]
                                          : __float2bfloat16_rn(0.0f);
      }
    }
  }
};

// One K step of the A and B (W) tiles into shared memory.  VB: W's rows are
// 16-byte aligned.
template <bool VB, class ASrc>
__device__ __forceinline__ void load_stage(bf16* sA, bf16* sB, const ASrc& a,
                                           const bf16* __restrict__ W, int M, int N, int K,
                                           int m0, int n0, int k0, int tid) {
  a.load(sA, M, K, m0, k0, tid);
  if constexpr (VB) {
#pragma unroll
    for (int i = tid; i < BK * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + c;
      const bool ok = gk < K && gn < N;
      cp_async16(sB + r * BS + c, ok ? W + static_cast<size_t>(gk) * N + gn : W, ok);
    }
  } else {
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      sB[r * BS + c] = gk < K && gn < N ? W[static_cast<size_t>(gk) * N + gn]
                                        : __float2bfloat16_rn(0.0f);
    }
  }
}

// The epilogue of one fp32 value v (the sum) with its bias b and residual r.
__device__ __forceinline__ float epilogue(float v, float b, float r, int epi) {
  if (epi == 3) return (v + b) + r;
  if (epi == ROW_BIAS) return v + r;
  v = round_bf16(round_bf16(v) + b);
  if (epi == 1) return gelu_tanh_f(v);
  if (epi == 2) return gelu_erf_f(v);
  return v;
}

template <bool VB, class ASrc>
__device__ __forceinline__ void tile(unsigned char* smem, const ASrc& a,
                                     const bf16* __restrict__ W, const bf16* bias,
                                     const bf16* res, bf16* Y, int M, int N, int K, int epi,
                                     int res_rows, int m0, int n0) {
  using namespace nvcuda;
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + STAGES * A_STAGE;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_stage<VB>(sA + s * A_STAGE, sB + s * B_STAGE, a, W, M, N, K, m0, n0, s * BK, tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt-1
    const int nk = kt + STAGES - 1;
    if (nk < KT) {
      const int s = nk % STAGES;
      load_stage<VB>(sA + s * A_STAGE, sB + s * B_STAGE, a, W, M, N, K, m0, n0, nk * BK, tid);
    }
    cp_async_commit();
    const bf16* ta = sA + (kt % STAGES) * A_STAGE;
    const bf16* tb = sB + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], ta + (wm + i * 16) * AS + kk, AS);
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(fb[j], tb + kk * BS + wn + j * 16, BS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // the pipeline buffers become the fp32 output tile
  float* sC = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(sC + (wm + i * 16) * CS + wn + j * 16, acc[i][j], CS,
                              wmma::mem_row_major);
  __syncthreads();

  if constexpr (VB) {
    for (int i = tid; i < BM * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int gm = m0 + r, gn = n0 + c;
      if (gm >= M || gn >= N) continue;  // N % 8 == 0: a vector is all in or all out
      float v[8], bv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f},
                  rv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = sC[r * CS + c + e];
      if (epi != ROW_BIAS) unpack8(*reinterpret_cast<const uint4*>(bias + gn), bv);
      const size_t off = static_cast<size_t>(gm) * N + gn;
      if (epi == 3) unpack8(*reinterpret_cast<const uint4*>(res + off), rv);
      if (epi == ROW_BIAS)
        unpack8(*reinterpret_cast<const uint4*>(res + static_cast<size_t>(gm % res_rows) * N + gn),
                rv);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = epilogue(v[e], bv[e], rv[e], epi);
      *reinterpret_cast<uint4*>(Y + off) = pack8(v);
    }
  } else {
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gm = m0 + r, gn = n0 + c;
      if (gm >= M || gn >= N) continue;
      const size_t off = static_cast<size_t>(gm) * N + gn;
      const float bv = epi == ROW_BIAS ? 0.f : __bfloat162float(bias[gn]);
      const float rv = epi == 3          ? __bfloat162float(res[off])
                       : epi == ROW_BIAS ? __bfloat162float(res[static_cast<size_t>(gm % res_rows) * N + gn])
                                         : 0.f;
      Y[off] = __float2bfloat16_rn(epilogue(sC[r * CS + c], bv, rv, epi));
    }
  }
}

}  // namespace gemm

// ---------------------------------------------------------------------------
// Attention tile (vit_full.cu's; attention_rows.cu runs its own): 64
// queries of one (image, head) over the fused qkv rows
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
