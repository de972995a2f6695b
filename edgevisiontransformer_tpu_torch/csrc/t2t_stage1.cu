// t2t_stage1: the T2T-ViT stage-1 tokenizer, kqv(LN(unfold(img, k7 s4 p2))),
// in one kernel, from the NCHW bf16 image to the [b, 3136, d] kqv rows.
//
// Replaces: edgevisiontransformer_tpu/ops/pallas/t2t_stage1.py
//   `stage1_kqv_kernel` (K8, pallas_call :82; body `_stage1_kernel` :39-58).
//   With W9 [432, d], M9 [432] (0/1), c1, c2 [d] from build_stage1_weights:
//     big = the 9 shifted views of the padded space-to-depth image  [3136, 432]
//     out = big @ W9                      bf16 operands, fp32 accumulation
//     mu  = sum(big * M9) / 147,  sq = sum(big * big * M9) / 147    (fp32)
//     y   = (out - mu * c1) * rsqrt(sq - mu * mu + eps) + c2, cast once
//   The one-pass variance is the TPU kernel's (:54-56).  The TPU version
//   leaves the s2d relayout and pad to XLA; here the kernel reads the NCHW
//   image itself and zero-fills the borders.
//
// Bound on the card: per image 3136 x 432 x d x 2 = 0.52 GFLOP (d = 192) on
// 0.3 MB of image and 166 KB of W9, ~1,000 flop/byte: above the H100's
// balance point, so the tensor cores bound it at serving batches; at b1 the
// bound is 0.5 us, and the latency of one block's chain (stage, statistics,
// 27 k16 steps, epilogue) is what a launch takes.
//
// Design: one 8-warp block per (image, token row y of the 56 x 56 grid, 64
// or 96 of the d columns, as the host's plan says): 96 where that keeps to
// one block an SM and 64 would not (112 blocks at b1, d = 192, for the 132
// SMs, against 168), else 64 (two blocks fit an SM).  A token's bits do not
// depend on the plan.
// - The block stages the three padded s2d rows y..y+2 it needs ([3][66]
//   cells of 48 values at a stride of 56, 112 bytes, an odd multiple of 16:
//   ldmatrix's eight row addresses fall in eight bank groups; 58 padded
//   columns and a zero tail, so 64-token tiles stay in range) straight from
//   the NCHW image by 8-byte cp.async, and its whole W9 column slice ([432]
//   rows of 64 or 96, 55 or 88 KB) by 16-byte cp.async, every copy in
//   flight at once in two groups: the rows first, then W9.  A token's 48-wide slab for shift
//   (dy, dx) is the s2d row 1 + dy read from column x + 1 + dx: the A
//   fragment is an ldmatrix of 16 consecutive cells, no gather.
// - The LN statistics wait for the rows only, and overlap W9's copies: 4
//   lanes a token, each adding the masked values k = lane, lane + 4, ... in
//   order (unrolled, at constant offsets from the token's cells), rounded
//   as the twin rounds (no contraction into FMAs), then two shuffles.  A
//   token's statistics do not depend on its block.
// - Products on mma.sync.m16n8k16: warp (wm, wn) owns 16 token rows by 32
//   or 48 columns (WC); K runs in k16 steps in order (shift-major, three steps a shift,
//   the order of the WMMA kernel this one replaced, which mma.sync matches
//   bit for bit).
// - The epilogue from the accumulator registers: (acc - mu c1) rs + c2 at
//   the twin's cast points, packed to bf16x2 into the warp's patch, which
//   the warp writes out as 16-byte vectors.
#include "common.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr int IMG = 224;
constexpr int GRID = 56;                  // tokens per side
constexpr int CH = 48;                    // s2d channels: 3 x 4 x 4
constexpr int CS = 56;                    // a staged cell's stride (elements)
constexpr int PCOLS = 66;                 // 58 padded columns + zero tail
constexpr int PROWS = 3;                  // padded rows y .. y + 2
constexpr int SHIFTS = 9;
constexpr int KTOT = SHIFTS * CH;         // 432
constexpr int MROWS = 64;                 // 56 tokens of one row, in 4 m16 tiles
constexpr int WN = 2;                     // warps across the columns
constexpr int WARPS = (MROWS / 16) * WN;  // 8: 16 rows by NT / 2 columns each
constexpr int THREADS = WARPS * 32;
constexpr float FEATURES = 147.0f;        // 3 x 7 x 7 unfold features
constexpr int A_ELEMS = PROWS * PCOLS * CS;
constexpr int A_BYTES = A_ELEMS * 2;
constexpr int VEC_PER_ROW = IMG / 8;      // 16-byte vectors per image row
static_assert(A_BYTES % 16 == 0, "16-byte aligned regions");

// A block of NT columns (64 or 96): the W9 slice's row stride (144 or 208
// bytes), a warp's columns, its patch's row stride (80 or 112 bytes; all
// odd multiples of 16), and the dynamic shared memory: the W9 slice, the
// staged rows, the mask, the per-token statistics and the warps' patches.
// ops/cuda/t2t_stage1.py:_smem_bytes mirrors it.
__host__ __device__ constexpr int w_stride(int nt) { return nt + 8; }
__host__ __device__ constexpr int p_stride(int nt) { return nt / WN + 8; }
__host__ __device__ constexpr int smem_bytes(int nt) {
  return KTOT * w_stride(nt) * 2 + A_BYTES + (KTOT + 2 * MROWS) * 4 + WARPS * 16 * p_stride(nt) * 2;
}

// 8-byte asynchronous copy global -> shared (through L1).
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

template <int NT, class T>
__global__ __launch_bounds__(THREADS, 2) void t2t_stage1_kernel(
    const T* __restrict__ img, const T* __restrict__ W9, const float* __restrict__ M9,
    const float* __restrict__ c1, const float* __restrict__ c2, T* __restrict__ out, int d,
    float eps) {
  constexpr int WS = w_stride(NT), WC = NT / WN, PLD = p_stride(NT);
  constexpr int W_BYTES = KTOT * WS * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sW = reinterpret_cast<T*>(smem);                          // [432][WS]
  T* sA = reinterpret_cast<T*>(smem + W_BYTES);                // [3][66][CS]
  float* sM = reinterpret_cast<float*>(smem + W_BYTES + A_BYTES);  // [432]
  float* sMu = sM + KTOT;                                      // [64]
  float* sRs = sMu + MROWS;                                    // [64]
  T* sP = reinterpret_cast<T*>(sRs + MROWS);                   // [WARPS][16][PLD]

  const int y = blockIdx.x, n0 = blockIdx.y * NT, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Padded row prow holds s2d row iy = y + prow - 1; its cell (ix, c*16 + phy*4 +
  // phx) is pixel (c, 4*iy + phy, 4*ix + phx), stored at column ix + 1.  One
  // 16-byte vector of an image row is 8 pixels: two cells' 4 phases, copied as
  // two 8-byte halves.  Group 0: the rows.
  const T* im = img + static_cast<size_t>(b) * 3 * IMG * IMG;
  for (int i = tid; i < PROWS * 12 * VEC_PER_ROW; i += THREADS) {
    const int prow = i / (12 * VEC_PER_ROW), rem = i % (12 * VEC_PER_ROW);
    const int cp = rem / VEC_PER_ROW, j = rem % VEC_PER_ROW;
    const int iy = y + prow - 1;
    if (iy < 0 || iy >= GRID) continue;  // the zero padding rows
    const int c = cp >> 2, phy = cp & 3;
    const T* src = im + (static_cast<size_t>(c) * IMG + iy * 4 + phy) * IMG + j * 8;
    T* dst = sA + (prow * PCOLS + 2 * j + 1) * CS + c * 16 + phy * 4;
    cp_async8(dst, src);
    cp_async8(dst + CS, src + 4);
  }
  cp_async_commit();
  // Group 1: W9's column slice n0 .. n0 + 63, zeros past d.
  for (int i = tid; i < KTOT * (NT / 8); i += THREADS) {
    const int r = i / (NT / 8), c = (i % (NT / 8)) * 8;
    const bool ok = n0 + c < d;
    cp_async16(sW + r * WS + c, ok ? W9 + static_cast<size_t>(r) * d + n0 + c : W9, ok);
  }
  cp_async_commit();

  // Zeros where no copy lands: every cell of a padding row, the padding
  // columns 0 and 57..65 of the others (channels 0..47; 48..55 are never read).
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < PROWS * PCOLS * (CH / 8); i += THREADS) {
    const int cell = i / (CH / 8), v = i % (CH / 8);
    const int prow = cell / PCOLS, col = cell % PCOLS, iy = y + prow - 1;
    if (iy < 0 || iy >= GRID || col == 0 || col > GRID)
      reinterpret_cast<uint4*>(sA + cell * CS)[v] = zero;
  }
  for (int i = tid; i < KTOT; i += THREADS) sM[i] = M9[i];
  if (tid < MROWS - GRID) sMu[GRID + tid] = sRs[GRID + tid] = 0.0f;  // the tile's pad rows
  cp_async_wait<1>();
  __syncthreads();  // the staged rows, zeros and mask are in place (W9 may still fly)

  // LN statistics of token x over the 147 masked columns: 4 lanes per token.
  // 224 is a multiple of 32, so every warp of the loop runs whole.  Rounded
  // as the twin rounds: no contraction into FMAs.
  for (int t = tid; t < GRID * 4; t += THREADS) {
    const int x = t >> 2, part = t & 3;
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int s = 0; s < SHIFTS; ++s) {  // k = s * 48 + part + c: part, part + 4, ... in order
      const T* row = sA + ((s / 3) * PCOLS + x + s % 3) * CS + part;
      const float* mask = sM + s * CH + part;
#pragma unroll
      for (int c = 0; c < CH; c += 4) {
        const float v = Elem<T>::to_float(row[c]), m = mask[c];
        s1 = __fadd_rn(s1, __fmul_rn(v, m));
        s2 = __fadd_rn(s2, __fmul_rn(__fmul_rn(v, v), m));
      }
    }
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
    if (part == 0) {
      const float mu = __fdiv_rn(s1, FEATURES), sq = __fdiv_rn(s2, FEATURES);
      sMu[x] = mu;
      sRs[x] = rsqrtf(__fadd_rn(__fsub_rn(sq, __fmul_rn(mu, mu)), eps));
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // W9's slice landed; every token's statistics are in place

  // out = big @ W9: K over the 9 shifts, 3 k16 steps each, in order.
  const int wm = (warp / WN) * 16, wn = (warp % WN) * WC;
  if (n0 + wn >= d) return;  // a warp wholly past d (d < 64)
  float acc[WC / 8][4];
#pragma unroll
  for (int j = 0; j < WC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll 1
  for (int s = 0; s < SHIFTS; ++s) {
    const T* a = sA + ((s / 3) * PCOLS + s % 3 + wm + (lane & 15)) * CS + (lane >> 4) * 8;
    const T* w = sW + (s * CH + (lane & 15)) * WS + wn + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < CH; kk += 16) {
      uint32_t fa[4];
      ldsm_x4(fa, a + kk);
#pragma unroll
      for (int np = 0; np < WC / 16; ++np) {
        uint32_t fb[4];
        ldsm_x4_trans(fb, w + kk * WS + np * 16);
        mma16<T>(acc[2 * np], fa, fb[0], fb[1]);
        mma16<T>(acc[2 * np + 1], fa, fb[2], fb[3]);
      }
    }
  }

  // Thread (g, t) holds rows g, g + 8 and columns 2t, 2t + 1 of each n8 tile.
  const int g = lane >> 2, t = lane & 3;
  T* patch = sP + warp * 16 * PLD;
#pragma unroll
  for (int j = 0; j < WC / 8; ++j) {
    const int c = j * 8 + 2 * t, gn = n0 + wn + c;  // d % 16 == 0: a pair is all in or out
    const float2 k1 = gn < d ? *reinterpret_cast<const float2*>(c1 + gn) : make_float2(0.f, 0.f);
    const float2 k2 = gn < d ? *reinterpret_cast<const float2*>(c2 + gn) : make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      const float mu = sMu[wm + r], rs = sRs[wm + r];
      const float y0 =
          __fadd_rn(__fmul_rn(__fsub_rn(acc[j][2 * h], __fmul_rn(mu, k1.x)), rs), k2.x);
      const float y1 =
          __fadd_rn(__fmul_rn(__fsub_rn(acc[j][2 * h + 1], __fmul_rn(mu, k1.y)), rs), k2.y);
      *reinterpret_cast<uint32_t*>(patch + r * PLD + c) = pack2<T>(y0, y1);
    }
  }
  __syncwarp();
  T* o = out + (static_cast<size_t>(b) * GRID * GRID + static_cast<size_t>(y) * GRID) * d;
  for (int i = lane; i < 16 * (WC / 8); i += 32) {
    const int r = i / (WC / 8), c = (i % (WC / 8)) * 8;
    if (wm + r < GRID && n0 + wn + c < d)
      *reinterpret_cast<uint4*>(o + static_cast<size_t>(wm + r) * d + n0 + wn + c) =
          *reinterpret_cast<const uint4*>(patch + r * PLD + c);
  }
}

template <int NT>
int launch(const void* img, const void* w9, const void* m9, const void* c1, const void* c2,
           void* out, int batch, int d, float eps, void* stream) {
  constexpr int BYTES = smem_bytes(NT);
  static_assert(BYTES <= 232448, "the block must fit in shared memory");
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        t2t_stage1_kernel<NT, elem>, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(GRID, (d + NT - 1) / NT, batch);
  t2t_stage1_kernel<NT, elem><<<grid, THREADS, BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const elem*>(img), static_cast<const elem*>(w9), static_cast<const float*>(m9),
      static_cast<const float*>(c1), static_cast<const float*>(c2), static_cast<elem*>(out), d,
      eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img [batch, 3, 224, 224], w9 [432, d] bf16 (fp16 in the fp16 instance); m9
// [432], c1, c2 [d] fp32; out [batch, 3136, d] bf16 (fp16). cols: the columns
// a block takes (64 or 96; the plan of ops/cuda/t2t_stage1.py:stage1_plan).
extern "C" int EVT_EXPORT(evt_t2t_stage1)(const void* img, const void* w9, const void* m9,
                                          const void* c1, const void* c2, void* out, int batch,
                                          int d, float eps, int cols, void* stream) {
  if (d < 16 || d > 256 || d % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  switch (cols) {
    case 64: return launch<64>(img, w9, m9, c1, c2, out, batch, d, eps, stream);
    case 96: return launch<96>(img, w9, m9, c1, c2, out, batch, d, eps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
