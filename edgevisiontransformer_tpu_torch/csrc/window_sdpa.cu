// window_sdpa: multi-head attention within Swin windows, on window-major
// tokens, with the relative-position bias and the shifted-window mask: the
// attention core of the Swin module's kernel_mode="pallas" forward.
//
// Replaces: `_win_attn_kernel` / `window_sdpa` (K12) in
//   edgevisiontransformer_tpu/ops/pallas/window_attention.py:26-121.
//
// Input qkv is [windows, n, 3 * heads * HD] bf16 (the module's Dense qkv
// output, columns ordered (qkv, head, hd)); bias [heads, n, n] bf16 (the
// module passes it in the compute dtype); mask [mask_windows, n, n] fp32 or
// null, window j taking mask[j % mask_windows] (K12's jnp.tile over the
// images).  Output [windows, n, heads * HD] bf16.  Per (window, head), with
// K12's math, which is not K9's:
//   s = f32(q . k) * hd^-1/2 + f32(bias[h]) (+ f32(bf16(mask[j % nW])))
//   p = exp(s - max_row s) / sum_row exp(s - max_row s)     (fp32, normalised)
//   o = bf16(f32(bf16(p) @ v))
// The scale multiplies the fp32 score (the module's XLA path scales q in the
// compute dtype first); K12's wrapper casts the tiled mask to the compute
// dtype, which the kernel does as it reads it (-100 and 0 are exact in bf16).
// Keys past n are left out of the max and the sum (K12's -1e30 gives them
// p = 0 exactly).  Each step rounds as the reference does (__fmul_rn /
// __fadd_rn / __fsub_rn, and a division that gives __fdiv_rn's quotient), so
// nvcc contracts nothing into an FMA.
//
// Bound on the card: a swin_tiny window does 4 * n^2 * HD = 0.3 MFLOP per
// head on 3 * n * HD * 2 = 9.4 KB of q, k, v (HD 32, n 49): ~33 flop/byte,
// far below the H100's ~295 flop/byte balance point, so bytes bound it: qkv
// read once and the output written once, the bias and mask once.  In
// practice each block's chain of loads, products and softmax decides the
// time (bench/window_sdpa_ab.py).
//
// Design (bench/window_sdpa_ab.py times its choices; PERF.md section 6 has
// the numbers):
// - One block of 4 warps per (window, head).  Each block's chain of loads,
//   products and softmax is the time, so more, shorter blocks in flight beat
//   fewer, longer ones: blocks that walk several heads of a window in turn
//   (the next head's loads under this one's arithmetic, the mask tile loaded
//   once) measured slower at every swin_tiny shape at b1 and at most at b32.
// - q, k and v arrive by cp.async, zero-filled past n: q and k of the
//   window's n tokens with the head's bias tile in a first group, v in a
//   second, landing while Q K^T and the softmax run (load_rows of
//   attn_tiles.cuh, rows 3 * heads * HD apart).  The n x n bias tile, whose
//   rows have the odd length n, is copied as one flat run of 16-byte chunks
//   from the 16-byte boundary at or below its start (load_bias).  A shifted
//   window's fp32 mask is read element by element from L2 where the scores
//   need it: staging its tile too (9.4 KB at n = 49) measured no faster at
//   any swin_tiny shape and slower at b1's shifted stages, where it holds
//   every block's first wait.
// - Scores in registers: each warp owns 16 query rows (the warps walk the
//   window's ceil(n / 16) strips in rounds); Q K^T runs on
//   mma.sync.m16n8k16 (qk of attn_tiles.cuh) over NC 16-key chunks, NC = 4
//   (n <= 64, windows up to 8) or 9 (n <= 144, windows up to 12), the fewest
//   that hold n.  Scale, bias and mask act on the accumulators in place;
//   the row max and sum live in the 4 lanes of a quad (two shuffles each);
//   p, packed to bf16x2, is PV's A fragment (pv).  No score and no p goes
//   through shared memory.  O leaves through the warp's own Q rows as
//   16-byte stores (store_rows).
// - The division (divide_exact) gives the correctly rounded e / l, the
//   value of __fdiv_rn(e, l), for every e in [0, 1] and l in [1, 2^9), by
//   the same instructions for every score: a subnormal e (a shifted
//   window's -100 mask) costs what any other does, where __fdiv_rn leaves
//   its fast path for it (with __fdiv_rn, a shifted launch took 2.5x an
//   unshifted one).
// - Every (window, head) runs the same instructions whatever the batch, so
//   a window's output is the same bits alone and in a batch.
#include <math.h>

#include "attn_tiles.cuh"

namespace {

constexpr int WARPS = 4, THREADS = WARPS * 32;

// bf16 elements the staged n x n bias tile takes: its n * n values from the
// 16-byte boundary at or below its start, in whole 16-byte chunks.
__host__ __device__ constexpr int bias_elems(int n) { return (7 + n * n + 7) / 8 * 8; }

// 16-byte cp.async of which only the first `bytes` (0-16) are read, the
// rest zero-filled.
__device__ __forceinline__ void cp_async_bytes(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

// The n x n tile that starts at element e0 of `bias` into dst by cp.async
// (not waited for): element (q, c) lands at dst[e0 % 8 + q * n + c].
__device__ __forceinline__ void load_bias(bf16* dst, const bf16* __restrict__ bias, long long e0,
                                          int n, int tid) {
  const long long a0 = e0 - e0 % 8, end = e0 + static_cast<long long>(n) * n;
  for (int i = tid; i < bias_elems(n) / 8; i += THREADS) {
    const long long from = a0 + static_cast<long long>(i) * 8;
    const long long left = end - from;
    const int bytes = left >= 8 ? 16 : (left > 0 ? static_cast<int>(left) * 2 : 0);
    cp_async_bytes(dst + i * 8, bytes > 0 ? bias + from : bias, bytes);
  }
}

// p = e / l correctly rounded, the value of __fdiv_rn(e, l), for e in [0, 1]
// and l in [1, 2^9), given y = __frcp_rn(l) (one per row).  sdpa.cu's
// normalise (two corrections of e * y, the last Markstein's) is exact only
// while e / l >= 2^-101; so it runs on es = e * 2^64 (exact), whose
// quotient q = RN(es / l) stays above 2^-93 for any e > 0.  Where q >=
// 2^-62 the quotient is normal and q * 2^-64 is exact.  Below, e / l is
// subnormal: q * 2^85 = t counts units of 2^-149 and is rounded to an
// integer, ties to even unless the exact remainder es - l q (one FMA) says
// on which side of the tie es / l lies.  Twenty fp32 operations a score,
// the same for every e (tests/test_torch_window_sdpa_tiles.py checks this
// arithmetic against the exact quotient over the fp32 range).
__device__ __forceinline__ float divide_exact(float e, float l, float y) {
  const float es = __fmul_rn(e, 0x1p64f);
  float q = __fmul_rn(es, y);
  q = __fmaf_rn(__fmaf_rn(-l, q, es), y, q);
  q = __fmaf_rn(__fmaf_rn(-l, q, es), y, q);
  const float r = __fmaf_rn(-l, q, es);
  const float t = __fmul_rn(q, 0x1p85f);
  float i = rintf(t);
  const float d = __fsub_rn(t, i);
  if (d == 0.5f && r > 0.0f) i = __fadd_rn(i, 1.0f);
  if (d == -0.5f && r < 0.0f) i = __fsub_rn(i, 1.0f);
  return q >= 0x1p-62f ? __fmul_rn(q, 0x1p-64f) : __fmul_rn(i, 0x1p-149f);
}

// In place over the scores of the strip at row0: s = f32(q . k) * scale +
// f32(bias) (+ f32(bf16(mask))), -inf for a key at or past n (whose bias
// and mask are never read); m[0] / m[1] become the row max of rows g / g +
// 8, quad-reduced.  eb (shared memory) and em (L2) point at their tile's
// element (0, 0); rows past n read row n - 1 (never stored).
template <int NC, bool MASK>
__device__ __forceinline__ void scores(float (&s)[NC][2][4], const bf16* eb, const float* em,
                                       int row0, int n, float scale, int lane, float m[2]) {
  const int g = lane >> 2, t = lane & 3;
  const int at[2] = {min(row0 + g, n - 1) * n, min(row0 + g + 8, n - 1) * n};
  m[0] = m[1] = -INFINITY;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int r = (e % 4) / 2, key = c * 16 + (e / 4) * 8 + 2 * t + (e & 1);
      float& x = s[c][e / 4][e % 4];
      if (key < n) {
        x = __fadd_rn(__fmul_rn(x, scale), __bfloat162float(eb[at[r] + key]));
        if (MASK) x = __fadd_rn(x, round_bf16(em[at[r] + key]));
      } else {
        x = -INFINITY;
      }
      m[r] = fmaxf(m[r], x);
    }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
}

// In place, s becomes p = exp(s - m) / l with l the fp32 row sum of the
// unrounded exp (0 for a key past n: exp(-inf) = 0).
template <int NC>
__device__ __forceinline__ void softmax_rows(float (&s)[NC][2][4], const float m[2]) {
  float l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float& x = s[c][e / 4][e % 4];
      x = expf(__fsub_rn(x, m[(e % 4) / 2]));
      l[(e % 4) / 2] = __fadd_rn(l[(e % 4) / 2], x);
    }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  const float y[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float& x = s[c][e / 4][e % 4];
      x = divide_exact(x, l[(e % 4) / 2], y[(e % 4) / 2]);
    }
}

// Dynamic shared memory: q, k, v (16 NC rows each), then the bias tile.
template <int HD, int NC, bool MASK>
__global__ __launch_bounds__(THREADS) void window_sdpa_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ bias, const float* __restrict__ mask,
    bf16* __restrict__ out, int n, int heads, int mask_windows, float scale) {
  constexpr int LD = row_ld(HD), ROWS = 16 * NC;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + ROWS * LD;
  bf16* sV = sK + ROWS * LD;
  bf16* sB = sV + ROWS * LD;

  const int win = blockIdx.x, head = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long ld = 3LL * heads * HD, ldo = static_cast<long long>(heads) * HD;
  const long long nn = static_cast<long long>(n) * n, b0 = head * nn;
  const long long m0 = MASK ? (win % mask_windows) * nn : 0;
  const bf16* wq = qkv + static_cast<long long>(win) * n * ld + head * HD;
  bf16* op = out + static_cast<long long>(win) * n * ldo + head * HD;

  load_rows<HD, THREADS>(sQ, wq, ld, 0, ROWS, n, tid);
  load_rows<HD, THREADS>(sK, wq + heads * HD, ld, 0, ROWS, n, tid);
  load_bias(sB, bias, b0, n, tid);
  cp_async_commit();  // group 0: q, k and the bias tile
  load_rows<HD, THREADS>(sV, wq + 2 * heads * HD, ld, 0, ROWS, n, tid);
  cp_async_commit();  // group 1: v, landing while q k^T and the softmax run
  cp_async_wait<1>();
  __syncthreads();
  const bf16* eb = sB + b0 % 8;
  const float* em = mask + m0;
  const int strips = (n + 15) / 16;
  // in rounds of one strip a warp, so that every warp meets the barrier
  for (int first = 0; first < strips; first += WARPS) {
    const int strip = first + warp;
    float s[NC][2][4];
    if (strip < strips) {
      float m[2];
      qk<HD, NC>(s, sQ + strip * 16 * LD, sK, lane);
      scores<NC, MASK>(s, eb, em, strip * 16, n, scale, lane, m);
      softmax_rows<NC>(s, m);
    }
    if (first == 0) {
      cp_async_wait<0>();
      __syncthreads();  // v landed
    }
    if (strip < strips) {
      float o[HD / 8][4];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
      pv<HD, NC>(o, s, sV, lane);
      store_rows<HD>(o, sQ + strip * 16 * LD, op, ldo, strip * 16, n, lane);
    }
  }
}

template <int HD, int NC>
constexpr int smem_bytes(int n) {
  return 3 * 16 * NC * row_ld(HD) * 2 + bias_elems(n) * 2;
}

template <int HD, int NC, bool MASK>
int launch(const void* qkv, const void* bias, const void* mask, void* out, int windows, int n,
           int heads, int mask_windows, float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {  // the most an instance asks for: n = 16 NC
    const cudaError_t e = cudaFuncSetAttribute(window_sdpa_kernel<HD, NC, MASK>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem_bytes<HD, NC>(16 * NC));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(windows, heads);
  window_sdpa_kernel<HD, NC, MASK><<<grid, THREADS, smem_bytes<HD, NC>(n), stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
      static_cast<const float*>(mask), static_cast<bf16*>(out), n, heads, mask_windows, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int NC>
int launch_mask(const void* qkv, const void* bias, const void* mask, void* out, int windows,
                int n, int heads, int mask_windows, float scale, cudaStream_t s) {
  if (mask != nullptr)
    return launch<HD, NC, true>(qkv, bias, mask, out, windows, n, heads, mask_windows, scale, s);
  return launch<HD, NC, false>(qkv, bias, mask, out, windows, n, heads, mask_windows, scale, s);
}

// The fewest 16-key chunks that hold n: 4 (windows up to 8) or 9 (up to 12).
template <int HD>
int launch_chunks(const void* qkv, const void* bias, const void* mask, void* out, int windows,
                  int n, int heads, int mask_windows, float scale, cudaStream_t s) {
  if (n <= 64)
    return launch_mask<HD, 4>(qkv, bias, mask, out, windows, n, heads, mask_windows, scale, s);
  return launch_mask<HD, 9>(qkv, bias, mask, out, windows, n, heads, mask_windows, scale, s);
}

}  // namespace

// qkv [windows, n, 3 * heads * head_dim], bias [heads, n, n], out [windows,
// n, heads * head_dim] bf16, mask [mask_windows, n, n] fp32 or null, all
// 16-byte aligned.
extern "C" int evt_window_sdpa(const void* qkv, const void* bias, const void* mask, void* out,
                               int windows, int n, int heads, int head_dim, int mask_windows,
                               float scale, void* stream) {
  if (windows == 0) return 0;
  if (windows < 0 || n <= 0 || n > 144 || heads <= 0 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mask != nullptr && (mask_windows <= 0 || windows % mask_windows != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_chunks<32>(qkv, bias, mask, out, windows, n, heads, mask_windows, scale, s);
    case 64:
      return launch_chunks<64>(qkv, bias, mask, out, windows, n, heads, mask_windows, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
