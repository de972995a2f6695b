// window_attention: shifted-window multi-head attention of a Swin block,
// reading and writing token-major rows in image raster order: the attention
// of the Swin chain (ops/cuda/swin_block.py).
//
// Replaces: the attention step of the TPU Swin kernels in
//   edgevisiontransformer_tpu/ops/pallas/swin_block.py:
//   `_swin_stage_kernel_pipelined` (K9, :334-569, attention :454-481, the
//   roll + partition bracket `permute` :383-426 and :531-535),
//   `_swin_block_kernel` (K11a, :99-168) and `_swin_block_kernel_blocked`
//   (K11b, :171-251), with `common.softmax_unnorm` (nomax, clamp 60).
//
// Input qkv is [b * res * res, 3 * heads * HD] bf16, columns ordered
// (qkv, head, hd); output is the merged [b * res * res, heads * HD] bf16.
// Window (wy, wx), token t = (ty, tx) of the image rolled by -shift reads
// the row of pixel ((wy*w + ty + shift) % res, (wx*w + tx + shift) % res)
// and writes its output row back to that pixel: that is jnp.roll(-shift),
// window_partition, attention, window_reverse and jnp.roll(+shift), with no
// permutation pass.  Per (image, window, head), in fp32, K9's math:
//   s = (q . k) * hd^-1/2 * log2(e) + bias[h] (+ mask[window], shifted blocks)
//   p = exp2(min(s, 60)) over the n = w*w keys, r = max(sum p, 1e-30)
//   o = bf16(f32(bf16(p) @ v) * (1 / r)), 1 / r exact, one a row
// The fp16 instance (build.py's -DEVT_F16 compile) takes softmax_unnorm's
// float16 branch: p = exp2(s - max s) over the n keys, no clamp, r = sum p,
// from the scores in registers (the row max is one more pass over them).
// bias [heads, n, n] and mask [nW, n, n] come pre-scaled by log2(e), as
// K9's kernel-ready bias does.  The score is rounded after the product and
// again after each add (__fmul_rn / __fadd_rn), in the reference's order,
// so nvcc contracts nothing into an FMA.  r sums the unrounded p.
//
// Bound on the card: a swin_tiny window does 4 * n^2 * HD = 0.3 MFLOP per
// head on 3 * n * HD * 2 = 9.4 KB of q, k, v (HD 32, n 49): ~33 flop/byte,
// far below the H100's ~295 flop/byte balance point, so bytes bound it:
// qkv read once and the output written once (stage 0, b1: 2.4 MB, ~0.7 us
// at 3.35 TB/s).  The bias and mask (9.6 KB per head or window at n = 49)
// are read by every image and stay in L2.  In practice each block's chain
// of loads, products and softmax decides the time
// (bench/window_attention_ab.py).
//
// Design (bench/window_attention_ab.py times its choices; PERF.md section 6
// has the numbers), on the mma.sync routines of attn_tiles.cuh, as
// window_sdpa.cu (K12):
// - One block of 4 warps per (window, head, image): more, shorter blocks
//   in flight beat blocks that walk several heads (window_sdpa.cu's A/B),
//   and a window's blocks do not depend on the batch.
// - The gather: the block computes its window tokens' pixel rows once
//   (sRow), and q, k and v arrive from those rows by cp.async
//   (load_rows_gather), zero-filled past n: q and k in a first group, v in
//   a second, landing while Q K^T and the softmax run.
// - Scores in registers: each warp owns 16 query rows (the warps walk the
//   window's ceil(n / 16) strips in rounds); Q K^T runs on
//   mma.sync.m16n8k16 (qk) over NC 16-key chunks, NC = 4 (n <= 64, windows
//   up to 8) or 9 (n <= 144, windows up to 12), the fewest that hold n.
//   Scale, bias, mask, the clamp and exp2 act on the accumulators in place
//   (probs); the row sum runs per thread in key order, then over the 4
//   lanes of a quad (quad_sum); p, packed to bf16x2, is PV's A fragment
//   (pv).  No score and no p goes through shared memory.
// - A shifted window's fp32 mask is read element by element from L2 where
//   the scores need it, and so is the fp32 bias of an unshifted block.
//   Where the block reads the mask, the bias tile (9.6 KB at n = 49, 81 KB
//   at n = 144) is staged in shared memory by cp.async with q and k
//   instead, as one flat run of 16-byte chunks from the boundary at or
//   below its start (load_tile): with both read from L2, a shifted launch
//   took 1.8x an unshifted one (swin_tiny b1 stage 0: 9.5-9.9 against
//   5.2-5.3 us), and staging the bias brought it to 5.7; staging it for an
//   unshifted block measured slower at every shape (at window 12, 36
//   against 19 us: the tile leaves room for one block an SM).  The bits do
//   not depend on where the bias is read (stage_bias).
// - The store: O * (1 / r) in fp32 from the accumulators, packed to bf16,
//   leaves through the warp's own Q rows to the pixel row its query came
//   from, as 16-byte stores (store_rows_scatter).
// - Every (window, head, image) runs the same instructions whatever the
//   batch, so a window's output is the same bits alone and in a batch.
#include <math.h>

#include "attn_tiles.cuh"

namespace {

constexpr int WARPS = 4, THREADS = WARPS * 32;
constexpr float kClamp = 60.0f;
// Where the scores read the fp32 bias: true, from its n x n tile staged in
// shared memory by cp.async with q and k; false, from L2, element by
// element.  Staged where the block also reads a shifted window's mask.
template <bool MASK>
__host__ __device__ constexpr bool stage_bias() { return MASK; }

// In place over the scores of the strip at row0: p = exp2(min(s * scale2 +
// bias (+ mask), 60)) for a key below n, or with ROW_MAX p = exp2(s - m)
// with m the row's max over its n keys, 0 for a key at or past n (whose
// bias and mask are never read); l[0] / l[1] become the fp32 sums of rows g
// / g + 8 over the unrounded p.  eb and em point at their tile's element
// (0, 0); rows past n read row n - 1 (never stored).
template <int NC, bool MASK, bool ROW_MAX>
__device__ __forceinline__ void probs(float (&s)[NC][2][4], const float* eb, const float* em,
                                      int row0, int n, float scale2, int lane, float (&l)[2]) {
  const int g = lane >> 2, t = lane & 3;
  const int at[2] = {min(row0 + g, n - 1) * n, min(row0 + g + 8, n - 1) * n};
  l[0] = l[1] = 0.0f;
  if constexpr (ROW_MAX) {
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = (e % 4) / 2, key = c * 16 + (e / 4) * 8 + 2 * t + (e & 1);
        float& x = s[c][e / 4][e % 4];
        if (key < n) {
          x = __fadd_rn(__fmul_rn(x, scale2), eb[at[r] + key]);
          if (MASK) x = __fadd_rn(x, em[at[r] + key]);
          m[r] = fmaxf(m[r], x);
        }
      }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = (e % 4) / 2, key = c * 16 + (e / 4) * 8 + 2 * t + (e & 1);
        float& x = s[c][e / 4][e % 4];
        x = key < n ? exp2f(__fsub_rn(x, m[r])) : 0.0f;
        l[r] = __fadd_rn(l[r], x);
      }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    return;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int r = (e % 4) / 2, key = c * 16 + (e / 4) * 8 + 2 * t + (e & 1);
      float& x = s[c][e / 4][e % 4];
      if (key < n) {
        x = __fadd_rn(__fmul_rn(x, scale2), eb[at[r] + key]);
        if (MASK) x = __fadd_rn(x, em[at[r] + key]);
        x = exp2f(fminf(x, kClamp));
      } else {
        x = 0.0f;
      }
      l[r] = __fadd_rn(l[r], x);
    }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
}

// Dynamic shared memory: q, k, v (16 NC rows each), then the staged bias
// tile (stage_bias).
template <int HD, int NC, bool MASK, class T>
__global__ __launch_bounds__(THREADS) void window_attention_kernel(
    const T* __restrict__ qkv, const float* __restrict__ bias, const float* __restrict__ mask,
    T* __restrict__ out, int res, int w, int shift, int heads, float scale2) {
  constexpr int LD = row_ld(HD), ROWS = 16 * NC;
  constexpr bool STAGE = stage_bias<MASK>();
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + ROWS * LD;
  T* sV = sK + ROWS * LD;
  float* sB = reinterpret_cast<float*>(sV + ROWS * LD);
  __shared__ int sRow[ROWS];  // the pixel row of each window token

  const int win = blockIdx.x, head = blockIdx.y, img = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = w * w, nwx = res / w;
  const int wy = win / nwx, wx = win % nwx;
  const long long ld = 3LL * heads * HD, ldo = static_cast<long long>(heads) * HD;
  const long long nn = static_cast<long long>(n) * n;
  const long long row0 = static_cast<long long>(img) * res * res;  // the image's first row

  for (int t = tid; t < n; t += THREADS)
    sRow[t] = ((wy * w + t / w + shift) % res) * res + (wx * w + t % w + shift) % res;
  __syncthreads();
  const T* ip = qkv + row0 * ld + head * HD;
  load_rows_gather<HD, THREADS>(sQ, ip, sRow, ld, ROWS, n, tid);
  load_rows_gather<HD, THREADS>(sK, ip + heads * HD, sRow, ld, ROWS, n, tid);
  if (STAGE) load_tile<float, THREADS>(sB, bias, head * nn, n, tid);
  cp_async_commit();  // group 0: q and k (and the bias tile)
  load_rows_gather<HD, THREADS>(sV, ip + 2 * heads * HD, sRow, ld, ROWS, n, tid);
  cp_async_commit();  // group 1: v, landing while q k^T and the softmax run
  cp_async_wait<1>();
  __syncthreads();
  const float* eb = STAGE ? sB + head * nn % 4 : bias + head * nn;
  const float* em = MASK ? mask + win * nn : nullptr;
  T* op = out + row0 * ldo + head * HD;
  const int strips = (n + 15) / 16;
  // in rounds of one strip a warp, so that every warp meets the barrier
  for (int first = 0; first < strips; first += WARPS) {
    const int strip = first + warp;
    float s[NC][2][4], l[2];
    if (strip < strips) {
      qk<HD, NC>(s, sQ + strip * 16 * LD, sK, lane);
      probs<NC, MASK, Elem<T>::row_max>(s, eb, em, strip * 16, n, scale2, lane, l);
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
      const float inv[2] = {1.0f / fmaxf(l[0], 1e-30f), 1.0f / fmaxf(l[1], 1e-30f)};
      store_rows_scatter<HD>(o, inv, sQ + strip * 16 * LD, op, ldo, sRow, strip * 16, n, lane);
    }
  }
}

template <int HD, int NC, bool MASK>
constexpr int smem_bytes(int n) {
  return 3 * 16 * NC * row_ld(HD) * 2 + (stage_bias<MASK>() ? tile_elems<float>(n) * 4 : 0);
}

template <int HD, int NC, bool MASK>
int launch(const void* qkv, const void* bias, const void* mask, void* out, int batch, int res,
           int w, int shift, int heads, float scale2, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {  // the most an instance asks for: n = 16 NC
    const cudaError_t e = cudaFuncSetAttribute(window_attention_kernel<HD, NC, MASK, elem>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem_bytes<HD, NC, MASK>(16 * NC));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int nwx = res / w;
  const dim3 grid(nwx * nwx, heads, batch);
  window_attention_kernel<HD, NC, MASK, elem>
      <<<grid, THREADS, smem_bytes<HD, NC, MASK>(w * w), stream>>>(
      static_cast<const elem*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<elem*>(out), res, w, shift, heads, scale2);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int NC>
int launch_mask(const void* qkv, const void* bias, const void* mask, void* out, int batch,
                int res, int w, int shift, int heads, float scale2, cudaStream_t s) {
  if (mask != nullptr)
    return launch<HD, NC, true>(qkv, bias, mask, out, batch, res, w, shift, heads, scale2, s);
  return launch<HD, NC, false>(qkv, bias, mask, out, batch, res, w, shift, heads, scale2, s);
}

// The fewest 16-key chunks that hold n: 4 (windows up to 8) or 9 (up to 12).
template <int HD>
int launch_chunks(const void* qkv, const void* bias, const void* mask, void* out, int batch,
                  int res, int w, int shift, int heads, float scale2, cudaStream_t s) {
  if (w * w <= 64)
    return launch_mask<HD, 4>(qkv, bias, mask, out, batch, res, w, shift, heads, scale2, s);
  return launch_mask<HD, 9>(qkv, bias, mask, out, batch, res, w, shift, heads, scale2, s);
}

}  // namespace

// qkv [batch * res * res, 3 * heads * head_dim], out [batch * res * res,
// heads * head_dim] bf16 (fp16 in the fp16 instance), bias [heads, n, n]
// and mask [(res / w)^2, n, n] fp32 (mask null for an unshifted block), all
// 16-byte aligned.
extern "C" int EVT_EXPORT(evt_window_attention)(const void* qkv, const void* bias,
                                                const void* mask, void* out, int batch, int res,
                                                int w, int shift, int heads, int head_dim,
                                                float scale2, void* stream) {
  if (batch == 0) return 0;
  if (batch < 0 || batch > 65535 || heads <= 0 || heads > 65535 || w <= 0 || w * w > 144 ||
      res <= 0 || res % w != 0 || shift < 0 || shift >= w)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_chunks<32>(qkv, bias, mask, out, batch, res, w, shift, heads, scale2, s);
    case 64:
      return launch_chunks<64>(qkv, bias, mask, out, batch, res, w, shift, heads, scale2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
