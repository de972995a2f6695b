// window_attention: shifted-window multi-head attention of a Swin block,
// reading and writing token-major rows in image raster order.
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
// permutation pass.  Per (image, window, head), in fp32:
//   s = (q . k) * hd^-1/2 * log2(e) + bias[h] (+ mask[window], shifted blocks)
//   p = exp2(min(s, 60)) over the n = w*w keys, r = max(sum p, 1e-30)
//   o = bf16((bf16(p) @ v) * (1 / r))
// bias [heads, n, n] and mask [nW, n, n] come pre-scaled by log2(e), as
// K9's kernel-ready bias does.  The score is rounded after the product and
// again after each add (__fmul_rn / __fadd_rn), in the reference's order,
// so nvcc contracts nothing into an FMA.
//
// Bound on the card: a swin_tiny window does 4 * n^2 * HD = 0.3 MFLOP per
// head on 3 * n * HD * 2 = 9.4 KB of q, k, v (HD 32, n 49): ~33 flop/byte,
// far below the H100's ~295 flop/byte balance point, so bytes bound it:
// qkv read once and the output written once (stage 0, b1: 2.4 MB, ~0.7 us
// at 3.35 TB/s).  The bias and mask (9.6 KB per head or window) are read
// by every image and stay in L2.
//
// Design (simple first): one thread block of 4 warps per (window, head,
// image), each warp owning 16 of the 64 query rows.  The n <= 64 tokens'
// q, k and v are gathered into shared memory with 16-byte loads, padded to
// 64 rows with zeros; S = q k^T and O = bf16(p) v run on WMMA 16x16x16 bf16
// fragments with fp32 accumulation; keys >= n get p = 0.  The score and
// probability tiles never leave shared memory.  Several heads or windows
// per block, wgmma, and keeping the bias in shared memory across windows
// are later work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int T = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr float kClamp = 60.0f;

template <int HD>
struct Smem {
  static constexpr int LD = HD + 8;  // q, k, v row stride (bf16)
  static constexpr int SLD = T + 4;  // scores / output row stride (fp32); HD + 4 <= SLD
  static constexpr int PLD = T + 8;  // probabilities row stride (bf16)
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + T * LD * 2;
  static constexpr int V_OFF = K_OFF + T * LD * 2;
  static constexpr int S_OFF = V_OFF + T * LD * 2;
  static constexpr int P_OFF = S_OFF + T * SLD * 4;
  static constexpr int R_OFF = P_OFF + T * PLD * 2;
  static constexpr int BYTES = R_OFF + T * 4;
};

template <int HD>
__global__ __launch_bounds__(THREADS) void window_attention_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ bias, const float* __restrict__ mask,
    bf16* __restrict__ out, int res, int w, int shift, int heads, float scale2) {
  using L = Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::V_OFF);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::P_OFF);
  float* sR = reinterpret_cast<float*>(smem + L::R_OFF);
  __shared__ int sRow[T];  // the pixel row of each window token, -1 past n

  const int win = blockIdx.x, head = blockIdx.y, img = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = w * w, nwx = res / w;
  const int wy = win / nwx, wx = win % nwx;
  const int ld = 3 * heads * HD;
  const size_t img_row0 = static_cast<size_t>(img) * res * res;

  if (tid < T) {
    int row = -1;
    if (tid < n) {
      const int py = (wy * w + tid / w + shift) % res;
      const int px = (wx * w + tid % w + shift) % res;
      row = py * res + px;
    }
    sRow[tid] = row;
  }
  __syncthreads();

  // Gather q, k, v of the window's tokens; rows >= n are zero.
  constexpr int CH = HD / 8;
  for (int i = tid; i < 3 * T * CH; i += THREADS) {
    const int part = i / (T * CH), r = (i / CH) % T, c = (i % CH) * 8;
    const int row = sRow[r];
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row >= 0)
      v = *reinterpret_cast<const uint4*>(qkv + (img_row0 + row) * ld +
                                          (part * heads + head) * HD + c);
    bf16* dst = part == 0 ? sQ : (part == 1 ? sK : sV);
    *reinterpret_cast<uint4*>(dst + r * L::LD + c) = v;
  }
  __syncthreads();

  const int wr = warp * 16;  // this warp's first query row
  // S[wr:wr+16, 0:64] = q k^T
#pragma unroll
  for (int j = 0; j < T / 16; ++j) {
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

  // p = exp2(min(s * scale2 + bias (+ mask), 60)) for keys < n, else 0;
  // query rows >= n are padding and get p = 0 (nothing reads them).
  const float* bh = bias + static_cast<size_t>(head) * n * n;
  const float* mw = mask != nullptr ? mask + static_cast<size_t>(win) * n * n : nullptr;
#pragma unroll 4
  for (int r = 0; r < 16; ++r) {
    const int q = wr + r;
    float part = 0.0f;
#pragma unroll
    for (int c = lane; c < T; c += 32) {
      float p = 0.0f;
      if (q < n && c < n) {
        float s = __fadd_rn(__fmul_rn(sS[q * L::SLD + c], scale2), bh[q * n + c]);
        if (mw != nullptr) s = __fadd_rn(s, mw[q * n + c]);
        p = exp2f(fminf(s, kClamp));
      }
      part += p;
      sP[q * L::PLD + c] = __float2bfloat16_rn(p);
    }
    part = warp_sum(part);
    if (lane == 0) sR[q] = 1.0f / fmaxf(part, 1e-30f);
  }
  __syncwarp();

  // O = bf16(p) v
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[HD / 16];
#pragma unroll
  for (int d = 0; d < HD / 16; ++d) {
    wmma::fill_fragment(o[d], 0.0f);
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, sP + wr * L::PLD + kk * 16, L::PLD);
      wmma::load_matrix_sync(b, sV + kk * 16 * L::LD + d * 16, L::LD);
      wmma::mma_sync(o[d], a, b, o[d]);
    }
  }
  // The warp's own score rows become its fp32 output rows (HD + 4 <= SLD).
  __syncwarp();
#pragma unroll
  for (int d = 0; d < HD / 16; ++d)
    wmma::store_matrix_sync(sS + wr * L::SLD + d * 16, o[d], L::SLD, wmma::mem_row_major);
  __syncwarp();

  const int ldo = heads * HD;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    const int q = wr + r;
    if (q >= n) continue;
    const float inv = sR[q];
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = sS[q * L::SLD + c + e] * inv;
    *reinterpret_cast<uint4*>(out + (img_row0 + sRow[q]) * ldo + head * HD + c) = pack8(v);
  }
}

template <int HD>
int launch(const void* qkv, const void* bias, const void* mask, void* out, int batch, int res,
           int w, int shift, int heads, float scale2, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(window_attention_kernel<HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Smem<HD>::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int nwx = res / w;
  const dim3 grid(nwx * nwx, heads, batch);
  window_attention_kernel<HD><<<grid, THREADS, Smem<HD>::BYTES, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<bf16*>(out), res, w, shift, heads, scale2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int evt_window_attention(const void* qkv, const void* bias, const void* mask, void* out,
                                    int batch, int res, int w, int shift, int heads, int head_dim,
                                    float scale2, void* stream) {
  if (batch == 0) return 0;
  if (w <= 0 || w * w > T || res % w != 0 || shift < 0 || shift >= w)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch<32>(qkv, bias, mask, out, batch, res, w, shift, heads, scale2, s);
    case 64: return launch<64>(qkv, bias, mask, out, batch, res, w, shift, heads, scale2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
