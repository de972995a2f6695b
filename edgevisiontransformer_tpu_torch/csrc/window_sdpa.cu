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
// There is no exp2, no clamp at 60 and no deferred 1/r as in K9.  Each step
// rounds as the reference does (__fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn), so nvcc contracts nothing into an FMA and divides exactly.
//
// Bound on the card: a swin_tiny window does 4 * n^2 * HD = 0.3 MFLOP per
// head on 3 * n * HD * 2 = 9.4 KB of q, k, v (HD 32, n 49): ~33 flop/byte,
// far below the H100's ~295 flop/byte balance point, so bytes bound it: qkv
// read once and the output written once, the bias and mask once.
//
// Design (simple first, as window_attention.cu): one thread block of 4
// warps per (window, head), each warp owning 16 of the 64 query rows.  The
// n <= 64 tokens' q, k and v are copied into shared memory with 16-byte
// loads, padded to 64 rows with zeros; S = q k^T and O = bf16(p) v run on
// WMMA 16x16x16 bf16 fragments with fp32 accumulation; keys >= n get p = 0
// (K12 sets their score to -1e30, whose exp underflows to 0).  Several heads
// or windows per block and wgmma are later work.
#include <math.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int T = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr int PER_LANE = T / 32;  // keys of a score row per lane

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
  static constexpr int BYTES = P_OFF + T * PLD * 2;
};

template <int HD>
__global__ __launch_bounds__(THREADS) void window_sdpa_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ bias, const float* __restrict__ mask,
    bf16* __restrict__ out, int n, int heads, int mask_windows, float scale) {
  using L = Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::V_OFF);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::P_OFF);

  const int win = blockIdx.x, head = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ld = 3 * heads * HD;
  const size_t row0 = static_cast<size_t>(win) * n;

  // Copy q, k, v of the window's tokens; rows >= n are zero.
  constexpr int CH = HD / 8;
  for (int i = tid; i < 3 * T * CH; i += THREADS) {
    const int part = i / (T * CH), r = (i / CH) % T, c = (i % CH) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n)
      v = *reinterpret_cast<const uint4*>(qkv + (row0 + r) * ld + (part * heads + head) * HD + c);
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

  // Max-subtracted softmax of each valid query row over its n keys, p
  // normalised before the PV product; padding rows and keys get p = 0.
  const bf16* bh = bias + static_cast<size_t>(head) * n * n;
  const float* mw = mask != nullptr ? mask + static_cast<size_t>(win % mask_windows) * n * n
                                    : nullptr;
  for (int r = 0; r < 16; ++r) {
    const int q = wr + r;
    const bool row_ok = q < n;
    float s[PER_LANE];
    float mx = -INFINITY;
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) {
      const int c = lane + 32 * e;
      s[e] = -INFINITY;
      if (row_ok && c < n) {
        float v = __fadd_rn(__fmul_rn(sS[q * L::SLD + c], scale),
                            __bfloat162float(bh[q * n + c]));
        if (mw != nullptr) v = __fadd_rn(v, round_bf16(mw[q * n + c]));
        s[e] = v;
        mx = fmaxf(mx, v);
      }
    }
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) {
      const int c = lane + 32 * e;
      s[e] = (row_ok && c < n) ? expf(__fsub_rn(s[e], mx)) : 0.0f;
      sum += s[e];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) {
      const int c = lane + 32 * e;
      sP[q * L::PLD + c] = __float2bfloat16_rn(row_ok && c < n ? __fdiv_rn(s[e], sum) : 0.0f);
    }
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
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = sS[q * L::SLD + c + e];
    *reinterpret_cast<uint4*>(out + (row0 + q) * ldo + head * HD + c) = pack8(v);
  }
}

template <int HD>
int launch(const void* qkv, const void* bias, const void* mask, void* out, int windows, int n,
           int heads, int mask_windows, float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_sdpa_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<HD>::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(windows, heads);
  window_sdpa_kernel<HD><<<grid, THREADS, Smem<HD>::BYTES, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
      static_cast<const float*>(mask), static_cast<bf16*>(out), n, heads, mask_windows, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int evt_window_sdpa(const void* qkv, const void* bias, const void* mask, void* out,
                               int windows, int n, int heads, int head_dim, int mask_windows,
                               float scale, void* stream) {
  if (windows == 0) return 0;
  if (n <= 0 || n > T || heads <= 0 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mask != nullptr && (mask_windows <= 0 || windows % mask_windows != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch<32>(qkv, bias, mask, out, windows, n, heads, mask_windows, scale, s);
    case 64: return launch<64>(qkv, bias, mask, out, windows, n, heads, mask_windows, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
