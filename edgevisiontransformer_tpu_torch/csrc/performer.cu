// performer_reduce + performer_rows: the T2T tokenizer's TokenPerformer
// after norm1 and kqv, in two launches.
//
// Replaces: edgevisiontransformer_tpu/ops/pallas/performer.py
//   `_performer_kernel` / `performer_rest` (K16, :46-110), with its cast
//   points.  Input x_kqv [b, n, 3 ts] bf16 holds k, q, v in that order;
//   w [m, ts] is the fixed random-feature matrix (in bf16, as the kernel
//   takes it).  In fp32:
//     prm(t) = exp(t w^T - |t|^2 / 2) * (1 / sqrt m)      kp = prm(k), qp = prm(q)
//     kp_sum = sum over tokens of kp,  kptv = v^T kp      (padded rows excluded)
//     y      = (qp kptv^T) / max(qp . kp_sum, 1e-8)
//   then  y2  = bf16(v + (f32(bf16(y) @ wo) + bo))        (the skip is from v)
//         h   = bf16(LN(y2))                               (fp32 statistics)
//         g   = bf16(gelu(bf16(f32(h @ w1) + b1)))
//         out = bf16(y2 + (f32(g @ w2) + b2))
//   At t2t_vit_14: ts = 64, m = 32, n = 3136 (stage 1) or 784 (stage 2).
//
// Bound on the card: device-memory bytes.  Per token it reads 3 ts bf16
// values and writes ts (512 bytes) and does ~20 kflop in fp32: t2t_vit_14
// b1 stage 1 moves 1.6 MB (0.5 us at 3.35 TB/s) and does 63 MFLOP (0.9 us
// at the 67 TFLOP/s fp32 rate).  The sums over all tokens are a reduction
// across blocks.
//
// Design: performer_reduce runs one block per (image, 256-token chunk): for
// each 64-token tile it computes kp in fp32 on the CUDA cores (the TPU kernel
// keeps prm_exp, D and kptv in fp32) and adds the tile to the chunk's
// kp_sum [m] and kptv [ts, m], which it writes as a partial in fp32 (no
// atomics, so the result does not depend on block order).  performer_rows
// runs one block per (image, 64-token tile): it sums the image's partials in
// chunk order, computes qp, d and y in fp32, and runs attn_output, the skip,
// the LayerNorm and the ts -> ts -> ts MLP as 64x64x64 WMMA bf16 products
// (fp32 accumulate) with the weights in shared memory, then writes its rows.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int TS = 64, MF = 32;          // token size, random features
constexpr int TILE = 64, CHUNK = 256;    // tokens per tile, per reduce block
constexpr int THREADS = 256;
constexpr int FLD = TS + 1;              // fp32 token-row stride (conflict-free columns)
constexpr int PLD = MF + 1;              // fp32 feature-row stride
constexpr int HLD = TS + 8;              // bf16 row stride of the WMMA operands
constexpr int CLD = TS + 4;              // fp32 row stride of a WMMA result
constexpr int PARTIAL = MF + TS * MF;    // kp_sum then kptv [ts, m], per chunk
constexpr float kInvSqrtM = 0.17677669529663687f;  // f32(1 / sqrt(32)), as the reference's constant

// rows [t0, t0 + TILE) of columns [col, col + TS) of one image's x_kqv into
// fp32 shared memory; rows past n are zeros
__device__ __forceinline__ void load_tile(float* dst, const bf16* __restrict__ x, int t0, int n,
                                          int col) {
  for (int i = threadIdx.x; i < TILE * (TS / 8); i += THREADS) {
    const int r = i / (TS / 8), c = (i % (TS / 8)) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (t0 + r < n)
      unpack8(*reinterpret_cast<const uint4*>(x + static_cast<size_t>(t0 + r) * 3 * TS + col + c),
              f);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[r * FLD + c + e] = f[e];
  }
}

// w [m, ts] bf16 -> fp32 shared memory
__device__ __forceinline__ void load_w(float* sw, const bf16* __restrict__ w) {
  for (int i = threadIdx.x; i < MF * TS; i += THREADS) sw[i] = __bfloat162float(w[i]);
}

// prm of the TILE rows of t (fp32, stride FLD) into p [TILE, MF] (stride
// PLD); rows at or past `valid` become 0 when `mask`.  td holds |t|^2 / 2.
__device__ __forceinline__ void prm_exp(const float* t, const float* sw, float* td, float* p,
                                        int valid, bool mask) {
  const int tid = threadIdx.x;
  if (tid < TILE) {
    float s = 0.f;
    for (int i = 0; i < TS; ++i) s += t[tid * FLD + i] * t[tid * FLD + i];
    td[tid] = s * 0.5f;
  }
  __syncthreads();
  const int r = tid % TILE, j0 = (tid / TILE) * (MF / 4);
#pragma unroll
  for (int e = 0; e < MF / 4; ++e) {
    const int j = j0 + e;
    float s = 0.f;
    for (int i = 0; i < TS; ++i) s += t[r * FLD + i] * sw[j * TS + i];
    p[r * PLD + j] = (mask && r >= valid) ? 0.f : expf(s - td[r]) * kInvSqrtM;
  }
}

__global__ __launch_bounds__(THREADS) void performer_reduce_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, float* __restrict__ partial, int n) {
  extern __shared__ __align__(16) float sm[];
  float* sw = sm;                    // [MF, TS]
  float* sk = sw + MF * TS;          // [TILE, FLD]
  float* sv = sk + TILE * FLD;       // [TILE, FLD]
  float* sp = sv + TILE * FLD;       // [TILE, PLD]
  float* td = sp + TILE * PLD;       // [TILE]
  const int chunk = blockIdx.x, img = blockIdx.y, tid = threadIdx.x;
  const bf16* xi = x + static_cast<size_t>(img) * n * 3 * TS;
  load_w(sw, w);

  const int i = tid / 4, j0 = (tid % 4) * (MF / 4);  // this thread's kptv[i, j0:j0+8]
  float acc[MF / 4] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float ksum = 0.f;                                   // kp_sum[tid], tid < MF
  const int c0 = chunk * CHUNK, c1 = min(c0 + CHUNK, n);
  for (int t0 = c0; t0 < c1; t0 += TILE) {
    __syncthreads();  // the previous tile's sums are done with sk, sv, sp
    load_tile(sk, xi, t0, n, 0);
    load_tile(sv, xi, t0, n, 2 * TS);
    __syncthreads();
    prm_exp(sk, sw, td, sp, n - t0, true);
    __syncthreads();
    for (int t = 0; t < TILE; ++t) {
      const float vi = sv[t * FLD + i];
#pragma unroll
      for (int e = 0; e < MF / 4; ++e) acc[e] += vi * sp[t * PLD + j0 + e];
    }
    if (tid < MF)
      for (int t = 0; t < TILE; ++t) ksum += sp[t * PLD + tid];
  }
  float* out = partial + (static_cast<size_t>(img) * gridDim.x + chunk) * PARTIAL;
  if (tid < MF) out[tid] = ksum;
#pragma unroll
  for (int e = 0; e < MF / 4; ++e) out[MF + i * MF + j0 + e] = acc[e];
}

// C [64, 64] fp32 (stride CLD) = A [64, 64] @ B [64, 64], bf16 operands in
// shared memory (stride HLD); warp w owns rows 16 (w / 2), columns 32 (w % 2).
__device__ __forceinline__ void mm64(const bf16* A, const bf16* B, float* C) {
  const int warp = threadIdx.x >> 5, r0 = (warp >> 1) * 16, n0 = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
#pragma unroll
  for (int k = 0; k < TS; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + r0 * HLD + k, HLD);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, B + k * HLD + n0 + j * 16, HLD);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(C + r0 * CLD + n0 + j * 16, acc[j], CLD, wmma::mem_row_major);
}

__device__ __forceinline__ void load_weight(bf16* dst, const bf16* __restrict__ src) {
  for (int i = threadIdx.x; i < TS * (TS / 8); i += THREADS) {
    const int r = i / (TS / 8), c = (i % (TS / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * HLD + c) =
        *reinterpret_cast<const uint4*>(src + r * TS + c);
  }
}

__global__ __launch_bounds__(THREADS) void performer_rows_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const float* __restrict__ partial,
    int chunks, const bf16* __restrict__ wo, const float* __restrict__ bo,
    const float* __restrict__ g2, const float* __restrict__ be2, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2, const float* __restrict__ b2,
    bf16* __restrict__ out, int n, float eps, int approx) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* swo = reinterpret_cast<bf16*>(smem);   // [TS, HLD] x 3
  bf16* sw1 = swo + TS * HLD;
  bf16* sw2 = sw1 + TS * HLD;
  bf16* sa = sw2 + TS * HLD;                   // [TILE, HLD]: bf16(y), then the GELU output
  bf16* sh = sa + TILE * HLD;                  // [TILE, HLD]: bf16(LN(y2))
  float* sw = reinterpret_cast<float*>(sh + TILE * HLD);  // [MF, TS]
  float* skv = sw + MF * TS;                   // kp_sum [MF], then kptv [TS, MF]
  float* sq = skv + PARTIAL;                   // [TILE, CLD]: q, then each product
  float* sv = sq + TILE * CLD;                 // [TILE, FLD]: v, then y2
  float* sp = sv + TILE * FLD;                 // [TILE, PLD]: qp
  float* td = sp + TILE * PLD;                 // [TILE]
  float* sd = td + TILE;                       // [TILE]: 1 / max(d, 1e-8)
  const int img = blockIdx.y, t0 = blockIdx.x * TILE, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bf16* xi = x + static_cast<size_t>(img) * n * 3 * TS;

  load_w(sw, w);
  load_weight(swo, wo);
  load_weight(sw1, w1);
  load_weight(sw2, w2);
  const float* pi = partial + static_cast<size_t>(img) * chunks * PARTIAL;
  for (int k = tid; k < PARTIAL; k += THREADS) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += pi[static_cast<size_t>(c) * PARTIAL + k];
    skv[k] = s;
  }
  // q into the product buffer (stride CLD >= FLD: read back with FLD below)
  for (int i = tid; i < TILE * (TS / 8); i += THREADS) {
    const int r = i / (TS / 8), c = (i % (TS / 8)) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (t0 + r < n)
      unpack8(*reinterpret_cast<const uint4*>(xi + static_cast<size_t>(t0 + r) * 3 * TS + TS + c),
              f);
#pragma unroll
    for (int e = 0; e < 8; ++e) sq[r * FLD + c + e] = f[e];
  }
  load_tile(sv, xi, t0, n, 2 * TS);
  __syncthreads();
  prm_exp(sq, sw, td, sp, n - t0, false);
  __syncthreads();

  // d = qp . kp_sum, then y = (qp kptv^T) / max(d, 1e-8) -> bf16
  if (tid < TILE) {
    float d = 0.f;
    for (int j = 0; j < MF; ++j) d += sp[tid * PLD + j] * skv[j];
    sd[tid] = fmaxf(d, 1e-8f);
  }
  __syncthreads();
  const float* kptv = skv + MF;
  for (int o = tid; o < TILE * TS; o += THREADS) {
    const int r = o / TS, i = o % TS;
    float s = 0.f;
    for (int j = 0; j < MF; ++j) s += sp[r * PLD + j] * kptv[i * MF + j];
    sa[r * HLD + i] = __float2bfloat16_rn(s / sd[r]);
  }
  __syncthreads();

  // y2 = bf16(v + (f32(bf16(y) @ wo) + bo)), kept as fp32 in sv
  mm64(sa, swo, sq);
  __syncthreads();
  for (int o = tid; o < TILE * TS; o += THREADS) {
    const int r = o / TS, i = o % TS;
    sv[r * FLD + i] = round_bf16(sv[r * FLD + i] + (sq[r * CLD + i] + bo[i]));
  }
  __syncthreads();

  // h = bf16(LN(y2)): one warp per row, two values a lane
  for (int r = warp; r < TILE; r += THREADS / 32) {
    const float a = sv[r * FLD + lane], b = sv[r * FLD + lane + 32];
    const float mean = warp_sum(a + b) / static_cast<float>(TS);
    const float da = a - mean, db = b - mean;
    const float var = warp_sum(da * da + db * db) / static_cast<float>(TS);
    const float rs = rsqrtf(var + eps);
    sh[r * HLD + lane] = __float2bfloat16_rn(da * rs * g2[lane] + be2[lane]);
    sh[r * HLD + lane + 32] = __float2bfloat16_rn(db * rs * g2[lane + 32] + be2[lane + 32]);
  }
  __syncthreads();

  // g = bf16(gelu(bf16(f32(h @ w1) + b1)))
  mm64(sh, sw1, sq);
  __syncthreads();
  for (int o = tid; o < TILE * TS; o += THREADS) {
    const int r = o / TS, i = o % TS;
    const float v = round_bf16(sq[r * CLD + i] + b1[i]);
    sa[r * HLD + i] = __float2bfloat16_rn(approx ? gelu_tanh_f(v) : gelu_erf_f(v));
  }
  __syncthreads();

  // out = bf16(y2 + (f32(g @ w2) + b2))
  mm64(sa, sw2, sq);
  __syncthreads();
  bf16* oi = out + static_cast<size_t>(img) * n * TS;
  for (int o = tid; o < TILE * (TS / 8); o += THREADS) {
    const int r = o / (TS / 8), c = (o % (TS / 8)) * 8;
    if (t0 + r >= n) continue;
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = sv[r * FLD + c + e] + (sq[r * CLD + c + e] + b2[c + e]);
    *reinterpret_cast<uint4*>(oi + static_cast<size_t>(t0 + r) * TS + c) = pack8(f);
  }
}

constexpr int REDUCE_SMEM = (MF * TS + 2 * TILE * FLD + TILE * PLD + TILE) * 4;
constexpr int ROWS_SMEM = (3 * TS + 2 * TILE) * HLD * 2 +
                          (MF * TS + PARTIAL + TILE * CLD + TILE * FLD + TILE * PLD + 2 * TILE) * 4;

int configure(const void* kernel, int bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  *done = true;
  return 0;
}

}  // namespace

// partial: [b, ceil(n / 256), m + ts * m] fp32 scratch.
extern "C" int evt_performer_reduce(const void* x, const void* w, void* partial, int batch, int n,
                                    void* stream) {
  if (batch == 0 || n == 0) return 0;
  static bool done = false;
  const int rc = configure(reinterpret_cast<const void*>(performer_reduce_kernel), REDUCE_SMEM,
                           &done);
  if (rc != 0) return rc;
  const dim3 grid((n + CHUNK - 1) / CHUNK, batch);
  performer_reduce_kernel<<<grid, THREADS, REDUCE_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<float*>(partial), n);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: x, w, partial, wo, bo, g2, be2, w1, b1, w2, b2, out (the vectors fp32).
extern "C" int evt_performer_rows(void* const* ptrs, int batch, int n, float eps, int approx,
                                  void* stream) {
  if (batch == 0 || n == 0) return 0;
  static bool done = false;
  const int rc = configure(reinterpret_cast<const void*>(performer_rows_kernel), ROWS_SMEM, &done);
  if (rc != 0) return rc;
  const dim3 grid((n + TILE - 1) / TILE, batch);
  auto b = [&](int i) { return static_cast<const bf16*>(ptrs[i]); };
  auto f = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  performer_rows_kernel<<<grid, THREADS, ROWS_SMEM, static_cast<cudaStream_t>(stream)>>>(
      b(0), b(1), f(2), (n + CHUNK - 1) / CHUNK, b(3), f(4), f(5), f(6), b(7), f(8), b(9), f(10),
      static_cast<bf16*>(ptrs[11]), n, eps, approx);
  return static_cast<int>(cudaGetLastError());
}
