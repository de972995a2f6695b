// sdpa: scaled dot-product attention over [b, h, n, d] operands read through
// their strides: the attention core of the ViT module's kernel_mode="pallas"
// forward.
//
// Replaces: `_attn_kernel` / `sdpa` (K13) in
//   edgevisiontransformer_tpu/ops/pallas/fused_attention.py:29-75.  Per
//   (image, head), with K13's math (:33-42):
//     s = f32(q . k) * scale               (the scale multiplies the fp32 product)
//     keys at index >= n: s = -1e30        (exp gives p = 0 exactly)
//     p = exp(s - max_row s) / sum_row exp(s - max_row s)   (fp32, before PV)
//     o = bf16(f32(bf16(p) @ v))           (p cast to v's dtype, fp32 accumulation)
//   This is not attention_rows' max-free exp2 softmax with the normalisation
//   deferred past PV.  Every step rounds as K13 does (__fmul_rn / __fsub_rn /
//   __fdiv_rn): nvcc contracts nothing into an FMA and divides exactly.  K13
//   pads n to a multiple of 128 and masks the padded keys; here keys past n
//   are never read (their p is 0 either way), and the sums run over the n
//   real keys, which adds the same numbers.
//
// Operands: q, k, v and out are [b, h, n, d] with d contiguous and every
// other stride a multiple of 8 elements, so a row is one run of 16-byte
// vectors.  attention() hands the kernel views of the fused qkv activation
// [b, n, 3 * h * d] and of the merged output [b, n, h * d]: no split, no
// permute and no merge copy.
//
// Bound on the card: for deit_tiny (n = 197, d = 64, 3 heads) one (image,
// head) does 4 * n^2 * d = 10 MFLOP on 4 * n * d * 2 = 101 KB of q, k, v and
// out: ~100 flop/byte, under the H100's ~295 flop/byte balance point, so
// bytes bound it (0.0116 ms per deit_tiny b128 layer at 3.35 TB/s), and the
// n^2 exp (one MUFU op each) and the exact divisions cost about as much as
// the two products on the tensor cores.
//
// Design (simple first, the structure of attention_rows.cu): one thread
// block of 4 warps per (image * head, 64-query tile); each warp owns 16
// query rows.  The block's whole fp32 score row lives in shared memory
// (64 x n_pad x 4 B, 66 KB at n = 197, 165 KB at n = 577), so the exact
// softmax needs one pass over the keys for S = q k^T, one over each warp's
// own rows in shared memory for max, exp, sum and p / sum, and one more over
// the keys for O = bf16(p) v.  k and v stream through one 64-row tile
// buffer, zero-filled past n; the products run on WMMA 16x16x16 bf16
// fragments with fp32 accumulation.  At b1 (12 blocks for deit_tiny) the
// card is mostly idle; several heads per block, wgmma and TMA are later work.
#include <math.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int QT = 64, KT = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr int MAX_SMEM = 232448;  // the most dynamic shared memory a block may use

// Element strides of q, k, v and out over (image, head, token).
struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, ob, oh, on;
};

template <int HD>
struct Smem {
  static constexpr int LD = HD + 8;   // q and k / v tile row stride (bf16)
  static constexpr int PLD = KT + 8;  // p tile row stride (bf16)
  static constexpr int Q_OFF = 0;
  static constexpr int KV_OFF = Q_OFF + QT * LD * 2;
  static constexpr int P_OFF = KV_OFF + KT * LD * 2;
  static constexpr int S_OFF = P_OFF + QT * PLD * 2;
  // Score row stride (fp32): every key tile, and at least a row of output.
  static __host__ __device__ int sld(int n) {
    const int keys = (n + KT - 1) / KT * KT;
    return (keys > HD ? keys : HD) + 4;
  }
  static __host__ __device__ size_t bytes(int n) {
    return S_OFF + static_cast<size_t>(QT) * sld(n) * 4;
  }
};

// Rows [r0, r0 + 64) of one (image, head) of a [.., n, HD] operand into
// shared memory, zeros past token n.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src,
                                          long long stride_n, int r0, int n, int tid) {
  constexpr int CH = HD / 8;
  for (int i = tid; i < 64 * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const int t = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t < n) v = *reinterpret_cast<const uint4*>(src + t * stride_n + c);
    *reinterpret_cast<uint4*>(dst + r * Smem<HD>::LD + c) = v;
  }
}

template <int HD>
__global__ __launch_bounds__(THREADS) void sdpa_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, Strides st, int heads, int n, float scale) {
  using L = Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* sKV = reinterpret_cast<bf16*>(smem + L::KV_OFF);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::P_OFF);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);

  const int img = blockIdx.x / heads, head = blockIdx.x % heads;
  const int q0 = blockIdx.y * QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp * 16;  // this warp's first query row in the tile
  const int ktiles = (n + KT - 1) / KT;
  const int sld = L::sld(n);
  const bf16* qp = q + img * st.qb + head * st.qh;
  const bf16* kp = k + img * st.kb + head * st.kh;
  const bf16* vp = v + img * st.vb + head * st.vh;
  bf16* op = out + img * st.ob + head * st.oh;

  load_rows<HD>(sQ, qp, st.qn, q0, n, tid);

  // S[wr:wr+16, :] = q k^T, one 64-key tile at a time
  for (int t = 0; t < ktiles; ++t) {
    __syncthreads();  // q landed; every warp is done with the previous k tile
    load_rows<HD>(sKV, kp, st.kn, t * KT, n, tid);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, sQ + wr * L::LD + kk * 16, L::LD);
        wmma::load_matrix_sync(b, sKV + j * 16 * L::LD + kk * 16, L::LD);
        wmma::mma_sync(s, a, b, s);
      }
      wmma::store_matrix_sync(sS + wr * sld + t * KT + j * 16, s, sld, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // The exact softmax of each of the warp's valid query rows over its n keys,
  // in place; p is 0 past key n (those scores are -1e30 in K13).
  for (int r = 0; r < 16; ++r) {
    if (q0 + wr + r >= n) break;
    float* row = sS + (wr + r) * sld;
    float mx = -INFINITY;
    for (int c = lane; c < n; c += 32) {
      const float s = __fmul_rn(row[c], scale);
      row[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int c = lane; c < n; c += 32) {
      const float e = expf(__fsub_rn(row[c], mx));
      row[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < ktiles * KT; c += 32) row[c] = c < n ? __fdiv_rn(row[c], sum) : 0.0f;
  }
  __syncwarp();

  // O = bf16(p) v, one 64-key tile at a time
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[HD / 16];
#pragma unroll
  for (int d = 0; d < HD / 16; ++d) wmma::fill_fragment(o[d], 0.0f);
  for (int t = 0; t < ktiles; ++t) {
    __syncthreads();  // every warp is done with the previous k / v and p tiles
    load_rows<HD>(sKV, vp, st.vn, t * KT, n, tid);
    for (int i = lane; i < 16 * KT; i += 32) {
      const int r = wr + i / KT, c = i % KT;
      sP[r * L::PLD + c] = __float2bfloat16_rn(sS[r * sld + t * KT + c]);
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < HD / 16; ++d) {
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, sP + wr * L::PLD + kk * 16, L::PLD);
        wmma::load_matrix_sync(b, sKV + kk * 16 * L::LD + d * 16, L::LD);
        wmma::mma_sync(o[d], a, b, o[d]);
      }
    }
  }

  // The warp's own score rows become its fp32 output rows (sld >= HD + 4).
#pragma unroll
  for (int d = 0; d < HD / 16; ++d)
    wmma::store_matrix_sync(sS + wr * sld + d * 16, o[d], sld, wmma::mem_row_major);
  __syncwarp();
  constexpr int CH = HD / 8;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    const int qi = q0 + wr + r;
    if (qi >= n) continue;
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = sS[(wr + r) * sld + c + e];
    *reinterpret_cast<uint4*>(op + qi * st.on + c) = pack8(f);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, const Strides& st, int bh,
           int heads, int n, float scale, cudaStream_t stream) {
  const size_t bytes = Smem<HD>::bytes(n);
  if (bytes > static_cast<size_t>(MAX_SMEM)) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        sdpa_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(bh, (n + QT - 1) / QT);
  sdpa_kernel<HD><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), st, heads, n, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 element strides, (image, head, token) of q, k, v and out.
extern "C" int evt_sdpa(const void* q, const void* k, const void* v, void* out,
                        const long long* strides, int batch, int heads, int n, int head_dim,
                        float scale, void* stream) {
  if (batch == 0 || heads == 0 || n == 0) return 0;
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],  strides[5],
                   strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  const int bh = batch * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(q, k, v, out, st, bh, heads, n, scale, s);
    case 32: return launch<32>(q, k, v, out, st, bh, heads, n, scale, s);
    case 64: return launch<64>(q, k, v, out, st, bh, heads, n, scale, s);
    case 128: return launch<128>(q, k, v, out, st, bh, heads, n, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
