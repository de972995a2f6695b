// sdpa: scaled dot-product attention over [b, h, n, d] operands read through
// their strides: the attention core of the ViT module's kernel_mode="pallas"
// forward.
//
// Replaces: `_attn_kernel` / `sdpa` (K13) in
//   edgevisiontransformer_tpu/ops/pallas/fused_attention.py:29-75.  Per
//   (image, head), with K13's math (:33-42):
//     s = f32(q . k) * scale               (the scale multiplies the fp32 product)
//     keys at index >= n: excluded         (K13's -1e30 gives p = 0 exactly)
//     p = exp(s - max_row s) / sum_row exp(s - max_row s)   (fp32, before PV)
//     o = bf16(f32(bf16(p) @ v))           (p cast to v's dtype, fp32 accumulation)
//   Every step rounds as K13 does (__fmul_rn / __fsub_rn): nvcc contracts
//   nothing into an FMA, and the division is exact (normalise: the correctly
//   rounded quotient, as __fdiv_rn gives it).  The sums run over the n real
//   keys in another order than K13's, which adds the same numbers.
//
// Head dims: instances at the multiples of 16 from 16 to 128; a head_dim of
// 8 more than one (24, ..., 120) runs on the next, its q, k and v rows
// zero-filled to the instance's width in shared memory (the scores do not
// change) and the extra O columns never stored.
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
// bytes bound it (0.0116 ms per deit_tiny b128 layer at 3.35 TB/s).  In
// practice the n^2 exps and exact divisions on the fp32 ALUs cost more than
// the two products on the tensor cores, and the latency of each block's
// chain of loads, products and softmax decides how much of that overlaps.
//
// Design (n <= RES_KEYS): one block of 4 warps per (image * head, 64-query
// tile); each warp owns 16 query rows.
// - Products on mma.sync.m16n8k16 (bf16 in, fp32 accumulators), fed by
//   ldmatrix from tiles of row stride d + 8 (the 16-byte skew spreads eight
//   rows over all 32 banks).  Q's A fragments come from its rows, S = Q K^T's
//   B fragments from K's rows (ldmatrix), O = P V's from V's rows
//   (ldmatrix.trans).
// - The scores stay in the accumulator registers.  In the m16n8 layout a
//   score row lives in the 4 lanes of a quad, so the row max and sum are
//   taken in registers and reduced with two shuffles; and the accumulators
//   of two neighbouring n8 tiles, packed to bf16x2, are the A fragment of one
//   k16 step of PV (FlashAttention-2's register reuse).  P never goes to
//   shared memory.
// - K and V arrive by cp.async, zero-filled past n (p = 0 times a NaN left in
//   shared memory would be NaN), so the loads overlap the arithmetic.
// - Resident form (n <= RES_KEYS: 256 keys, 128 above d = 96, where the O
//   accumulators take 56 or 64 registers): all of K and V sit in shared memory, K
//   with Q in one commit group and V in a second, so V lands while Q K^T and
//   the softmax run.  Each warp holds its 16 x n scores in registers: one
//   Q K^T, one exp per score, one exact division, one PV.  The kernel is
//   compiled for 2, 4, 8, 13 and 16 chunks of 16 keys and takes the fewest
//   that hold n, so its loops carry no bound check (a branch in them keeps
//   the compiler from running loads ahead of the products) and the scores
//   take no more registers than n needs: at n = 197 (13 chunks, every
//   registry ViT at 224^2) 168 registers, three blocks per SM.
// - Longer n (past RES_KEYS) runs on sdpa_long.cu: wgmma products fed by
//   TMA, the same softmax (sdpa_softmax.cuh) in two passes over 64-key
//   tiles.  This kernel refuses it (cudaErrorInvalidValue); the wrapper
//   (ops/cuda/fused_attention.py:sdpa) sends each shape to one of the two.
// - The exact division costs a reciprocal on the MUFU and about ten more
//   operations a score as __fdiv_rn; normalise gives the same quotient in
//   five FMA-pipe operations from one reciprocal per row, wherever the
//   warp's rows keep every quotient above 2^-101 (a warp-uniform check;
//   other warps take __fdiv_rn).
// - Query rows past n are computed from zeros and never stored; a warp whose
//   16 rows all lie past n skips the arithmetic (at n = 197 three of the last
//   tile's four warps).
// - Epilogue: O is rounded to bf16 into the warp's own Q rows of shared
//   memory, then written to the strided out view as 16-byte vectors.
// - The routines it shares with attention_rows.cu and window_sdpa.cu
//   (load_rows, qk, pv, store_rows, quad_sum, quad_max) are in
//   attn_tiles.cuh; the softmax it shares with sdpa_long.cu (scale_mask,
//   row_max, exp_rows, exact_corrections, divide_rows) in sdpa_softmax.cuh.
#include "sdpa_softmax.cuh"

namespace {

constexpr int QT = 64, WARPS = 4, THREADS = WARPS * 32;

// Element strides of q, k, v and out over (image, head, token).
struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, ob, oh, on;
};

template <int HD>
struct Tile {
  static constexpr int LD = row_ld(HD);  // shared-memory row stride (elements)
  // The longest n of the resident form: its scores take RES_KEYS / 2
  // registers a thread, beside HD / 2 of O accumulators; above HD 96 the
  // two would pass ptxas's 255 (chip_smoke.py phase 2 fails on a spill).
  static constexpr int RES_KEYS = HD > 96 ? 128 : 256;
};

// The resident form over RC 16-key chunks (n <= 16 RC).
template <int HD, int RC, class T>
__global__ __launch_bounds__(THREADS) void sdpa_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, Strides st, int heads, int n, int hd, float scale) {
  constexpr int LD = Tile<HD>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + QT * LD;
  T* sV = sK + RC * 16 * LD;

  const int img = blockIdx.x / heads, head = blockIdx.x % heads;
  const int q0 = blockIdx.y * QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp * 16;  // this warp's first query row in the tile
  const bool active = q0 + wr < n;
  T* sQw = sQ + wr * LD;
  const T* qp = q + img * st.qb + head * st.qh;
  const T* kp = k + img * st.kb + head * st.kh;
  const T* vp = v + img * st.vb + head * st.vh;
  T* op = out + img * st.ob + head * st.oh;
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;

  load_rows<HD, THREADS, true>(sQ, qp, st.qn, q0, QT, n, tid, hd);
  load_rows<HD, THREADS, true>(sK, kp, st.kn, 0, RC * 16, n, tid, hd);
  cp_async_commit();  // group 0: q and k
  load_rows<HD, THREADS, true>(sV, vp, st.vn, 0, RC * 16, n, tid, hd);
  cp_async_commit();  // group 1: v, landing while q k^T and the softmax run
  cp_async_wait<1>();
  __syncthreads();
  float s[RC][2][4];
  if (active) {
    qk<HD, RC>(s, sQw, sK, lane);
    float m[2], l[2], lo[2] = {INFINITY, INFINITY};
    scale_mask<RC>(s, 0, n, scale, lane, lo);
    row_max<RC>(s, m);
    exp_rows<RC>(s, m, l);
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    divide_rows<RC>(s, l, exact_corrections(lo, m, l));
  }
  cp_async_wait<0>();
  __syncthreads();
  if (active) pv<HD, RC>(o, s, sV, lane);
  if (active) store_rows<HD, true>(o, sQw, op, st.on, q0 + wr, n, lane, hd);
}

template <int HD, int RC>
int launch_form(const void* q, const void* k, const void* v, void* out, const Strides& st,
                int bh, int heads, int n, int hd, float scale, cudaStream_t stream) {
  constexpr int bytes = (QT + 2 * RC * 16) * Tile<HD>::LD * 2;  // q, then k and v
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        sdpa_kernel<HD, RC, elem>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(bh, (n + QT - 1) / QT);
  sdpa_kernel<HD, RC, elem><<<grid, THREADS, bytes, stream>>>(
      static_cast<const elem*>(q), static_cast<const elem*>(k), static_cast<const elem*>(v),
      static_cast<elem*>(out), st, heads, n, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

// The resident form at the fewest chunks that hold n (13 chunks: n = 197,
// every registry ViT at 224^2); a longer n is sdpa_long.cu's.
template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, const Strides& st, int bh,
           int heads, int n, int hd, float scale, cudaStream_t stream) {
  const int nc = (n + 15) / 16;
  if (nc <= 2) return launch_form<HD, 2>(q, k, v, out, st, bh, heads, n, hd, scale, stream);
  if (nc <= 4) return launch_form<HD, 4>(q, k, v, out, st, bh, heads, n, hd, scale, stream);
  if (nc <= 8) return launch_form<HD, 8>(q, k, v, out, st, bh, heads, n, hd, scale, stream);
  if constexpr (Tile<HD>::RES_KEYS > 128) {
    if (nc <= 13) return launch_form<HD, 13>(q, k, v, out, st, bh, heads, n, hd, scale, stream);
    if (nc <= 16) return launch_form<HD, 16>(q, k, v, out, st, bh, heads, n, hd, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// strides: 12 element strides, (image, head, token) of q, k, v and out
// (bf16, or fp16 in the fp16 instance).  head_dim is a multiple of 8 from 16
// to 128: the instance of the next multiple of 16 runs it, its extra columns
// zeros in shared memory and never stored.  n at most RES_KEYS of that
// instance (256, or 128 above head_dim 96); cudaErrorInvalidValue beyond.
extern "C" int EVT_EXPORT(evt_sdpa)(const void* q, const void* k, const void* v, void* out,
                                    const long long* strides, int batch, int heads, int n,
                                    int head_dim, float scale, void* stream) {
  if (batch == 0 || heads == 0 || n == 0) return 0;
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],  strides[5],
                   strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  if (head_dim < 16 || head_dim > 128 || head_dim % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bh = batch * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((head_dim + 15) / 16) {
#define EVT_SDPA_HD(N) \
    case N / 16: return launch<N>(q, k, v, out, st, bh, heads, n, head_dim, scale, s);
    EVT_SDPA_HD(16)
    EVT_SDPA_HD(32)
    EVT_SDPA_HD(48)
    EVT_SDPA_HD(64)
    EVT_SDPA_HD(80)
    EVT_SDPA_HD(96)
    EVT_SDPA_HD(112)
    EVT_SDPA_HD(128)
#undef EVT_SDPA_HD
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
