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
// Design: one block of 4 warps per (image * head, 64-query tile); each warp
// owns 16 query rows.
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
// - Resident form (n <= RES_KEYS: 256 keys, 128 at d = 128, where the O
//   accumulators take 64 registers): all of K and V sit in shared memory, K
//   with Q in one commit group and V in a second, so V lands while Q K^T and
//   the softmax run.  Each warp holds its 16 x n scores in registers: one
//   Q K^T, one exp per score, one exact division, one PV.  The kernel is
//   compiled for 2, 4, 8, 13 and 16 chunks of 16 keys and takes the fewest
//   that hold n, so its loops carry no bound check (a branch in them keeps
//   the compiler from running loads ahead of the products) and the scores
//   take no more registers than n needs: at n = 197 (13 chunks, every
//   registry ViT at 224^2) 168 registers, three blocks per SM.
// - Streamed form (longer n): 64-key tiles of K (sweep 1) and then K and V
//   (sweep 2) pass through a 2-stage cp.async ring.  Sweep 1 keeps a running
//   row max and sum, l = l * exp(m_old - m_new) + sum exp(s - m_new); sweep 2
//   recomputes S and takes p = exp(s - m) / l, rounds it to bf16 and runs PV.
//   So p is normalised before PV, as K13 does; the online sum differs from a
//   direct one only in the rounding of its fp32 additions.  Any n runs.
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
//   attn_tiles.cuh.
#include <math.h>

#include "attn_tiles.cuh"

namespace {

constexpr int QT = 64, KT = 64, WARPS = 4, THREADS = WARPS * 32;

// Element strides of q, k, v and out over (image, head, token).
struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, ob, oh, on;
};

template <int HD>
struct Tile {
  static constexpr int LD = row_ld(HD);  // shared-memory row stride (elements)
  // The longest n of the resident form: its scores take RES_KEYS / 2
  // registers a thread, beside HD / 2 of O accumulators.
  static constexpr int RES_KEYS = HD == 128 ? 128 : 256;
};

// The softmax's two costly steps, each in one place (bench/sdpa_ab.py
// builds variants of them).
__device__ __forceinline__ float exp_shifted(float s, float m) {
  return expf(__fsub_rn(s, m));
}

// p = e / l correctly rounded, the value of __fdiv_rn(e, l), given y =
// __frcp_rn(l) (one per row), for l >= 1 and e / l >= 2^-101 or e = 0.
// q = RN(e y) lies within 1.5 ulp of e / l; one correction q + (e - l q) y
// brings it within one ulp; then Markstein's theorem holds: with y within
// half an ulp of 1/l and q within one ulp of e/l, the remainder r = e - l q
// is exact in one FMA and RN(q + r y) = RN(e / l).  The bound on e / l keeps
// r clear of underflow, which would break that (exact_corrections decides).
// Five fp32 operations a score, where __fdiv_rn takes a reciprocal on the
// MUFU and about ten more (tests/test_torch_sdpa_tiles.py checks this
// arithmetic against the exact quotient).
__device__ __forceinline__ float normalise(float e, float l, float y) {
  float q = __fmul_rn(e, y);
  q = __fmaf_rn(__fmaf_rn(-l, q, e), y, q);
  return __fmaf_rn(__fmaf_rn(-l, q, e), y, q);
}

// p = e / l for the rows that normalise does not take.
__device__ __forceinline__ float divide_ieee(float e, float l) {
  return __fdiv_rn(e, l);
}

__device__ __forceinline__ float quad_min(float v) {
  v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Whether normalise is exact for every score of the warp's rows: the least
// unmasked score lo gives the least nonzero numerator exp(lo - m), which must
// keep e / l >= 2^-101 (2^-100 here, a margin for expf's last ulps).  lo is
// this thread's share (quad-reduced here); l is quad-reduced.  Warp-uniform,
// so the division loops stay free of branches; a row whose scores span more
// than ~65 takes __fdiv_rn.
__device__ __forceinline__ bool exact_corrections(const float lo[2], const float m[2],
                                                  const float l[2]) {
  bool ok = true;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float least = exp_shifted(quad_min(lo[r]), m[r]);  // every lane shuffles
    ok &= least >= 0x1p-100f * l[r];
  }
  return __all_sync(0xffffffffu, ok);
}

// s = f32(q . k) * scale, -inf for keys at or past n (key0: the first key
// of chunk 0); lo[r] becomes the least unmasked score of row r in this
// thread's share, if smaller.
template <int NC>
__device__ __forceinline__ void scale_mask(float (&s)[NC][2][4], int key0, int n, float scale,
                                           int lane, float lo[2]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int key = key0 + c * 16 + (e / 4) * 8 + 2 * (lane & 3) + (e & 1);
      float& x = s[c][e / 4][e % 4];
      x = key < n ? __fmul_rn(x, scale) : -INFINITY;
      if (key < n) lo[(e % 4) / 2] = fminf(lo[(e % 4) / 2], x);
    }
}

// In place, p = e / l: by normalise where exact_corrections holds, else by
// the IEEE division.
template <int NC>
__device__ __forceinline__ void divide_rows(float (&s)[NC][2][4], const float l[2],
                                            bool corrections) {
  if (corrections) {
    const float y[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float& x = s[c][e / 4][e % 4];
        x = normalise(x, l[(e % 4) / 2], y[(e % 4) / 2]);
      }
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float& x = s[c][e / 4][e % 4];
        x = divide_ieee(x, l[(e % 4) / 2]);
      }
  }
}

// The row max of the scores (m[0]: row g, m[1]: row g + 8), quad-reduced.
template <int NC>
__device__ __forceinline__ void row_max(const float (&s)[NC][2][4], float m[2]) {
  m[0] = m[1] = -INFINITY;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) m[(e % 4) / 2] = fmaxf(m[(e % 4) / 2], s[c][e / 4][e % 4]);
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
}

// In place, s becomes exp(s - m) (0 for a masked key); returns this
// thread's share of each row's sum in l (not quad-reduced).
template <int NC>
__device__ __forceinline__ void exp_rows(float (&s)[NC][2][4], const float m[2], float l[2]) {
  l[0] = l[1] = 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float& x = s[c][e / 4][e % 4];
      const int r = (e % 4) / 2;
      x = x == -INFINITY ? 0.0f : exp_shifted(x, m[r]);
      l[r] = __fadd_rn(l[r], x);
    }
}

// RC > 0: the resident form over RC 16-key chunks (n <= 16 RC); RC == 0:
// the streamed form.
template <int HD, int RC, class T>
__global__ __launch_bounds__(THREADS) void sdpa_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, Strides st, int heads, int n, float scale) {
  constexpr int LD = Tile<HD>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sKV = sQ + QT * LD;

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

  load_rows<HD, THREADS>(sQ, qp, st.qn, q0, QT, n, tid);
  if constexpr (RC > 0) {
    T* sK = sKV;
    T* sV = sKV + RC * 16 * LD;
    load_rows<HD, THREADS>(sK, kp, st.kn, 0, RC * 16, n, tid);
    cp_async_commit();  // group 0: q and k
    load_rows<HD, THREADS>(sV, vp, st.vn, 0, RC * 16, n, tid);
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
  } else {
    constexpr int NC = KT / 16;
    const int tiles = (n + KT - 1) / KT, steps = 2 * tiles;
    // Step i < tiles: k tile i (sweep 1); step i >= tiles: k and v tile
    // i - tiles (sweep 2); stage i % 2 of the ring holds a k and a v tile.
    auto prefetch = [&](int i) {
      T* sK = sKV + (i & 1) * 2 * KT * LD;
      const int t = i < tiles ? i : i - tiles;
      load_rows<HD, THREADS>(sK, kp, st.kn, t * KT, KT, n, tid);
      if (i >= tiles) load_rows<HD, THREADS>(sK + KT * LD, vp, st.vn, t * KT, KT, n, tid);
    };
    prefetch(0);
    cp_async_commit();  // group 0: q and the first k tile
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, lo[2] = {INFINITY, INFINITY};
    bool corrections = true;
    for (int i = 0; i < steps; ++i) {
      if (i + 1 < steps) prefetch(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // step i landed
      if (active) {
        const T* sK = sKV + (i & 1) * 2 * KT * LD;
        const int t = i < tiles ? i : i - tiles;
        float s[NC][2][4];
        qk<HD, NC>(s, sQw, sK, lane);
        scale_mask<NC>(s, t * KT, n, scale, lane, lo);
        if (i < tiles) {
          float mt[2], lt[2];
          row_max<NC>(s, mt);
#pragma unroll
          for (int r = 0; r < 2; ++r) mt[r] = fmaxf(mt[r], m[r]);
          exp_rows<NC>(s, mt, lt);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            l[r] = __fadd_rn(__fmul_rn(l[r], exp_shifted(m[r], mt[r])), lt[r]);
            m[r] = mt[r];
          }
        } else {
          if (i == tiles) {
            l[0] = quad_sum(l[0]);
            l[1] = quad_sum(l[1]);
            corrections = exact_corrections(lo, m, l);
          }
#pragma unroll
          for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              float& x = s[c][e / 4][e % 4];
              x = x == -INFINITY ? 0.0f : exp_shifted(x, m[(e % 4) / 2]);
            }
          divide_rows<NC>(s, l, corrections);
          pv<HD, NC>(o, s, sK + KT * LD, lane);
        }
      }
      __syncthreads();  // every warp is done with stage i % 2 before step i + 2 refills it
    }
  }
  if (active) store_rows<HD>(o, sQw, op, st.on, q0 + wr, n, lane);
}

template <int HD, int RC>
int launch_form(const void* q, const void* k, const void* v, void* out, const Strides& st,
                int bh, int heads, int n, float scale, cudaStream_t stream) {
  constexpr int rows = RC > 0 ? QT + 2 * RC * 16 : QT + 2 * 2 * KT;  // q, then k and v
  constexpr int bytes = rows * Tile<HD>::LD * 2;
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
      static_cast<elem*>(out), st, heads, n, scale);
  return static_cast<int>(cudaGetLastError());
}

// The resident form at the fewest chunks that hold n (13 chunks: n = 197,
// every registry ViT at 224^2), else the streamed form.
template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, const Strides& st, int bh,
           int heads, int n, float scale, cudaStream_t stream) {
  const int nc = (n + 15) / 16;
  if (nc <= 2) return launch_form<HD, 2>(q, k, v, out, st, bh, heads, n, scale, stream);
  if (nc <= 4) return launch_form<HD, 4>(q, k, v, out, st, bh, heads, n, scale, stream);
  if (nc <= 8) return launch_form<HD, 8>(q, k, v, out, st, bh, heads, n, scale, stream);
  if constexpr (Tile<HD>::RES_KEYS > 128) {
    if (nc <= 13) return launch_form<HD, 13>(q, k, v, out, st, bh, heads, n, scale, stream);
    if (nc <= 16) return launch_form<HD, 16>(q, k, v, out, st, bh, heads, n, scale, stream);
  }
  return launch_form<HD, 0>(q, k, v, out, st, bh, heads, n, scale, stream);
}

}  // namespace

// strides: 12 element strides, (image, head, token) of q, k, v and out
// (bf16, or fp16 in the fp16 instance).
extern "C" int EVT_EXPORT(evt_sdpa)(const void* q, const void* k, const void* v, void* out,
                                    const long long* strides, int batch, int heads, int n,
                                    int head_dim, float scale, void* stream) {
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
