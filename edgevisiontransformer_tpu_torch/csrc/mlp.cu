// mlp: Y[M, D] = bf16(f32(bf16(gelu(X @ W1 + b1))) @ W2 + b2), both products
// in one kernel, the hidden activation kept on chip: the MLP of the ViT
// module's kernel_mode="pallas" forward.
//
// Replaces: `_mlp_kernel` / `mlp` (K14) in
//   edgevisiontransformer_tpu/ops/pallas/fused_mlp.py:23-79, with its cast
//   points (:25-30):
//     h   = f32(X @ W1) + f32(b1)          (fp32 accumulation, no rounding)
//     h   = bf16(gelu(h))                  (GELU on the fp32 value, one cast)
//     out = bf16(f32(h @ W2) + f32(b2))
//   GELU is the exact form with erff (K14's mathlib.gelu_kernel evaluates erf
//   with a polynomial, erf_poly, within 7.2e-7 of erf) or the tanh form.  This
//   is neither of linear.cu's epilogues: CAST_THEN_BIAS_GELU rounds twice
//   before GELU, BIAS_RESIDUAL adds a residual.
//
// Bound on the card: a deit_tiny b128 layer (M = 25,216, D = 192, hidden
// 768) does 4 * M * D * hidden = 14.9 GFLOP on 20 MB (X and Y, the weights
// once): 0.0150 ms on the tensor cores at 989 TFLOP/s against 0.0060 ms of
// bytes, so operations bound it at serving batches.  At b1 (M = 197) it moves
// 742 KB (the weights once, X in and Y out): ~0.22 us of bytes, so the launch
// and the latency of each block's chain of loads and products bound it.
//
// Design (bench/mlp_ab.py times its choices; PERF.md section 6 has the numbers).
// - Each warp owns 16 rows; a block has 8 warps (128 rows) or 4 (64 rows),
//   as the host's plan says (ops/cuda/fused_mlp.py:plan).  Every row block
//   reads all of W1 and W2 for its column tile from L2, so 128 rows halve
//   that traffic (116 MB a deit_tiny b128 layer, 232 MB at 64 rows); 128
//   rows are taken where the row blocks fill at least half the card and D
//   is at most 512 (the block's X rows stay in shared memory).
// - Both products run on mma.sync.m16n8k16 (bf16 in, fp32 accumulators) fed
//   by ldmatrix from tiles whose row stride is an odd multiple of 16 bytes
//   (8 rows land in 8 distinct bank groups).  fc1's A fragments come from
//   the X rows, its B fragments from the W1 tile [k, HC] by ldmatrix.trans
//   (W1 is k-major, as V is in sdpa's PV); fc2's B from the W2 tile [HC, NT]
//   likewise.
// - The hidden width is walked in chunks of HC units.  A chunk's fc1
//   accumulators (16 rows x HC units a warp: HC / 2 registers) take +
//   f32(b1) and GELU in registers and are packed to bf16x2: in the m16n8
//   layout two neighbouring n8 tiles packed so are the A fragment of one
//   k16 step of fc2 (sdpa's P -> PV reuse).  The hidden chunk never touches
//   shared memory.  HC = 64 (128 rows, no split, where the ring fits) halves
//   the barriers and the reloads of X's fragments against HC = 32, which
//   keeps the hidden registers few beside the NT / 2 output accumulators
//   and the split's shares fine at small M.
// - W1 arrives in slabs [KS <= KMAX rows of D, HC] through a STAGES-deep
//   cp.async ring, one commit group per slab, waited for with depth STAGES -
//   2 and the next slab issued right after the barrier, so two slabs are in
//   flight while one computes.  A chunk's W2 tile rides in the group of its
//   first slab, into a ring of its own.  At D = 192 a chunk is one slab: one
//   barrier a chunk.
// - D wider than NT is cut into column tiles, each recomputing fc1 (3x fc1
//   at deit_base's 768, 2x at t2t_vit_14's 384): an fp32 accumulator tile of
//   all D columns would not fit in registers.
// - Small M (few row blocks): a cluster of S <= 8 blocks splits the hidden
//   chunks, block s walking the contiguous s-th share, and the column tiles
//   narrow to 64 until the clusters cover half the SMs (deit_tiny b1: 4 row
//   blocks x 3 column tiles x S = 8).  Each block leaves its fp32 partial
//   tile in its own shared memory (over the X rows and the ring); after
//   cluster.sync() block r sums rows r * BM / S .. of the S partials through
//   distributed shared memory in the order s = 0 .. S - 1, adds f32(b2),
//   rounds and stores; a second cluster.sync() keeps every partial alive
//   until its readers are done.  One launch, no workspace, no atomics:
//   deterministic, and safe under graph capture.  S = 1 (serving batches)
//   rounds the accumulators straight to bf16.  S > 1 sums the chunks in
//   another order than S = 1, so a row may differ by one bf16 spacing
//   between a small and a large M.
// - Any hidden width: where hidden % 8 != 0 or W1 (W2) is off a 16-byte
//   boundary, that operand is loaded element by element; units past hidden
//   get zero W1 columns, zero b1 and zero W2 rows, so gelu(0) = 0 meets zeros
//   (never leave them unset: 0 * NaN is NaN).  D is a multiple of 8; X and W1
//   are zero-filled past D up to the slabs' k16 steps.
// - Warps whose 16 rows all lie past M skip the products (the last row block
//   at b1) but keep every barrier.
// - What holds it back at b128 (mlp_ab): each warp reloads every weight
//   fragment from shared memory for its own 16 rows, the GELU's fp32 work
//   runs between the products rather than beside them (the whole block keeps
//   step), and 197 row blocks make 1.5 waves on 132 SMs.  wgmma, whose
//   warpgroup reads B once for 64 rows, is the next step.
#include <cooperative_groups.h>

#include "common.cuh"
#include "mma_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int STAGES = 3;         // W1 slabs in the ring
constexpr int KMAX = 192;         // the most rows of D in a W1 slab
constexpr int MAX_SPLIT = 8;      // the portable cluster size
constexpr int MAX_SMEM = 232448;  // the most dynamic shared memory a block may use

// The activation, in one place (bench/mlp_ab.py builds a variant of it).
__device__ __forceinline__ float gelu_act(float h, int approx) {
  return approx ? gelu_tanh_f(h) : gelu_erf_f(h);
}

// Shared memory, in bytes from the start: X [BM, xld], the W1 ring
// [STAGES][KS, HC + 8], the W2 ring [nw2][HC, NT + 8]; with S > 1 the fp32
// partial tile [BM, NT + 4] reuses the start.  A chunk's W2 tile is issued
// STAGES - 1 slabs ahead, so nw2 buffers cover the chunks that span them.
// fused_mlp.py:_smem_bytes mirrors this.
struct Layout {
  int ks, KS, xld, w1_off, w2_off, nw2, pld, bytes;
  __host__ __device__ Layout(int dim, int bm, int nt, int hc) {
    ks = (dim + KMAX - 1) / KMAX;
    KS = ((dim + ks - 1) / ks + 15) / 16 * 16;
    xld = ks * KS + 8;
    nw2 = 1 + (STAGES - 2 + ks) / ks;
    pld = nt + 4;
    w1_off = bm * xld * 2;
    w2_off = w1_off + STAGES * KS * (hc + 8) * 2;
    const int end = w2_off + nw2 * hc * (nt + 8) * 2;
    bytes = end > bm * pld * 4 ? end : bm * pld * 4;
  }
};

// W1[k0:k0+KS, j0:j0+HC] into a slab, zeros past dim and hidden.
template <int THREADS, int HC, class T>
__device__ __forceinline__ void load_w1(T* dst, const T* __restrict__ W1, int dim,
                                        int hidden, int KS, int k0, int j0, bool vec, int tid) {
  constexpr int W1LD = HC + 8;
  if (vec) {
    for (int i = tid; i < KS * (HC / 8); i += THREADS) {
      const int r = i / (HC / 8), c = (i % (HC / 8)) * 8;
      const bool ok = k0 + r < dim && j0 + c < hidden;
      cp_async16(dst + r * W1LD + c, ok ? W1 + static_cast<size_t>(k0 + r) * hidden + j0 + c : W1,
                 ok);
    }
  } else {
    for (int i = tid; i < KS * HC; i += THREADS) {
      const int r = i / HC, c = i % HC;
      dst[r * W1LD + c] = k0 + r < dim && j0 + c < hidden
                              ? W1[static_cast<size_t>(k0 + r) * hidden + j0 + c]
                              : Elem<T>::from_float(0.0f);
    }
  }
}

// W2[j0:j0+HC, n0:n0+NT] into a tile, zeros past hidden and dim.
template <int THREADS, int NT, int HC, class T>
__device__ __forceinline__ void load_w2(T* dst, const T* __restrict__ W2, int dim,
                                        int hidden, int j0, int n0, bool vec, int tid) {
  constexpr int LD = NT + 8;
  if (vec) {
    for (int i = tid; i < HC * (NT / 8); i += THREADS) {
      const int r = i / (NT / 8), c = (i % (NT / 8)) * 8;
      const bool ok = j0 + r < hidden && n0 + c < dim;
      cp_async16(dst + r * LD + c, ok ? W2 + static_cast<size_t>(j0 + r) * dim + n0 + c : W2, ok);
    }
  } else {
    for (int i = tid; i < HC * NT; i += THREADS) {
      const int r = i / NT, c = i % NT;
      dst[r * LD + c] = j0 + r < hidden && n0 + c < dim
                            ? W2[static_cast<size_t>(j0 + r) * dim + n0 + c]
                            : Elem<T>::from_float(0.0f);
    }
  }
}

template <class T>
__device__ __forceinline__ float bias_at(const T* __restrict__ b, int i, int n) {
  return i < n ? Elem<T>::to_float(b[i]) : 0.0f;
}

// Grid (split * row tiles, column tiles); a cluster is the split's blocks of
// one (row tile, column tile).
template <int WARPS, int NT, int HC, class T>
__global__ __launch_bounds__(WARPS * 32) void mlp_kernel(
    const T* __restrict__ X, const T* __restrict__ W1, const T* __restrict__ b1,
    const T* __restrict__ W2, const T* __restrict__ b2, T* __restrict__ Y, int M,
    int dim, int hidden, int approx, int split, bool v1, bool v2) {
  constexpr int THREADS = WARPS * 32, BM = WARPS * 16, NJ = NT / 8;
  constexpr int W1LD = HC + 8, W2LD = NT + 8;
  const Layout L(dim, BM, NT, HC);
  extern __shared__ __align__(128) unsigned char smem[];
  T* sX = reinterpret_cast<T*>(smem);
  T* sW1 = reinterpret_cast<T*>(smem + L.w1_off);
  T* sW2 = reinterpret_cast<T*>(smem + L.w2_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s = blockIdx.x % split;
  const int m0 = (blockIdx.x / split) * BM, n0 = blockIdx.y * NT;
  const int wr = warp * 16;  // this warp's first row in the block
  const bool active = m0 + wr < M;
  const int g = lane >> 2, t = lane & 3;
  const int KS = L.KS, ks = L.ks, xld = L.xld;
  // this block's share of the hidden chunks
  const int nc = (hidden + HC - 1) / HC;
  const int c0 = s * nc / split, c1 = (s + 1) * nc / split;
  const int steps = (c1 - c0) * ks;

  // The block's X rows, zeros past M and the slabs' width (dim % 8 == 0: a
  // vector is all in or all out); group 0 with the first slab.
  for (int i = tid; i < BM * (ks * KS / 8); i += THREADS) {
    const int r = i / (ks * KS / 8), c = (i % (ks * KS / 8)) * 8;
    const bool ok = m0 + r < M && c < dim;
    cp_async16(sX + r * xld + c, ok ? X + static_cast<size_t>(m0 + r) * dim + c : X, ok);
  }
  // step i: W1 slab i % ks of chunk c0 + i / ks into stage i % STAGES, and
  // with the chunk's first slab its W2 tile into W2 buffer (i / ks) % nw2
  auto prefetch = [&](int i) {
    const int cl = i / ks, kt = i % ks, j0 = (c0 + cl) * HC;
    load_w1<THREADS, HC>(sW1 + (i % STAGES) * KS * W1LD, W1, dim, hidden, KS, kt * KS, j0, v1,
                         tid);
    if (kt == 0)
      load_w2<THREADS, NT, HC>(sW2 + (cl % L.nw2) * HC * W2LD, W2, dim, hidden, j0, n0, v2, tid);
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < steps) prefetch(i);
    cp_async_commit();
  }

  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float h[HC / 8][4];
  float bias[HC / 8][2];

  const T* sXw = sX + wr * xld;
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step i landed; every warp is done with step i - 1
    if (i + STAGES - 1 < steps) prefetch(i + STAGES - 1);
    cp_async_commit();
    if (!active) continue;
    const int cl = i / ks, kt = i % ks, j0 = (c0 + cl) * HC;
    if (kt == 0) {
#pragma unroll
      for (int j = 0; j < HC / 8; ++j) {
        h[j][0] = h[j][1] = h[j][2] = h[j][3] = 0.0f;
        bias[j][0] = bias_at(b1, j0 + 8 * j + 2 * t, hidden);
        bias[j][1] = bias_at(b1, j0 + 8 * j + 2 * t + 1, hidden);
      }
    }
    // fc1: h += X[:, slab] @ W1[slab, chunk]
    const T* w1s = sW1 + (i % STAGES) * KS * W1LD;
    const T* xs = sXw + kt * KS;
#pragma unroll 4
    for (int kk = 0; kk < KS; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, xs + (lane & 15) * xld + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < HC / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, w1s + (kk + (lane & 15)) * W1LD + np * 16 + (lane >> 4) * 8);
        mma16<T>(h[2 * np], a, b[0], b[1]);
        mma16<T>(h[2 * np + 1], a, b[2], b[3]);
      }
    }
    if (kt != ks - 1) continue;
    // the chunk is summed: + f32(b1), GELU in fp32, one round to T, packed
    // as fc2's A fragments; then acc += h @ W2[chunk, tile]
    const T* w2c = sW2 + (cl % L.nw2) * HC * W2LD;
#pragma unroll
    for (int q = 0; q < HC / 16; ++q) {
      float v[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[u][e] = gelu_act(h[2 * q + u][e] + bias[2 * q + u][e & 1], approx);
      const uint32_t a[4] = {pack2<T>(v[0][0], v[0][1]), pack2<T>(v[0][2], v[0][3]),
                             pack2<T>(v[1][0], v[1][1]), pack2<T>(v[1][2], v[1][3])};
#pragma unroll
      for (int np = 0; np < NT / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, w2c + (q * 16 + (lane & 15)) * W2LD + np * 16 + (lane >> 4) * 8);
        mma16<T>(acc[2 * np], a, b[0], b[1]);
        mma16<T>(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  // thread (g, t) holds rows g and g + 8 of the warp, columns 8j + 2t, + 1
  const int cols = min(NT, dim - n0);  // a multiple of 8
  if (split == 1) {
    // Y = T(acc + f32(b2)) through the warp's own X rows (no other warp
    // reads them; cp.async wrote them in group 0, long waited for), then to
    // Y as 16-byte vectors
    if (!active) return;
    T* sYw = sX + wr * xld;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = 8 * j + 2 * t;
      if (c >= cols) continue;
      const float c0b = Elem<T>::to_float(b2[n0 + c]), c1b = Elem<T>::to_float(b2[n0 + c + 1]);
      *reinterpret_cast<uint32_t*>(sYw + g * xld + c) = pack2<T>(acc[j][0] + c0b,
                                                                 acc[j][1] + c1b);
      *reinterpret_cast<uint32_t*>(sYw + (g + 8) * xld + c) =
          pack2<T>(acc[j][2] + c0b, acc[j][3] + c1b);
    }
    __syncwarp();
    for (int i = lane; i < 16 * (cols / 8); i += 32) {
      const int r = i / (cols / 8), c = (i % (cols / 8)) * 8;
      if (m0 + wr + r < M)
        *reinterpret_cast<uint4*>(Y + static_cast<size_t>(m0 + wr + r) * dim + n0 + c) =
            *reinterpret_cast<const uint4*>(sYw + r * xld + c);
    }
    return;
  }

  // S > 1: the fp32 partial tile over the X rows and the ring
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with X and the ring
  float* sP = reinterpret_cast<float*>(smem);
  const int pld = L.pld;
  if (active) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = 8 * j + 2 * t;
      *reinterpret_cast<float2*>(sP + (wr + g) * pld + c) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(sP + (wr + g + 8) * pld + c) = make_float2(acc[j][2], acc[j][3]);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every partial of the cluster is written
  const int rank = static_cast<int>(cluster.block_rank());
  const int r0 = rank * BM / split, r1 = (rank + 1) * BM / split;
  for (int i = tid; i < (r1 - r0) * (cols / 8); i += THREADS) {
    const int r = r0 + i / (cols / 8), c = (i % (cols / 8)) * 8;
    if (m0 + r >= M) continue;
    float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int p = 0; p < split; ++p) {  // in split order: deterministic
      const float* peer = cluster.map_shared_rank(sP, p) + r * pld + c;
      const float4 lo = *reinterpret_cast<const float4*>(peer);
      const float4 hi = *reinterpret_cast<const float4*>(peer + 4);
      v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
      v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += Elem<T>::to_float(b2[n0 + c + e]);
    *reinterpret_cast<uint4*>(Y + static_cast<size_t>(m0 + r) * dim + n0 + c) = pack8<T>(v);
  }
  cluster.sync();  // no block leaves while a peer may still read its partial
}

template <int WARPS, int NT, int HC>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* y, int M, int dim, int hidden, int approx, int split, bool v1, bool v2,
           cudaStream_t stream) {
  constexpr int BM = WARPS * 16;
  const Layout L(dim, BM, NT, HC);
  if (L.bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlp_kernel<WARPS, NT, HC, elem>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split * ((M + BM - 1) / BM), (dim + NT - 1) / NT);
  cfg.blockDim = dim3(WARPS * 32);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, mlp_kernel<WARPS, NT, HC, elem>, static_cast<const elem*>(x),
      static_cast<const elem*>(w1), static_cast<const elem*>(b1), static_cast<const elem*>(w2),
      static_cast<const elem*>(b2), static_cast<elem*>(y), M, dim, hidden, approx, split, v1, v2);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int WARPS, int HC>
int launch_nt(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
              void* y, int M, int dim, int hidden, int approx, int split, int nt, bool v1,
              bool v2, cudaStream_t s) {
  switch (nt) {
#define EVT_MLP_NT(N) \
    case N: return launch<WARPS, N, HC>(x, w1, b1, w2, b2, y, M, dim, hidden, approx, split, v1, v2, s);
    EVT_MLP_NT(64)
    EVT_MLP_NT(128)
    EVT_MLP_NT(192)
    EVT_MLP_NT(256)
#undef EVT_MLP_NT
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x [M, dim] and y 16-byte aligned, dim % 8 == 0; w1 [dim, hidden], b1
// [hidden], w2 [hidden, dim], b2 [dim] bf16 (fp16 in the fp16 instance) at
// any alignment.  The plan
// (ops/cuda/fused_mlp.py:plan): rows per block (64 or 128), split (the
// blocks of a cluster sharing the hidden width, 1..8), nt (output columns
// per block: 64, 128, 192 or 256) and hc (hidden units per chunk: 32, or
// 64 at 128 rows).
extern "C" int EVT_EXPORT(evt_mlp)(const void* x, const void* w1, const void* b1, const void* w2,
                                   const void* b2, void* y, int M, int dim, int hidden,
                                   int approx, int rows, int split, int nt, int hc,
                                   void* stream) {
  if (M == 0) return 0;
  if (dim <= 0 || dim % 8 || hidden <= 0 || !aligned16(x) || !aligned16(y) || split < 1 ||
      split > MAX_SPLIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool v1 = hidden % 8 == 0 && aligned16(w1);
  const bool v2 = aligned16(w2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 128 && hc == 64)
    return launch_nt<8, 64>(x, w1, b1, w2, b2, y, M, dim, hidden, approx, split, nt, v1, v2, s);
  if (rows == 128 && hc == 32)
    return launch_nt<8, 32>(x, w1, b1, w2, b2, y, M, dim, hidden, approx, split, nt, v1, v2, s);
  if (rows == 64 && hc == 32)
    return launch_nt<4, 32>(x, w1, b1, w2, b2, y, M, dim, hidden, approx, split, nt, v1, v2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
