// mlp_wide: Y[M, D] = T(f32(T(gelu(f32(X @ W1) + f32(b1)))) @ W2 + f32(b2)) for
// D above 1,152 (ViT-H/14's 1,280, ViT-g/14's 1,408, ViT-G/14's 1,664, and
// any wider multiple of 8): the wide form of K14 behind ops/cuda/fused_mlp.py
// :mlp, which sends every narrower D to csrc/mlp.cu.
//
// Replaces: `_mlp_kernel` / `mlp` (K14) in
//   edgevisiontransformer_tpu/ops/pallas/fused_mlp.py:23-79 at those widths,
//   with its cast points (:25-30), the same as mlp.cu's:
//     h   = f32(X @ W1) + f32(b1)          (fp32 accumulation, no rounding)
//     h   = T(gelu(h))                     (GELU on the fp32 value, one round)
//     out = T(f32(h @ W2) + f32(b2))
//   GELU is the exact form with erff or the tanh form (gelu_act).  The JAX
//   kernel holds both weights in VMEM and never cuts D (:60); 227 KB of
//   shared memory holds nothing like that at these widths, and mlp.cu's plan
//   (X rows resident beside its rings, fc1 recomputed for every column tile
//   of D) left two warps on an SM and did 5x the fc1 work at D 1,280.
//
// Bound on the card: one ViT-H/14 layer (D 1,280, hidden 5,120) reads 26.2 MB
// of weights (7.8 us at 3.35 TB/s) and does 6.7 GFLOP at b1 (M = 257; 6.8 us
// at 989 TFLOP/s) and 53.9 GFLOP at b8 (M = 2,056; 54.5 us): bytes and
// operations about even at b1, operations at b8.  What holds this kernel
// back is the traffic from L2 to the SMs: a 64 x 256 tile streams its whole
// K of A and B, 40 KB a 64-deep step for 2.1 MFLOP, and the loads alone (the
// products left out) take ~90% of the kernel's time at b1 and b8
// (bench/mlp_ab.py's floors; PERF.md section 6).  At b1 the 64-row
// granularity of wgmma adds a fifth row tile for one row (M = 257).
//
// Design: one persistent cooperative launch (vit_full.cu's barrier:
// cudaLaunchCooperativeKernel and cooperative_groups' grid sync; the runtime
// refuses the launch unless every block is resident, and the wrapper raises
// on the refusal), one block an SM on the grid of the host's plan
// (ops/cuda/fused_mlp.py:wide_plan), in three phases:
// 1. fc1 + GELU: H[M, HP] = T(gelu(f32(X @ W1) + f32(b1))) in tiles of 64
//    rows x 256 hidden units, block b taking tiles b, b + grid, ...; the row
//    tiles of one hidden tile run on neighbouring blocks, so W1 comes from
//    device memory once and the other row tiles find it in L2.  HP is hidden
//    rounded up to 256; past hidden W1's columns and b1 load as zeros, so H
//    holds gelu(0) = 0 there.  H is a workspace the wrapper allocates (M x HP
//    in T: 2.6 MB at ViT-H/14 b1, 21 MB at b8), the only place the hidden
//    activation lives.  It stays in the 50 MB L2 between the phases; were it
//    to fall out, it would cost one write and one read of it in device
//    memory (~1.6 us at b1, ~12.6 us at b8).  fc1 is computed once.
// 2. One grid barrier, then fc2 in tiles of 64 rows x 256 columns of D.
//    Where the tiles are few (b1: 5 x 5) fc2's K (HP) is cut into S
//    contiguous shares of whole 64-deep steps, one unit a (tile, share), so
//    every hidden unit falls in exactly one share (the plan's cost model
//    picks S).  S = 1 rounds acc + f32(b2) straight to Y; S > 1 writes each
//    share's fp32 partial to a second workspace P[S, M, D].
// 3. With S > 1 a second barrier, then each 8 outputs summed over the
//    shares in the order s = 0 .. S - 1, + f32(b2), one round: the fixed
//    order of mlp.cu's cluster split.  No atomics: the same inputs give the
//    same bits on every call and under graph replay; a row differs between
//    two M only through S.
// - Both products on wgmma.mma_async m64n128k16 (bf16, or f16 in the
//   -DEVT_F16 instance) with fp32 accumulators: the block's two consumer
//   warpgroups take 128 columns of the tile each (64 accumulators a thread).
//   A (X or H) is K-major; B (W1 [D, hidden] or W2 [hidden, D]) is
//   N-contiguous ("MN-major") and read as it lies through the instruction's
//   transpose-B flag, so no transposed copy of the weights is made.
// - The operands of each 64-deep K step land in a 4-stage ring in shared
//   memory (A 64 x 64; B 64 x 256 as four 64-column panels), in the
//   128-byte-swizzled layout the descriptors name: 16-byte chunk c of the
//   128-byte row r at chunk c ^ (r % 8), each 8-row group 1,024 bytes (the
//   descriptors' SBO), B's panels BK * 128 bytes apart (its LBO).
// - The ring is fed by TMA (mlp_wide_tma_kernel): a producer warp, whose lane
//   0 walks the same units as the consumers and, per step, waits for the
//   slot's `empty` mbarrier, then issues one 64 x 64 box of A and four of B
//   (cp.async.bulk.tensor, 128-byte swizzle, zeros past the tensors' edges:
//   rows past M, K past D or hidden) counted on the slot's `full` mbarrier.
//   A consumer warpgroup waits on `full`, issues the step's products, keeps
//   them in flight (LAG = 1) while it waits for the next step, and releases
//   a slot (one arrive a warpgroup on `empty`) once its products are done.
//   The tensor maps (hopper.cuh's make_map, which holds the descriptors,
//   mbarrier and TMA routines sdpa_long.cu shares) are made on the host for
//   each call and passed as __grid_constant__ parameters.  Against
//   the first form of this kernel, whose 256 threads loaded every step by
//   cp.async behind a block barrier, TMA took ViT-H/14 b1 from 59 to 40 us
//   and b8 from 290-295 to 183-185 us (bench/mlp_ab.py, PERF.md section 6).
// - TMA wants 16-byte global strides and bases; where W1 or W2 has neither
//   (hidden % 8 != 0, such as 6,150, or an unaligned pointer) the launch
//   takes that first form (mlp_wide_kernel): all 256 threads load by
//   cp.async (16-byte chunks zero-filled past the edges, or element by
//   element where the rows are not 16-byte vectors), AHEAD = 2 steps ahead;
//   a step is read after cp.async.wait_group, fence.proxy.async (the
//   products read shared memory through the async proxy) and a block
//   barrier.  Both forms share the products, the epilogues and the order
//   of every sum, so they give the same bits.
// - The epilogues run from the accumulator registers (rows g and g + 8 of
//   each warp's 16, columns 8j + 2q and + 1): + f32(b1), GELU, one round and
//   4-byte stores to H (then fence.proxy.async.global: phase 2 reads H
//   through the async proxy); + f32(b2), one round to Y, or fp32 pairs to P.
#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64;         // rows a tile: one wgmma M
constexpr int BN = 256;        // columns a tile: two warpgroups of WN
constexpr int WN = 128;        // a warpgroup's columns
constexpr int BK = 64;         // K a ring step: one 128-byte row of 16-bit values
constexpr int STAGES = 4;      // ring steps
constexpr int LAG = 1;         // groups of products a warpgroup leaves in flight
constexpr int AHEAD = STAGES - 1 - LAG;  // steps the cp.async form loads ahead
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int PRODUCER = 32;             // the TMA form's producer warp
constexpr int MAX_SPLIT = 8;   // the most shares of fc2's K
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BK * BN * 2;
constexpr int PANEL_BYTES = BK * 128;  // one 64-column panel of a B step
constexpr int STEP_BYTES = A_BYTES + B_BYTES;
// the ring, up to 1,024 bytes to align it (the swizzle's period), and the
// TMA form's full and empty mbarriers (fused_mlp.py:wide_smem_bytes mirrors
// this)
constexpr int SMEM = STAGES * STEP_BYTES + 1024 + 2 * STAGES * 8;
static_assert(AHEAD >= 1 && SMEM <= 232448, "the ring");

// The activation, in one place (bench/mlp_ab.py builds a variant of it).
__device__ __forceinline__ float gelu_act(float h, int approx) {
  return approx ? gelu_tanh_f(h) : gelu_erf_f(h);
}

template <class T>
struct Params {
  const T *x, *w1, *b1, *w2, *b2;
  T *y, *h;
  float* part;
  int M, dim, hidden, hp, approx, split;
  bool v1, v2;
};

// The TMA form's parameters: the tensor maps of X [M, dim], W1 [dim,
// hidden], H [M, hp] and W2 [hidden, dim] beside the rest.
template <class T>
struct TmaParams {
  CUtensorMap x, w1, h, w2;
  Params<T> q;
};

// Byte offset of 16-byte chunk c of 128-byte row r in the swizzled layout.
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// d[64] += A (64 x 16, K-major) @ B (16 x 128, N-contiguous: transpose-B).
#define EVT_WGMMA_N128(TY)                                                                 \
  asm volatile(                                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                         \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                         \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "   \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
      "%64, %65, p, 1, 1, 0, 1;\n}\n"                                                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),            \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),          \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),      \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),      \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),      \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),      \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),      \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),      \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),      \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                                 \
      : "l"(a), "l"(b), "r"(1))

template <class T>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_n128<bf16>(float (&d)[64], uint64_t a, uint64_t b) {
  EVT_WGMMA_N128("bf16");
}

template <>
__device__ __forceinline__ void wgmma_n128<f16>(float (&d)[64], uint64_t a, uint64_t b) {
  EVT_WGMMA_N128("f16");
}
#undef EVT_WGMMA_N128

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products (their asm names them as outputs when issued).
__device__ __forceinline__ void fence_acc(float (&acc)[WN / 2]) {
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// A step's products from the ring step at shared address `st`, issued and
// committed as one group: acc += A[rows, 64] @ B[64, columns] of this
// warpgroup.
template <class T>
__device__ __forceinline__ void step_products(float (&acc)[WN / 2], uint32_t st) {
  const uint32_t b = st + A_BYTES + (threadIdx.x >> 7) * (WN / 64) * PANEL_BYTES;
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_n128<T>(acc, desc(st + kk * 32, 16, 1024), desc(b + kk * 16 * 128, PANEL_BYTES, 1024));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void products_wait(float (&acc)[WN / 2]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
  fence_acc(acc);
}

template <class T>
__device__ __forceinline__ float bias_at(const T* __restrict__ b, int i, int n) {
  return i < n ? Elem<T>::to_float(b[i]) : 0.0f;
}

// The fc2 unit u: its tile's first row and column and its share [k0, k1)
// of fc2's K steps.  The row tiles of one (column tile, share) are
// neighbours, so the W2 slab they share comes from L2.
struct Unit {
  int m0, n0, s, k0, k1;
};

__device__ __forceinline__ Unit fc2_unit(int u, int rt, int S, int ks) {
  const int s = (u / rt) % S;
  return {(u % rt) * BM, (u / (rt * S)) * BN, s, s * ks / S, (s + 1) * ks / S};
}

// Thread (g, q) of a warp holds rows g and g + 8 of its 16 and columns
// 8j + 2q and + 1 of its warpgroup's WN: the first of each, in the tile.
__device__ __forceinline__ int frag_row() {
  return ((threadIdx.x & 127) >> 5) * 16 + ((threadIdx.x & 31) >> 2);
}

__device__ __forceinline__ int frag_col() {
  return (threadIdx.x >> 7) * WN + (threadIdx.x & 3) * 2;
}

// Phase 1's epilogue: H = T(gelu(acc + f32(b1))) for the tile at (m0, n0).
template <class T>
__device__ __forceinline__ void store_h(const Params<T>& p, const float (&acc)[WN / 2], int m0,
                                        int n0) {
  const int wr = m0 + frag_row(), wc = n0 + frag_col();
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = wc + 8 * j;
    const float c0 = bias_at(p.b1, col, p.hidden), c1 = bias_at(p.b1, col + 1, p.hidden);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = wr + 8 * u;
      if (row < p.M)
        *reinterpret_cast<typename Elem<T>::x2*>(p.h + static_cast<size_t>(row) * p.hp + col) =
            Elem<T>::from_floats(gelu_act(acc[4 * j + 2 * u] + c0, p.approx),
                                 gelu_act(acc[4 * j + 2 * u + 1] + c1, p.approx));
    }
  }
}

// Phase 2's epilogue for unit v: Y = T(acc + f32(b2)), or with S > 1 the
// share's fp32 partial.
template <class T>
__device__ __forceinline__ void store_y(const Params<T>& p, const float (&acc)[WN / 2],
                                        const Unit& v) {
  const int wr = v.m0 + frag_row(), wc = v.n0 + frag_col();
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = wc + 8 * j;
    if (col >= p.dim) continue;  // D % 8 == 0: a pair is all in or all out
    const float c0 = Elem<T>::to_float(p.b2[col]), c1 = Elem<T>::to_float(p.b2[col + 1]);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = wr + 8 * u;
      if (row >= p.M) continue;
      const float e0 = acc[4 * j + 2 * u], e1 = acc[4 * j + 2 * u + 1];
      if (p.split == 1)
        *reinterpret_cast<typename Elem<T>::x2*>(p.y + static_cast<size_t>(row) * p.dim + col) =
            Elem<T>::from_floats(e0 + c0, e1 + c1);
      else
        *reinterpret_cast<float2*>(p.part + (static_cast<size_t>(v.s) * p.M + row) * p.dim +
                                   col) = make_float2(e0, e1);
    }
  }
}

// Phase 3: Y = T(sum over s = 0 .. S - 1 of P[s] + f32(b2)), 8 outputs a
// thread of the block's `threads`; P is read from L2 (__ldcg): other blocks
// wrote it in this launch.
template <class T>
__device__ __forceinline__ void sum_shares(const Params<T>& p, int threads) {
  const int vecs = p.dim / 8;
  const size_t items = static_cast<size_t>(p.M) * vecs;
  for (size_t i = static_cast<size_t>(blockIdx.x) * threads + threadIdx.x; i < items;
       i += static_cast<size_t>(gridDim.x) * threads) {
    const int row = static_cast<int>(i / vecs), c = static_cast<int>(i % vecs) * 8;
    float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int s = 0; s < p.split; ++s) {
      const float4* src = reinterpret_cast<const float4*>(
          p.part + (static_cast<size_t>(s) * p.M + row) * p.dim + c);
      const float4 lo = __ldcg(src), hi = __ldcg(src + 1);
      v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
      v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += Elem<T>::to_float(p.b2[c + e]);
    *reinterpret_cast<uint4*>(p.y + static_cast<size_t>(row) * p.dim + c) = pack8<T>(v);
  }
}

// ---- The TMA form ----

// The producer's ring step g: A[m0 : m0 + BM, k0 : k0 + BK] and B[k0 : k0 +
// BK, n0 : n0 + BN] into slot g % STAGES, once the consumers released it.
__device__ __forceinline__ void produce(unsigned char* ring, uint64_t* full, uint64_t* empty,
                                        int g, const CUtensorMap* a, const CUtensorMap* b,
                                        int m0, int n0, int k0) {
  const int slot = g % STAGES;
  mbar_wait(empty + slot, ((g / STAGES) & 1) ^ 1);
  unsigned char* st = ring + slot * STEP_BYTES;
  mbar_expect(full + slot, STEP_BYTES);
  tma_box(st, a, k0, m0, full + slot);
#pragma unroll
  for (int j = 0; j < BN / 64; ++j)
    tma_box(st + A_BYTES + j * PANEL_BYTES, b, n0 + 64 * j, k0, full + slot);
}

// The consumers' product of one unit, ring steps g0 .. g0 + n - 1: acc = the
// sum of their products; each warpgroup releases a slot (one arrive on its
// `empty`) once its products of that slot are done.
template <class T>
__device__ __forceinline__ void consume(float (&acc)[WN / 2], unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, int g0, int n) {
  const bool signal = (threadIdx.x & 127) == 0;
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int g = g0 + i, slot = g % STAGES;
    mbar_wait(full + slot, (g / STAGES) & 1);
    step_products<T>(acc, smem_u32(ring + slot * STEP_BYTES));
    products_wait<LAG>(acc);
    if (i > 0 && signal) mbar_arrive(empty + (g - 1) % STAGES);
  }
  products_wait<0>(acc);
  if (n > 0 && signal) mbar_arrive(empty + (g0 + n - 1) % STAGES);
}

// Grid: the plan's blocks (at most one an SM); see the design note.
template <class T>
__global__ __launch_bounds__(CONSUMERS + PRODUCER, 1) void mlp_wide_tma_kernel(
    const __grid_constant__ TmaParams<T> tp) {
  const Params<T>& p = tp.q;
  unsigned char* ring = ring_base();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STEP_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);  // one arrive a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const int rt = (p.M + BM - 1) / BM, tiles1 = rt * (p.hp / BN), steps1 = (p.dim + BK - 1) / BK;
  const int S = p.split, ks = p.hp / BK, units = rt * ((p.dim + BN - 1) / BN) * S;
  // ring steps count on from phase 1 into phase 2 on both sides
  int g = 0;
  if (tid >= CONSUMERS) {  // the producer warp: its lane 0 issues every load
    const bool lead = tid == CONSUMERS;
    for (int t = blockIdx.x; t < tiles1; t += gridDim.x)
      for (int k = 0; k < steps1; ++k, ++g)
        if (lead)
          produce(ring, full, empty, g, &tp.x, &tp.w1, (t % rt) * BM, (t / rt) * BN, k * BK);
    __syncwarp();
    grid.sync();
    // H was written through the generic proxy; TMA reads it through the
    // async proxy
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit v = fc2_unit(u, rt, S, ks);
      for (int k = v.k0; k < v.k1; ++k, ++g)
        if (lead) produce(ring, full, empty, g, &tp.h, &tp.w2, v.m0, v.n0, k * BK);
    }
    __syncwarp();
  } else {
    float acc[WN / 2];
    for (int t = blockIdx.x; t < tiles1; t += gridDim.x, g += steps1) {
      consume<T>(acc, ring, full, empty, g, steps1);
      store_h(p, acc, (t % rt) * BM, (t / rt) * BN);
    }
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    grid.sync();
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit v = fc2_unit(u, rt, S, ks);
      consume<T>(acc, ring, full, empty, g, v.k1 - v.k0);
      g += v.k1 - v.k0;
      store_y(p, acc, v);
    }
  }
  if (S == 1) return;
  grid.sync();
  sum_shares(p, CONSUMERS + PRODUCER);
}

// ---- The cp.async form, for W1 / W2 without 16-byte rows ----

// One tile's product: acc = A[m0 : m0 + BM, K] @ B[K, n0 : n0 + BN] over the
// K steps [s0, s1).  A [arows, lda] is K-major with data in its first
// `acols` columns; B [brows, ldb] N-contiguous with data in its first
// `bcols` columns, as 16-byte vectors where `bvec`; zeros elsewhere.
template <class T>
__device__ __forceinline__ void tile_product(float (&acc)[WN / 2], unsigned char* ring,
                                             const T* __restrict__ A, int lda, int arows,
                                             int acols, const T* __restrict__ B, int ldb,
                                             int brows, int bcols, bool bvec, int m0, int n0,
                                             int s0, int s1) {
  const int tid = threadIdx.x;
  auto load = [&](int step, int slot) {
    unsigned char* sA = ring + slot * STEP_BYTES;
    unsigned char* sB = sA + A_BYTES;
    const int k0 = step * BK;
    for (int i = tid; i < BM * (BK / 8); i += CONSUMERS) {
      const int r = i / (BK / 8), c = i % (BK / 8);
      const bool ok = m0 + r < arows && k0 + c * 8 < acols;
      cp_async16(sA + swz(r, c), ok ? A + static_cast<size_t>(m0 + r) * lda + k0 + c * 8 : A, ok);
    }
    if (bvec) {
      for (int i = tid; i < BK * (BN / 8); i += CONSUMERS) {
        const int r = i / (BN / 8), cc = i % (BN / 8);
        const bool ok = k0 + r < brows && n0 + cc * 8 < bcols;
        cp_async16(sB + (cc >> 3) * PANEL_BYTES + swz(r, cc & 7),
                   ok ? B + static_cast<size_t>(k0 + r) * ldb + n0 + cc * 8 : B, ok);
      }
    } else {
      for (int i = tid; i < BK * BN; i += CONSUMERS) {
        const int r = i / BN, n = i % BN;
        *reinterpret_cast<T*>(sB + (n >> 6) * PANEL_BYTES + swz(r, (n >> 3) & 7) + (n & 7) * 2) =
            k0 + r < brows && n0 + n < bcols ? B[static_cast<size_t>(k0 + r) * ldb + n0 + n]
                                             : Elem<T>::from_float(0.0f);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.0f;
  const int n = s1 - s0;
  __syncthreads();  // both warpgroups are done with the ring's last use
#pragma unroll
  for (int i = 0; i < AHEAD; ++i) {
    if (i < n) load(s0 + i, i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    // step i landed (one commit group a step); every warpgroup is done with
    // the products of step i - 1 - LAG, whose slot the loads below refill
    cp_async_wait<AHEAD - 1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    step_products<T>(acc, smem_u32(ring + (i % STAGES) * STEP_BYTES));
    if (i + AHEAD < n) load(s0 + i + AHEAD, (i + AHEAD) % STAGES);
    cp_async_commit();
    products_wait<LAG>(acc);
  }
  products_wait<0>(acc);
  cp_async_wait<0>();
}

template <class T>
__global__ __launch_bounds__(CONSUMERS, 1) void mlp_wide_kernel(const Params<T> p) {
  unsigned char* ring = ring_base();
  cg::grid_group grid = cg::this_grid();
  const int rt = (p.M + BM - 1) / BM, tiles1 = rt * (p.hp / BN);
  const int S = p.split, ks = p.hp / BK, units = rt * ((p.dim + BN - 1) / BN) * S;
  float acc[WN / 2];
  for (int t = blockIdx.x; t < tiles1; t += gridDim.x) {
    const int m0 = (t % rt) * BM, n0 = (t / rt) * BN;
    tile_product<T>(acc, ring, p.x, p.dim, p.M, p.dim, p.w1, p.hidden, p.dim, p.hidden, p.v1, m0,
                    n0, 0, (p.dim + BK - 1) / BK);
    store_h(p, acc, m0, n0);
  }
  grid.sync();
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit v = fc2_unit(u, rt, S, ks);
    tile_product<T>(acc, ring, p.h, p.hp, p.M, p.hp, p.w2, p.dim, p.hidden, p.dim, p.v2, v.m0,
                    v.n0, v.k0, v.k1);
    store_y(p, acc, v);
  }
  if (S == 1) return;
  grid.sync();
  sum_shares(p, CONSUMERS);
}

// ---- The launch ----

// A [rows, cols] row-major tensor map in 64 x 64 boxes (hopper.cuh).
bool make_map_2d(CUtensorMap* map, const void* base, int rows, int cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, 64};
  return make_map<elem>(map, base, 2, dims, strides, box);
}

// One cooperative launch of `kernel` with `threads` threads a block; its
// shared memory set once.
int launch(const void* kernel, void* args, int grid, int threads, bool* configured,
           cudaStream_t stream) {
  if (!*configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    *configured = true;
  }
  void* argv[] = {args};
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, grid, threads, argv, SMEM, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, dim] and y 16-byte aligned, dim % 8 == 0; w1 [dim, hidden], b1
// [hidden], w2 [hidden, dim], b2 [dim] bf16 (fp16 in the fp16 instance) at
// any alignment and any hidden (TMA where w1 and w2 are 16-byte aligned and
// hidden % 8 == 0, the cp.async form elsewhere).  Workspaces: h [M, hp] of
// the element type, hp = hidden rounded up to 256, 16-byte aligned; part
// [split, M, dim] fp32, 16-byte aligned (unused, may be null, at split 1).
// The plan (ops/cuda/fused_mlp.py:wide_plan): split (shares of fc2's K,
// 1..8, at most hp / 64) and grid (blocks, at most one an SM: the
// cooperative launch is refused otherwise).
extern "C" int EVT_EXPORT(evt_mlp_wide)(const void* x, const void* w1, const void* b1,
                                        const void* w2, const void* b2, void* y, void* h,
                                        void* part, int M, int dim, int hidden, int approx,
                                        int split, int grid, void* stream) {
  if (M == 0) return 0;
  const int hp = (hidden + BN - 1) / BN * BN;
  if (dim <= 0 || dim % 8 || hidden <= 0 || !aligned16(x) || !aligned16(y) || !aligned16(h) ||
      split < 1 || split > MAX_SPLIT || split > hp / BK ||
      (split > 1 && (!part || !aligned16(part))) || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params<elem> p;
  p.x = static_cast<const elem*>(x);
  p.w1 = static_cast<const elem*>(w1);
  p.b1 = static_cast<const elem*>(b1);
  p.w2 = static_cast<const elem*>(w2);
  p.b2 = static_cast<const elem*>(b2);
  p.y = static_cast<elem*>(y);
  p.h = static_cast<elem*>(h);
  p.part = static_cast<float*>(part);
  p.M = M;
  p.dim = dim;
  p.hidden = hidden;
  p.hp = hp;
  p.approx = approx;
  p.split = split;
  p.v1 = hidden % 8 == 0 && aligned16(w1);
  p.v2 = aligned16(w2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.v1 && p.v2) {
    static bool configured = false;
    TmaParams<elem> tp;
    tp.q = p;
    if (!make_map_2d(&tp.x, x, M, dim) || !make_map_2d(&tp.w1, w1, dim, hidden) ||
        !make_map_2d(&tp.h, h, M, hp) || !make_map_2d(&tp.w2, w2, hidden, dim))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch(reinterpret_cast<const void*>(mlp_wide_tma_kernel<elem>), &tp, grid,
                  CONSUMERS + PRODUCER, &configured, s);
  }
  static bool configured = false;
  return launch(reinterpret_cast<const void*>(mlp_wide_kernel<elem>), &p, grid, CONSUMERS,
                &configured, s);
}
