// sdpa_long: K13's scaled dot-product attention (sdpa.cu's function) for
// every [b, h, n, d] shape past sdpa.cu's resident form: n > 256 at head_dim
// <= 96, n > 128 above (ViT-H/14 and ViT-g/14 at 257 keys, ViT-G/14's 104 at
// 257, every ViT at 384^2's 577), at every head_dim that is a multiple of 8
// from 16 to 128.
//
// Replaces: `_attn_kernel` / `sdpa` (K13) in
//   edgevisiontransformer_tpu/ops/pallas/fused_attention.py:29-75 at those
//   shapes, with K13's math and cast points (:33-42), the same as sdpa.cu's
//   (sdpa_softmax.cuh):
//     s = f32(q . k) * scale               (__fmul_rn; keys at index >= n excluded)
//     m, l: the row max and sum in fp32    (pass 1, online over 64-key tiles)
//     p = exp(s - m) / l                   (pass 2, exact: the correctly rounded quotient)
//     o = T(f32(T(p) @ v))                 (p rounded to T before PV, fp32 accumulation)
//   Pass 1 keeps sdpa.cu's running form l = l * exp(m_old - m_new) + sum
//   exp(s - m_new), each thread over its share of a row (quad-summed after
//   the last tile); pass 2 recomputes S tile by tile.  So p is normalised
//   before PV, as K13 does; the online sum differs from a direct one only in
//   the rounding of its fp32 additions.
//
// Bound on the card: one ViT-H/14 layer at b1 (16 heads of 80, n = 257)
// reads q, k, v and writes o, 2.6 MB (0.79 us at 3.35 TB/s), and does 4 *
// 16 * 257^2 * 80 = 338 MFLOP (0.34 us at 989 TFLOP/s): bytes bound it.
// What costs the time is the chain of each block: two passes of 64-key
// tiles, each a product, a softmax of 32 scores a thread on the fp32 ALUs
// and the MUFU, and (pass 2) a second product.  sdpa.cu's streamed form ran
// that chain behind a 2-stage cp.async ring and two block barriers a step,
// read K from L2 twice and did the products on mma.sync.
//
// Design: one block per (image * head, 64, 128 or 192 query rows): one to
// three consumer warpgroups of 64 query rows (wgmma's M) and one producer
// warp; the host's plan (ops/cuda/fused_attention.py:long_plan) picks the
// rows and the ring's depth by how many blocks an SM holds at once.
// - Loads by TMA: lane 0 of the producer warp issues the Q boxes of every
//   warpgroup, then the 64-key tiles of K and V in the order the consumers
//   take them, each into a slot of a ring of `stages` tiles with a `full`
//   and an `empty` mbarrier.  No block barrier is taken after the start.
//   Each operand is a 4-D tensor map (d, n, h, b) over the view's own
//   strides (q, k and v are views of the fused qkv [b, n, 3 h d], out of the
//   merged [b, n, h d]): a box past n or past d loads zeros, never the next
//   head's columns or the next image's rows (p = 0 times a NaN left there
//   would be NaN), and a store past them writes nothing.
// - A tile is 64 rows of P = ceil(d / 64) 128-byte-swizzled panels of 64
//   columns (one 64 x 64 box each; columns past d zeros).
// - Resident (stages >= 2 x tiles): the loads are K tiles 0 .. tiles - 1,
//   then V tiles 0 .. tiles - 1, each in its own slot, never refilled: pass
//   2 reads K where pass 1 found it and waits only for V.  Streamed (a ring
//   of 2 or more: where K and V do not fit, or where a small ring lets an SM
//   hold more blocks): K tiles for pass 1, then K and V tile by tile for
//   pass 2; a warpgroup releases a slot (one arrive on `empty`) once its
//   products of it are done.
// - Pass 1: S = Q K^T of a tile on wgmma.mma_async m64n64k16 (T in, fp32
//   accumulators), A (Q) and B (the K tile) K-major from shared memory,
//   ceil(d / 16) k16 steps; the accumulators' layout is mma.sync's m16n8
//   for each warp's 16 rows, so sdpa.cu's softmax routines run on them.
// - The tail: where the last tile holds at most 16 keys below n (n = 1 +
//   64 k: ViT-H/g/G's 257, 384^2's 577), both passes take only its first 16
//   keys (m64n16k16, one k16 step of P V); its other keys are masked, so
//   they would add exp(-inf) = 0 to the sums and 0 x 0 to O: the same bits.
// - Pass 2: S again, p = exp(s - m) / l in the accumulator registers,
//   rounded to T and packed: the m64n64 accumulators of a tile are the k16 A
//   fragments of P V (FlashAttention-3's register A), so P goes to neither
//   shared nor device memory.  O += P V on wgmma m64nNk16 with A from
//   registers and B the V tile read N-contiguous (d contiguous) through the
//   transpose-B flag, N the 16 ceil(d / 16) columns that reach d: 64 of
//   panel 0 and the rest of panel 1 (at d = 80, 64 + 16 of 128).
// - Epilogue: O rounded to T into the warpgroup's own Q tile in the
//   swizzled layout, then TMA stores of its panels through out's map, which
//   clips at n and d.
// - Bits: a row's arithmetic depends neither on the batch nor on the plan
//   (rows a block, resident or streamed): the same products in the same
//   order, the same softmax.  No atomics and no split of the keys across
//   blocks, so two calls, and a CUDA graph's replays, give the same bits.
#include <type_traits>

#include "hopper.cuh"
#include "sdpa_softmax.cuh"

namespace {

constexpr int ROWS = 64;          // query rows of a consumer warpgroup: one wgmma M
constexpr int KEYS = 64;          // keys a tile: the N of S = Q K^T
constexpr int PANEL = 64;         // head_dim columns of a 128-byte swizzled panel
constexpr int BOX = 64 * 128;     // bytes of one 64 x 64 box: a panel of 64 rows
constexpr int WARPGROUP = 128;
constexpr int PRODUCER = 32;      // the producer warp
constexpr int MAX_SMEM = 232448;  // a block's dynamic shared memory on the H100
// The widest head_dim of a three-warpgroup block: ptxas holds its 416
// threads to 128 registers, and at 128 it spills
constexpr int WIDEST_HEAD_DIM = 112;

// The dynamic shared memory of a block of `wg` warpgroups, rows of `panels`
// panels and a ring of `stages` tiles: up to 1,024 bytes to align it, the
// warpgroups' Q tiles, the ring, a full and an empty mbarrier a slot and
// Q's (fused_attention.py:long_smem_bytes mirrors this).
constexpr int smem_bytes(int wg, int panels, int stages) {
  return 1024 + (wg + stages) * panels * BOX + (2 * stages + 1) * 8;
}

// The 4-D tensor maps (d, n, h, b) of q, k, v and out, and the shape.
// tail: the last tile holds at most 16 keys below n, and takes one 16-key
// chunk (its other keys are masked: p = 0, which adds nothing).
struct LongParams {
  CUtensorMap q, k, v, o;
  int heads, n, tiles, stages;
  float scale;
  bool tail;
};

// S (64 x 16 NC) = (ACC ? S : 0) + A (64 x 16, Q: K-major) @ B (16 x 16 NC,
// the K tile's first 16 NC rows: K-major); NC = 4 (a tile) or 1 (a tail).
// O (64 x N) += A (64 x 16, P: registers) @ B (16 x N, V: N-contiguous), N =
// 16, 32, 48 or 64: a 64-column panel of V, or its first N columns.
#define EVT_WGMMA_QK64(TY)                                                                \
  asm volatile(                                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                         \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                                     \
      : "+f"(s[0][0][0]), "+f"(s[0][0][1]), "+f"(s[0][0][2]), "+f"(s[0][0][3]),           \
        "+f"(s[0][1][0]), "+f"(s[0][1][1]), "+f"(s[0][1][2]), "+f"(s[0][1][3]),           \
        "+f"(s[1][0][0]), "+f"(s[1][0][1]), "+f"(s[1][0][2]), "+f"(s[1][0][3]),           \
        "+f"(s[1][1][0]), "+f"(s[1][1][1]), "+f"(s[1][1][2]), "+f"(s[1][1][3]),           \
        "+f"(s[2][0][0]), "+f"(s[2][0][1]), "+f"(s[2][0][2]), "+f"(s[2][0][3]),           \
        "+f"(s[2][1][0]), "+f"(s[2][1][1]), "+f"(s[2][1][2]), "+f"(s[2][1][3]),           \
        "+f"(s[3][0][0]), "+f"(s[3][0][1]), "+f"(s[3][0][2]), "+f"(s[3][0][3]),           \
        "+f"(s[3][1][0]), "+f"(s[3][1][1]), "+f"(s[3][1][2]), "+f"(s[3][1][3])            \
      : "l"(a), "l"(b), "r"(ACC))

#define EVT_WGMMA_QK16(TY)                                                      \
  asm volatile(                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                              \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "                                      \
      "%8, %9, p, 1, 1, 0, 0;\n}\n"                                             \
      : "+f"(s[0][0][0]), "+f"(s[0][0][1]), "+f"(s[0][0][2]), "+f"(s[0][0][3]), \
        "+f"(s[0][1][0]), "+f"(s[0][1][1]), "+f"(s[0][1][2]), "+f"(s[0][1][3])  \
      : "l"(a), "l"(b), "r"(ACC))

#define EVT_WGMMA_PV16(TY)                                                      \
  asm volatile(                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                              \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "                                      \
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"                               \
      : "+f"(o[0]), "+f"(o[1]), "+f"(o[2]), "+f"(o[3]), "+f"(o[4]), "+f"(o[5]), \
        "+f"(o[6]), "+f"(o[7])                                                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

#define EVT_WGMMA_PV32(TY)                                                        \
  asm volatile(                                                                   \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "                 \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "  \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                               \
      : "+f"(o[0]), "+f"(o[1]), "+f"(o[2]), "+f"(o[3]), "+f"(o[4]), "+f"(o[5]),   \
        "+f"(o[6]), "+f"(o[7]), "+f"(o[8]), "+f"(o[9]), "+f"(o[10]), "+f"(o[11]), \
        "+f"(o[12]), "+f"(o[13]), "+f"(o[14]), "+f"(o[15])                        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

#define EVT_WGMMA_PV48(TY)                                                            \
  asm volatile(                                                                       \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"                                    \
      "wgmma.mma_async.sync.aligned.m64n48k16.f32." TY "." TY " "                     \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "       \
      "%16, %17, %18, %19, %20, %21, %22, %23}, "                                     \
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"                                   \
      : "+f"(o[0]), "+f"(o[1]), "+f"(o[2]), "+f"(o[3]), "+f"(o[4]), "+f"(o[5]),       \
        "+f"(o[6]), "+f"(o[7]), "+f"(o[8]), "+f"(o[9]), "+f"(o[10]), "+f"(o[11]),     \
        "+f"(o[12]), "+f"(o[13]), "+f"(o[14]), "+f"(o[15]), "+f"(o[16]), "+f"(o[17]), \
        "+f"(o[18]), "+f"(o[19]), "+f"(o[20]), "+f"(o[21]), "+f"(o[22]), "+f"(o[23])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

#define EVT_WGMMA_PV64(TY)                                                                \
  asm volatile(                                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                         \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                       \
      : "+f"(o[0]), "+f"(o[1]), "+f"(o[2]), "+f"(o[3]), "+f"(o[4]), "+f"(o[5]),           \
        "+f"(o[6]), "+f"(o[7]), "+f"(o[8]), "+f"(o[9]), "+f"(o[10]), "+f"(o[11]),         \
        "+f"(o[12]), "+f"(o[13]), "+f"(o[14]), "+f"(o[15]), "+f"(o[16]), "+f"(o[17]),     \
        "+f"(o[18]), "+f"(o[19]), "+f"(o[20]), "+f"(o[21]), "+f"(o[22]), "+f"(o[23]),     \
        "+f"(o[24]), "+f"(o[25]), "+f"(o[26]), "+f"(o[27]), "+f"(o[28]), "+f"(o[29]),     \
        "+f"(o[30]), "+f"(o[31])                                                          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <int NC, int ACC, class T>
__device__ __forceinline__ void wgmma_qk(float (&s)[NC][2][4], uint64_t a, uint64_t b) {
  static_assert(NC == 4 || NC == 1, "a tile or a tail");
  constexpr bool H = std::is_same<T, f16>::value;
  if constexpr (NC == 4) {
    if constexpr (H) EVT_WGMMA_QK64("f16"); else EVT_WGMMA_QK64("bf16");
  } else {
    if constexpr (H) EVT_WGMMA_QK16("f16"); else EVT_WGMMA_QK16("bf16");
  }
}

template <int N, class T>
__device__ __forceinline__ void wgmma_pv(float (&o)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64, "one panel of V");
  constexpr bool H = std::is_same<T, f16>::value;
  if constexpr (N == 16) {
    if constexpr (H) EVT_WGMMA_PV16("f16"); else EVT_WGMMA_PV16("bf16");
  } else if constexpr (N == 32) {
    if constexpr (H) EVT_WGMMA_PV32("f16"); else EVT_WGMMA_PV32("bf16");
  } else if constexpr (N == 48) {
    if constexpr (H) EVT_WGMMA_PV48("f16"); else EVT_WGMMA_PV48("bf16");
  } else {
    if constexpr (H) EVT_WGMMA_PV64("f16"); else EVT_WGMMA_PV64("bf16");
  }
}
#undef EVT_WGMMA_QK64
#undef EVT_WGMMA_QK16
#undef EVT_WGMMA_PV16
#undef EVT_WGMMA_PV32
#undef EVT_WGMMA_PV48
#undef EVT_WGMMA_PV64

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products (their asm names them as outputs when issued).
template <int N>
__device__ __forceinline__ void fence_acc(float (&o)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(o[i])::"memory");
}

template <int NC>
__device__ __forceinline__ void fence_acc(float (&s)[NC][2][4]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) asm volatile("" : "+f"(s[c][e / 4][e % 4])::"memory");
}

__device__ __forceinline__ void products_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// scale_mask and exp_rows (sdpa_softmax.cuh) for a tile whose 64 keys all
// lie below n: the same operations in the same order, without the key
// index, its test and the select a masked key needs.
__device__ __forceinline__ void scale_full(float (&s)[4][2][4], float scale, float lo[2]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float& x = s[c][e / 4][e % 4];
      x = __fmul_rn(x, scale);
      lo[(e % 4) / 2] = fminf(lo[(e % 4) / 2], x);
    }
}

__device__ __forceinline__ void exp_full(float (&s)[4][2][4], const float m[2], float l[2]) {
  l[0] = l[1] = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float& x = s[c][e / 4][e % 4];
      const int r = (e % 4) / 2;
      x = exp_shifted(x, m[r]);
      l[r] = __fadd_rn(l[r], x);
    }
}

// Pass 1 on tile t's scores (NC chunks): the running max m and this
// thread's share l of each row's sum, the least unmasked score lo.  MASK:
// the tile holds keys at or past n (a tail always).  A tail's missing keys
// would add exp(-inf) = 0 to l and nothing to m or lo: the same bits.
template <bool MASK, int NC>
__device__ __forceinline__ void pass1_tile(float (&s)[NC][2][4], int t, const LongParams& p,
                                           int lane, float m[2], float l[2], float lo[2]) {
  float mt[2], lt[2];
  if constexpr (MASK)
    scale_mask<NC>(s, t * KEYS, p.n, p.scale, lane, lo);
  else
    scale_full(s, p.scale, lo);
  row_max<NC>(s, mt);
#pragma unroll
  for (int r = 0; r < 2; ++r) mt[r] = fmaxf(mt[r], m[r]);
  if constexpr (MASK)
    exp_rows<NC>(s, mt, lt);
  else
    exp_full(s, mt, lt);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __fadd_rn(__fmul_rn(l[r], exp_shifted(m[r], mt[r])), lt[r]);
    m[r] = mt[r];
  }
}

// Pass 2 on tile t's scores: p = exp(s - m) / l in place (0 for a masked
// key).
template <bool MASK, int NC>
__device__ __forceinline__ void pass2_tile(float (&s)[NC][2][4], int t, const LongParams& p,
                                           int lane, const float m[2], const float l[2],
                                           bool corrections) {
  float unused[2] = {INFINITY, INFINITY};
  if constexpr (MASK)
    scale_mask<NC>(s, t * KEYS, p.n, p.scale, lane, unused);
  else
    scale_full(s, p.scale, unused);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float& x = s[c][e / 4][e % 4];
      x = MASK && x == -INFINITY ? 0.0f : exp_shifted(x, m[(e % 4) / 2]);
    }
  divide_rows<NC>(s, l, corrections);
}

// S = Q K^T of the warpgroup's 64 query rows (Q tile at shared address qa)
// and the first 16 NC keys of the K tile at ka, over KS k16 steps of the
// head dim (step kk: panel kk / 4, bytes 32 (kk % 4) of each 128-byte row).
template <int KS, int NC, class T>
__device__ __forceinline__ void scores(float (&s)[NC][2][4], uint32_t qa, uint32_t ka) {
  fence_acc(s);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wgmma_qk<NC, 0, T>(s, desc(qa, 16, 1024), desc(ka, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < KS; ++kk) {
    const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
    wgmma_qk<NC, 1, T>(s, desc(qa + off, 16, 1024), desc(ka + off, 16, 1024));
  }
  products_wait();
  fence_acc(s);
}

// The head-dim columns O holds: N0 = min(16 KS, 64) of panel 0 in o0, N1 =
// 16 KS - N0 of panel 1 in o1 (no product runs on a 16-column step wholly
// past d; o1 is unused where N1 = 0).
template <int KS>
struct Cols {
  static constexpr int N0 = KS < 4 ? 16 * KS : 64, N1 = 16 * KS - N0;
  static constexpr int O1 = N1 > 0 ? N1 / 2 : 1;
};

// O += T(P) V_tile over NC k16 steps: P in the score registers (s[c]: the
// k16 A fragment of keys 16c .. 16c + 15), the V tile at va (step c: rows
// 16c.., its panels BOX bytes apart).
template <int KS, int NC, class T>
__device__ __forceinline__ void pv(float (&o0)[Cols<KS>::N0 / 2], float (&o1)[Cols<KS>::O1],
                                   const float (&s)[NC][2][4], uint32_t va) {
  constexpr int N0 = Cols<KS>::N0, N1 = Cols<KS>::N1;
  uint32_t a[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    a[c][0] = pack2<T>(s[c][0][0], s[c][0][1]);
    a[c][1] = pack2<T>(s[c][0][2], s[c][0][3]);
    a[c][2] = pack2<T>(s[c][1][0], s[c][1][1]);
    a[c][3] = pack2<T>(s[c][1][2], s[c][1][3]);
  }
  fence_acc(o0);
  fence_acc(o1);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    wgmma_pv<N0, T>(o0, a[c], desc(va + c * 16 * 128, BOX, 1024));
    if constexpr (N1 > 0) wgmma_pv<N1, T>(o1, a[c], desc(va + BOX + c * 16 * 128, BOX, 1024));
  }
  products_wait();
  fence_acc(o0);
  fence_acc(o1);
}

// The producer's loads (its lane 0): the warpgroups' Q tiles on `qbar`,
// then load g = 0, 1, ... into slot g % stages once the consumers released
// it: K tile g for g < tiles; then V tile g - tiles (resident), or K and V
// tile (g - tiles) / 2 in turn (streamed).
template <int P, int WG>
__device__ __forceinline__ void produce(const LongParams& p, unsigned char* sQ,
                                        unsigned char* ring, uint64_t* full, uint64_t* empty,
                                        uint64_t* qbar, int img, int head, int q0,
                                        bool resident) {
  constexpr int TILE = P * BOX;
  mbar_expect(qbar, WG * TILE);
#pragma unroll
  for (int w = 0; w < WG; ++w)
#pragma unroll
    for (int c = 0; c < P; ++c)
      tma_box4(sQ + w * TILE + c * BOX, &p.q, c * PANEL, q0 + w * ROWS, head, img, qbar);
  const int tiles = p.tiles, loads = resident ? 2 * tiles : 3 * tiles;
  for (int g = 0; g < loads; ++g) {
    const int slot = g % p.stages, h = g - tiles;
    mbar_wait(empty + slot, ((g / p.stages) & 1) ^ 1);
    const bool is_v = h >= 0 && (resident || (h & 1));
    const int t = h < 0 ? g : (resident ? h : h >> 1);
    unsigned char* dst = ring + slot * TILE;
    mbar_expect(full + slot, TILE);
#pragma unroll
    for (int c = 0; c < P; ++c)
      tma_box4(dst + c * BOX, is_v ? &p.v : &p.k, c * PANEL, t * KEYS, head, img, full + slot);
  }
}

// The warpgroup's O, rounded to T, into its Q tile at `so` in the swizzled
// layout of a box (row r, column 8j + 2t: panel j / 8, 16-byte chunk (j %
// 8) ^ (r % 8), byte 4t), then stored through out's map from row `row0`
// (which writes no column past d).
template <int KS, class T>
__device__ __forceinline__ void store_o(const LongParams& p, const float (&o0)[Cols<KS>::N0 / 2],
                                        const float (&o1)[Cols<KS>::O1],
                                        unsigned char* so, int row0, int head, int img, int w) {
  constexpr int P = (KS + 3) / 4;
  const int r0 = ((threadIdx.x % WARPGROUP) >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  const int b4 = (threadIdx.x & 3) * 4;
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + 8 * u;
      const float* o = j < 8 ? o0 + 4 * j : o1 + 4 * (j - 8);
      *reinterpret_cast<uint32_t*>(so + (j / 8) * BOX + r * 128 + (((j % 8) ^ (r & 7)) << 4) +
                                   b4) = pack2<T>(o[2 * u], o[2 * u + 1]);
    }
  // the stores above are read by TMA (the async proxy), after the whole
  // warpgroup's (named barrier 1 + w)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "n"(WARPGROUP) : "memory");
  if (threadIdx.x % WARPGROUP == 0) {
#pragma unroll
    for (int c = 0; c < P; ++c) tma_store4(&p.o, so + c * BOX, c * PANEL, row0, head, img);
    tma_store_drain();
  }
}

// Grid: (batch * heads, query blocks of WG * 64 rows); WG * 128 + 32
// threads: the consumer warpgroups, then the producer warp.  KS: k16 steps
// of the head dim (ceil(d / 16)).
template <int KS, int WG, class T>
__global__ __launch_bounds__(WG * WARPGROUP + PRODUCER, 1) void sdpa_long_kernel(
    const __grid_constant__ LongParams p) {
  constexpr int P = (KS + 3) / 4, TILE = P * BOX;
  unsigned char* sQ = ring_base();
  unsigned char* ring = sQ + WG * TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * TILE);
  uint64_t* empty = full + p.stages;
  uint64_t* qbar = empty + p.stages;
  const int tid = threadIdx.x;
  const int img = blockIdx.x / p.heads, head = blockIdx.x % p.heads;
  const int q0 = blockIdx.y * WG * ROWS;
  const int tiles = p.tiles, stages = p.stages;
  const bool resident = stages >= 2 * tiles;
  const int last = p.n % KEYS ? tiles - 1 : tiles;  // the tile that holds keys past n, if any
  const int tail = p.tail ? tiles - 1 : tiles;      // the tail tile, if any
  // the warpgroups with a query row below n; the others leave at once, and
  // a slot waits for the releases of these only
  const int active = min(WG, (p.n - q0 + ROWS - 1) / ROWS);
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, active);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= WG * WARPGROUP) {
    if (tid == WG * WARPGROUP)
      produce<P, WG>(p, sQ, ring, full, empty, qbar, img, head, q0, resident);
    return;
  }
  const int w = tid / WARPGROUP, lane = tid & 31;
  if (w >= active) return;
  const bool signal = tid % WARPGROUP == 0;  // a warpgroup's one arrive on `empty`
  const uint32_t qa = smem_u32(sQ + w * TILE), ra = smem_u32(ring);
  mbar_wait(qbar, 0);

  // pass 1: the running row max m and this thread's share of the row sum l
  float s[4][2][4], st[1][2][4];  // a tile's scores, a tail's
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, lo[2] = {INFINITY, INFINITY};
  for (int t = 0; t < tiles; ++t) {
    const int slot = t % stages;
    mbar_wait(full + slot, (t / stages) & 1);
    if (t == tail) {
      scores<KS, 1, T>(st, qa, ra + slot * TILE);
      if (!resident && signal) mbar_arrive(empty + slot);
      pass1_tile<true, 1>(st, t, p, lane, m, l, lo);
      continue;
    }
    scores<KS, 4, T>(s, qa, ra + slot * TILE);
    if (!resident && signal) mbar_arrive(empty + slot);
    if (t == last)
      pass1_tile<true, 4>(s, t, p, lane, m, l, lo);
    else
      pass1_tile<false, 4>(s, t, p, lane, m, l, lo);
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  const bool corrections = exact_corrections(lo, m, l);

  // pass 2: p = exp(s - m) / l, O += T(p) V
  float o0[Cols<KS>::N0 / 2], o1[Cols<KS>::O1];
#pragma unroll
  for (int i = 0; i < Cols<KS>::N0 / 2; ++i) o0[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < Cols<KS>::O1; ++i) o1[i] = 0.0f;
  for (int t = 0; t < tiles; ++t) {
    const int gk = resident ? t : tiles + 2 * t, gv = resident ? tiles + t : gk + 1;
    const int sk = gk % stages, sv = gv % stages;
    mbar_wait(full + sk, (gk / stages) & 1);
    if (t == tail) {
      scores<KS, 1, T>(st, qa, ra + sk * TILE);
      if (!resident && signal) mbar_arrive(empty + sk);
      pass2_tile<true, 1>(st, t, p, lane, m, l, corrections);
      mbar_wait(full + sv, (gv / stages) & 1);
      pv<KS, 1, T>(o0, o1, st, ra + sv * TILE);
    } else {
      scores<KS, 4, T>(s, qa, ra + sk * TILE);
      if (!resident && signal) mbar_arrive(empty + sk);
      if (t == last)
        pass2_tile<true, 4>(s, t, p, lane, m, l, corrections);
      else
        pass2_tile<false, 4>(s, t, p, lane, m, l, corrections);
      mbar_wait(full + sv, (gv / stages) & 1);
      pv<KS, 4, T>(o0, o1, s, ra + sv * TILE);
    }
    if (!resident && signal) mbar_arrive(empty + sv);
  }
  store_o<KS, T>(p, o0, o1, sQ + w * TILE, q0 + w * ROWS, head, img, w);
}

template <int KS, int WG>
int launch(const LongParams& p, int bh, int smem, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        sdpa_long_kernel<KS, WG, elem>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(bh, (p.n + WG * ROWS - 1) / (WG * ROWS));
  sdpa_long_kernel<KS, WG, elem><<<grid, WG * WARPGROUP + PRODUCER, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The kernel of wg warpgroups; none of three past WIDEST_HEAD_DIM (not
// instantiated there).
template <int KS>
int launch_rows(const LongParams& p, int wg, int bh, int smem, cudaStream_t stream) {
  if constexpr (16 * KS <= WIDEST_HEAD_DIM) {
    if (wg == 3) return launch<KS, 3>(p, bh, smem, stream);
  }
  return wg == 1 ? launch<KS, 1>(p, bh, smem, stream) : launch<KS, 2>(p, bh, smem, stream);
}

}  // namespace

// q, k, v, out: [batch, heads, n, head_dim] of bf16 (fp16 in the fp16
// instance), 16-byte aligned, head_dim contiguous; strides: their 12
// element strides (image, head, token), each a multiple of 8.  head_dim a
// multiple of 8 from 16 to 128.  The plan (ops/cuda/fused_attention.py:
// long_plan): rows (64, 128 or 192 query rows a block; 192 up to head_dim
// 112) and stages (the
// ring's tiles: at least 2 x ceil(n / 64), K and V resident, or at least 2,
// streamed).  cudaErrorInvalidValue for a shape or plan outside these, or a
// tensor map cuTensorMapEncodeTiled refuses.
extern "C" int EVT_EXPORT(evt_sdpa_long)(const void* q, const void* k, const void* v, void* out,
                                         const long long* strides, int batch, int heads, int n,
                                         int head_dim, float scale, int rows, int stages,
                                         void* stream) {
  if (batch == 0 || heads == 0 || n == 0) return 0;
  const int tiles = (n + KEYS - 1) / KEYS;
  if (head_dim < 16 || head_dim > 128 || head_dim % 8 || rows % ROWS || rows < ROWS ||
      rows > 3 * ROWS || stages < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 3 * ROWS && head_dim > WIDEST_HEAD_DIM) return static_cast<int>(cudaErrorInvalidValue);
  const int wg = rows / ROWS, ks = (head_dim + 15) / 16, panels = (ks + 3) / 4;
  const int smem = smem_bytes(wg, panels, stages);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  LongParams p;
  const void* bases[4] = {q, k, v, out};
  CUtensorMap* maps[4] = {&p.q, &p.k, &p.v, &p.o};
  for (int i = 0; i < 4; ++i) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim), static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
    const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[3 * i + 2]) * 2,
                                 static_cast<cuuint64_t>(strides[3 * i + 1]) * 2,
                                 static_cast<cuuint64_t>(strides[3 * i]) * 2};
    const cuuint32_t box[4] = {PANEL, KEYS, 1, 1};
    if (!make_map<elem>(maps[i], bases[i], 4, dims, bytes, box))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  p.heads = heads;
  p.n = n;
  p.tiles = tiles;
  p.stages = stages;
  p.scale = scale;
  p.tail = n % KEYS != 0 && n % KEYS <= 16;
  const int bh = batch * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ks) {
#define EVT_SDPA_LONG_KS(K) \
    case K: return launch_rows<K>(p, wg, bh, smem, s);
    EVT_SDPA_LONG_KS(1)
    EVT_SDPA_LONG_KS(2)
    EVT_SDPA_LONG_KS(3)
    EVT_SDPA_LONG_KS(4)
    EVT_SDPA_LONG_KS(5)
    EVT_SDPA_LONG_KS(6)
    EVT_SDPA_LONG_KS(7)
    EVT_SDPA_LONG_KS(8)
#undef EVT_SDPA_LONG_KS
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
