// attention_rows: multi-head self-attention over the fused qkv activation.
//
// Replaces: `_attention_rows` (:101-171) with `common.softmax_unnorm`
//   (edgevisiontransformer_tpu/ops/pallas/common.py:24-44), the attention
//   step inside the TPU whole-encoder kernels `_encoder_kernel` (K1),
//   `_encoder_kernel_pipelined` (K2) and their int8 forms (K4, K5) of
//   edgevisiontransformer_tpu/ops/pallas/fused_encoder.py.  Per (image,
//   head), with K1's math:
//     s   = f32(q . k) * scale2         (scale2 = hd^-1/2 * log2 e, one fp32 multiply)
//     p   = exp2(min(s, 60))            (max-free; keys at index >= seq_len give 0)
//     r   = sum p                       (fp32, over the unrounded p)
//     out = bf16(f32(bf16(p) v) * (1 / max(r, 1e-30)))
//   Normalisation is deferred past PV and needs no row max, so one sweep
//   over the keys serves any n.
//
// Input qkv is [b * tokens, 3 * heads * HD] bf16, columns ordered
// (qkv, head, hd); output is the merged [b * tokens, heads * HD] bf16.  The
// TPU pads 197 tokens to 200 and masks the padded keys; masking keys >=
// seq_len without padding is the same math.
//
// Bound on the card: for DeiT (n = 197, HD = 64) one (image, head) does
// 4 * n^2 * HD = 10 MFLOP on 4 * n * HD * 2 = 101 KB of q, k, v and out:
// ~100 flop/byte, under the H100's ~295 flop/byte balance point, so bytes
// bound it (0.0116 ms per deit_tiny b128 layer at 3.35 TB/s).  On the card
// the loads of K and V into every block, the two products and the stores
// take most of the time; the exp2 of n^2 scores (one MUFU op each) and the
// fp32 work around it add little (bench/attention_ab.py's no-softmax floor).
//
// Design (bench/attention_ab.py times its choices; PERF.md section 6 has the
// numbers):
// - The grid is the host's plan (ops/cuda/fused_encoder.py:attention_plan):
//   each block holds `warps` (4 or 8) warps of one (image, head), each warp
//   16 query rows, and every block loads all of its head's K and V.  8 warps
//   halve those loads where the blocks still fill the card (deit_tiny b128);
//   4 elsewhere (b1: 12 blocks).  Fewer warps a block and more blocks lose
//   even at b1: one warp then issues every load of its K and V alone.
// - Products on mma.sync.m16n8k16 with the scores in accumulator registers,
//   on the tile routines of attn_tiles.cuh that sdpa.cu runs too.  Scale,
//   clamp, exp2 and the mask act on the accumulators in place; each lane
//   sums its share of r in fp32 and two quad shuffles finish it; the p
//   registers, packed to bf16x2, are PV's A fragments.  No score and no p
//   goes through shared memory.
// - K and V pass through a STAGES-deep cp.async ring of 64-key tiles,
//   zero-filled past `tokens` (p = 0 times a NaN left in shared memory would
//   be NaN); Q lands with the first tile.  Two stages: the next tile lands
//   while this one's products and exp2 run, in the least shared memory.
//   More stages (4: every tile of n <= 256 in flight from the start, the
//   resident form) cost blocks an SM and time.
// - Only the 16-key chunks that hold a key below seq_len are walked (13 at
//   n = 197): full tiles run a 4-chunk body without the mask, the last tile
//   a body of its 1-4 chunks with the mask, each compiled for its chunk
//   count, so no loop carries a bounds check.
// - Every warp walks the keys in the same order, with the same instructions
//   and explicitly rounded fp32 operations (nothing contracts into an FMA),
//   whatever its block holds: a query row's output is the same bits alone
//   and in any batch, under every plan.  The keys are never split across
//   warps.  A warp whose 16 rows all lie past `tokens` skips its arithmetic.
// - Epilogue: O * (1 / max(r, 1e-30)) in registers, rounded to bf16 through
//   the warp's own Q rows of shared memory and stored as 16-byte vectors.
// - vit_full.cu runs the WMMA tile attn::tile of encoder_tiles.cuh instead,
//   inside its persistent kernel.
#include "attn_tiles.cuh"

namespace {

constexpr int KT = 64, STAGES = 2;
constexpr float kClamp = 60.0f;

// p of one log2-scaled score, common.softmax_unnorm's max-free softmax
// (bench/attention_ab.py builds a variant without it).
__device__ __forceinline__ float softmax_p(float s) {
  return exp2f(fminf(s, kClamp));
}

// In place over NC 16-key chunks from key key0: s becomes p = softmax_p(s *
// scale2), 0 for a key at or past seq_len when MASK; r[0] (row g) and r[1]
// (row g + 8) add this thread's share of p, in fp32.
template <int NC, bool MASK>
__device__ __forceinline__ void exp2_rows(float (&s)[NC][2][4], int key0, int seq_len,
                                          float scale2, int lane, float (&r)[2]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float& x = s[c][e / 4][e % 4];
      x = softmax_p(__fmul_rn(x, scale2));
      if (MASK && key0 + c * 16 + (e / 4) * 8 + 2 * (lane & 3) + (e & 1) >= seq_len) x = 0.0f;
      r[(e % 4) / 2] = __fadd_rn(r[(e % 4) / 2], x);
    }
}

// One tile of NC chunks: S = Q K^T, p and r, O += bf16(p) V.
template <int HD, int NC, bool MASK>
__device__ __forceinline__ void tile_step(float (&o)[HD / 8][4], float (&r)[2], const bf16* sQw,
                                          const bf16* sK, const bf16* sV, int key0, int seq_len,
                                          float scale2, int lane) {
  float s[NC][2][4];
  qk<HD, NC>(s, sQw, sK, lane);
  exp2_rows<NC, MASK>(s, key0, seq_len, scale2, lane, r);
  pv<HD, NC>(o, s, sV, lane);
}

// Dynamic shared memory: W * 16 Q rows, then `stages` ring stages of a K
// and a V tile.
template <int HD>
constexpr int smem_bytes(int warps, int stages) {
  return (warps * 16 + stages * 2 * KT) * row_ld(HD) * 2;
}

template <int HD, int W>
__global__ __launch_bounds__(W * 32) void attention_rows_kernel(
    const bf16* __restrict__ qkv, bf16* __restrict__ out, int tokens, int seq_len, int heads,
    int strips, float scale2) {
  constexpr int NT = W * 32, LD = row_ld(HD), STAGE = 2 * KT * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* ring = sQ + W * 16 * LD;

  const int strip = blockIdx.x % strips, bh = blockIdx.x / strips;
  const int img = bh / heads, head = bh % heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = strip * W * 16, row0 = q0 + warp * 16;
  const bool active = row0 < tokens;
  const long long ld = 3LL * heads * HD, ldo = static_cast<long long>(heads) * HD;
  const bf16* qp = qkv + static_cast<long long>(img) * tokens * ld + head * HD;
  const bf16* kp = qp + heads * HD;
  const bf16* vp = kp + heads * HD;
  bf16* op = out + static_cast<long long>(img) * tokens * ldo + head * HD;
  bf16* sQw = sQ + warp * 16 * LD;

  // the 16-key chunks that hold a key below seq_len, four to a 64-key tile
  const int chunks = (seq_len + 15) / 16, tiles = (chunks + 3) / 4;
  auto prefetch = [&](int t) {
    bf16* sK = ring + (t % STAGES) * STAGE;
    const int rows = min(KT, 16 * chunks - t * KT);
    load_rows<HD, NT>(sK, kp, ld, t * KT, rows, tokens, tid);
    load_rows<HD, NT>(sK + KT * LD, vp, ld, t * KT, rows, tokens, tid);
  };
  load_rows<HD, NT>(sQ, qp, ld, q0, W * 16, tokens, tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < tiles) prefetch(t);
    cp_async_commit();  // group t: tile t (group 0 holds Q too)
  }

  float o[HD / 8][4], r[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    // tile t landed; every warp is done with tile t - 1, whose stage the
    // prefetch below refills
    __syncthreads();
    if (t + STAGES - 1 < tiles) prefetch(t + STAGES - 1);
    cp_async_commit();
    if (!active) continue;
    const bf16* sK = ring + (t % STAGES) * STAGE;
    const bf16* sV = sK + KT * LD;
    const int key0 = t * KT;
    if (t + 1 < tiles) {
      tile_step<HD, 4, false>(o, r, sQw, sK, sV, key0, seq_len, scale2, lane);
      continue;
    }
    switch (chunks - 4 * t) {  // the last tile, masked
      case 1: tile_step<HD, 1, true>(o, r, sQw, sK, sV, key0, seq_len, scale2, lane); break;
      case 2: tile_step<HD, 2, true>(o, r, sQw, sK, sV, key0, seq_len, scale2, lane); break;
      case 3: tile_step<HD, 3, true>(o, r, sQw, sK, sV, key0, seq_len, scale2, lane); break;
      default: tile_step<HD, 4, true>(o, r, sQw, sK, sV, key0, seq_len, scale2, lane); break;
    }
  }
  if (tiles == 0) {  // seq_len = 0: Q's loads were never waited for, and its rows take the output
    cp_async_wait<0>();
    __syncthreads();
  }
  if (!active) return;

  const float inv[2] = {__frcp_rn(fmaxf(quad_sum(r[0]), 1e-30f)),
                        __frcp_rn(fmaxf(quad_sum(r[1]), 1e-30f))};
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[j][0] = __fmul_rn(o[j][0], inv[0]);
    o[j][1] = __fmul_rn(o[j][1], inv[0]);
    o[j][2] = __fmul_rn(o[j][2], inv[1]);
    o[j][3] = __fmul_rn(o[j][3], inv[1]);
  }
  store_rows<HD>(o, sQw, op, ldo, row0, tokens, lane);
}

template <int HD, int W>
int launch(const void* qkv, void* out, int batch, int tokens, int seq_len, int heads,
           float scale2, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(attention_rows_kernel<HD, W>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem_bytes<HD>(W, STAGES));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int tiles = ((seq_len + 15) / 16 + 3) / 4;
  const int strips = (tokens + W * 16 - 1) / (W * 16);
  const long long blocks = static_cast<long long>(strips) * batch * heads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  attention_rows_kernel<HD, W>
      <<<static_cast<unsigned>(blocks), W * 32,
         smem_bytes<HD>(W, tiles < STAGES ? tiles : STAGES), stream>>>(
          static_cast<const bf16*>(qkv), static_cast<bf16*>(out), tokens, seq_len, heads, strips,
          scale2);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_plan(const void* qkv, void* out, int batch, int tokens, int seq_len, int heads,
                float scale2, int warps, cudaStream_t s) {
  switch (warps) {
    case 4: return launch<HD, 4>(qkv, out, batch, tokens, seq_len, heads, scale2, s);
    case 8: return launch<HD, 8>(qkv, out, batch, tokens, seq_len, heads, scale2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// qkv [batch * tokens, 3 * heads * head_dim], out [batch * tokens, heads *
// head_dim], bf16, 16-byte aligned; keys at index >= seq_len are masked.
// The plan (ops/cuda/fused_encoder.py:attention_plan): `warps` (4 or 8)
// 16-row query strips a block.
extern "C" int evt_attention_rows(const void* qkv, void* out, int batch, int tokens,
                                  int seq_len, int heads, int head_dim, float scale2, int warps,
                                  void* stream) {
  if (batch == 0 || tokens == 0 || heads == 0) return 0;
  if (batch < 0 || tokens < 0 || heads < 0 || seq_len < 0 || seq_len > tokens)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch_plan<16>(qkv, out, batch, tokens, seq_len, heads, scale2, warps, s);
    case 32: return launch_plan<32>(qkv, out, batch, tokens, seq_len, heads, scale2, warps, s);
    case 64: return launch_plan<64>(qkv, out, batch, tokens, seq_len, heads, scale2, warps, s);
    case 128: return launch_plan<128>(qkv, out, batch, tokens, seq_len, heads, scale2, warps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
