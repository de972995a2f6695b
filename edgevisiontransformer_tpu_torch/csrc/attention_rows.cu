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
//   over the keys serves any n.  The fp16 instance (build.py's -DEVT_F16
//   compile) takes softmax_unnorm's float16 branch instead:
//     p   = exp2(s - max_row s)         (over the keys below seq_len; no clamp)
//     out = fp16(f32(fp16(p) v) * (1 / r))
//   with a first sweep over the keys for the row max (attention_strip.cuh).
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
// - Head dims: an instance at each multiple of 16 from 16 to 128, and a
//   padded form of each from 32 on that runs head_dim 8 less (24, ..., 120:
//   ViT-g/14's 88 on 96's), its q, k and v rows zero-filled to the
//   instance's width in shared memory and its extra output columns never
//   stored; PAD is a template argument, so an unpadded form carries no
//   column check.  The instances at 16, 32, 64 and 128 are attention_rows_kernel;
//   the others, attention_rows_kernel_wide, allow ptxas one block an SM.
// - The strip is a __device__ routine (attention_strip.cuh): this kernel runs
//   one a block, vit_full.cu the strips of its attention phase inside its
//   persistent kernel, so the whole-model forward takes the same bits.
#include "attention_strip.cuh"

namespace {

using arows::STAGES;

// One strip a block: block i is strip i % strips of (image, head) i / strips.
template <int HD, int W, class T>
__global__ __launch_bounds__(W * 32) void attention_rows_kernel(
    const T* __restrict__ qkv, T* __restrict__ out, int tokens, int seq_len, int heads,
    int strips, float scale2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bh = blockIdx.x / strips;
  arows::strip<HD, W>(smem, qkv, out, tokens, seq_len, heads, HD, scale2, blockIdx.x % strips,
                      bh / heads, bh % heads, threadIdx.x, 0);
}

// The same at the other head dims: HD 48, 80, 96 or 112, and with PAD head_dim
// hd = HD - 8, its rows zero-filled to HD (attention_strip.cuh).  One block
// an SM is allowed (launch bounds' second argument): without it ptxas held
// some of these at 128 or 80 registers, to keep more blocks an SM, and
// spilled; with it, none spills.
template <int HD, int W, bool PAD, class T>
__global__ __launch_bounds__(W * 32, 1) void attention_rows_kernel_wide(
    const T* __restrict__ qkv, T* __restrict__ out, int tokens, int seq_len, int heads, int hd,
    int strips, float scale2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bh = blockIdx.x / strips;
  arows::strip<HD, W, 4, PAD>(smem, qkv, out, tokens, seq_len, heads, hd, scale2,
                              blockIdx.x % strips, bh / heads, bh % heads, threadIdx.x, 0);
}

// The kernel of (HD, W, PAD): attention_rows_kernel at the head dims 16, 32,
// 64 and 128, attention_rows_kernel_wide at the others (only the one taken
// is instantiated).
template <int HD, bool PAD>
constexpr bool kNarrow = !PAD && (HD == 16 || HD == 32 || HD == 64 || HD == 128);

template <int HD, int W, bool PAD>
const void* kernel_of() {
  if constexpr (kNarrow<HD, PAD>)
    return reinterpret_cast<const void*>(attention_rows_kernel<HD, W, elem>);
  else
    return reinterpret_cast<const void*>(attention_rows_kernel_wide<HD, W, PAD, elem>);
}

template <int HD, int W, bool PAD>
int launch(const void* qkv, void* out, int batch, int tokens, int seq_len, int heads, int hd,
           float scale2, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(kernel_of<HD, W, PAD>(),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               arows::smem_bytes<HD>(W, STAGES));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int tiles = ((seq_len + 15) / 16 + 3) / 4;
  const int strips = (tokens + W * 16 - 1) / (W * 16);
  const long long blocks = static_cast<long long>(strips) * batch * heads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int smem = arows::smem_bytes<HD>(W, tiles < STAGES ? tiles : STAGES);
  const elem* q = static_cast<const elem*>(qkv);
  elem* o = static_cast<elem*>(out);
  if constexpr (kNarrow<HD, PAD>)
    attention_rows_kernel<HD, W, elem><<<static_cast<unsigned>(blocks), W * 32, smem, stream>>>(
        q, o, tokens, seq_len, heads, strips, scale2);
  else
    attention_rows_kernel_wide<HD, W, PAD, elem>
        <<<static_cast<unsigned>(blocks), W * 32, smem, stream>>>(q, o, tokens, seq_len, heads,
                                                                    hd, strips, scale2);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool PAD>
int launch_plan(const void* qkv, void* out, int batch, int tokens, int seq_len, int heads,
                int hd, float scale2, int warps, cudaStream_t s) {
  switch (warps) {
    case 4: return launch<HD, 4, PAD>(qkv, out, batch, tokens, seq_len, heads, hd, scale2, s);
    case 8: return launch<HD, 8, PAD>(qkv, out, batch, tokens, seq_len, heads, hd, scale2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// qkv [batch * tokens, 3 * heads * head_dim], out [batch * tokens, heads *
// head_dim], bf16 (fp16 in the fp16 instance), 16-byte aligned; keys at
// index >= seq_len are masked.  head_dim is a multiple of 8 from 16 to 128:
// a multiple of 16 runs on its own instance, one 8 more than a multiple of
// 16 on the next instance's padded form (88 on 96's: its eight extra
// columns are zeros in shared memory and never stored).
// The plan (ops/cuda/fused_encoder.py:attention_plan): `warps` (4 or 8)
// 16-row query strips a block.
extern "C" int EVT_EXPORT(evt_attention_rows)(const void* qkv, void* out, int batch, int tokens,
                                              int seq_len, int heads, int head_dim, float scale2,
                                              int warps, void* stream) {
  if (batch == 0 || tokens == 0 || heads == 0) return 0;
  if (batch < 0 || tokens < 0 || heads < 0 || seq_len < 0 || seq_len > tokens)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
#define EVT_ATTENTION_HD(N)                                                                  \
    case N:                                                                                  \
      return launch_plan<N, false>(qkv, out, batch, tokens, seq_len, heads, N, scale2, warps, \
                                   s);                                                       \
    case N - 8:                                                                              \
      return launch_plan<N, true>(qkv, out, batch, tokens, seq_len, heads, N - 8, scale2,    \
                                  warps, s);
    case 16:
      return launch_plan<16, false>(qkv, out, batch, tokens, seq_len, heads, 16, scale2, warps,
                                    s);
    EVT_ATTENTION_HD(32)
    EVT_ATTENTION_HD(48)
    EVT_ATTENTION_HD(64)
    EVT_ATTENTION_HD(80)
    EVT_ATTENTION_HD(96)
    EVT_ATTENTION_HD(112)
    EVT_ATTENTION_HD(128)
#undef EVT_ATTENTION_HD
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
