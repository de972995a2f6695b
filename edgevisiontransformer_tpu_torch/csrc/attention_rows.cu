// attention_rows: multi-head self-attention over the fused qkv activation.
//
// Replaces: `_attention_rows` (:101-171) with `common.softmax_unnorm`
//   (edgevisiontransformer_tpu/ops/pallas/common.py:24-44), the attention
//   step inside the TPU whole-encoder kernels `_encoder_kernel` (K1) and
//   `_encoder_kernel_pipelined` (K2) of
//   edgevisiontransformer_tpu/ops/pallas/fused_encoder.py.
//
// Input qkv is [b * tokens, 3 * heads * HD] bf16, columns ordered
// (qkv, head, hd); output is the merged [b * tokens, heads * HD] bf16.  Keys
// at index >= seq_len are masked (the TPU pads 197 tokens to 200 and masks
// the padded keys; masking keys >= 197 without padding is the same math).
//
// Bound on the card: for DeiT (n = 197, HD = 64) one (image, head) does
// 4 * n^2 * HD = 10 MFLOP on 3 * n * HD * 2 = 76 KB of q, k, v: ~130 flop/byte,
// under the balance point, and the exp2 of n^2 scores (one MUFU op each)
// costs about as much as the two products.  The [n, n] score matrix never
// leaves shared memory.
//
// Design: one thread block of 4 warps per (64-query tile, head, image); each
// warp owns 16 query rows.  For each 64-key tile: S = q k^T on WMMA bf16
// fragments (fp32 accumulate), p = exp2(min(S * hd^-1/2 * log2e, 60)) with
// masked keys 0, the fp32 row sums r += p, and O += bf16(p) v (fp32
// accumulate).  The softmax is max-free, so key tiles need no rescaling; at
// the end out = bf16(O * 1 / max(r, 1e-30)).  Loads are 16-byte vectors,
// zero-filled past the last token.  The tile itself is attn::tile
// (encoder_tiles.cuh), which vit_full.cu runs too.
#include "encoder_tiles.cuh"

namespace {

using attn::Smem;
using attn::THREADS;

template <int HD>
__global__ __launch_bounds__(THREADS) void attention_rows_kernel(
    const bf16* __restrict__ qkv, bf16* __restrict__ out, int tokens, int seq_len, int heads,
    float scale2) {
  extern __shared__ __align__(128) unsigned char smem[];
  attn::tile<HD>(smem, qkv, out, tokens, seq_len, heads, scale2, blockIdx.x * attn::QT,
                 blockIdx.y, blockIdx.z, threadIdx.x, 0);
}

template <int HD>
int launch(const void* qkv, void* out, int batch, int tokens, int seq_len, int heads,
           float scale2, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_rows_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<HD>::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((tokens + attn::QT - 1) / attn::QT, heads, batch);
  attention_rows_kernel<HD><<<grid, THREADS, Smem<HD>::BYTES, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), tokens, seq_len, heads, scale2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int evt_attention_rows(const void* qkv, void* out, int batch, int tokens,
                                  int seq_len, int heads, int head_dim, float scale2,
                                  void* stream) {
  if (batch == 0 || tokens == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch<32>(qkv, out, batch, tokens, seq_len, heads, scale2, s);
    case 64: return launch<64>(qkv, out, batch, tokens, seq_len, heads, scale2, s);
    case 128: return launch<128>(qkv, out, batch, tokens, seq_len, heads, scale2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
