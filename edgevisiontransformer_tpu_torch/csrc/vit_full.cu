// vit_full: the whole DeiT forward (patch embedding, every encoder layer, the
// final LayerNorm and the head) in one persistent kernel launch.
//
// Replaces: the TPU whole-model kernels of
//   edgevisiontransformer_tpu/ops/pallas/fused_vit_full.py, `_full_kernel`
//   (K7a, vit_full_forward: a layer grid) and `_full_kernel_pipelined` (K7b,
//   vit_full_forward_pipelined: one program, double-buffered weight DMA).
//   They differ only in TPU blocking (and in padding tokens to 256 or 200),
//   so both become this one kernel.  Their arithmetic:
//     x      = bf16(f32(patches @ patch_w) + f32(embed_bias[token]))  (:55-65)
//     layers = exactly K1's block (fused_encoder.py `_ln`, `_attention_rows`,
//              the four products with their cast points, both residual forms)
//     logits = bf16(f32(LN(x)[cls] @ head_w) + f32(head_b))           (:107-118)
//   embed_bias folds cls, pos and the patch bias in bf16 beforehand
//   (models/vit.py prepare_vit_full).  The final LN applies only with
//   final_norm.
//
// Bound on the card: at b1 a deit_tiny forward does ~2.5 GFLOP on ~11 MB of
// weights: ~3.4 us of weight bytes at 3.35 TB/s.  What bounds it in practice
// is the chain of ~86 dependent phases, each a few small tiles; one launch
// replaces the 84 kernel launches (and their host work) of the separate
// kernels.  At b128 the products bound it, as they bound `linear`.
//
// Design: a persistent kernel.  Its grid is the number of 256-thread blocks
// that can be resident at once (occupancy x SMs), capped by the largest
// phase's tile count.  It walks the forward as a fixed sequence of phases
// with a grid-wide barrier between them: the embedding GEMM; per layer LN1,
// qkv, attention, out-projection, LN2, fc1, fc2; then the final LN and head.
// Inside a phase block i takes tiles i, i + grid, ...  The tiles are the
// standalone kernels' own (encoder_tiles.cuh): a gemm::tile of 128x128, an
// ln_row per warp, and two attn::tile query tiles per block (one per 128
// threads, each with its own named barrier and shared memory).  Activations
// live in device scratch [b * tokens, width] rows that the wrapper allocates
// (x, h, qkv, att, hid); at b1 they stay in L2.  The embedding's A loader
// gathers the (p1 p2 c) patch features straight from the NCHW image (fp32
// or bf16, rounded to bf16 on load, as JAX's img.astype(dt)); token 0 is a
// zero row.  The out-projection and fc2 epilogues read the residual (x, or
// h in the reference form) and write x: each element is read and written
// by the same thread, so in place is safe.  The head phase takes up to 8
// images and 256 classes per tile: one warp per image normalises its cls
// row into shared memory, then each thread sums one class for them in fp32.
//
// The barrier: a cooperative launch (cudaLaunchCooperativeKernel) with
// cooperative_groups::this_grid().sync(), which needs no -rdc since CUDA 11.
// The runtime refuses the launch unless every block can be resident at
// once, so the barrier cannot wait on a block that never runs (the wrapper
// raises on the refusal), and a cooperative launch is captured and replayed
// in a CUDA graph like any other.  A plain launch with a hand-written
// counter barrier was tried beside it on the H100 and was slower per
// barrier, so it went.
#include <cooperative_groups.h>

#include <algorithm>

#include "encoder_tiles.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int HEAD_IMAGES = THREADS / 32;  // one warp per image's cls row
constexpr int HEAD_CLASSES = THREADS;      // one thread per class

struct Params {
  const void* img;
  const bf16 *patch_w, *embed_bias;
  const bf16 *ln1_g, *ln1_b, *qkv_w, *qkv_b, *out_w, *out_b;
  const bf16 *ln2_g, *ln2_b, *fc1_w, *fc1_b, *fc2_w, *fc2_b;
  const bf16 *fnorm_g, *fnorm_b, *head_w, *head_b;
  bf16 *x, *h, *qkv, *att, *hid, *logits;
  int batch, depth, dim, heads, mlp, classes, image, patch, channels, tokens;
  int img_f32, reference_residual, approx_gelu, final_norm;
  float eps, scale2;
};

// The embedding's A operand: row gm = (image, token) of the patch matrix,
// column gk = (p1, p2, c) of the patch, read from the NCHW image; token 0
// (cls) is a zero row.
struct PatchA {
  const void* img;
  int f32, tokens, grid, patch, image, channels;

  __device__ __forceinline__ void load(bf16* sA, int M, int K, int m0, int k0, int tid) const {
    constexpr int BK = gemm::BK;
    for (int i = tid; i < gemm::BM * BK; i += gemm::THREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      float v = 0.0f;
      if (gm < M && gk < K) {
        const int b = gm / tokens, t = gm % tokens;
        if (t > 0) {
          const int py = (t - 1) / grid, px = (t - 1) % grid;
          const int ch = gk % channels, j = (gk / channels) % patch, ii = gk / (channels * patch);
          const size_t off =
              ((static_cast<size_t>(b) * channels + ch) * image + py * patch + ii) * image +
              px * patch + j;
          v = f32 ? static_cast<const float*>(img)[off]
                  : __bfloat162float(static_cast<const bf16*>(img)[off]);
        }
      }
      sA[r * gemm::AS + c] = __float2bfloat16_rn(v);
    }
  }
};

template <class ASrc>
__device__ __forceinline__ void gemm_phase(unsigned char* smem, const ASrc& a, const bf16* W,
                                           const bf16* bias, const bf16* res, bf16* Y, int M,
                                           int N, int K, int epi, int res_rows) {
  constexpr int BM = gemm::BM, BN = gemm::BN;
  const int tn = (N + BN - 1) / BN, tiles = ((M + BM - 1) / BM) * tn;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    __syncthreads();  // the block's previous tile is done with shared memory
    gemm::tile<true>(smem, a, W, bias, res, Y, M, N, K, epi, res_rows, (t / tn) * BM,
                     (t % tn) * BN);
  }
}

__device__ __forceinline__ void ln_phase(const bf16* x, const bf16* g, const bf16* b, bf16* y,
                                         int rows, int dim, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row = blockIdx.x * (THREADS / 32) + warp; row < rows;
       row += gridDim.x * (THREADS / 32)) {
    bf16* yr = y + static_cast<size_t>(row) * dim;
    ln_row(x + static_cast<size_t>(row) * dim, g, b, dim, eps, 0, lane,
           [yr](int c, const float f[8]) { *reinterpret_cast<uint4*>(yr + c * 8) = pack8(f); });
  }
}

template <int HD>
__host__ __device__ constexpr int attn_bytes() {
  return (attn::Smem<HD>::BYTES + 127) / 128 * 128;
}

// Two query tiles at a time: threads 0-127 and 128-255 each run one, on
// named barriers 1 and 2 and their own half of shared memory.
template <int HD>
__device__ __forceinline__ void attention_phase(unsigned char* smem, const bf16* qkv, bf16* out,
                                                int batch, int tokens, int heads, float scale2) {
  const int half = threadIdx.x / attn::THREADS, tid = threadIdx.x % attn::THREADS;
  const int qt = (tokens + attn::QT - 1) / attn::QT, tiles = qt * heads * batch;
  unsigned char* s = smem + half * attn_bytes<HD>();
  for (int t = blockIdx.x * 2 + half; t < tiles; t += gridDim.x * 2) {
    attn::sync(1 + half);  // the half's previous tile is done with shared memory
    attn::tile<HD>(s, qkv, out, tokens, tokens, heads, scale2, (t % qt) * attn::QT,
                   (t / qt) % heads, t / (qt * heads), tid, 1 + half);
  }
}

__device__ __forceinline__ void head_phase(unsigned char* smem, const Params& p) {
  float* scls = reinterpret_cast<float*>(smem);  // [HEAD_IMAGES, dim]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, dim = p.dim, C = p.classes;
  const int cb = (C + HEAD_CLASSES - 1) / HEAD_CLASSES;
  const int tiles = ((p.batch + HEAD_IMAGES - 1) / HEAD_IMAGES) * cb;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i0 = (t / cb) * HEAD_IMAGES, c = (t % cb) * HEAD_CLASSES + threadIdx.x;
    const int nimg = min(HEAD_IMAGES, p.batch - i0);
    __syncthreads();  // the block's previous tile is done with scls
    float* dst = scls + warp * dim;
    if (warp < nimg) {
      const bf16* xr = p.x + static_cast<size_t>(i0 + warp) * p.tokens * dim;  // the cls row
      if (p.final_norm) {
        ln_row(xr, p.fnorm_g, p.fnorm_b, dim, p.eps, 0, lane, [dst](int ch, const float f[8]) {
#pragma unroll
          for (int e = 0; e < 8; ++e) dst[ch * 8 + e] = round_bf16(f[e]);
        });
      } else {
        for (int k = lane; k < dim; k += 32) dst[k] = __bfloat162float(xr[k]);
      }
    } else {
      for (int k = lane; k < dim; k += 32) dst[k] = 0.0f;
    }
    __syncthreads();
    if (c < C) {
      float acc[HEAD_IMAGES];
#pragma unroll
      for (int j = 0; j < HEAD_IMAGES; ++j) acc[j] = 0.0f;
      for (int k = 0; k < dim; ++k) {
        const float w = __bfloat162float(p.head_w[static_cast<size_t>(k) * C + c]);
#pragma unroll
        for (int j = 0; j < HEAD_IMAGES; ++j) acc[j] += scls[j * dim + k] * w;
      }
      const float hb = __bfloat162float(p.head_b[c]);
      for (int j = 0; j < nimg; ++j)
        p.logits[static_cast<size_t>(i0 + j) * C + c] = __float2bfloat16_rn(acc[j] + hb);
    }
  }
}

template <int HD>
__global__ __launch_bounds__(THREADS) void vit_full_kernel(const Params p) {
  using gemm::RowsA;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int tokens = p.tokens, M = p.batch * tokens, dim = p.dim, mlp = p.mlp;
  const int inner = p.heads * HD, qkvn = 3 * inner;

  const PatchA patches{p.img, p.img_f32, tokens, p.image / p.patch, p.patch, p.image, p.channels};
  gemm_phase(smem, patches, p.patch_w, nullptr, p.embed_bias, p.x, M, dim,
             p.patch * p.patch * p.channels, gemm::ROW_BIAS, tokens);
  for (int l = 0; l < p.depth; ++l) {
    bf16* res = p.reference_residual ? p.h : p.x;
    grid.sync();
    ln_phase(p.x, p.ln1_g + l * dim, p.ln1_b + l * dim, p.h, M, dim, p.eps);
    grid.sync();
    gemm_phase(smem, RowsA<true>{p.h}, p.qkv_w + static_cast<size_t>(l) * dim * qkvn,
               p.qkv_b + l * qkvn, nullptr, p.qkv, M, qkvn, dim, 0, M);
    grid.sync();
    attention_phase<HD>(smem, p.qkv, p.att, p.batch, tokens, p.heads, p.scale2);
    grid.sync();
    gemm_phase(smem, RowsA<true>{p.att}, p.out_w + static_cast<size_t>(l) * inner * dim,
               p.out_b + l * dim, res, p.x, M, dim, inner, 3, M);
    grid.sync();
    ln_phase(p.x, p.ln2_g + l * dim, p.ln2_b + l * dim, p.h, M, dim, p.eps);
    grid.sync();
    gemm_phase(smem, RowsA<true>{p.h}, p.fc1_w + static_cast<size_t>(l) * dim * mlp,
               p.fc1_b + l * mlp, nullptr, p.hid, M, mlp, dim, p.approx_gelu ? 1 : 2, M);
    grid.sync();
    gemm_phase(smem, RowsA<true>{p.hid}, p.fc2_w + static_cast<size_t>(l) * mlp * dim,
               p.fc2_b + l * dim, res, p.x, M, dim, mlp, 3, M);
  }
  grid.sync();
  head_phase(smem, p);
}

__global__ __launch_bounds__(THREADS) void barrier_probe_kernel(int count) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < count; ++i) grid.sync();
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The most tiles any phase of the forward has: more blocks than this idle.
int max_tiles(const Params& p, int hd) {
  const int M = p.batch * p.tokens, mt = cdiv(M, gemm::BM);
  const int widths[] = {p.dim, 3 * p.heads * hd, p.mlp};
  int most = cdiv(M, THREADS / 32);                                    // LayerNorm rows
  most = std::max(most, cdiv(cdiv(p.tokens, attn::QT) * p.heads * p.batch, 2));
  for (int n : widths) most = std::max(most, mt * cdiv(n, gemm::BN));  // GEMMs
  most = std::max(most, cdiv(p.batch, HEAD_IMAGES) * cdiv(p.classes, HEAD_CLASSES));
  return most;
}

// Blocks of `kernel` that fit on the card at once with `smem` bytes each.
int resident_blocks(const void* kernel, int smem, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  *out = per_sm * sms;
  return static_cast<int>(e);
}

template <int HD>
int launch(const Params& p, int* grid_out, cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(vit_full_kernel<HD>);
  const int smem = std::max({gemm::SMEM_BYTES, 2 * attn_bytes<HD>(),
                             HEAD_IMAGES * p.dim * static_cast<int>(sizeof(float))});
  static int configured = 0;
  if (smem > configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  static int cached_smem = -1, cached_blocks = 0;
  if (smem != cached_smem) {
    const int rc = resident_blocks(kernel, smem, &cached_blocks);
    if (rc != 0) return rc;
    cached_smem = smem;
  }
  const int grid = std::min(cached_blocks, max_tiles(p, HD));
  *grid_out = grid;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  void* args[] = {const_cast<Params*>(&p)};
  return static_cast<int>(cudaLaunchCooperativeKernel(kernel, grid, THREADS, args, smem, stream));
}

}  // namespace

// ptrs: img, patch_w, embed_bias, ln1_g, ln1_b, qkv_w, qkv_b, out_w, out_b,
//   ln2_g, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, fnorm_g, fnorm_b, head_w,
//   head_b, x, h, qkv, att, hid, logits (25; the stacks [L, ...]).
// ints: batch, depth, dim, heads, head_dim, mlp, classes, image, patch,
//   channels, img_f32, reference_residual, approx_gelu, final_norm; ints[14]
//   receives the grid size.  floats: eps, scale2 (head_dim^-1/2 * log2 e).
extern "C" int evt_vit_full(void* const* ptrs, int* ints, const float* floats, void* stream) {
  Params p;
  const void* const* q = ptrs;
  p.img = q[0];
  const bf16** w[] = {&p.patch_w, &p.embed_bias, &p.ln1_g, &p.ln1_b, &p.qkv_w, &p.qkv_b,
                      &p.out_w, &p.out_b, &p.ln2_g, &p.ln2_b, &p.fc1_w, &p.fc1_b,
                      &p.fc2_w, &p.fc2_b, &p.fnorm_g, &p.fnorm_b, &p.head_w, &p.head_b};
  for (int i = 0; i < 18; ++i) *w[i] = static_cast<const bf16*>(q[1 + i]);
  bf16** a[] = {&p.x, &p.h, &p.qkv, &p.att, &p.hid, &p.logits};
  for (int i = 0; i < 6; ++i) *a[i] = static_cast<bf16*>(ptrs[19 + i]);
  p.batch = ints[0];
  p.depth = ints[1];
  p.dim = ints[2];
  p.heads = ints[3];
  const int head_dim = ints[4];
  p.mlp = ints[5];
  p.classes = ints[6];
  p.image = ints[7];
  p.patch = ints[8];
  p.channels = ints[9];
  p.img_f32 = ints[10];
  p.reference_residual = ints[11];
  p.approx_gelu = ints[12];
  p.final_norm = ints[13];
  p.tokens = (p.image / p.patch) * (p.image / p.patch) + 1;
  p.eps = floats[0];
  p.scale2 = floats[1];
  if (p.batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch<32>(p, &ints[14], s);
    case 64: return launch<64>(p, &ints[14], s);
    case 128: return launch<128>(p, &ints[14], s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// `count` grid barriers and nothing else, on `blocks` blocks of 256 threads:
// what one barrier costs at the block count of a forward.
extern "C" int evt_vit_full_barrier_probe(int blocks, int count, void* stream) {
  void* args[] = {&count};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(barrier_probe_kernel), blocks, THREADS, args, 0,
      static_cast<cudaStream_t>(stream)));
}
