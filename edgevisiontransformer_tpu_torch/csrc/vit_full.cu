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
//   final_norm.  The fp16 instance (build.py's -DEVT_F16 compile) rounds to
//   fp16 at every one of these points, and its attention takes the strip's
//   row-max softmax (attention_strip.cuh), as JAX's K7 at dtype = float16.
//
// Bound on the card: at b1 a deit_tiny forward does ~2.5 GFLOP on ~11 MB of
// weights: ~3.4 us of weight bytes at 3.35 TB/s.  What bounds it in practice
// is the chain of ~86 dependent phases, each a few small tiles; one launch
// replaces the 84 kernel launches (and their host work) of the separate
// kernels.  At b128 the products bound it, as they bound `linear`.
//
// Design: a persistent kernel.  Its grid is the number of 256-thread blocks
// that can be resident at once (one or two an SM, by the instance), capped
// by the host's plan.  It walks the forward as a fixed sequence of phases with a
// grid-wide barrier between them: the embedding GEMM; per layer LN1, qkv,
// attention, out-projection, LN2, fc1, fc2; then the final LN and head.
// - The work of a phase is cut into tiles, and a block runs them on warp
//   groups: group g of block b takes tiles b * G + g, + grid * G, ...; each
//   group synchronises on its own named barrier (1 + g) and works in its own
//   part of shared memory, so the groups of a block never wait for each
//   other inside a phase.
// - The GEMM phases run linear.cu's mma.sync tile (linear_tile.cuh
//   gemm_tile: a 3-stage cp.async ring of 64-deep K steps, the epilogue from
//   the accumulator registers through a per-warp patch and 16-byte stores).
//   Every output element sums its K in k16 steps, in order, into one fp32
//   accumulator, whatever the tile: K is never split.  The host's plan
//   (ops/cuda/fused_vit_full.py:vit_full_plan) picks each GEMM phase's tile
//   from the shapes compiled here: 128 x 96 on one group of 8 warps at
//   serving batches, 16 x 32 on four groups of 2 warps where 128-row tiles
//   would leave SMs idle (b1: fc1 has 312 such tiles where it had 12 of
//   128 x 128).
// - The attention phase runs attention_rows.cu's query strip
//   (attention_strip.cuh): 16 query rows a warp, scores and p in mma.sync
//   registers, K and V through a 2-stage cp.async ring; 8-warp strips, or two
//   4-warp strips a block (the plan's, attention_plan's rule).
// - LayerNorm phases run ln_rows.cu's row (ln_row.cuh), one row a warp.
// - So a row's bits depend neither on the batch nor on the plan or the grid,
//   and equal those of the per-layer chain.
// - Two instances at head_dim <= 64, picked by the plan.  At serving batches
//   at most 128 registers a thread and at most half an SM's shared memory a
//   block keep two blocks on an SM: one block's loads and epilogues overlap
//   the other's products.  At b1, where the small tiles leave the second
//   block little to overlap, one block an SM with up to 255 registers a
//   thread runs faster (bench/vit_full_ab.py; PERF.md section 6).  At
//   head_dim 128 the strip needs ~174 registers: one block an SM.  In the
//   two-block instance every phase runs at the edge of the 128: linear's
//   128 x 128 tile (64 accumulators) spilled here and lost to 128 x 96, a
//   strip takes its 64-key tiles two 16-key chunks at a time (STRIP_CHUNKS),
//   the patch gather keeps 8 loads in flight, and each tile and strip reads
//   the thread's index, its buffer and the layer's sizes through opaque, so
//   that nothing a phase derives is hoisted out of the loops and held live
//   across the forward.  What still spills there is a few words of the
//   layer loop's own state, reloaded once a tile or phase (PERF.md section
//   6); the one-block instances do not spill.
// Activations live in device scratch [b * tokens, width] rows that the
// wrapper allocates (x, h, qkv, att, hid); at b1 they stay in L2.  The
// embedding's A operand is gathered straight from the NCHW image (fp32 or the
// weights' type, rounded to it on load, as JAX's img.astype(dt)) through
// registers; token 0 is a zero row; its epilogue adds embed_bias[row %
// tokens].  The out-projection and fc2 epilogues read the residual (x, or h
// in the reference form) and write x: each element is read and written by the
// same thread, so in place is safe.  The activations are read by cp.async
// (L2) or plain loads, never through the read-only cache path, which must not
// serve what other blocks wrote earlier in the same launch.  The head phase
// takes up to 8 images and 256 classes per tile: one warp per image
// normalises its cls row into shared memory, then each thread sums one class
// for them in fp32.
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

#include "attention_strip.cuh"
#include "linear_tile.cuh"
#include "ln_row.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int HEAD_IMAGES = THREADS / 32;  // one warp per image's cls row
constexpr int HEAD_CLASSES = THREADS;      // one thread per class
// 16-key chunks an attention strip takes through its products at a time:
// two hold half a tile's scores in registers where attention_rows.cu holds
// all four, and give the same bits.
constexpr int STRIP_CHUNKS = 2;
// The GEMM tile shapes, by the plan's code: rows x columns, on groups of
// WM x 2 warps (ops/cuda/fused_vit_full.py VIT_FULL_TILES mirrors this).
//   0: 128 x 96, one group of 8 warps of 32 x 48
//   1: 16 x 32,  four groups of 2 warps of 16 x 16
// linear's 128 x 128 tile (64 accumulators a thread) spills in this kernel
// at 128 registers and loses to 128 x 96 (bench/vit_full_ab.py builds it
// beside; PERF.md section 6).
constexpr int TILE_CODES = 2;
constexpr int GEMM_PHASES = 5;  // embed, qkv, out, fc1, fc2

// The forward's pointers (weights, scratch and logits of the element type
// T) and sizes.
template <class T>
struct Params {
  const void* img;
  const T *patch_w, *embed_bias;
  const T *ln1_g, *ln1_b, *qkv_w, *qkv_b, *out_w, *out_b;
  const T *ln2_g, *ln2_b, *fc1_w, *fc1_b, *fc2_w, *fc2_b;
  const T *fnorm_g, *fnorm_b, *head_w, *head_b;
  T *x, *h, *qkv, *att, *hid, *logits;
  int batch, depth, dim, heads, head_dim, mlp, classes, image, patch, channels, tokens;
  int img_f32, reference_residual, approx_gelu, final_norm;
  int tile[GEMM_PHASES], attn_warps;
  float eps, scale2;
};

// `v` through a volatile move, which the compiler may not move out of a
// loop: what a loop body derives from the result is computed in that body.
// Every phase's shared-memory and fragment offsets (derived from the
// thread's index, its group's buffer and the layer's sizes) are otherwise
// invariant across the tile, strip and layer loops; the compiler hoisted
// them all to the top of the kernel, and they stayed live through the whole
// forward: hundreds of bytes spilled at 128 registers.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(v));
  return v;
}

// The thread's index, read anew for each tile (see opaque).
__device__ __forceinline__ int thread_index() { return opaque(threadIdx.x); }

// The embedding's A operand: row gm = (image, token) of the patch matrix,
// column gk = (p1, p2, c) of the patch, read from the NCHW image into
// registers and rounded to T; token 0 (cls) is a zero row.  Each thread
// keeps 8 loads in flight before it stores them (16 spilled registers).
template <class T>
struct PatchA {
  const void* img;
  int f32, tokens, grid, patch, image, channels;

  __device__ __forceinline__ float value(int gm, int gk, int M, int K) const {
    if (gm >= M || gk >= K) return 0.0f;
    const int b = gm / tokens, t = gm % tokens;
    if (t == 0) return 0.0f;
    const int py = (t - 1) / grid, px = (t - 1) % grid;
    const int ch = gk % channels, j = (gk / channels) % patch, ii = gk / (channels * patch);
    const size_t off = ((static_cast<size_t>(b) * channels + ch) * image + py * patch + ii) *
                           image + px * patch + j;
    return f32 ? static_cast<const float*>(img)[off]
               : Elem<T>::to_float(static_cast<const T*>(img)[off]);
  }

  template <int NT, int BM>
  __device__ __forceinline__ void load(T* a, int M, int K, int m0, int k0, int tid) const {
    constexpr int PER = BM * BK / NT, BATCH = PER < 8 ? PER : 8;
    static_assert(PER % BATCH == 0, "whole batches a thread");
    for (int j0 = 0; j0 < PER; j0 += BATCH) {
      float v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = tid + (j0 + u) * NT;
        v[u] = value(m0 + i / BK, k0 + i % BK, M, K);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = tid + (j0 + u) * NT;
        a[(i / BK) * AS + i % BK] = Elem<T>::from_float(v[u]);
      }
    }
  }
};

// Every tile of one GEMM phase on the block's warp groups of WM x WN warps.
template <int WM, int TM, int TN, class ASrc, class T>
__device__ __forceinline__ void gemm_groups(unsigned char* smem, const ASrc& a, const T* W,
                                            const T* bias, const T* res, T* Y, int M, int N,
                                            int K, int epi, int res_rows) {
  constexpr int NT = WM * WN * 32, GROUPS = THREADS / NT, BM = WM * TM, BN = WN * TN;
  const int group = thread_index() / NT;
  const int tn = (N + BN - 1) / BN, tiles = ((M + BM - 1) / BM) * tn;
  for (int t = blockIdx.x * GROUPS + group; t < tiles; t += gridDim.x * GROUPS) {
    group_sync<NT>(1 + group);  // the group's previous tile is done with its ring
    gemm_tile<WM, TM, TN>(smem + opaque(group * smem_bytes(BM, BN)), a, W, bias, res, Y, M, N,
                          K, epi, res_rows, (t / tn) * BM, (t % tn) * BN, true,
                          thread_index() % NT, 1 + group);
  }
}

template <class ASrc, class T>
__device__ __forceinline__ void gemm_phase(int tile, unsigned char* smem, const ASrc& a,
                                           const T* W, const typename Same<T>::type* bias,
                                           const T* res, T* Y, int M, int N, int K, int epi,
                                           int res_rows) {
  if (tile == 0) gemm_groups<4, 32, 48>(smem, a, W, bias, res, Y, M, N, K, epi, res_rows);
  else gemm_groups<1, 16, 16>(smem, a, W, bias, res, Y, M, N, K, epi, res_rows);
}

template <class T>
__device__ __forceinline__ void ln_phase(const T* x, const T* g, const T* b, T* y, int rows,
                                         int dim, float eps) {
  const int thread = thread_index(), warp = thread >> 5, lane = thread & 31;
  for (int row = blockIdx.x * (THREADS / 32) + warp; row < rows;
       row += gridDim.x * (THREADS / 32)) {
    T* yr = y + static_cast<size_t>(row) * dim;
    ln_row(x + static_cast<size_t>(row) * dim, g, b, dim, eps, 0, lane,
           [yr](int c, const float f[8]) { *reinterpret_cast<uint4*>(yr + c * 8) = pack8<T>(f); });
  }
}

// Every query strip of the attention phase on the block's groups of W warps.
template <int HD, int W, class T>
__device__ __forceinline__ void attention_groups(unsigned char* smem, const Params<T>& p) {
  constexpr int NT = W * 32, GROUPS = THREADS / NT;
  const int group = thread_index() / NT;
  const int strips = (p.tokens + W * 16 - 1) / (W * 16), units = strips * p.heads * p.batch;
  for (int u = blockIdx.x * GROUPS + group; u < units; u += gridDim.x * GROUPS) {
    arows::strip_sync<W>(1 + group);  // the group's previous strip is done with its memory
    const int bh = u / strips, tokens = opaque(p.tokens), heads = opaque(p.heads);
    arows::strip<HD, W, STRIP_CHUNKS>(
        smem + opaque(group * arows::smem_bytes<HD>(W, arows::STAGES)), p.qkv, p.att, tokens,
        tokens, heads, p.scale2, u % strips, bh / heads, bh % heads, thread_index() % NT,
        1 + group);
  }
}

template <int HD, class T>
__device__ __forceinline__ void attention_warps(unsigned char* smem, const Params<T>& p) {
  if (p.attn_warps == 8) attention_groups<HD, 8>(smem, p);
  else attention_groups<HD, 4>(smem, p);
}

// The head dims of an instance: 16, 32 and 64 (HD_MAX 64), or 128.
template <int HD_MAX, class T>
__device__ __forceinline__ void attention_phase(unsigned char* smem, const Params<T>& p) {
  if constexpr (HD_MAX == 128) {
    attention_warps<128>(smem, p);
  } else {
    switch (p.head_dim) {
      case 16: attention_warps<16>(smem, p); break;
      case 32: attention_warps<32>(smem, p); break;
      default: attention_warps<64>(smem, p);
    }
  }
}

template <class T>
__device__ __forceinline__ void head_phase(unsigned char* smem, const Params<T>& p) {
  float* scls = reinterpret_cast<float*>(smem);  // [HEAD_IMAGES, dim]
  const int thread = thread_index(), warp = thread >> 5, lane = thread & 31;
  const int dim = p.dim, C = p.classes;
  const int cb = (C + HEAD_CLASSES - 1) / HEAD_CLASSES;
  const int tiles = ((p.batch + HEAD_IMAGES - 1) / HEAD_IMAGES) * cb;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i0 = (t / cb) * HEAD_IMAGES, c = (t % cb) * HEAD_CLASSES + thread;
    const int nimg = min(HEAD_IMAGES, p.batch - i0);
    __syncthreads();  // the block's previous tile is done with scls
    float* dst = scls + warp * dim;
    if (warp < nimg) {
      const T* xr = p.x + static_cast<size_t>(i0 + warp) * p.tokens * dim;  // the cls row
      if (p.final_norm) {
        ln_row(xr, p.fnorm_g, p.fnorm_b, dim, p.eps, 0, lane, [dst](int ch, const float f[8]) {
#pragma unroll
          for (int e = 0; e < 8; ++e) dst[ch * 8 + e] = round_to<T>(f[e]);
        });
      } else {
        for (int k = lane; k < dim; k += 32) dst[k] = Elem<T>::to_float(xr[k]);
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
        const float w = Elem<T>::to_float(p.head_w[static_cast<size_t>(k) * C + c]);
#pragma unroll
        for (int j = 0; j < HEAD_IMAGES; ++j) acc[j] += scls[j * dim + k] * w;
      }
      const float hb = Elem<T>::to_float(p.head_b[c]);
      for (int j = 0; j < nimg; ++j)
        p.logits[static_cast<size_t>(i0 + j) * C + c] = Elem<T>::from_float(acc[j] + hb);
    }
  }
}

// The forward.  A layer is seven phases, each after a grid barrier; the four
// GEMMs share one call site, so each tile shape is compiled once for them.
// BLOCKS: the blocks an SM the instance is built for (launch bounds of at
// most 128 registers a thread at 2, 255 at 1).
template <int HD_MAX, int BLOCKS, class T>
__global__ __launch_bounds__(THREADS, BLOCKS) void vit_full_kernel(const Params<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();

  const PatchA<T> patches{p.img,   p.img_f32, p.tokens,  p.image / p.patch,
                          p.patch, p.image,   p.channels};
  gemm_phase(p.tile[0], smem, patches, p.patch_w, nullptr, p.embed_bias, p.x,
             p.batch * p.tokens, p.dim, p.patch * p.patch * p.channels, ROW_BIAS, p.tokens);
#pragma unroll 1
  for (int l = 0; l < p.depth; ++l) {
#pragma unroll 1
    for (int step = 0; step < 7; ++step) {
      grid.sync();
      // the layer's sizes, computed here (see opaque)
      const int M = opaque(p.batch) * p.tokens, dim = opaque(p.dim), mlp = opaque(p.mlp);
      const int inner = opaque(p.heads) * p.head_dim, qkvn = 3 * inner;
      const T* res = opaque(p.reference_residual) ? p.h : p.x;
      if (step == 0 || step == 4) {  // LN1, LN2
        const T* g = (step == 0 ? p.ln1_g : p.ln2_g) + l * dim;
        const T* b = (step == 0 ? p.ln1_b : p.ln2_b) + l * dim;
        ln_phase(p.x, g, b, p.h, M, dim, p.eps);
        continue;
      }
      if (step == 2) {
        attention_phase<HD_MAX>(smem, p);
        continue;
      }
      const T *a, *w, *bias, *r = nullptr;
      T* y;
      int n, k, epi, tile;
      if (step == 1) {  // qkv
        a = p.h, w = p.qkv_w + static_cast<size_t>(l) * dim * qkvn, bias = p.qkv_b + l * qkvn;
        y = p.qkv, n = qkvn, k = dim, epi = 0, tile = p.tile[1];
      } else if (step == 3) {  // out-projection
        a = p.att, w = p.out_w + static_cast<size_t>(l) * inner * dim, bias = p.out_b + l * dim;
        r = res, y = p.x, n = dim, k = inner, epi = 3, tile = p.tile[2];
      } else if (step == 5) {  // fc1
        a = p.h, w = p.fc1_w + static_cast<size_t>(l) * dim * mlp, bias = p.fc1_b + l * mlp;
        y = p.hid, n = mlp, k = dim, epi = p.approx_gelu ? 1 : 2, tile = p.tile[3];
      } else {  // fc2
        a = p.hid, w = p.fc2_w + static_cast<size_t>(l) * mlp * dim, bias = p.fc2_b + l * dim;
        r = res, y = p.x, n = dim, k = mlp, epi = 3, tile = p.tile[4];
      }
      gemm_phase(tile, smem, RowsA<T>{a, true}, w, bias, r, y, M, n, k, epi, M);
    }
  }
  grid.sync();
  head_phase(smem, p);
}

#ifndef EVT_F16
__global__ __launch_bounds__(THREADS) void barrier_probe_kernel(int count) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < count; ++i) grid.sync();
}
#endif

// The shared memory of one block under the plan: the largest of its GEMM
// phases' rings (one per warp group), its attention strips' and the head's.
int smem_of(const Params<elem>& p) {
  constexpr int rows[TILE_CODES] = {128, 16}, cols[TILE_CODES] = {96, 32};
  constexpr int groups[TILE_CODES] = {1, 4};
  int most = HEAD_IMAGES * p.dim * static_cast<int>(sizeof(float));
  for (int i = 0; i < GEMM_PHASES; ++i) {
    const int c = p.tile[i];
    most = std::max(most, groups[c] * smem_bytes(rows[c], cols[c]));
  }
  const int strip = (p.attn_warps * 16 + arows::STAGES * 2 * arows::KT) * row_ld(p.head_dim) * 2;
  return std::max(most, THREADS / (p.attn_warps * 32) * strip);
}

// The instance at the translation unit's element type.
template <int HD_MAX, int BLOCKS>
const void* kernel_of() {
  return reinterpret_cast<const void*>(vit_full_kernel<HD_MAX, BLOCKS, elem>);
}

// Let `kernel` take `smem` bytes of dynamic shared memory, with the SM's
// carveout all shared memory, so that two blocks fit; once per size.
int configure(const void* kernel, int smem, int* configured) {
  if (smem <= *configured) return 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) *configured = smem;
  return static_cast<int>(e);
}

// Blocks of the instance (head dims up to HD_MAX, built for BLOCKS) that fit
// on one SM at once with `smem` bytes each.
template <int HD_MAX, int BLOCKS>
int blocks_per_sm(int smem, int* out) {
  static int configured = 0;
  const int rc = configure(kernel_of<HD_MAX, BLOCKS>(), smem, &configured);
  if (rc != 0) return rc;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel_of<HD_MAX, BLOCKS>(), THREADS, smem));
}

template <int HD_MAX, int BLOCKS>
int launch_full(const Params<elem>& p, int grid_cap, int* grid_out, cudaStream_t stream) {
  const int smem = smem_of(p);
  static int cached_smem = -1, cached_blocks = 0;
  if (smem != cached_smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int rc = blocks_per_sm<HD_MAX, BLOCKS>(smem, &per_sm);
    if (rc != 0) return rc;
    cached_smem = smem;
    cached_blocks = per_sm * sms;
  }
  const int grid = std::min(cached_blocks, grid_cap);
  *grid_out = grid;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  void* args[] = {const_cast<Params<elem>*>(&p)};
  return static_cast<int>(
      cudaLaunchCooperativeKernel(kernel_of<HD_MAX, BLOCKS>(), grid, THREADS, args, smem, stream));
}

}  // namespace

// ptrs: img, patch_w, embed_bias, ln1_g, ln1_b, qkv_w, qkv_b, out_w, out_b,
//   ln2_g, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, fnorm_g, fnorm_b, head_w,
//   head_b, x, h, qkv, att, hid, logits (25; the stacks [L, ...]; bf16, or
//   fp16 in the fp16 instance, but the image, which may be fp32).
// ints: batch, depth, dim, heads, head_dim, mlp, classes, image, patch,
//   channels, img_f32, reference_residual, approx_gelu, final_norm; the plan
//   (ops/cuda/fused_vit_full.py:vit_full_plan): the tile code of the embed,
//   qkv, out, fc1 and fc2 phases, the attention strip's warps (4 or 8), the
//   grid cap and the instance's blocks an SM (2, or 1; 1 at head_dim 128);
//   ints[22] receives the grid size.  floats: eps, scale2 (head_dim^-1/2 *
//   log2 e).  Every width a multiple of 8.
extern "C" int EVT_EXPORT(evt_vit_full)(void* const* ptrs, int* ints, const float* floats,
                                        void* stream) {
  Params<elem> p;
  const void* const* q = ptrs;
  p.img = q[0];
  const elem** w[] = {&p.patch_w, &p.embed_bias, &p.ln1_g, &p.ln1_b, &p.qkv_w, &p.qkv_b,
                      &p.out_w, &p.out_b, &p.ln2_g, &p.ln2_b, &p.fc1_w, &p.fc1_b,
                      &p.fc2_w, &p.fc2_b, &p.fnorm_g, &p.fnorm_b, &p.head_w, &p.head_b};
  for (int i = 0; i < 18; ++i) *w[i] = static_cast<const elem*>(q[1 + i]);
  elem** a[] = {&p.x, &p.h, &p.qkv, &p.att, &p.hid, &p.logits};
  for (int i = 0; i < 6; ++i) *a[i] = static_cast<elem*>(ptrs[19 + i]);
  p.batch = ints[0];
  p.depth = ints[1];
  p.dim = ints[2];
  p.heads = ints[3];
  p.head_dim = ints[4];
  p.mlp = ints[5];
  p.classes = ints[6];
  p.image = ints[7];
  p.patch = ints[8];
  p.channels = ints[9];
  p.img_f32 = ints[10];
  p.reference_residual = ints[11];
  p.approx_gelu = ints[12];
  p.final_norm = ints[13];
  for (int i = 0; i < GEMM_PHASES; ++i) {
    p.tile[i] = ints[14 + i];
    if (p.tile[i] < 0 || p.tile[i] >= TILE_CODES) return static_cast<int>(cudaErrorInvalidValue);
  }
  p.attn_warps = ints[19];
  const int grid_cap = ints[20], blocks = ints[21];
  p.tokens = (p.image / p.patch) * (p.image / p.patch) + 1;
  p.eps = floats[0];
  p.scale2 = floats[1];
  if (p.batch == 0) return 0;
  if (p.attn_warps != 4 && p.attn_warps != 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.head_dim * 4 + blocks) {
    case 16 * 4 + 1:
    case 32 * 4 + 1:
    case 64 * 4 + 1: return launch_full<64, 1>(p, grid_cap, &ints[22], s);
    case 16 * 4 + 2:
    case 32 * 4 + 2:
    case 64 * 4 + 2: return launch_full<64, 2>(p, grid_cap, &ints[22], s);
    case 128 * 4 + 1: return launch_full<128, 1>(p, grid_cap, &ints[22], s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The blocks of the instance for `head_dim` built for `blocks` an SM that
// one SM holds at once with `smem` bytes of dynamic shared memory each, into
// *out.
extern "C" int EVT_EXPORT(evt_vit_full_blocks_per_sm)(int head_dim, int blocks, int smem,
                                                      int* out) {
  switch (head_dim * 4 + blocks) {
    case 16 * 4 + 1:
    case 32 * 4 + 1:
    case 64 * 4 + 1: return blocks_per_sm<64, 1>(smem, out);
    case 16 * 4 + 2:
    case 32 * 4 + 2:
    case 64 * 4 + 2: return blocks_per_sm<64, 2>(smem, out);
    case 128 * 4 + 1: return blocks_per_sm<128, 1>(smem, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// `count` grid barriers and nothing else, on `blocks` blocks of 256 threads:
// what one barrier costs at the block count of a forward (no element type:
// the bf16 translation unit exports it).
#ifndef EVT_F16
extern "C" int evt_vit_full_barrier_probe(int blocks, int count, void* stream) {
  void* args[] = {&count};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(barrier_probe_kernel), blocks, THREADS, args, 0,
      static_cast<cudaStream_t>(stream)));
}
#endif
