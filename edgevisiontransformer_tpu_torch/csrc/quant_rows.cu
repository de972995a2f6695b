// quant_rows: symmetric int8 quantization of each row of a [rows, K] bf16
// matrix, the activation half of the encoder's int8 matmuls.
//
// Replaces: the in-kernel activation quantization of the TPU int8
//   whole-encoder kernels, edgevisiontransformer_tpu/ops/pallas/
//   fused_encoder.py, as called by `_encoder_kernel_int8` (K4,
//   encoder_forward_int8) and `_encoder_kernel_int8_pipelined` (K5,
//   encoder_forward_int8_pipelined):
//     dynamic  `_quant_rows_kernel` (:844-853): a = max|h| of the row,
//              s = a > 0 ? a * f32(1/127) : 1, q = clip(rint(h * (1/s)), +-127)
//     static   `_int8_mm_static` (:873-877): q = clip(rint(h * inv_a), +-127),
//              inv_a = act_inv[layer, matmul], a calibrated scalar.
//   `a / 127.0` inside the Pallas kernel is evaluated as the product with
//   the rounded reciprocal (the JAX package's interpret mode does so, bit for
//   bit), so it is written that way here; 1/s is the IEEE quotient and rint
//   rounds half to even, as jnp.round does.  __fmul_rn keeps nvcc from
//   contracting anything into an FMA, so the kernel equals its plain twin
//   bit for bit.
//
// Bound on the card: device-memory bytes.  Per element it reads 2 bytes and
// writes 1, with a few flops: deit_tiny b128's fc1 input (25,216 x 768)
// moves 58 MB, ~17 us at 3.35 TB/s.
//
// Design: one warp per row, 16-byte loads of 8 bf16 values and 8-byte
// stores of 8 int8 values.  Dynamic mode reads the row twice (the absmax,
// then the quantization; the second read hits L1 / L2).  Static mode reads
// inv_a on the device, so a forward needs no host copy of act_inv and can
// be captured in a CUDA graph.  Any K: where K is not a multiple of 8 (a
// pruned model's hidden width, 230) or a pointer is off its vector boundary,
// the host takes the element-wise form of the same loop.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr float kInv127 = 1.0f / 127.0f;  // folded at compile time, correctly rounded

__device__ __forceinline__ int8_t quant1(float f, float inv) {
  return static_cast<int8_t>(min(max(__float2int_rn(__fmul_rn(f, inv)), -127), 127));
}

__device__ __forceinline__ uint2 quant8(const float f[8], float inv) {
  uint2 out;
  int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = quant1(f[i], inv);
  return out;
}

// VEC: K % 8 == 0 and x, q on 16- and 8-byte boundaries (8 values a lane).
template <bool VEC>
__global__ __launch_bounds__(kWarps * 32) void quant_rows_kernel(
    const bf16* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
    const float* __restrict__ act_inv, int index, int rows, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const bf16* xr = x + static_cast<size_t>(row) * K;
  int8_t* qr = q + static_cast<size_t>(row) * K;
  const int chunks = K / 8;
  float f[8];

  float inv;
  if (act_inv != nullptr) {
    inv = act_inv[index];
  } else {
    float a = 0.f;
    if constexpr (VEC) {
      for (int c = lane; c < chunks; c += 32) {
        unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
#pragma unroll
        for (int i = 0; i < 8; ++i) a = fmaxf(a, fabsf(f[i]));
      }
    } else {
      for (int c = lane; c < K; c += 32) a = fmaxf(a, fabsf(__bfloat162float(xr[c])));
    }
    a = warp_max(a);
    const float sc = a > 0.f ? __fmul_rn(a, kInv127) : 1.0f;
    if (lane == 0) s[row] = sc;
    inv = __fdiv_rn(1.0f, sc);
  }

  if constexpr (VEC) {
    for (int c = lane; c < chunks; c += 32) {
      unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
      *reinterpret_cast<uint2*>(qr + c * 8) = quant8(f, inv);
    }
  } else {
    for (int c = lane; c < K; c += 32) qr[c] = quant1(__bfloat162float(xr[c]), inv);
  }
}

}  // namespace

// act_inv == nullptr: dynamic mode, writes s[rows].  Otherwise static mode
// with inv_a = act_inv[index]; s is not touched.
extern "C" int evt_quant_rows(const void* x, void* q, void* s, const void* act_inv, int index,
                              int rows, int K, void* stream) {
  if (rows == 0) return 0;
  const dim3 grid((rows + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  if (K % 8 == 0 && aligned16(x) && (reinterpret_cast<uintptr_t>(q) & 7u) == 0)
    quant_rows_kernel<true><<<grid, kWarps * 32, 0, st>>>(
        xp, qp, static_cast<float*>(s), static_cast<const float*>(act_inv), index, rows, K);
  else
    quant_rows_kernel<false><<<grid, kWarps * 32, 0, st>>>(
        xp, qp, static_cast<float*>(s), static_cast<const float*>(act_inv), index, rows, K);
  return static_cast<int>(cudaGetLastError());
}
