"""What the parts of ``csrc/window_sdpa.cu`` (K12) cost on the card: the
kernel as committed against variants of its source, against the WMMA
kernel it replaced and against SDPA, each timed on the same inputs.

    python -m edgevisiontransformer_tpu_torch.bench.window_sdpa_ab

Source variants, each built into its own library: the committed kernel
(the exact division ``divide_exact``); ``__fdiv_rn`` per score (the same
quotients: what the division's fast and slow paths cost, shifted windows
against unshifted); the product with the rounded reciprocal of the row sum
(up to one fp32 ulp off, so sometimes one bf16 spacing); no division
(``p = e``, a floor; its output is not attention).  The WMMA kernel:
``csrc/window_sdpa.cu`` as it stood before its redesign (scores and ``p``
through shared memory, synchronous loads, ``__fdiv_rn``;
:data:`WMMA_SOURCE`), built beside; it takes windows up to 8.  The library
yardstick is SDPA on the same window-major q, k, v with the
bf16 sum of the bias and the mask, as ``chip_smoke.py`` phase 6 times it.

Shapes: swin_tiny's four stages (window 7, head_dim 32) at b1 and b32,
shifted and unshifted where a stage has several windows, and Swin-B at
384's first stage (window 12) at b1.  Each line gives the device time per
launch (``harness.measure_graph_time``: CUDA events around a CUDA graph of
20 launches replayed, median of 5 samples), the largest difference from the
committed kernel's output and the number of elements that differ.  Runs go
A, B, ..., B, A.  Then, per variant, the sum over one swin_tiny b1 module
forward's 12 launches (the mean of both passes), split into unshifted and
shifted launches.  Needs a CUDA device and ``nvcc``; the libraries go to
``build/window_sdpa_ab/``.
"""

from __future__ import annotations

import ctypes
import subprocess
from collections import defaultdict

import torch
import torch.nn.functional as F

from ..models.swin import shifted_window_mask
from ..ops.cuda import build
from .harness import measure_graph_time

# swin_tiny at 224: per stage (resolution, heads, depth), window 7, head_dim
# 32; a stage's odd blocks shift where it has several windows
SWIN_TINY = ((56, 3, 2), (28, 6, 2), (14, 12, 6), (7, 24, 2))
# Swin-B at 384: stage 0 (resolution 96, 4 heads of 32), window 12
WINDOW12 = (96, 4, 2)
BATCHES = (1, 32)
# the first line of the division helper divide_exact(e, l, y)'s body
_DIVIDE = """  const float es = __fmul_rn(e, 0x1p64f);"""
COMMITTED = "committed"
WMMA = "WMMA kernel (parent)"
SDPA = "SDPA + bias + mask"
# The kernel before its redesign, exported as evt_window_sdpa_wmma: one
# 4-warp block per (window, head), WMMA products with the scores and p in
# shared memory, synchronous 16-byte loads, a warp walking its 16 rows one
# at a time, __fdiv_rn per score; n <= 64.
WMMA_SOURCE = r"""
#include <math.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int T = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr int PER_LANE = T / 32;  // keys of a score row per lane

template <int HD>
struct Smem {
  static constexpr int LD = HD + 8;  // q, k, v row stride (bf16)
  static constexpr int SLD = T + 4;  // scores / output row stride (fp32); HD + 4 <= SLD
  static constexpr int PLD = T + 8;  // probabilities row stride (bf16)
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + T * LD * 2;
  static constexpr int V_OFF = K_OFF + T * LD * 2;
  static constexpr int S_OFF = V_OFF + T * LD * 2;
  static constexpr int P_OFF = S_OFF + T * SLD * 4;
  static constexpr int BYTES = P_OFF + T * PLD * 2;
};

template <int HD>
__global__ __launch_bounds__(THREADS) void window_sdpa_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ bias, const float* __restrict__ mask,
    bf16* __restrict__ out, int n, int heads, int mask_windows, float scale) {
  using L = Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::V_OFF);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::P_OFF);

  const int win = blockIdx.x, head = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ld = 3 * heads * HD;
  const size_t row0 = static_cast<size_t>(win) * n;

  // Copy q, k, v of the window's tokens; rows >= n are zero.
  constexpr int CH = HD / 8;
  for (int i = tid; i < 3 * T * CH; i += THREADS) {
    const int part = i / (T * CH), r = (i / CH) % T, c = (i % CH) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n)
      v = *reinterpret_cast<const uint4*>(qkv + (row0 + r) * ld + (part * heads + head) * HD + c);
    bf16* dst = part == 0 ? sQ : (part == 1 ? sK : sV);
    *reinterpret_cast<uint4*>(dst + r * L::LD + c) = v;
  }
  __syncthreads();

  const int wr = warp * 16;  // this warp's first query row
  // S[wr:wr+16, 0:64] = q k^T
#pragma unroll
  for (int j = 0; j < T / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
    wmma::fill_fragment(s, 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, sQ + wr * L::LD + kk * 16, L::LD);
      wmma::load_matrix_sync(b, sK + j * 16 * L::LD + kk * 16, L::LD);
      wmma::mma_sync(s, a, b, s);
    }
    wmma::store_matrix_sync(sS + wr * L::SLD + j * 16, s, L::SLD, wmma::mem_row_major);
  }
  __syncwarp();

  // Max-subtracted softmax of each valid query row over its n keys, p
  // normalised before the PV product; padding rows and keys get p = 0.
  const bf16* bh = bias + static_cast<size_t>(head) * n * n;
  const float* mw = mask != nullptr ? mask + static_cast<size_t>(win % mask_windows) * n * n
                                    : nullptr;
  for (int r = 0; r < 16; ++r) {
    const int q = wr + r;
    const bool row_ok = q < n;
    float s[PER_LANE];
    float mx = -INFINITY;
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) {
      const int c = lane + 32 * e;
      s[e] = -INFINITY;
      if (row_ok && c < n) {
        float v = __fadd_rn(__fmul_rn(sS[q * L::SLD + c], scale),
                            __bfloat162float(bh[q * n + c]));
        if (mw != nullptr) v = __fadd_rn(v, round_bf16(mw[q * n + c]));
        s[e] = v;
        mx = fmaxf(mx, v);
      }
    }
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) {
      const int c = lane + 32 * e;
      s[e] = (row_ok && c < n) ? expf(__fsub_rn(s[e], mx)) : 0.0f;
      sum += s[e];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) {
      const int c = lane + 32 * e;
      sP[q * L::PLD + c] = __float2bfloat16_rn(row_ok && c < n ? __fdiv_rn(s[e], sum) : 0.0f);
    }
  }
  __syncwarp();

  // O = bf16(p) v
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[HD / 16];
#pragma unroll
  for (int d = 0; d < HD / 16; ++d) {
    wmma::fill_fragment(o[d], 0.0f);
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, sP + wr * L::PLD + kk * 16, L::PLD);
      wmma::load_matrix_sync(b, sV + kk * 16 * L::LD + d * 16, L::LD);
      wmma::mma_sync(o[d], a, b, o[d]);
    }
  }
  // The warp's own score rows become its fp32 output rows (HD + 4 <= SLD).
  __syncwarp();
#pragma unroll
  for (int d = 0; d < HD / 16; ++d)
    wmma::store_matrix_sync(sS + wr * L::SLD + d * 16, o[d], L::SLD, wmma::mem_row_major);
  __syncwarp();

  const int ldo = heads * HD;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    const int q = wr + r;
    if (q >= n) continue;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = sS[q * L::SLD + c + e];
    *reinterpret_cast<uint4*>(out + (row0 + q) * ldo + head * HD + c) = pack8(v);
  }
}

template <int HD>
int launch(const void* qkv, const void* bias, const void* mask, void* out, int windows, int n,
           int heads, int mask_windows, float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_sdpa_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<HD>::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(windows, heads);
  window_sdpa_kernel<HD><<<grid, THREADS, Smem<HD>::BYTES, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
      static_cast<const float*>(mask), static_cast<bf16*>(out), n, heads, mask_windows, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int evt_window_sdpa_wmma(const void* qkv, const void* bias, const void* mask,
                                    void* out, int windows, int n, int heads, int head_dim, int mask_windows,
                               float scale, void* stream) {
  if (windows == 0) return 0;
  if (n <= 0 || n > T || heads <= 0 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mask != nullptr && (mask_windows <= 0 || windows % mask_windows != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch<32>(qkv, bias, mask, out, windows, n, heads, mask_windows, scale, s);
    case 64: return launch<64>(qkv, bias, mask, out, windows, n, heads, mask_windows, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
"""


def variants(src: str) -> dict:
    """``{name: source of window_sdpa.cu}`` for each variant of ``src``."""
    if src.count(_DIVIDE) != 1:
        raise ValueError(f"csrc/window_sdpa.cu no longer holds {_DIVIDE!r} once")
    div = src.index(_DIVIDE)

    def divide(body):  # divide_exact(e, l, y) returning `body` at once
        return src[:div] + f"  return {body};\n" + src[div:]

    return {COMMITTED: src, "__fdiv_rn per score": divide("__fdiv_rn(e, l)"),
            "reciprocal product": divide("__fmul_rn(e, y)"), "no division": divide("e")}


def _bind(so, name: str):
    fn = getattr(ctypes.CDLL(str(so)), name)
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
    return fn


def build_libraries(source_variants: bool = True) -> tuple:
    """``({name: evt_window_sdpa}, evt_window_sdpa_wmma)``: each source
    variant (only the committed one unless ``source_variants``) and the WMMA
    kernel, compiled side by side."""
    out_dir = build.BUILD_DIR.parent / "window_sdpa_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = variants((build.CSRC / "window_sdpa.cu").read_text())
    if not source_variants:
        srcs = {COMMITTED: srcs[COMMITTED]}
    srcs[WMMA] = WMMA_SOURCE
    jobs = []
    for i, (name, code) in enumerate(srcs.items()):
        cu, so = out_dir / f"window_sdpa_v{i}.cu", out_dir / f"libwindow_sdpa_v{i}.so"
        cu.write_text(code)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC), "-o",
               str(so), str(cu)]
        jobs.append((name, so, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, so, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f"{name}: {err}")
        libs[name] = so
    wmma = _bind(libs.pop(WMMA), "evt_window_sdpa_wmma")
    return {name: _bind(so, "evt_window_sdpa") for name, so in libs.items()}, wmma


def launch(fn, qkv, bias, mask, out, heads, hd) -> None:
    """One launch of a built ``evt_window_sdpa`` or of the WMMA kernel."""
    build.check(fn(qkv.data_ptr(), bias.data_ptr(), None if mask is None else mask.data_ptr(),
                   out.data_ptr(), qkv.shape[0], qkv.shape[1], heads, hd,
                   0 if mask is None else mask.shape[0], ctypes.c_float(hd ** -0.5),
                   torch.cuda.current_stream().cuda_stream), "window_sdpa")


def cases() -> list:
    """``(tag, batch, res, window, heads, shifted, launches in one swin_tiny
    b1 module forward)`` of every timed shape."""
    out = []
    for batch in BATCHES:
        for si, (res, heads, depth) in enumerate(SWIN_TINY):
            several = res > 7
            odd = depth // 2 if several else 0
            for shifted in ((False, True) if several else (False,)):
                reps = odd if shifted else depth - odd
                out.append((f"swin_tiny b{batch} s{si}{' shifted' if shifted else ''}", batch,
                            res, 7, heads, shifted, reps if batch == 1 else 0))
    res, heads, _ = WINDOW12
    out += [(f"swin_b 384 b1 s0{' shifted' if s else ''}", 1, res, 12, heads, s, 0)
            for s in (False, True)]
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("window_sdpa_ab needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    fns, wmma = build_libraries()
    gen = torch.Generator(device="cuda").manual_seed(0)
    hd = 32
    forward = defaultdict(lambda: [0.0, 0.0])  # (variant) -> [unshifted, shifted] ms
    for tag, batch, res, w, heads, shifted, reps in cases():
        n, nwin = w * w, (res // w) ** 2
        bw = batch * nwin
        qkv = torch.randn(bw, n, 3 * heads * hd, generator=gen, device="cuda").bfloat16()
        bias = (0.5 * torch.randn(heads, n, n, generator=gen, device="cuda")).bfloat16()
        mask = (torch.from_numpy(shifted_window_mask(res, res, w, w // 2)).cuda()
                if shifted else None)
        parts = qkv.view(bw, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in parts)
        am = bias.float()[None] + (mask[:, None] if shifted else 0.0)
        am = am.bfloat16().repeat(bw // am.shape[0], 1, 1, 1)
        runs = list(fns) + ([WMMA] if n <= 64 else []) + [SDPA]
        ref, sums = None, defaultdict(float)
        for order in (runs, runs[::-1]):  # A, B, ..., B, A
            for name in order:
                if name == SDPA:
                    ms = measure_graph_time(lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=am))["p50_ms"]
                    print(f"{tag:27s} {name:22s} {ms * 1e3:9.2f} us")
                    sums[name] += ms / 2
                    continue
                out = torch.empty(bw, n, heads * hd, dtype=torch.bfloat16, device="cuda")
                fn = wmma if name == WMMA else fns[name]
                ms = measure_graph_time(
                    lambda: launch(fn, qkv, bias, mask, out, heads, hd))["p50_ms"]
                ref = out.clone() if ref is None else ref
                diff = (out.float() - ref.float()).abs()
                print(f"{tag:27s} {name:22s} {ms * 1e3:9.2f} us  "
                      f"max|diff vs committed| {float(diff.max()):.3g}  "
                      f"elements differing {int((diff > 0).sum())} of {diff.numel()}")
                sums[name] += ms / 2
        for name, ms in sums.items():
            forward[name][int(shifted)] += reps * ms
    print("one swin_tiny b1 module forward (12 launches), ms: all / unshifted / shifted")
    for name, (un, sh) in forward.items():
        print(f"  {name:22s} {un + sh:.4f} / {un:.4f} / {sh:.4f}")


if __name__ == "__main__":
    main()
