"""What the parts of ``csrc/window_attention.cu`` (the Swin chain's window
attention: K9's, K11a/b's) cost on the card: the kernel as committed
against variants of its source, against the WMMA kernel it replaced and
against SDPA, each timed on the same inputs.

    python -m edgevisiontransformer_tpu_torch.bench.window_attention_ab

Source variants, each built into its own library, all with the same bits:
the committed kernel (the fp32 bias tile staged in shared memory by
``cp.async`` with q and k where the block also reads a shifted window's
mask, read element by element from L2 where it does not); the bias read
from L2 everywhere; the bias staged everywhere (anchor: the body of
``stage_bias<MASK>()``).  The WMMA kernel:
``csrc/window_attention.cu`` as it stood before its redesign (scores and
``p`` through shared memory, synchronous loads, a warp walking its 16 rows
one at a time; :data:`WMMA_SOURCE`), built beside; it takes windows up to
8.  The library yardstick is SDPA on the windows' q, k, v gathered
beforehand (the gather not timed) with the bf16 sum of the bias and the
mask, as ``chip_smoke.py`` phase 6 times it.

Shapes: swin_tiny's four stages (window 7, head_dim 32) at b1 and b32,
shifted and unshifted where a stage has several windows, and Swin-B at
384's first stage (window 12) at b1.  Each line gives the device time per
launch (``harness.measure_graph_time``: CUDA events around a CUDA graph of
20 launches replayed, median of 5 samples), the largest difference from the
committed kernel's output and the number of elements that differ.  Runs go
A, B, ..., B, A.  Then, per variant, the sum over one swin_tiny b1
forward's 12 launches (the mean of both passes), split into unshifted and
shifted launches.  Last, how many of the 1000 logits of one swin_tiny b1
forward (``fused_swin_apply``, seeded random weights) move when the WMMA
kernel takes the committed kernel's place, and by how much.  Needs a CUDA
device and ``nvcc``; the libraries go to ``build/window_attention_ab/``.
"""

from __future__ import annotations

import ctypes
import subprocess
from collections import defaultdict

import torch
import torch.nn.functional as F

from ..models.swin import shifted_window_mask
from ..ops.cuda import build
from ..ops.cuda.swin_block import window_rows
from .harness import measure_graph_time

LOG2E = 1.4426950408889634
# swin_tiny at 224: per stage (resolution, heads, depth), window 7, head_dim
# 32; a stage's odd blocks shift where it has several windows
SWIN_TINY = ((56, 3, 2), (28, 6, 2), (14, 12, 6), (7, 24, 2))
# Swin-B at 384: stage 0 (resolution 96, 4 heads of 32), window 12
WINDOW12 = (96, 4, 2)
BATCHES = (1, 32)
# where the bias is read: the body of stage_bias<MASK>()
_STAGE = "constexpr bool stage_bias() { return MASK; }"
COMMITTED = "committed"
L2 = "bias from L2 everywhere"
STAGED = "bias staged everywhere"
WMMA = "WMMA kernel (parent)"
SDPA = "SDPA + bias + mask"
# The kernel before its redesign, exported as evt_window_attention_wmma:
# one 4-warp block per (window, head, image), q, k, v gathered by raster row
# with synchronous 16-byte loads, WMMA products with the scores and p in
# shared memory, a warp walking its 16 rows one at a time (the fp32 bias and
# mask read element by element), a lane-strided warp_sum; n <= 64.
WMMA_SOURCE = r"""
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int T = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr float kClamp = 60.0f;

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
  static constexpr int R_OFF = P_OFF + T * PLD * 2;
  static constexpr int BYTES = R_OFF + T * 4;
};

template <int HD>
__global__ __launch_bounds__(THREADS) void window_attention_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ bias, const float* __restrict__ mask,
    bf16* __restrict__ out, int res, int w, int shift, int heads, float scale2) {
  using L = Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::V_OFF);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::P_OFF);
  float* sR = reinterpret_cast<float*>(smem + L::R_OFF);
  __shared__ int sRow[T];  // the pixel row of each window token, -1 past n

  const int win = blockIdx.x, head = blockIdx.y, img = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = w * w, nwx = res / w;
  const int wy = win / nwx, wx = win % nwx;
  const int ld = 3 * heads * HD;
  const size_t img_row0 = static_cast<size_t>(img) * res * res;

  if (tid < T) {
    int row = -1;
    if (tid < n) {
      const int py = (wy * w + tid / w + shift) % res;
      const int px = (wx * w + tid % w + shift) % res;
      row = py * res + px;
    }
    sRow[tid] = row;
  }
  __syncthreads();

  // Gather q, k, v of the window's tokens; rows >= n are zero.
  constexpr int CH = HD / 8;
  for (int i = tid; i < 3 * T * CH; i += THREADS) {
    const int part = i / (T * CH), r = (i / CH) % T, c = (i % CH) * 8;
    const int row = sRow[r];
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row >= 0)
      v = *reinterpret_cast<const uint4*>(qkv + (img_row0 + row) * ld +
                                          (part * heads + head) * HD + c);
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

  // p = exp2(min(s * scale2 + bias (+ mask), 60)) for keys < n, else 0;
  // query rows >= n are padding and get p = 0 (nothing reads them).
  const float* bh = bias + static_cast<size_t>(head) * n * n;
  const float* mw = mask != nullptr ? mask + static_cast<size_t>(win) * n * n : nullptr;
#pragma unroll 4
  for (int r = 0; r < 16; ++r) {
    const int q = wr + r;
    float part = 0.0f;
#pragma unroll
    for (int c = lane; c < T; c += 32) {
      float p = 0.0f;
      if (q < n && c < n) {
        float s = __fadd_rn(__fmul_rn(sS[q * L::SLD + c], scale2), bh[q * n + c]);
        if (mw != nullptr) s = __fadd_rn(s, mw[q * n + c]);
        p = exp2f(fminf(s, kClamp));
      }
      part += p;
      sP[q * L::PLD + c] = __float2bfloat16_rn(p);
    }
    part = warp_sum(part);
    if (lane == 0) sR[q] = 1.0f / fmaxf(part, 1e-30f);
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
    const float inv = sR[q];
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = sS[q * L::SLD + c + e] * inv;
    *reinterpret_cast<uint4*>(out + (img_row0 + sRow[q]) * ldo + head * HD + c) = pack8(v);
  }
}

template <int HD>
int launch(const void* qkv, const void* bias, const void* mask, void* out, int batch, int res,
           int w, int shift, int heads, float scale2, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(window_attention_kernel<HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Smem<HD>::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int nwx = res / w;
  const dim3 grid(nwx * nwx, heads, batch);
  window_attention_kernel<HD><<<grid, THREADS, Smem<HD>::BYTES, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<bf16*>(out), res, w, shift, heads, scale2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int evt_window_attention_wmma(const void* qkv, const void* bias, const void* mask,
                                         void* out, int batch, int res, int w, int shift,
                                         int heads, int head_dim, float scale2, void* stream) {
  if (batch == 0) return 0;
  if (w <= 0 || w * w > T || res % w != 0 || shift < 0 || shift >= w)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch<32>(qkv, bias, mask, out, batch, res, w, shift, heads, scale2, s);
    case 64: return launch<64>(qkv, bias, mask, out, batch, res, w, shift, heads, scale2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
"""


def variants(src: str) -> dict:
    """``{name: source of window_attention.cu}`` for each variant of ``src``."""
    if src.count(_STAGE) != 1:
        raise ValueError(f"csrc/window_attention.cu no longer holds {_STAGE!r} once")
    return {COMMITTED: src, L2: src.replace(_STAGE, _STAGE.replace("MASK;", "false;")),
            STAGED: src.replace(_STAGE, _STAGE.replace("MASK;", "true;"))}


def _bind(so, name: str):
    fn = getattr(ctypes.CDLL(str(so)), name)
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
    return fn


def build_libraries(source_variants: bool = True) -> tuple:
    """``({name: evt_window_attention}, evt_window_attention_wmma)``: each
    source variant (only the committed one unless ``source_variants``) and
    the WMMA kernel, compiled side by side; prints ptxas's registers and
    spills of each."""
    out_dir = build.BUILD_DIR.parent / "window_attention_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = variants((build.CSRC / "window_attention.cu").read_text())
    if not source_variants:
        srcs = {COMMITTED: srcs[COMMITTED]}
    srcs[WMMA] = WMMA_SOURCE
    jobs = []
    for i, (name, code) in enumerate(srcs.items()):
        cu, so = out_dir / f"window_attention_v{i}.cu", out_dir / f"libwindow_attention_v{i}.so"
        cu.write_text(code)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
               str(build.CSRC), "-o", str(so), str(cu)]
        jobs.append((name, so, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, so, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f"{name}: {err}")
        if source_variants:
            for line in err.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.split('info    : ')[-1].strip()}")
        libs[name] = so
    wmma = _bind(libs.pop(WMMA), "evt_window_attention_wmma")
    return {name: _bind(so, "evt_window_attention") for name, so in libs.items()}, wmma


def launch(fn, qkv, bias, mask, out, res, window, shift, heads, hd) -> None:
    """One launch of a built ``evt_window_attention`` or of the WMMA kernel."""
    build.check(fn(qkv.data_ptr(), bias.data_ptr(), None if mask is None else mask.data_ptr(),
                   out.data_ptr(), qkv.shape[0] // (res * res), res, window, shift, heads, hd,
                   ctypes.c_float(hd ** -0.5 * LOG2E), torch.cuda.current_stream().cuda_stream),
                "window_attention")


def logits_against_wmma(wmma) -> tuple:
    """``(logits that move, logits, largest move, max|logit|)``: one swin_tiny
    b1 forward through ``fused_swin_apply`` (bf16, seeded random weights and
    image, as ``chip_smoke.py`` phase 4 builds them) with the committed
    kernel, and again with the WMMA kernel in its place."""
    from ..models.registry import build_model
    from ..models.swin import fused_swin_apply, prepare_swin_fused
    from ..ops.cuda import swin_block as sb

    model, shape = build_model("swin_tiny", dtype=torch.bfloat16, device="cuda",
                               generator=torch.Generator().manual_seed(0))
    prepared = prepare_swin_fused(model)
    img = torch.randn(1, *shape, generator=torch.Generator().manual_seed(1200)).cuda()

    def parent(qkv, bias, mask, *, res, window, shift, heads, head_dim):
        out = torch.empty(qkv.shape[0], heads * head_dim, dtype=qkv.dtype, device=qkv.device)
        launch(wmma, qkv, bias, mask, out, res, window, shift, heads, head_dim)
        return out

    with torch.no_grad():
        new = fused_swin_apply(model, img, prepared=prepared)
        kernel, sb.window_attention = sb.window_attention, parent
        try:
            old = fused_swin_apply(model, img, prepared=prepared)
        finally:
            sb.window_attention = kernel
    diff = (new.float() - old.float()).abs()
    return int((diff > 0).sum()), diff.numel(), float(diff.max()), float(old.float().abs().max())


def cases() -> list:
    """``(tag, batch, res, window, heads, shifted, launches in one swin_tiny
    b1 forward)`` of every timed shape."""
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
        raise SystemExit("window_attention_ab needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    fns, wmma = build_libraries()
    gen = torch.Generator(device="cuda").manual_seed(0)
    hd = 32
    forward = defaultdict(lambda: [0.0, 0.0])  # (variant) -> [unshifted, shifted] ms
    for tag, batch, res, w, heads, shifted, reps in cases():
        n, nwin, shift = w * w, (res // w) ** 2, w // 2 if shifted else 0
        qkv = torch.randn(batch * res * res, 3 * heads * hd, generator=gen,
                          device="cuda").bfloat16()
        bias = 0.5 * LOG2E * torch.randn(heads, n, n, generator=gen, device="cuda")
        mask = (torch.from_numpy(shifted_window_mask(res, res, w, w // 2)).cuda() * LOG2E
                if shifted else None)
        # SDPA's operands: the windows' q, k, v gathered by raster row, the
        # bias and mask summed in bf16 (natural-log scale)
        idx = window_rows(res, w, shift, "cuda")
        win = qkv.view(batch, res * res, 3, heads, hd)[:, idx]
        q, k, v = win.reshape(batch * nwin, n, 3, heads, hd).permute(2, 0, 3, 1, 4).contiguous()
        am = (bias[None] + (mask[:, None] if shifted else 0.0)) / LOG2E
        am = am.bfloat16().expand(nwin, heads, n, n).repeat(batch, 1, 1, 1)
        runs = list(fns) + ([WMMA] if n <= 64 else []) + [SDPA]
        ref, sums = None, defaultdict(float)
        for order in (runs, runs[::-1]):  # A, B, ..., B, A
            for name in order:
                if name == SDPA:
                    ms = measure_graph_time(lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=am))["p50_ms"]
                    print(f"{tag:27s} {name:30s} {ms * 1e3:9.2f} us")
                    sums[name] += ms / 2
                    continue
                out = torch.empty(qkv.shape[0], heads * hd, dtype=torch.bfloat16, device="cuda")
                fn = wmma if name == WMMA else fns[name]
                ms = measure_graph_time(lambda: launch(fn, qkv, bias, mask, out, res, w, shift,
                                                       heads, hd))["p50_ms"]
                ref = out.clone() if ref is None else ref
                diff = (out.float() - ref.float()).abs()
                print(f"{tag:27s} {name:30s} {ms * 1e3:9.2f} us  "
                      f"max|diff vs committed| {float(diff.max()):.3g}  "
                      f"elements differing {int((diff > 0).sum())} of {diff.numel()}")
                sums[name] += ms / 2
        for name, ms in sums.items():
            forward[name][int(shifted)] += reps * ms
    print("one swin_tiny b1 forward (12 launches), ms: all / unshifted / shifted")
    for name, (un, sh) in forward.items():
        print(f"  {name:30s} {un + sh:.4f} / {un:.4f} / {sh:.4f}")
    moved, total, most, scale = logits_against_wmma(wmma)
    print(f"swin_tiny b1 logits, committed kernel against the WMMA kernel: {moved} of {total} "
          f"move, by at most {most:.4g} (max|logit| {scale:.4g})")


if __name__ == "__main__":
    main()
