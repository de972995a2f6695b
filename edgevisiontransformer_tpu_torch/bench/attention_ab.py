"""What the parts of ``csrc/attention_rows.cu`` (K1's attention) cost on the
card: the kernel as committed against variants of its source, against
other plans of its grid, against the WMMA tile it replaced and against
SDPA, each timed on the same inputs.

    python -m edgevisiontransformer_tpu_torch.bench.attention_ab

Source variants of ``csrc/attention_strip.cuh`` (the query strip) and
``csrc/attention_rows.cu`` (its kernel and dispatch), each pair built into
its own library: the committed kernel (a 2-stage ring of 64-key tiles); a
3-stage ring; a 4-stage ring (at n <= 256 every K and V tile is in flight
from the start: the resident form); no
softmax (the helper ``softmax_p`` returns its argument: the products, the
loads, the row sums and the stores only, a floor; its output is not
attention); blocks of 1 and 2 warps compiled beside the committed 4 and 8.
Plan variants: each compiled block beside the plan
``fused_encoder.attention_plan`` picks (1 and 2 warps on their variant's
library, 4 and 8 on the committed one).  The tile
kernel: ``attn::tile`` of ``csrc/encoder_tiles.cuh`` (WMMA, scores and
``p`` through shared memory, synchronous loads) in blocks of 64 queries,
as ``attention_rows`` ran it before its redesign (:data:`TILE_SOURCE`),
built beside; it takes head_dim 32, 64 and 128.  The library yardstick is
SDPA with an additive key mask on q, k, v views of the same qkv.  Each line
gives the device time per launch (``harness.measure_graph_time``: CUDA
events around a CUDA graph of 20 launches replayed, median of 5 samples),
the largest difference from the committed kernel's output under its own
plan and the number of elements that differ.  Runs go A, B, ..., B, A.
Needs a CUDA device and ``nvcc``; the libraries go to
``build/attention_ab/``.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch
import torch.nn.functional as F

from ..ops.cuda import build
from ..ops.cuda import fused_encoder as fe
from .harness import measure_graph_time

# (batch, tokens, heads, head_dim): deit_tiny b128 and b1, t2t_vit_14 b1 and
# b32, the pruned model's one head at b1 and b128, deit_base b8, and
# deit_base at 384 (n = 577: ten 64-key tiles through the ring)
SHAPES = {"deit_tiny b128": (128, 197, 3, 64), "deit_tiny b1": (1, 197, 3, 64),
          "t2t_vit_14 b1": (1, 197, 6, 64), "t2t_vit_14 b32": (32, 197, 6, 64),
          "pruned h1 b1": (1, 197, 1, 64),
          "pruned h1 b128": (128, 197, 1, 64), "deit_base b8": (8, 197, 12, 64),
          "deit_base 384 b8": (8, 577, 12, 64)}
# the ring's depth and the body of the softmax helper softmax_p(s) in the
# strip's header, and the last case of the dispatch over the warps a block
# in the kernel's source
STRIP = "attention_strip.cuh"
ENTRY = "attention_rows.cu"
_STAGES = "constexpr int KT = 64, STAGES = 2;"
_SOFTMAX = "return exp2f(fminf(s, kClamp));"
_CASE8 = "    case 8: return launch<HD, 8>(qkv, out, batch, tokens, seq_len, heads, scale2, s);\n"
# attn::tile (csrc/encoder_tiles.cuh) in one 4-warp block per (64-query
# tile, head, image)
TILE_SOURCE = r"""
#include "encoder_tiles.cuh"

namespace {

template <int HD>
__global__ __launch_bounds__(attn::THREADS) void tile_kernel(
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
        tile_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, attn::Smem<HD>::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((tokens + attn::QT - 1) / attn::QT, heads, batch);
  tile_kernel<HD><<<grid, attn::THREADS, attn::Smem<HD>::BYTES, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), tokens, seq_len, heads, scale2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int evt_attention_rows_tile(const void* qkv, void* out, int batch, int tokens,
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
"""
TILE = "WMMA tile"
NARROW = "1 and 2 warps"


def variants(strip: str, entry: str) -> dict:
    """``{name: {STRIP: source, ENTRY: source}}`` for each variant of the
    strip's header ``strip`` and the kernel's source ``entry``."""
    for src, anchors in ((strip, (_STAGES, _SOFTMAX)), (entry, (_CASE8,))):
        for anchor in anchors:
            if src.count(anchor) != 1:
                raise ValueError(f"csrc/{STRIP} or {ENTRY} no longer holds {anchor!r} once")
    narrow = "".join(_CASE8.replace("8", str(w)) for w in (1, 2))

    def stages(k):
        return {STRIP: strip.replace(_STAGES, _STAGES.replace("STAGES = 2", f"STAGES = {k}")),
                ENTRY: entry}

    return {"committed": {STRIP: strip, ENTRY: entry}, "3 stages": stages(3),
            "4 stages (resident)": stages(4),
            "no softmax": {STRIP: strip.replace(_SOFTMAX, "return s;"), ENTRY: entry},
            NARROW: {STRIP: strip, ENTRY: entry.replace(_CASE8, _CASE8 + narrow)}}


def _compile(jobs: list) -> None:
    for name, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f"{name}: {err}")


def _bind(so, name: str, nargs_int: int):
    fn = getattr(ctypes.CDLL(str(so)), name)
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, i, i, ctypes.c_float] + [i] * nargs_int + [p]
    return fn


def build_libraries(source_variants: bool = True) -> tuple:
    """``({name: evt_attention_rows}, evt_attention_rows_tile)``: each source
    variant (only the committed one unless ``source_variants``) and the tile
    kernel, compiled side by side."""
    out_dir = build.BUILD_DIR.parent / "attention_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = variants((build.CSRC / STRIP).read_text(), (build.CSRC / ENTRY).read_text())
    if not source_variants:
        srcs = {"committed": srcs["committed"]}
    srcs[TILE] = {"tile.cu": TILE_SOURCE}
    jobs, libs = [], {}
    for i, (name, files) in enumerate(srcs.items()):
        vdir = out_dir / f"v{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        for fname, code in files.items():  # the entry includes the header beside it
            (vdir / fname).write_text(code)
        cu = vdir / next(f for f in files if f.endswith(".cu"))
        so = vdir / f"libattention_v{i}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC), "-o",
               str(so), str(cu)]
        jobs.append((name, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)))
        libs[name] = so
    _compile(jobs)
    tile = _bind(libs.pop(TILE), "evt_attention_rows_tile", 0)
    return {name: _bind(so, "evt_attention_rows", 1) for name, so in libs.items()}, tile


def launch(fn, qkv, out, tokens, heads, hd, warps=None, seq_len=None) -> None:
    """One launch of a built ``evt_attention_rows`` (``warps`` given) or of
    the tile kernel (``warps`` None)."""
    plan = () if warps is None else (warps,)
    seq_len = tokens if seq_len is None else seq_len
    build.check(fn(qkv.data_ptr(), out.data_ptr(), qkv.shape[0] // tokens, tokens, seq_len,
                   heads, hd, ctypes.c_float(hd ** -0.5 * fe._LOG2E), *plan,
                   torch.cuda.current_stream().cuda_stream), "attention_rows")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("attention_ab needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fns, tile = build_libraries()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for tag, (b, n, h, d) in SHAPES.items():
        qkv = torch.randn(b * n, 3 * h * d, generator=gen, device="cuda").bfloat16()
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        key_mask = torch.zeros(1, 1, 1, n, dtype=torch.bfloat16, device="cuda")
        plan = fe.attention_plan(b, h, n, sms)
        runs = [(name, plan, "plan") for name in fns if name != NARROW]
        runs += [("committed", w, f"{w} warps") for w in fe.ATTENTION_WARPS if w != plan]
        runs += [(NARROW, w, f"{w} warps") for w in (1, 2)]
        runs += [(TILE, None, "64 queries"), ("SDPA + key mask", None, "-")]
        ref = None
        for order in (runs, runs[::-1]):  # A, B, ..., B, A
            for name, warps, pname in order:
                out = torch.empty(b * n, h * d, dtype=torch.bfloat16, device="cuda")
                if name == "SDPA + key mask":
                    ms = measure_graph_time(lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=key_mask))["p50_ms"]
                    print(f"{tag:17s} {name:20s} {pname:10s} {ms * 1e3:9.2f} us")
                    continue
                fn = tile if warps is None else fns[name]
                ms = measure_graph_time(lambda: launch(fn, qkv, out, n, h, d, warps))["p50_ms"]
                ref = out.clone() if ref is None else ref
                diff = (out.float() - ref.float()).abs()
                print(f"{tag:17s} {name:20s} {pname:10s} {ms * 1e3:9.2f} us  "
                      f"max|diff vs committed| {float(diff.max()):.3g}  "
                      f"elements differing {int((diff > 0).sum())} of {diff.numel()}")


if __name__ == "__main__":
    main()
