"""What fusing K10 (Swin patch merging: the 2x2 gather, the LayerNorm over
4C and the [4C, 2C] reduction) into one launch would cost on the card,
against the port's two launches, each timed on the same inputs.

    python -m edgevisiontransformer_tpu_torch.bench.swin_merge_ab

The port runs K10 as ``ops/cuda/swin_merge.swin_merge`` (csrc/swin_merge.cu:
one warp per merged row, the gather and the LayerNorm into a ``[tokens/4,
4C]`` bf16 tensor) and then ``fused_encoder.linear`` with a zero bias
(``CAST_THEN_BIAS``): the chain.  Two fused forms do all of K10 in one
launch; each is built here into its own library, and its output equals the
chain's bit for bit (the ``max|diff|`` column):

- ``bench/swin_merge_fused.cu`` (:data:`FUSED`): ``linear``'s tile with the
  merged rows as its A operand, each block's row statistics computed in a
  prologue, each gathered K step normalized on its way into shared memory;
  and three floors of it, whose output is not K10's: without the statistics
  (anchor: the loop over a warp's rows that calls ``row_stats``; the steps
  are normalized with whatever shared memory holds), without the
  normalization (anchors: the two calls of ``normalize``) and without
  either (the gather and the product);
- ``bench/swin_merge_resident.cu`` (:data:`RESIDENT`): a block's merged
  rows gathered and normalized into shared memory once, then the products
  on them for ``group`` column tiles in turn; and two floors: without the
  normalization (anchor: the call of ``normalize_rows``) and without the
  gather too (anchor: the row chunks' ``cp.async``; the product on whatever
  shared memory holds).

Shapes: swin_tiny's three merges (C = 96, 192, 384 at resolution 56, 28,
14) at b1, b8 and b32, the fp32 affine of the prepared model, random
inputs.  Each line gives the device time (``harness.measure_graph_time``:
CUDA events around a CUDA graph of 20 calls replayed, median of 5 samples)
of the chain (its two launches apart and together) and of each fused form
and floor under its plan (:func:`fused_plan`, :func:`resident_plan`), the
largest difference from the chain's output and the number of elements that
differ.  Runs go A, B, C, C, B, A; each time is the mean of both passes.
At each shape the two fused forms are also timed under every block shape of
``linear``'s (rows 128, 64, 32, 16 by columns 32, 64, 96, 128; the
resident form with 1, 2, 4 and all of its column tiles a block, where its
rows fit in shared memory).  Last, per variant, the sum over one swin_tiny
forward's three merges at each batch, and each fused form's sum under the
fastest block shape of each merge.  Needs a CUDA device and ``nvcc``; the
libraries go to ``build/swin_merge_ab/``.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from collections import defaultdict
from pathlib import Path

import torch

from ..ops.cuda import build
from ..ops.cuda import fused_encoder as fe
from ..ops.cuda import swin_merge as sm
from ..ops.cuda.fused_mlp import MAX_SMEM
from .harness import measure_graph_time

# swin_tiny's merges: (C, resolution) of the stage before each
MERGES = ((96, 56), (192, 28), (384, 14))
BATCHES = (1, 8, 32)
EPS = 1e-5
HERE = Path(__file__).resolve().parent
FUSED_SOURCE, RESIDENT_SOURCE = "swin_merge_fused.cu", "swin_merge_resident.cu"
ALL_TILES = tuple((r, c) for r in fe.LINEAR_ROWS for c in fe.LINEAR_COLS)
# The anchors: the block shapes a source compiles, then each floor's parts.
_TILES = re.compile(r"#define EVT_MERGE_TILES\(X\).*?\n\n", re.S)
_STATS = ("  for (int r = r0; r < r0 + BM / WARPS; r += J <= 2 ? 8 : J <= 4 ? 4 : 2) {\n"
          "    if (J <= 2) row_stats<8, 2>(x, stats, m0, r, M, res, C, eps, lane);\n"
          "    else if (J <= 4) row_stats<4, 4>(x, stats, m0, r, M, res, C, eps, lane);\n"
          "    else row_stats<2, 8>(x, stats, m0, r, M, res, C, eps, lane);\n"
          "  }\n")
_NORMALIZE = ("  normalize(sA, 0);\n",
              "    if (kt + 1 < KT) normalize(sA + ((kt + 1) % MERGE_STAGES) * A_STAGE, kt + 1);\n")
_NORMALIZE_ROWS = ("        normalize_rows(sA, lda, r0, M - (m0 + r0), K, sg, sb, affine_f32, eps, "
                   "lane);\n")
_GATHER = "    cp_async16(sA + r * lda + c * 8, ok ? x + ro + co : x, ok);\n"
CHAIN = "chain: swin_merge + linear"
FUSED = "fused"
RESIDENT = "resident"
NO_STATS, NO_NORMALIZE, PRODUCT = ("fused floor: no statistics", "fused floor: no normalization",
                                   "fused floor: gather + product")
R_NO_NORMALIZE, R_PRODUCT = "resident floor: no normalization", "resident floor: gather + product"
# The resident form's plan (resident_plan): where linear's plan takes 64 or
# 128 rows a block, 32 rows by 96 columns; a block takes as many column
# tiles as keep the blocks this many an SM
RESIDENT_WIDE_TILE = (32, 96)
RESIDENT_BLOCKS_PER_SM = 0.7
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def fused_smem_bytes(rows: int, cols: int, c: int) -> int:
    """bench/swin_merge_fused.cu ``merge_smem_bytes``: the ring of 4 x (A
    ``[rows, 72]``, W ``[64, cols + 8]``) bf16, each row's ``(mean, rs)``
    fp32 and the affine ``g``, ``b [4c]`` (room for fp32)."""
    return 4 * (rows * (fe.LINEAR_BK + 8) + fe.LINEAR_BK * (cols + 8)) * 2 + rows * 8 + 32 * c


def resident_smem_bytes(rows: int, cols: int, c: int) -> int:
    """bench/swin_merge_resident.cu ``merge_smem_bytes``: the resident rows
    ``[rows, K + 8]`` bf16 (``K = 4c`` rounded up to whole 64-deep steps),
    the W ring ``[3][64, cols + 8]`` bf16, the int offset tables of the rows
    and of a row's ``K / 8`` chunks, and the affine (room for fp32)."""
    kp = -(-4 * c // fe.LINEAR_BK) * fe.LINEAR_BK
    return (rows * (kp + 8) * 2 + fe.LINEAR_STAGES * fe.LINEAR_BK * (cols + 8) * 2 + rows * 4
            + kp // 8 * 4 + 32 * c)


def fused_plan(m: int, n: int, sms: int) -> tuple[int, int]:
    """The fused form's ``(rows, cols)`` for ``m`` merged rows into ``n``
    columns: 96 columns and the most rows that still give 1.5 blocks an SM;
    where even 16 rows do not, 16 rows and the widest columns that give every
    SM a block (else 32).  At swin_tiny's merges (b1, b8, b32) this is the
    fastest block shape of the sweep or within 4% of it (PERF.md section 6)."""
    def blocks(rows, cols):
        return -(-m // rows) * -(-n // cols)

    for rows in fe.LINEAR_ROWS:
        if blocks(rows, 96) >= 1.5 * sms:
            return rows, 96
    return 16, next((c for c in (64, 32) if blocks(16, c) >= sms), 32)


def resident_plan(m: int, n: int, k: int, sms: int) -> tuple[int, int, int]:
    """The resident form's ``(rows, cols, group)``: ``linear``'s plan where
    that takes 32 or 16 rows a block, else :data:`RESIDENT_WIDE_TILE`, its
    rows halved until a block's rows and ring fit in shared memory; a row
    tile's column tiles in the fewest even groups that still leave
    :data:`RESIDENT_BLOCKS_PER_SM` blocks an SM."""
    rows, cols = fe.linear_plan(m, n, k, sms)
    if rows >= 64:
        rows, cols = RESIDENT_WIDE_TILE
    while rows > fe.LINEAR_ROWS[-1] and resident_smem_bytes(rows, cols, k // 4) > MAX_SMEM:
        rows //= 2
    row_tiles, tiles = -(-m // rows), -(-n // cols)
    group = max(g for g in range(1, tiles + 1)
                if g == 1 or row_tiles * -(-tiles // g) >= RESIDENT_BLOCKS_PER_SM * sms)
    return rows, cols, -(-tiles // -(-tiles // group))  # the same groups, evened


def plans(sms: int) -> dict:
    """``{form: {(rows, cols)}}``: the block shapes each form's plan takes at
    the shapes timed here."""
    out = {FUSED: set(), RESIDENT: set()}
    for batch in BATCHES:
        for c, res in MERGES:
            m = batch * (res // 2) ** 2
            out[FUSED].add(fused_plan(m, 2 * c, sms))
            out[RESIDENT].add(resident_plan(m, 2 * c, 4 * c, sms)[:2])
    return out


def _only(src: str, tiles) -> str:
    line = "".join(f" X({r}, {c})" for r, c in sorted(tiles))
    return _TILES.sub(f"#define EVT_MERGE_TILES(X){line}\n\n", src, count=1)


def variants(fused: str, resident: str, sms: int = 132) -> dict:
    """``{name: (form, source)}``: each fused form at every block shape and
    its floors (whose output is not K10's: what is left out costs the
    difference) at its plan's block shapes."""
    for src, anchors in ((fused, (_STATS, *_NORMALIZE)),
                         (resident, (_NORMALIZE_ROWS, _GATHER))):
        for anchor in anchors:
            if src.count(anchor) != 1:
                raise ValueError(f"a fused form's source no longer holds {anchor!r} once")
        if len(_TILES.findall(src)) != 1:
            raise ValueError("a fused form's source no longer defines EVT_MERGE_TILES once")
    taken = plans(sms)
    f_small, r_small = _only(fused, taken[FUSED]), _only(resident, taken[RESIDENT])
    no_norm = f_small
    for anchor in _NORMALIZE:
        no_norm = no_norm.replace(anchor, "")
    r_no_norm = r_small.replace(_NORMALIZE_ROWS, "        ;\n")
    return {FUSED: (FUSED, fused), NO_STATS: (FUSED, f_small.replace(_STATS, "")),
            NO_NORMALIZE: (FUSED, no_norm), PRODUCT: (FUSED, no_norm.replace(_STATS, "")),
            RESIDENT: (RESIDENT, resident), R_NO_NORMALIZE: (RESIDENT, r_no_norm),
            R_PRODUCT: (RESIDENT, r_no_norm.replace(_GATHER, ""))}


def _fn(lib, name: str, argtypes: list):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def build_libraries(sms: int) -> dict:
    """``{name: (form, entry point)}``: each variant, compiled side by side;
    prints ptxas's registers and spills of each."""
    out_dir = build.BUILD_DIR.parent / "swin_merge_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = variants((HERE / FUSED_SOURCE).read_text(), (HERE / RESIDENT_SOURCE).read_text(), sms)
    jobs = []
    for i, (name, (form, code)) in enumerate(srcs.items()):
        cu, so = out_dir / f"swin_merge_v{i}.cu", out_dir / f"libswin_merge_v{i}.so"
        cu.write_text(code)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
               str(build.CSRC), "-o", str(so), str(cu)]
        jobs.append((name, form, so, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)))
    fns = {}
    for name, form, so, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f"{name}: {err}")
        for line in err.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.split('info    : ')[-1].strip()}")
        lib = ctypes.CDLL(str(so))
        args = [_P] * 6 + [_I, _I, _I, _F, _I, _I, _I] + ([_I] if form == RESIDENT else []) + [_P]
        fns[name] = (form, _fn(lib, f"evt_swin_merge_{form}", args))
    return fns


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def fused_call(form: str, fn, x, g, b, w, res, plan=None):
    """``(run, out)``: a fused form's kernel on ``x`` under ``plan``
    (``(rows, cols)``, and ``group`` for the resident form; default its
    plan's)."""
    c = x.shape[1]
    bsz = x.shape[0] // (res * res)
    m = bsz * (res // 2) ** 2
    out = torch.empty(m, 2 * c, dtype=torch.bfloat16, device=x.device)
    zero = torch.zeros(2 * c, dtype=torch.bfloat16, device=x.device)
    sms = fe._sm_count(x.device.index or 0)
    if plan is None:
        plan = fused_plan(m, 2 * c, sms) if form == FUSED else resident_plan(m, 2 * c, 4 * c, sms)

    def run():
        build.check(fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), w.data_ptr(), zero.data_ptr(),
                       out.data_ptr(), bsz, res, c, EPS, int(g.dtype == torch.float32), *plan,
                       _stream()), f"swin_merge ({form})")

    return run, out


def chain_calls(x, g, b, w, res):
    """``(gather + LayerNorm, reduction, outputs)``: the port's two launches
    on ``x``; the reduction's latest output is ``outputs[-1]``."""
    zero = torch.zeros(2 * x.shape[1], dtype=torch.bfloat16, device=x.device)
    held, outputs = [], []

    def run_ln():
        held[:] = [sm.swin_merge(x, g, b, res=res, eps=EPS)]

    def run_linear():
        outputs[:] = [fe.linear(held[-1], w, zero, epilogue=fe.CAST_THEN_BIAS)]

    return run_ln, run_linear, outputs


def sweep(form: str, fn, x, g, b, w, res, ref) -> list:
    """``[(ms, label)]``, fastest first: a fused form under every block shape
    (and the resident form under 1, 2, 4 and all column tiles a block)."""
    c = x.shape[1]
    out = []
    for rows, cols in ALL_TILES:
        if form == FUSED:
            groups = [()]
        elif resident_smem_bytes(rows, cols, c) > MAX_SMEM:
            continue
        else:
            tiles = -(-2 * c // cols)
            groups = [(gr,) for gr in sorted({1, 2, 4, tiles} & set(range(1, tiles + 1)))]
        for group in groups:
            run, got = fused_call(form, fn, x, g, b, w, res, (rows, cols, *group))
            run()
            torch.cuda.synchronize()
            ms = measure_graph_time(run)["p50_ms"]
            label = f"{rows}x{cols}" + "".join(f"/{gr}" for gr in group)
            out.append((ms, f"{label} {ms * 1e3:.2f}"
                            f"{'' if torch.equal(got, ref) else ' (other bits)'}"))
    return sorted(out)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("swin_merge_ab needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    sms = fe._sm_count(0)
    fns = build_libraries(sms)
    gen = torch.Generator(device="cuda").manual_seed(19)
    forward = defaultdict(lambda: defaultdict(float))  # batch -> variant -> ms
    for batch in BATCHES:
        for c, res in MERGES:
            x = (torch.randn(batch * res * res, c, generator=gen, device="cuda") * 2).bfloat16()
            g = torch.randn(4 * c, generator=gen, device="cuda") * 0.5 + 1
            b = torch.randn(4 * c, generator=gen, device="cuda") * 0.5
            w = (torch.randn(4 * c, 2 * c, generator=gen, device="cuda") * (4 * c) ** -0.5
                 ).bfloat16()
            run_ln, run_linear, chain_out = chain_calls(x, g, b, w, res)
            calls = {CHAIN: (lambda: (run_ln(), run_linear()), None)}
            calls.update({name: fused_call(form, fn, x, g, b, w, res)
                          for name, (form, fn) in fns.items()})
            runs = list(calls)
            times, parts, diffs = defaultdict(float), [0.0, 0.0], {}
            ref = None
            for order in (runs, runs[::-1]):  # A, B, C, C, B, A
                for name in order:
                    run, out = calls[name]
                    run()
                    torch.cuda.synchronize()
                    out = chain_out[-1] if out is None else out
                    if ref is None:
                        ref = out.clone()
                    d = (out.float() - ref.float()).abs()
                    diffs[name] = (float(d.max()), int((d > 0).sum()), d.numel())
                    times[name] += measure_graph_time(run)["p50_ms"] / 2
                    if name == CHAIN:
                        parts[0] += measure_graph_time(run_ln)["p50_ms"] / 2
                        parts[1] += measure_graph_time(run_linear)["p50_ms"] / 2
            tag = f"swin_tiny b{batch:<2d} C{c:<3d} res{res:<2d}"
            for name in runs:
                most, moved, total = diffs[name]
                extra = (f"  (swin_merge {parts[0] * 1e3:.2f} us + linear {parts[1] * 1e3:.2f} us)"
                         if name == CHAIN else "")
                print(f"{tag} {name:36s} {times[name] * 1e3:8.2f} us  max|diff vs chain| "
                      f"{most:.3g}  elements differing {moved} of {total}{extra}")
                forward[batch][name] += times[name]
            m = batch * (res // 2) ** 2
            for form, plan in ((FUSED, fused_plan(m, 2 * c, sms)),
                               (RESIDENT, resident_plan(m, 2 * c, 4 * c, sms))):
                found = sweep(form, fns[form][1], x, g, b, w, res, ref)
                forward[batch][f"{form}, the fastest block shape of each merge"] += found[0][0]
                print(f"{tag} {form} (plan {'x'.join(map(str, plan[:2]))}"
                      f"{''.join(f'/{gr}' for gr in plan[2:])}) under each block shape, fastest "
                      f"first, us: " + ", ".join(label for _, label in found))
    print("one swin_tiny forward's three merges, ms")
    for batch, per in forward.items():
        print(f"  b{batch:<2d} " + ", ".join(f"{name} {ms:.4f}" for name, ms in per.items()))


if __name__ == "__main__":
    main()
