"""What the choices of ``csrc/vit_full.cu`` (the one-launch DeiT forward,
K7a / K7b) cost on the card: the kernel as committed against other plans,
against a variant of its source and against another checkout's kernel, each
a whole forward on the same weights and image.

    python -m edgevisiontransformer_tpu_torch.bench.vit_full_ab [--against DIR]

Plan variants, on the committed library: the plan ``vit_full_plan`` picks;
the same tiles on the other kernel instance (one block an SM with up to
255 registers a thread, or two with at most 128, the grid following);
every GEMM phase on 128 x 96 tiles (one 8-warp group a block: the tile
height the kernel ran at every batch before its small tiles); every GEMM
phase on 16 x 32 tiles (four 2-warp groups a block).  Source variants,
built beside, each on the plan: 128 x 128 tiles (``linear``'s 32 x 64 warp
tile compiled in as a third tile code, taken where ``linear_plan`` takes
128 columns at a 128-row phase: N = 576 and 768 at deit_tiny b128); 4-chunk
strip steps (``STRIP_CHUNKS = 4``: a whole 64-key tile of scores in
registers at once, as ``attention_rows`` does).  Each build prints ptxas's
registers and spills.  With ``--against DIR`` the
``vit_full.cu`` of another checkout's ``csrc`` directory ``DIR``, built
against its own headers, joins them (a kernel whose entry takes no plan runs
its own).  Shapes: deit_tiny at b1 and b128 and deit_base at b1, full depth,
seeded random weights, an fp32 image.  Each line gives the device time of
one forward (``harness.measure_graph_time``: CUDA events around a CUDA graph
of 10 forwards replayed, median of 5 samples), the grid, the largest
difference of its logits from the committed kernel's under its own plan and
the number of logits that differ (grid 0: a kernel that does not report
it).  Runs go A, B, ..., B, A.  Needs a CUDA
device and ``nvcc``; the libraries go to ``build/vit_full_ab/``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import subprocess
from pathlib import Path

import torch

from ..models.registry import build_model
from ..models.vit import prepare_vit_full
from ..ops.cuda import build
from ..ops.cuda import fused_encoder as fe
from ..ops.cuda import fused_vit_full as vf
from .harness import measure_graph_time

SHAPES = (("deit_tiny", 1), ("deit_tiny", 128), ("deit_base", 1))
SOURCE = "vit_full.cu"
COMMITTED = "committed"
WIDE = "128 x 128 tiles"
STRIP4 = "4-chunk strip steps"
# the anchors: the strip's chunks a step, the tile codes, the GEMM dispatch
# and the shared memory of each code
_STRIP = "constexpr int STRIP_CHUNKS = 2;"
_CODES = "constexpr int TILE_CODES = 2;"
_DISPATCH = "  if (tile == 0) gemm_groups<4, 32, 48>("
_SMEM = ("  constexpr int rows[TILE_CODES] = {128, 16}, cols[TILE_CODES] = {96, 32};\n"
         "  constexpr int groups[TILE_CODES] = {1, 4};\n")
WIDE_CODE = 2  # the third tile code of the WIDE variant: 128 x 128


def variants(src: str) -> dict:
    """``{name: source of vit_full.cu}`` for each variant of ``src``."""
    for anchor in (_STRIP, _CODES, _DISPATCH, _SMEM):
        if src.count(anchor) != 1:
            raise ValueError(f"csrc/{SOURCE} no longer holds {anchor!r} once")
    wide = src.replace(_CODES, _CODES.replace("2", "3"))
    wide = wide.replace(_DISPATCH, "  if (tile == 2) gemm_groups<4, 32, 64>(smem, a, W, bias, res, "
                                   "Y, M, N, K, epi, res_rows);\n  else" + _DISPATCH[1:])
    wide = wide.replace(_SMEM, _SMEM.replace("{128, 16}", "{128, 16, 128}")
                        .replace("{96, 32}", "{96, 32, 128}").replace("{1, 4}", "{1, 4, 1}"))
    return {COMMITTED: src, WIDE: wide, STRIP4: src.replace(_STRIP, _STRIP.replace("2", "4"))}


def wide_plan(plan: vf.VitFullPlan, shapes: tuple, sms: int) -> vf.VitFullPlan:
    """``plan`` with the WIDE variant's 128 x 128 tiles where a phase takes
    128-row tiles and ``linear_plan`` 128 columns."""
    tiles = tuple(WIDE_CODE if code == 0 and fe.linear_plan(m, n, 0, sms)[1] == 128 else code
                  for code, (m, n) in zip(plan.tiles, shapes))
    return dataclasses.replace(plan, tiles=tiles)


def plans(batch: int, tokens: int, dim: int, heads: int, head_dim: int, mlp: int,
          classes: int, sms: int) -> dict:
    """``{name: VitFullPlan}``: the committed plan, its tiles on the other
    instance, then every GEMM phase on 128-row and on 16-row tiles."""
    args = (batch, tokens, dim, heads, head_dim, mlp, classes, sms)
    plan = vf.vit_full_plan(*args)
    other = 3 - plan.blocks
    return {"plan": plan,
            f"{('one', 'two')[other - 1]} blocks/SM": vf.vit_full_plan(*args, blocks=other),
            "128-row tiles": vf.vit_full_plan(*args, rows=128),
            "16 x 32 tiles": vf.vit_full_plan(*args, rows=16)}


def build_libraries(against: Path | None = None) -> dict:
    """``{name: evt_vit_full}``: each source variant and, if given, the
    kernel of ``against``, compiled side by side."""
    out_dir = build.BUILD_DIR.parent / "vit_full_ab"
    srcs = {name: (code, build.CSRC)
            for name, code in variants((build.CSRC / SOURCE).read_text()).items()}
    if against is not None:
        srcs[str(against)] = ((against / SOURCE).read_text(), against)
    jobs, libs = [], {}
    for i, (name, (code, include)) in enumerate(srcs.items()):
        vdir = out_dir / f"v{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / SOURCE).write_text(code)
        so = vdir / f"libvit_full_v{i}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
               str(include), "-o", str(so), str(vdir / SOURCE)]
        jobs.append((name, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)))
        libs[name] = so
    for name, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f"{name}: {err}")
        for line in err.splitlines():  # each vit_full instance's registers and spills
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.split('info    : ')[-1].strip()}")
    fns = {}
    for name, so in libs.items():
        fn = ctypes.CDLL(str(so)).evt_vit_full
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4
        fns[name] = fn
    return fns


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="another checkout's csrc directory, whose vit_full.cu joins")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("vit_full_ab needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fns = build_libraries(args.against)
    models = {}
    for name, batch in SHAPES:
        if name not in models:
            model, shape = build_model(name, dtype=torch.bfloat16, device="cuda",
                                       generator=torch.Generator().manual_seed(0))
            with torch.no_grad():
                models[name] = (model, shape, prepare_vit_full(model))
        model, shape, prep = models[name]
        cfg = model.config
        img = torch.randn(batch, *shape, generator=torch.Generator().manual_seed(1)).cuda()
        kw = dict(heads=cfg.heads, head_dim=cfg.resolved_head_dim, eps=cfg.layernorm_eps,
                  reference_residual=cfg.reference_residual, approx_gelu=cfg.gelu_approx,
                  final_norm=cfg.final_norm)
        tokens = (shape[1] // cfg.patch_size) ** 2 + 1
        runs = [(COMMITTED, pname, p) for pname, p in plans(
            batch, tokens, cfg.dim, cfg.heads, cfg.resolved_head_dim, cfg.mlp_dim,
            cfg.num_classes, sms).items()]
        plan = runs[0][2]
        shapes = vf.gemm_shapes(batch, tokens, cfg.dim, cfg.heads, cfg.resolved_head_dim,
                                cfg.mlp_dim)
        runs += [(src, "plan", wide_plan(plan, shapes, sms) if src == WIDE else plan)
                 for src in fns if src != COMMITTED]
        print(f"{name} b{batch}: plan {dataclasses.asdict(runs[0][2])}")
        ref = None
        for order in (runs, runs[::-1]):  # A, B, ..., B, A
            for src, pname, plan in order:
                out = {}

                def forward():
                    out["logits"], out["grid"] = vf.launch(fns[src], img, prep, plan=plan, **kw)

                with torch.no_grad():
                    ms = measure_graph_time(forward, iters=10, repeats=5)["p50_ms"]
                    forward()
                torch.cuda.synchronize()
                logits = out["logits"]
                ref = logits.clone() if ref is None else ref
                diff = (logits.float() - ref.float()).abs()
                tiles = "/".join("128x128" if c == WIDE_CODE else
                                 f"{vf.VIT_FULL_TILES[c][0]}x{vf.VIT_FULL_TILES[c][1]}"
                                 for c in plan.tiles)
                print(f"{name} b{batch:<4d} {src[-32:]:32s} {pname:15s} {tiles:34s} "
                      f"blocks/SM {plan.blocks} grid {out['grid']:4d} {ms:9.4f} ms  "
                      f"max|diff vs committed| {float(diff.max()):.3g}  logits differing "
                      f"{int((diff > 0).sum())} of {diff.numel()}")
        del img


if __name__ == "__main__":
    main()
