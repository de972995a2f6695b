"""The arithmetic of ``csrc/linear.cu`` (the GEMM of K1, K2, K9 and K10 on
the card), emulated in a few lines of PyTorch on the CPU and held against
the JAX K1 lines it replaces (``ops/pallas/fused_encoder.py:202-243``,
``jax.lax.dot(..., preferred_element_type=jnp.float32)`` with their cast
points, run by JAX on the CPU) and against the port's twin
``linear_plain``.

The emulation follows the kernel: K zero-padded to whole 64-element steps
and summed in k16 steps, in order, into one fp32 accumulator (never split),
then the epilogue on that fp32 sum at the reference's cast points.  The
plan that picks the kernel's grid (``fused_encoder.linear_plan``), the
mirror of its shared memory and the block shapes it is compiled for are
checked here too; ``tests/test_torch_kernels_cuda.py`` holds the kernel
itself to the twin on the card.

Inputs come from a numpy seed.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from edgevisiontransformer_tpu.ops.pallas import mathlib as jmath
from edgevisiontransformer_tpu_torch.bench import linear_ab
from edgevisiontransformer_tpu_torch.ops.cuda import build
from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as tfe
from edgevisiontransformer_tpu_torch.ops.cuda import fused_mlp as tfm
from edgevisiontransformer_tpu_torch.ops.cuda.mathlib import gelu_kernel

torch.set_num_threads(1)

# fp32: the bound the JAX package's kernel tests use (1e-5; fp32 sums of up
# to 768 terms in another order); bf16: the kernel tolerance of PERF.md
# section 2 (an fp32-order difference, or erff / tanhf against JAX's erf_poly
# and bf16 tanh GELU, can move a value across a bf16 rounding boundary)
FP32 = dict(rtol=1e-5, atol=1e-5)
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 1e-2
H100_SMS = 132
# csrc/linear.cu epilogue codes as (epilogue, approx_gelu)
EPILOGUES = {0: (tfe.CAST_THEN_BIAS, False), 1: (tfe.CAST_THEN_BIAS_GELU, True),
             2: (tfe.CAST_THEN_BIAS_GELU, False), 3: (tfe.BIAS_RESIDUAL, False)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def kernel_tiles(x, w, b, res, code):
    """``linear`` as csrc/linear.cu computes it, for epilogue ``code``."""
    dt, k = x.dtype, x.shape[1]
    pad = -k % tfe.LINEAR_BK
    xf, wf = F.pad(x.float(), (0, pad)), F.pad(w.float(), (0, 0, 0, pad))
    acc = torch.zeros(x.shape[0], w.shape[1])
    for k0 in range(0, k + pad, 16):  # one accumulator, k16 steps in order
        acc = acc + xf[:, k0:k0 + 16] @ wf[k0:k0 + 16]
    if code == 3:
        return (acc + b.float() + res.float()).to(dt)
    v = (acc.to(dt).float() + b.float()).to(dt)
    return gelu_kernel(v, code == 1) if code in (1, 2) else v


def jax_k1(x, w, b, res, code, dt):
    """K1's lines for the matmul whose epilogue is ``code``, verbatim."""
    acc = jax.lax.dot(x, w, preferred_element_type=jnp.float32)
    if code == 3:
        return (acc + b.astype(jnp.float32) + res.astype(jnp.float32)).astype(dt)
    y = acc.astype(dt) + b
    return jmath.gelu_kernel(y, code == 1).astype(dt) if code in (1, 2) else y


@functools.lru_cache(maxsize=None)
def _inputs(m, k, n, dtype):
    """(JAX operands, torch operands) in ``dtype``: the same values on both
    sides (bf16 made once by JAX and handed to torch exactly)."""
    rng = np.random.default_rng(m * 7 + k * 31 + n)
    arrays = (rng.standard_normal((m, k)).astype(np.float32),
              (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32),
              (rng.standard_normal(n) * 0.5).astype(np.float32),
              rng.standard_normal((m, n)).astype(np.float32))
    jd, td = DTYPES[dtype]
    jax_side = tuple(jnp.asarray(a).astype(jd) for a in arrays)
    return jax_side, tuple(torch.from_numpy(np.array(a.astype(jnp.float32))).to(td)
                           for a in jax_side)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close_bf16(got, ref):
    got, ref = _np(got), _np(ref)
    assert np.isfinite(got).all()
    err = np.abs(got - ref)
    assert (err <= BF16_ATOL + BF16_RTOL * np.abs(ref)).all(), err.max()


@pytest.mark.parametrize("code", sorted(EPILOGUES))
@pytest.mark.parametrize("k,n", [(64, 96), (192, 576), (230, 64), (768, 192)])
@pytest.mark.parametrize("m", [1, 197])
def test_kernel_tiles_match_jax_k1_and_the_twin(m, k, n, code):
    epilogue, approx = EPILOGUES[code]
    for dtype in DTYPES:
        (jx, jw, jb, jr), (x, w, b, r) = _inputs(m, k, n, dtype)
        res = r if code == 3 else None
        got = kernel_tiles(x, w, b, res, code)
        ref = jax_k1(jx, jw, jb, jr if code == 3 else None, code, DTYPES[dtype][0])
        twin = tfe.linear_plain(x, w, b, epilogue=epilogue, res=res, approx_gelu=approx)
        assert got.shape == (m, n) and got.dtype == x.dtype
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), _np(ref), **FP32)
            np.testing.assert_allclose(_np(got), _np(twin), **FP32)
        else:
            _close_bf16(got, ref)
            _close_bf16(got, twin)


def tiles(m, n, plan):
    """The output elements each block of the plan's grid writes (csrc/linear.cu:
    grid (column tiles, row tiles), block (x, y) at rows y * rows, columns
    x * cols, masked at M and N)."""
    rows, cols = plan
    return [(range(y * rows, min((y + 1) * rows, m)), range(x * cols, min((x + 1) * cols, n)))
            for y in range(-(-m // rows)) for x in range(-(-n // cols))]


@pytest.mark.parametrize("m,n,k", [(197, 576, 192), (197, 192, 192), (197, 768, 192),
                                   (197, 192, 768), (25216, 576, 192), (25216, 768, 192),
                                   (25216, 192, 768), (100352, 288, 96), (3136, 96, 96),
                                   (49, 2304, 768), (197, 230, 192), (197, 537, 192),
                                   (1576, 3072, 768), (1, 8, 8), (5, 7, 13)])
def test_linear_plan_covers_every_element_once_within_the_kernel_limits(m, n, k):
    plan = tfe.linear_plan(m, n, k, H100_SMS)
    rows, cols = plan
    assert rows in tfe.LINEAR_ROWS and cols in tfe.LINEAR_COLS and cols % 32 == 0
    assert tfe._linear_smem_bytes(rows, cols) <= tfm.MAX_SMEM
    # never splits K: a (rows, cols) pair whatever k is, so every block walks all of it
    assert tfe.linear_plan(m, n, 1, H100_SMS) == plan == tfe.linear_plan(m, n, 4 * k, H100_SMS)
    covered = np.zeros((min(m, 400), n), dtype=np.int64)  # the first rows suffice
    for rs, cs in tiles(min(m, 400), n, plan):
        covered[rs.start:rs.stop, cs.start:cs.stop] += 1
    assert (covered == 1).all()
    blocks = -(-m // rows) * -(-n // cols)
    assert blocks >= H100_SMS or (rows, cols) == (tfe.LINEAR_ROWS[-1], tfe.LINEAR_COLS[0])
    ntiles = -(-n // tfe.LINEAR_COLS[-1])  # the fewest column tiles of at most 128
    base = min(c for c in tfe.LINEAR_COLS if c * ntiles >= n)
    if -(-m // 128) * ntiles >= H100_SMS:  # serving batches: the widest even tiles
        assert plan == (128, base)
    else:  # columns narrow first, then rows
        assert cols < base or rows == 128 or cols == tfe.LINEAR_COLS[0]


@pytest.mark.parametrize("n,want", [(192, (128, 96)), (576, (128, 128)), (768, (128, 128)),
                                    (96, (128, 96)), (230, (128, 128)), (3072, (128, 128)),
                                    (288, (128, 96))])
def test_linear_plan_takes_the_fewest_even_column_tiles_at_serving_batches(n, want):
    assert tfe.linear_plan(128 * 197, n, 192, H100_SMS) == want


@pytest.mark.parametrize("n", [192, 576, 768])
def test_linear_plan_fills_the_card_at_b1(n):
    rows, cols = tfe.linear_plan(197, n, 192, H100_SMS)
    blocks = -(-197 // rows) * -(-n // cols)
    assert 2 * blocks >= H100_SMS  # at least half the SMs
    assert blocks >= H100_SMS or (rows, cols) == (16, 32)  # all, where 16 x 32 blocks can


def test_linear_plan_narrows_columns_before_rows():
    """Swin stage 0 at b1 keeps 128 rows at 32 columns (25 x 9 blocks); a
    deit_tiny b1 GEMM narrows the columns to 32 before the rows; a card of
    fewer SMs needs fewer blocks."""
    assert tfe.linear_plan(3136, 288, 96, H100_SMS) == (128, 32)
    assert tfe.linear_plan(197, 576, 192, H100_SMS) == (16, 32)
    assert tfe.linear_plan(197, 768, 192, H100_SMS) == (32, 32)
    assert tfe.linear_plan(197, 576, 192, 24) == (128, 32)


def test_linear_smem_bytes_mirrors_the_kernel_layout():
    """csrc/linear_tile.cuh ``smem_bytes``: 3 stages of A [rows, 72] and W
    [64, cols + 8], worked by hand at the serving tiles and the smallest."""
    assert tfe._linear_smem_bytes(128, 128) == 3 * (128 * 72 + 64 * 136) * 2 == 107520
    assert tfe._linear_smem_bytes(128, 96) == 3 * (128 * 72 + 64 * 104) * 2 == 95232
    assert tfe._linear_smem_bytes(16, 32) == 3 * (16 * 72 + 64 * 40) * 2
    assert max(tfe._linear_smem_bytes(r, c) for r in tfe.LINEAR_ROWS
               for c in tfe.LINEAR_COLS) <= tfm.MAX_SMEM


def test_the_kernel_is_compiled_for_every_block_shape_of_the_plan():
    """The rows and column widths evt_linear dispatches on, read from the
    committed sources, are the ones linear_plan may return."""
    entry = (build.CSRC / "linear.cu").read_text()
    tile = (build.CSRC / "linear_tile.cuh").read_text()
    rows = tuple(int(r) for r in re.findall(r"case (\d+): return linear_rows\1\(", entry))
    cols = tuple(int(c) for c in re.findall(r"EVT_LINEAR_COLS\((\d+)\)\n", tile))
    assert rows == tfe.LINEAR_ROWS and cols == tfe.LINEAR_COLS
    for r in rows:  # each row count compiled in its own source
        src = entry if r == rows[0] else (build.CSRC / f"linear_rows{r}.cu").read_text()
        assert re.search(rf"int linear_rows{r}\(EVT_LINEAR_ARGS\) {{\n  return launch_cols<", src)
    assert f"BK = {tfe.LINEAR_BK}, STAGES = {tfe.LINEAR_STAGES};" in tile


def test_linear_ab_finds_its_anchors_in_the_committed_source():
    src = (build.CSRC / linear_ab.TILE).read_text()
    found = linear_ab.variants(src)
    assert list(found) == ["committed", "no epilogue", "2 stages", "4 stages", "bf16x2 stores"]
    assert found["committed"] == src
    assert all(v != src for k, v in found.items() if k != "committed")
    assert "patch + r * PLD + c) = pack_bf16x2" not in found["bf16x2 stores"]
    assert set(linear_ab.SOURCES) == {p.name for p in build.CSRC.glob("linear*.cu")
                                      if p.name != "linear_i8.cu"}
    plans = linear_ab.plans(197, 576, 192, H100_SMS)
    assert plans["plan"] == tfe.linear_plan(197, 576, 192, H100_SMS)
    every = [(r, c) for r in tfe.LINEAR_ROWS for c in tfe.LINEAR_COLS]
    assert sorted(plans.values()) == sorted(every)
