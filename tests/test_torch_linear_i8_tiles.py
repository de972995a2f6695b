"""The arithmetic of ``csrc/linear_i8.cu`` (the int8 GEMM of K4, K5 and K9's
int8 mode on the card), emulated on the CPU and held against the JAX
helpers it replaces (``ops/pallas/fused_encoder.py`` ``_int8_mm``,
``_int8_mm_static`` and ``_int8_mm_buf`` with K4's epilogue lines, run in a
Pallas kernel in interpret mode as the JAX package's own tests run them)
and against the port's twin ``linear_i8_plain``.

The emulation follows the kernel down to the bytes: the shared-memory
tiles at their strides, ``ldmatrix`` (plain for Q, ``.trans`` of int8 pairs
for the k-major W tile, at the rows ``frag_b_row`` picks per lane), the
byte permutes of ``frag_b``, ``mma.sync.m16n8k32`` from its register
fragments, k32 steps in 128-byte K steps (a step wholly past K skipped),
and the epilogue's reading of its four consecutive columns; then the
dequant and epilogues in fp32 in the kernel's order.  The plan that picks
the kernel's grid (``fused_encoder.linear_i8_plan``), the mirror of its
shared memory, the block shapes it is compiled for and the anchors of
``bench/linear_i8_ab.py`` are checked here too;
``tests/test_torch_kernels_cuda.py`` holds the kernel itself to the twin and
to the WMMA kernel it replaced on the card.

Inputs come from a numpy seed.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from edgevisiontransformer_tpu.ops.pallas import fused_encoder as jfe
from edgevisiontransformer_tpu.ops.pallas import mathlib as jmath
from edgevisiontransformer_tpu_torch.bench import linear_i8_ab
from edgevisiontransformer_tpu_torch.ops.cuda import build
from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as tfe
from edgevisiontransformer_tpu_torch.ops.cuda import fused_mlp as tfm
from edgevisiontransformer_tpu_torch.ops.cuda.mathlib import gelu_kernel

torch.set_num_threads(1)

# the kernel tolerance of PERF.md section 2 for the GELU epilogues (erff /
# tanhf against JAX's erf_poly and tanh can move a value across a bf16
# rounding boundary); the other epilogues are compared bit for bit in bf16,
# the kernel's output type.  In fp32, JAX's CPU backend contracts the
# dequant's product and the bias add into one fused multiply-add, which the
# kernel's __fmul_rn / __fadd_rn (and the twin) do not: one rounding fewer,
# so after each addition the two may sit up to two fp32 spacings of the
# terms summed (|deq| + |b| + |res|) apart, whatever the cancellation in
# the result.
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 1e-2
FP32_ROUNDING = 2.0 ** -22
H100_SMS = 132
BK, AS = tfe.LINEAR_I8_BK, tfe.LINEAR_I8_BK + 16
# csrc/linear_i8.cu epilogue codes as (epilogue, approx_gelu)
EPILOGUES = {0: (tfe.BIAS, False), 1: (tfe.BIAS_GELU, True), 2: (tfe.BIAS_GELU, False),
             3: (tfe.BIAS_RESIDUAL, False)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


# ---------------------------------------------------------------------------
# The warp tile, byte by byte
# ---------------------------------------------------------------------------


def frag_b_row(lane: int) -> int:
    """csrc/linear_i8_tile.cuh ``frag_b_row``, as written there."""
    r, mat = lane & 7, lane >> 3
    return (mat >> 1) * 16 + ((((r & 6) << 1) | (r & 1)) ^ ((((r >> 2) ^ mat) & 1) << 1))


def sel(lane: int) -> int:
    return 0x6420 if (lane & 3) < 2 else 0x2064


def ldmatrix_x4(smem: np.ndarray, addrs, trans: bool) -> np.ndarray:
    """``ldmatrix.sync.aligned.m8n8.x4[.trans].shared.b16``: lanes 8j..8j+7
    give the row addresses of matrix j; lane l receives, of matrix j, row
    l // 4, b16 elements 2 (l % 4) and 2 (l % 4) + 1 (plain), or rows 2 (l %
    4) and 2 (l % 4) + 1 of column l // 4 (trans), low half first."""
    regs = np.zeros((32, 4), dtype=np.uint32)
    for j in range(4):
        rows = np.stack([smem[a:a + 16] for a in addrs[8 * j:8 * j + 8]])
        m = rows.view(np.uint16).astype(np.uint32)  # [8, 8] b16, little-endian pairs
        if trans:
            m = m.T
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            regs[lane, j] = m[g, 2 * t] | (m[g, 2 * t + 1] << 16)
    return regs


def byte_perm(x: int, y: int, s: int) -> int:
    """``__byte_perm(x, y, s)``: byte i of the result is byte ``s >> 4i & 7``
    of the eight bytes of y:x."""
    src = int(x) | (int(y) << 32)
    return sum(((src >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def _bytes(reg: int) -> np.ndarray:
    return np.array([int(reg) >> (8 * i) & 0xFF for i in range(4)], dtype=np.uint8).view(np.int8)


def mma_s8(c: np.ndarray, a: np.ndarray, b0, b1) -> np.ndarray:
    """``mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`` on the warp's
    fragments (a [32, 4], b0 / b1 [32], c [32, 4])."""
    A, B = np.zeros((16, 32), np.int64), np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        A[g, 4 * t:4 * t + 4] = _bytes(a[lane, 0])
        A[g + 8, 4 * t:4 * t + 4] = _bytes(a[lane, 1])
        A[g, 16 + 4 * t:20 + 4 * t] = _bytes(a[lane, 2])
        A[g + 8, 16 + 4 * t:20 + 4 * t] = _bytes(a[lane, 3])
        B[4 * t:4 * t + 4, g] = _bytes(b0[lane])
        B[16 + 4 * t:20 + 4 * t, g] = _bytes(b1[lane])
    C = A @ B
    out = c.copy()
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        out[lane] += [C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], C[g + 8, 2 * t + 1]]
    return out


def warp_tile(q: np.ndarray, w: np.ndarray, fm: int, tn: int, bn: int):
    """One warp's [16 fm, tn] int32 tile of ``q @ w`` as the kernel computes
    it (its columns first in the block, so at column 0 of a [BK, bn + 16]
    W stage), laid out by ``store_tile``'s reading of the accumulators; with
    every ldmatrix address it used."""
    tm, k = 16 * fm, q.shape[1]
    bs = bn + 16
    acc = np.zeros((fm, tn // 8, 32, 4), dtype=np.int64)
    addrs_seen = []
    for k0 in range(0, k, BK):
        sa = np.zeros(tm * AS, dtype=np.int8)
        sb = np.zeros(BK * bs, dtype=np.int8)
        kq = q[:, k0:k0 + BK]
        for r in range(tm):  # zero-filled past K, as cp.async / load_masked write it
            sa[r * AS:r * AS + kq.shape[1]] = kq[r]
        for r in range(min(BK, k - k0)):
            sb[r * bs:r * bs + tn] = w[k0 + r]
        sa8, sb8 = sa.view(np.uint8), sb.view(np.uint8)
        for kk in range(0, BK, 32):
            if k0 + kk >= k:  # the kernel's break
                break
            a = []
            for i in range(fm):
                ad = [(i * 16 + (ln & 15)) * AS + kk + (ln >> 4) * 16 for ln in range(32)]
                addrs_seen.append(("A", AS, ad))
                a.append(ldmatrix_x4(sa8, ad, trans=False))
            for p in range(tn // 16):
                ad = [(kk + frag_b_row(ln)) * bs + p * 16 for ln in range(32)]
                addrs_seen.append(("B", bs, ad))
                r = ldmatrix_x4(sb8, ad, trans=True)
                b = np.zeros((4, 32), dtype=np.uint32)
                for ln in range(32):
                    s = sel(ln)
                    b[:, ln] = [byte_perm(r[ln, 0], r[ln, 1], s), byte_perm(r[ln, 2], r[ln, 3], s),
                                byte_perm(r[ln, 0], r[ln, 1], s + 0x1111),
                                byte_perm(r[ln, 2], r[ln, 3], s + 0x1111)]
                for i in range(fm):
                    acc[i, 2 * p] = mma_s8(acc[i, 2 * p], a[i], b[0], b[1])
                    acc[i, 2 * p + 1] = mma_s8(acc[i, 2 * p + 1], a[i], b[2], b[3])
    out = np.full((tm, tn), -(2 ** 40), dtype=np.int64)
    for i in range(fm):
        for p in range(tn // 16):
            for ln in range(32):
                g, t = ln >> 2, ln & 3
                for h in range(2):
                    vals = [acc[i, 2 * p, ln, 2 * h], acc[i, 2 * p + 1, ln, 2 * h],
                            acc[i, 2 * p, ln, 2 * h + 1], acc[i, 2 * p + 1, ln, 2 * h + 1]]
                    out[i * 16 + g + 8 * h, p * 16 + 4 * t:p * 16 + 4 * t + 4] = vals
    return out, addrs_seen


@pytest.mark.parametrize("fm,tn,bn,k", [(1, 16, 32, 32), (2, 16, 32, 192), (1, 32, 64, 230),
                                        (2, 48, 96, 128), (1, 64, 128, 300)])
def test_warp_tile_fragments_give_the_exact_product(fm, tn, bn, k):
    """The fragments, the in-register transpose and the column order of the
    epilogue give every element of the warp's tile its exact int32 sum, at
    K a whole k32 step, 1.5 K steps (192) and ragged (230, 300)."""
    rng = np.random.default_rng(fm * 1000 + tn * 10 + k)
    q = rng.integers(-127, 128, (16 * fm, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, tn)).astype(np.int8)
    got, _ = warp_tile(q, w, fm, tn, bn)
    np.testing.assert_array_equal(got, q.astype(np.int64) @ w.astype(np.int64))


def test_frag_b_rows_gather_four_consecutive_k_per_thread():
    """Matrix 0 holds k {0, 1, 4, 5, 10, 11, 14, 15}, matrix 1 the rest; thread
    t receives rows 2t and 2t + 1 of each, so the two matrices give it k
    4t..4t+3, the lower pair in matrix 0 for t < 2 (the permute selector)."""
    rows = [frag_b_row(ln) for ln in range(32)]
    assert rows[:8] == [0, 1, 4, 5, 10, 11, 14, 15]
    assert rows[8:16] == [2, 3, 6, 7, 8, 9, 12, 13]
    assert rows[16:] == [r + 16 for r in rows[:16]]
    for t in range(4):
        got = {rows[2 * t], rows[2 * t + 1], rows[8 + 2 * t], rows[9 + 2 * t]}
        assert got == set(range(4 * t, 4 * t + 4))
        assert (rows[2 * t] == 4 * t) == (t < 2)


@pytest.mark.parametrize("bn", tfe.LINEAR_I8_COLS)
def test_ldmatrix_addressing_is_free_of_bank_conflicts(bn):
    """Each matrix's eight 16-byte rows fall in eight distinct 16-byte bank
    groups (address / 16 mod 8), for Q's 144-byte rows and for every W stage
    width, at every k32 step and column pair of a warp."""
    fm, tn = 2, bn // 2
    q = np.zeros((16 * fm, 2 * BK), dtype=np.int8)
    w = np.zeros((2 * BK, tn), dtype=np.int8)
    _, seen = warp_tile(q, w, fm, tn, bn)
    assert {s for kind, s, _ in seen} == {AS, bn + 16}
    for kind, stride, addrs in seen:
        assert stride % 16 == 0 and (stride // 16) % 2 == 1
        for j in range(4):
            groups = {(a // 16) % 8 for a in addrs[8 * j:8 * j + 8]}
            assert len(groups) == 8, (kind, stride, j)
            assert all(a % 16 == 0 for a in addrs[8 * j:8 * j + 8])


def test_the_emulation_reads_the_committed_source():
    """The formulas emulated here are the ones in csrc/linear_i8_tile.cuh."""
    tile = (build.CSRC / "linear_i8_tile.cuh").read_text()
    assert ("return (mat >> 1) * 16 + ((((r & 6) << 1) | (r & 1)) ^ "
            "((((r >> 2) ^ mat) & 1) << 1));") in tile
    assert "const uint32_t sel = (lane & 3) < 2 ? 0x6420u : 0x2064u;" in tile
    assert "ldsm_x4(a[i], ta + (i * 16 + (lane & 15)) * AS + kk + (lane >> 4) * 16);" in tile
    assert "frag_b(b, tb + (kk + brow) * BS + p * 16, sel);" in tile
    assert "if (kt * BK + kk >= K) break;" in tile
    assert "mma_s8(acc[i][2 * p], a[i], b[0], b[1]);" in tile
    assert "mma_s8(acc[i][2 * p + 1], a[i], b[2], b[3]);" in tile
    assert ("const int a[4] = {acc[i][2 * p][2 * h], acc[i][2 * p + 1][2 * h],\n"
            "                          acc[i][2 * p][2 * h + 1], acc[i][2 * p + 1][2 * h + 1]};"
            ) in tile
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in (
        build.CSRC / "mma_tiles.cuh").read_text()


# ---------------------------------------------------------------------------
# The dequant and epilogues, against JAX and the twin
# ---------------------------------------------------------------------------


def kernel_epilogue(acc, s_row, w_s, b, res, code, out_dtype):
    """The kernel's ``epilogue<EPI>`` on exact int32 sums ``acc``, in fp32 in
    its order: f32(acc), (acc * sr) * ws or acc * ws, + b, then + res, or
    GELU of the bf16-rounded value."""
    accf = acc.float()  # int -> fp32, round to nearest
    deq = (accf * s_row[:, None]) * w_s if s_row is not None else accf * w_s
    v = deq + b.float()
    if code == 3:
        return (v + res.float()).to(out_dtype)
    if code in (1, 2):
        return gelu_kernel(v.to(out_dtype), code == 1)
    return v.to(out_dtype)


def _jax_int8_layer_mm(kind, h, wq, ws, b, res, code, dt, inv_a):
    """One int8 matmul of K4 / K5 with its epilogue lines (fused_encoder.py
    :926-951), in a Pallas kernel in interpret mode; ``kind`` picks the
    helper: ``_int8_mm`` (refs), ``_int8_mm_buf`` (values) or
    ``_int8_mm_static``."""
    m, n = h.shape[0], wq.shape[1]

    def kern(h_ref, wq_ref, ws_ref, b_ref, res_ref, inv_ref, o_ref):
        if kind == "_int8_mm":
            mm = jfe._int8_mm(h_ref[:], wq_ref, ws_ref)
        elif kind == "_int8_mm_buf":
            mm = jfe._int8_mm_buf(h_ref[:], wq_ref[0], ws_ref[0])
        else:
            mm = jfe._int8_mm_static(h_ref[:], wq_ref[0], ws_ref[0], inv_ref[0, 0])
        y = mm + b_ref[0].astype(jnp.float32)
        if code == 3:
            o_ref[:] = (y + res_ref[:].astype(jnp.float32)).astype(dt)
        elif code in (1, 2):
            o_ref[:] = jmath.gelu_kernel(y.astype(dt), code == 1).astype(dt)
        else:
            o_ref[:] = y.astype(dt)

    return pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct((m, n), dt), interpret=True)(
        h, wq[None], ws[None], b[None], res, jnp.full((1, 1), inv_a, jnp.float32))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _compare(got, ref, code, dtype, terms):
    got, ref = _np(got), _np(ref)
    assert np.isfinite(got).all() and got.shape == ref.shape
    err = np.abs(got - ref)
    if code in (1, 2):
        assert (err <= BF16_ATOL + BF16_RTOL * np.abs(ref)).all(), err.max()
    elif dtype == "float32":
        additions = 2 if code == 3 else 1
        assert (err <= additions * FP32_ROUNDING * terms.numpy()).all(), err.max()
    else:
        np.testing.assert_array_equal(got, ref)


@functools.lru_cache(maxsize=None)
def _layer_inputs(m, k, n, dtype):
    """h (activations that quantize to every int8 bucket), int8 weights,
    per-column scales, an fp32 bias, a residual; numpy, then both sides."""
    rng = np.random.default_rng(m * 7 + k * 31 + n)
    h = (rng.standard_normal((m, k)) * rng.uniform(0.5, 4.0, (m, 1))).astype(np.float32)
    h[min(1, m - 1)] = 0.0  # absmax 0: s = 1
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    ws = (rng.uniform(0.5, 1.5, (1, n)) / (127.0 * k ** 0.5)).astype(np.float32)
    b = (rng.standard_normal((1, n)) * 0.5).astype(np.float32)
    res = rng.standard_normal((m, n)).astype(np.float32)
    jd, td = DTYPES[dtype]
    h_j, res_j = jnp.asarray(h).astype(jd), jnp.asarray(res).astype(jd)
    torch_side = (torch.from_numpy(np.array(h_j.astype(jnp.float32))).to(td),
                  torch.from_numpy(wq), torch.from_numpy(ws[0]), torch.from_numpy(b[0]),
                  torch.from_numpy(np.array(res_j.astype(jnp.float32))).to(td))
    return (h_j, jnp.asarray(wq), jnp.asarray(ws), jnp.asarray(b), res_j), torch_side


@pytest.mark.parametrize("kind", ["_int8_mm", "_int8_mm_buf", "_int8_mm_static"])
@pytest.mark.parametrize("code", sorted(EPILOGUES))
@pytest.mark.parametrize("m,k,n", [(37, 64, 48), (20, 230, 96), (9, 192, 230)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_arithmetic_matches_jax_int8_helpers_and_the_twin(m, k, n, code, kind, dtype):
    """Quantize as JAX does (``quant_rows_plain``, bit for bit with
    ``_quant_rows_kernel`` and ``_int8_mm_static``'s quantization), take the
    warp tiles' exact sums, finish with the kernel's epilogue: the non-GELU
    epilogues equal JAX's lines bit for bit in bf16 (in fp32 within JAX's
    fused multiply-add), GELU within the kernel tolerance of JAX; every
    epilogue equals the twin bit for bit (the GELU ones round the same value,
    then run torch's GELU)."""
    (jh, jwq, jws, jb, jres), (h, wq, ws, b, res) = _layer_inputs(m, k, n, dtype)
    jd, td = DTYPES[dtype]
    static = kind == "_int8_mm_static"
    inv_a = 127.0 / 6.0  # clips the largest rows, as a calibrated scale does
    q, s_row = tfe.quant_rows_plain(h, torch.tensor([[inv_a]]) if static else None, 0)
    tile = np.zeros((m, n), dtype=np.int64)
    for r0 in range(0, m, 16):  # 16-row warp tiles across 48-column blocks
        for c0 in range(0, n, 48):
            qt = np.zeros((16, k), np.int8)
            wt = np.zeros((k, 48), np.int8)
            qt[:min(16, m - r0)] = q.numpy()[r0:r0 + 16]
            wt[:, :min(48, n - c0)] = wq.numpy()[:, c0:c0 + 48]
            out, _ = warp_tile(qt, wt, 1, 48, 96)
            tile[r0:r0 + 16, c0:c0 + 48] = out[:min(16, m - r0), :min(48, n - c0)]
    acc = torch.from_numpy(tile)
    assert torch.equal(acc, q.long() @ wq.long())
    # static: the kernel's w_s is the combined scale w_s * act_scale
    cs = (ws * torch.tensor(1.0 / inv_a, dtype=torch.float32)) if static else ws
    got = kernel_epilogue(acc, s_row, cs, b, res, code, td)
    j_cs = jnp.asarray(cs.numpy()[None]) if static else jws
    ref = _jax_int8_layer_mm(kind, jh, jwq, j_cs, jb, jres, code, jd, inv_a)
    deq = acc.float() * s_row[:, None] * cs if s_row is not None else acc.float() * cs
    terms = deq.abs() + b.abs() + (res.float().abs() if code == 3 else 0.0)
    _compare(got, ref, code, dtype, terms)
    epilogue, approx = EPILOGUES[code]
    twin = tfe.linear_i8_plain(q, s_row, wq, cs, b, epilogue=epilogue, out_dtype=td,
                               res=res if code == 3 else None, approx_gelu=approx)
    np.testing.assert_array_equal(_np(got), _np(twin))


# ---------------------------------------------------------------------------
# The plan, the shared memory, the compiled shapes, the A/B anchors
# ---------------------------------------------------------------------------


def tiles(m, n, plan):
    rows, cols = plan
    return [(range(y * rows, min((y + 1) * rows, m)), range(x * cols, min((x + 1) * cols, n)))
            for y in range(-(-m // rows)) for x in range(-(-n // cols))]


@pytest.mark.parametrize("m,n,k", [(197, 576, 192), (197, 192, 192), (197, 768, 192),
                                   (197, 192, 768), (25216, 576, 192), (25216, 192, 768),
                                   (197, 768, 3072), (197, 2304, 768), (784, 576, 192),
                                   (49, 768, 3072), (25088, 576, 192), (197, 230, 192),
                                   (197, 537, 192), (3136, 64, 147), (1, 8, 8), (5, 7, 13)])
def test_linear_i8_plan_covers_every_element_once_within_the_kernel_limits(m, n, k):
    rows, cols, split = tfe.linear_i8_plan(m, n, k, H100_SMS)
    assert rows in tfe.LINEAR_I8_ROWS and cols in tfe.LINEAR_I8_COLS
    assert 1 <= split <= tfe.LINEAR_I8_MAX_SPLIT
    assert tfe._linear_i8_smem_bytes(rows, cols) <= tfm.MAX_SMEM
    # k changes the split only, never the block shape
    assert tfe.linear_i8_plan(m, n, 1, H100_SMS) == (rows, cols, 1)
    assert tfe.linear_i8_plan(m, n, 4 * k, H100_SMS)[:2] == (rows, cols)
    covered = np.zeros((min(m, 400), n), dtype=np.int64)
    for rs, cs in tiles(min(m, 400), n, (rows, cols)):
        covered[rs.start:rs.stop, cs.start:cs.stop] += 1
    assert (covered == 1).all()
    blocks = -(-m // rows) * -(-n // cols)
    # at small M the blocks (with the split's) fill the SMs wherever the
    # tiles and K's steps allow it
    steps = -(-k // tfe.LINEAR_I8_BK)
    assert (blocks * split >= H100_SMS or (rows, cols) == (16, 32) or n % 16
            or steps // (split + 1) < tfe.LINEAR_I8_SPLIT_STEPS)


@pytest.mark.parametrize("m,n,want", [(25216, 576, (128, 128)), (25216, 768, (128, 96)),
                                      (25216, 192, (128, 96)), (25088, 576, (128, 128)),
                                      (6304, 192, (128, 64))])
def test_linear_i8_plan_takes_the_width_that_fills_the_last_wave(m, n, want):
    """At 128 rows, :func:`linear_plan`'s width or the next narrower one,
    whichever fills the last wave of two blocks an SM better: deit_tiny
    b128's qkv keeps 128 columns (3.73 waves against 4.48 at 96), its fc1
    takes 96 (5.97 against 4.48); where linear_plan's rows or columns
    narrowed for the SMs, the rule never widens."""
    plan = tfe.linear_i8_plan(m, n, 192, H100_SMS)[:2]
    assert plan == want
    base = tfe.linear_plan(m, n, 192, H100_SMS)
    assert plan[0] == base[0] and plan[1] in (base[1], max(
        [c for c in tfe.LINEAR_I8_COLS if c < base[1]], default=base[1]))
    per_wave = tfe.LINEAR_I8_BLOCKS_PER_SM * H100_SMS
    fill = lambda c: (lambda w: w - np.ceil(w) + 1)(-(-m // 128) * -(-n // c) / per_wave)  # noqa
    assert fill(plan[1]) >= fill(base[1])


@pytest.mark.parametrize("m,k,n,want", [(25216, 192, 230, (128, 32, 1)),
                                        (197, 192, 230, (32, 32, 1)),
                                        (394, 192, 537, (32, 32, 1))])
def test_linear_i8_plan_takes_narrow_blocks_where_n_is_ragged(m, k, n, want):
    """N off a multiple of 16: W's loads and the epilogue go element by
    element, and 32 columns of at least 32 rows took the least time."""
    assert tfe.linear_i8_plan(m, n, k, H100_SMS) == want


@pytest.mark.parametrize("m,k,n,want", [(197, 768, 192, 3), (197, 3072, 768, 2),
                                        (197, 192, 576, 1), (25216, 768, 192, 1),
                                        (49, 3072, 768, 3), (197, 1152, 384, 2)])
def test_linear_i8_plan_splits_k_at_small_m(m, k, n, want):
    """Splits while the blocks number fewer than two an SM and every block
    keeps at least two K steps; the shares of K's steps, as the kernel cuts
    them (rank r walks [r KT / S, (r + 1) KT / S)), cover every step once."""
    rows, cols, split = tfe.linear_i8_plan(m, n, k, H100_SMS)
    assert split == want
    steps = -(-k // tfe.LINEAR_I8_BK)
    for s in range(1, tfe.LINEAR_I8_MAX_SPLIT + 1):
        shares = [range(r * steps // s, (r + 1) * steps // s) for r in range(s)]
        assert [kt for sh in shares for kt in sh] == list(range(steps))
    assert all(len(range(r * steps // split, (r + 1) * steps // split))
               >= tfe.LINEAR_I8_SPLIT_STEPS for r in range(split))
    tile = (build.CSRC / "linear_i8_tile.cuh").read_text()
    assert "const int kt0 = rank * KT / split, nkt = (rank + 1) * KT / split - kt0;" in tile


@pytest.mark.parametrize("n", [192, 576, 768, 2304])
def test_linear_i8_plan_fills_the_card_at_b1(n):
    """Blocks at least as many as the SMs wherever the compiled tiles allow
    it: N = 192 at 197 rows gives 78 blocks of the smallest, 16 x 32."""
    rows, cols, _ = tfe.linear_i8_plan(197, n, 192, H100_SMS)
    blocks = -(-197 // rows) * -(-n // cols)
    assert blocks >= H100_SMS or (rows, cols) == (16, 32)
    assert 2 * blocks >= H100_SMS


def test_linear_i8_smem_bytes_mirrors_the_kernel_layout():
    """csrc/linear_i8_tile.cuh ``smem_bytes``: 3 stages of Q [rows, 144] and W
    [128, cols + 16] bytes, worked by hand; two 128 x 128 blocks fit an SM
    (228 KB, 1 KB of it reserved per block); every warp patch fits the ring."""
    assert tfe._linear_i8_smem_bytes(128, 128) == 3 * (128 * 144 + 128 * 144) == 110592
    assert tfe._linear_i8_smem_bytes(16, 32) == 3 * (16 * 144 + 128 * 48) == 25344
    assert 2 * (tfe._linear_i8_smem_bytes(128, 128) + 1024) <= 228 * 1024
    for r in tfe.LINEAR_I8_ROWS:
        for c in tfe.LINEAR_I8_COLS:
            assert r * (c + 16) * 2 <= tfe._linear_i8_smem_bytes(r, c) <= tfm.MAX_SMEM


def test_the_kernel_is_compiled_for_every_block_shape_of_the_plan():
    """The rows and column widths evt_linear_i8 dispatches on, read from the
    committed sources, are the ones linear_i8_plan may return; each row count
    compiles in its own source."""
    entry = (build.CSRC / "linear_i8.cu").read_text()
    tile = (build.CSRC / "linear_i8_tile.cuh").read_text()
    rows = tuple(int(r) for r in re.findall(r"case (\d+): return linear_i8_rows\1\(", entry))
    cols = tuple(int(c) for c in re.findall(r"EVT_LINEAR_I8_COLS\((\d+)\)\n", tile))
    assert rows == tfe.LINEAR_I8_ROWS and cols == tfe.LINEAR_I8_COLS
    for r in rows:
        src = entry if r == rows[0] else (build.CSRC / f"i8_rows{r}.cu").read_text()
        assert re.search(rf"int linear_i8_rows{r}\(EVT_LINEAR_I8_ARGS\) {{\n  return launch_cols<",
                         src)
    assert f"BK = {tfe.LINEAR_I8_BK}, STAGES = {tfe.LINEAR_I8_STAGES};" in tile
    assert "wmma" not in entry.lower().replace("the wmma kernel", "") + tile.lower()


def test_linear_i8_ab_finds_its_anchors_in_the_committed_source():
    src = (build.CSRC / linear_i8_ab.TILE).read_text()
    found = linear_i8_ab.variants(src)
    assert list(found) == ["committed", "no epilogue", "no byte permutes", "warp patch",
                           "4 stages"]
    assert found["committed"] == src
    assert all(v != src for k, v in found.items() if k != "committed")
    assert "__byte_perm" not in found["no byte permutes"]
    assert found["warp patch"].count("__syncthreads();") == src.count("__syncthreads();") + 1
    assert "reinterpret_cast<uint4*>(Y +" in found["warp patch"]
    assert set(linear_i8_ab.SOURCES) == {"linear_i8.cu"} | {
        p.name for p in build.CSRC.glob("i8_rows*.cu")}
    plans = linear_i8_ab.plans(197, 576, 192, H100_SMS)
    assert plans["plan"] == tfe.linear_i8_plan(197, 576, 192, H100_SMS)
    every = [(r, c, 1) for r in tfe.LINEAR_I8_ROWS for c in tfe.LINEAR_I8_COLS]
    assert sorted(plans.values()) == sorted(every + [(16, 32, 2)])  # K = 192: 2 steps
    long_k = linear_i8_ab.plans(197, 768, 3072, H100_SMS)
    assert {v[2] for v in long_k.values()} == set(linear_i8_ab.SPLITS)
    # the WMMA kernel it replaced, kept for the card tests, exports its own name
    assert 'extern "C" int evt_linear_i8_wmma(' in linear_i8_ab.WMMA_SOURCE
    assert "wmma::mma_sync" in linear_i8_ab.WMMA_SOURCE
