"""The arithmetic of ``bench/swin_merge_fused.cu`` (a fused form of K10,
Swin patch merging: the 2x2 gather, the LayerNorm over 4C and the [4C,
2C] reduction in one launch, which ``bench/swin_merge_ab.py`` times against
the port's two launches), emulated in a few lines of numpy and PyTorch on
the CPU and held against the port's chain (``swin_merge_plain``, then
``linear_plain`` with a zero bias) and against JAX's K10
``swin_merge_forward`` in interpret mode.

The emulation follows the kernel.  Each 8-value chunk of a merged row comes
from one input row, at the offset the kernel computes (its row's (0,0)
input row plus the chunk's place in the 2x2 block; at C = 96 a 64-deep K
step straddles two (dy, dx) groups), K rounded up to whole 64-deep steps
with zeros.  The LayerNorm statistics of a row are ``ln_rows``': lane
``l`` of a warp adds chunks ``l, l + 32, ...`` in order, each chunk's 8
values in order, in fp32; the warp's butterfly (``warp_sum``: xor 16, 8,
4, 2, 1) adds the lanes; the squared deviations are added by fma; ``rs =
rsqrt(var + eps)``.  Each chunk is normalized as ``fma((f - mean) * rs, g,
b)`` and rounded to bf16.  ``mma_step`` sums K in k16 steps, in order, into
one fp32 accumulator: each step's exact products added in fp64 and rounded
to fp32, then added.  The epilogue rounds once to bf16.  An fma is emulated
as one fp64 multiply-add rounded to fp32 (up to a double rounding).  The
A/B script's plans, the compiled block shapes, the shared-memory mirrors and
the anchors are checked too.

Inputs come from a numpy seed.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.models import swin as jswin
from edgevisiontransformer_tpu.ops.pallas.swin_merge import swin_merge_forward
from edgevisiontransformer_tpu_torch.bench import swin_merge_ab
from edgevisiontransformer_tpu_torch.ops.cuda import build
from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as tfe
from edgevisiontransformer_tpu_torch.ops.cuda import swin_merge as tsm

torch.set_num_threads(1)

BK = 64  # gemm_tile's K step
EPS = 1e-5
H100_SMS = 132
MAX_SMEM = 232448
# against the twin and JAX: the kernel tolerance of the card tests (fp32
# summation order and rsqrtf against torch.rsqrt can move a value across a
# bf16 rounding boundary, before or after the product: ~2 bf16 spacings)
BF16 = dict(rtol=2.0 ** -6, atol=1e-2)
# the normalized A values against ln_rows_plain's: the same fp32 math in
# another summation order, one bf16 rounding: at most one bf16 spacing
ONE_SPACING = dict(rtol=2.0 ** -7, atol=1e-6)
# swin_tiny / _small / _base at 224: the merges' (C, res) per stage
SWIN_MERGES = {"tiny": ((96, 56), (192, 28), (384, 14)),
               "base": ((128, 56), (256, 28), (512, 14))}


def chunk_offsets(bsz, res, c):
    """``[M, 4C / 8]``: the flat offset in ``x [bsz * res * res, C]`` of
    each 8-value chunk of each merged row, as the kernel's tables hold it
    (``rowoff`` of the row plus ``chunkoff`` of the chunk)."""
    ho = res // 2
    m = np.arange(bsz * ho * ho)
    img, yo, xo = m // (ho * ho), (m // ho) % ho, m % ho
    x00 = ((img * res + 2 * yo) * res + 2 * xo) * c
    per_row = c // 8
    ch = np.arange(4 * per_row)
    q = ch // per_row
    off = ((q >> 1) * res + (q & 1)) * c + (ch - q * per_row) * 8
    return x00[:, None] + off[None, :]


def fma(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def warp_sum(lanes):
    """``[rows, 32]`` lane values -> ``[rows]``: the xor butterfly."""
    idx = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ off]
    return lanes[:, 0]


def lane_stats(rows):
    """ln_rows' mean and rstd of each fp32 row (``[M, dim]``), in its lane
    order."""
    m, dim = rows.shape
    v = rows.reshape(m, dim // 8, 8)
    chunks = dim // 8
    s = np.zeros((m, 32), np.float32)
    for c0 in range(0, chunks, 32):
        n = min(32, chunks - c0)
        for i in range(8):
            s[:, :n] = s[:, :n] + v[:, c0:c0 + n, i]
    mean = warp_sum(s) / np.float32(dim)
    sq = np.zeros((m, 32), np.float32)
    for c0 in range(0, chunks, 32):
        n = min(32, chunks - c0)
        for i in range(8):
            d = v[:, c0:c0 + n, i] - mean[:, None]
            sq[:, :n] = fma(d, d, sq[:, :n])
    var = warp_sum(sq) / np.float32(dim)
    rs = (np.float32(1.0) / np.sqrt(var + np.float32(EPS))).astype(np.float32)
    return mean, rs


def kernel_tiles(x, g, b, w, res):
    """The merge as bench/swin_merge_fused.cu computes it: ``(A, y)``, the
    normalized bf16 A operand and the bf16 output."""
    bsz, c = x.shape[0] // (res * res), x.shape[1]
    offs = chunk_offsets(bsz, res, c)
    flat = x.float().numpy().reshape(-1)
    k = 4 * c
    kpad = -(-k // BK) * BK
    rows = np.zeros((offs.shape[0], kpad), np.float32)
    for k0 in range(0, k, BK):  # one K step: its chunks, each from one input row
        for j in range(min(BK, k - k0) // 8):
            ch = (k0 + 8 * j) // 8
            rows[:, k0 + 8 * j:k0 + 8 * j + 8] = flat[offs[:, ch, None] + np.arange(8)]
    mean, rs = lane_stats(rows[:, :k])
    gf, bf = g.float().numpy(), b.float().numpy()
    a = fma((rows[:, :k] - mean[:, None]) * rs[:, None], gf[None], bf[None])
    a = torch.from_numpy(a).to(torch.bfloat16)
    af = torch.nn.functional.pad(a.float(), (0, kpad - k)).double()
    wf = torch.nn.functional.pad(w.float(), (0, 0, 0, kpad - k)).double()
    acc = torch.zeros(a.shape[0], w.shape[1])
    for k0 in range(0, kpad, 16):  # one accumulator, k16 steps in order
        acc = acc + (af[:, k0:k0 + 16] @ wf[k0:k0 + 16]).float()
    return a, acc.to(torch.bfloat16)


def chain(x, g, b, w, res):
    """The port's two launches' twins: ``swin_merge_plain``, then
    ``linear_plain`` with a zero bias (``CAST_THEN_BIAS``)."""
    return tfe.linear_plain(tsm.swin_merge_plain(x, g, b, res=res, eps=EPS), w,
                            torch.zeros(w.shape[1], dtype=torch.bfloat16),
                            epilogue=tfe.CAST_THEN_BIAS)


def _inputs(bsz, res, c, affine, seed=0):
    rng = np.random.default_rng(seed + c)
    arrays = ((rng.standard_normal((bsz * res * res, c)) * 2.0).astype(np.float32),
              (1.0 + 0.5 * rng.standard_normal(4 * c)).astype(np.float32),
              (0.5 * rng.standard_normal(4 * c)).astype(np.float32),
              (rng.standard_normal((4 * c, 2 * c)) * (4 * c) ** -0.5).astype(np.float32))
    x, g, b, w = (torch.from_numpy(a) for a in arrays)
    dt = getattr(torch, affine)
    return x.bfloat16(), g.to(dt), b.to(dt), w.bfloat16()


@pytest.mark.parametrize("res,c", [(8, 96), (6, 32), (4, 8), (12, 48)])
def test_chunk_offsets_are_the_merge_gather(res, c):
    x = torch.arange(2 * res * res * c, dtype=torch.float64).reshape(-1, c)
    offs = chunk_offsets(2, res, c)
    idx = torch.from_numpy(offs[:, :, None] + np.arange(8)).reshape(offs.shape[0], -1)
    got = x.reshape(-1)[idx]
    assert torch.equal(got, tsm.merge_gather(x, res))


def test_a_k_step_straddles_two_groups_at_c96():
    """At C = 96 a group is 12 chunks, a 64-deep K step 8: steps 1 and 4
    read two input rows each, which the chunk-by-chunk arithmetic covers."""
    per_row = 96 // 8
    groups = [sorted({ch // per_row for ch in range(k0 // 8, k0 // 8 + BK // 8)})
              for k0 in range(0, 4 * 96, BK)]
    assert groups == [[0], [0, 1], [1], [2], [2, 3], [3]]


@pytest.mark.parametrize("affine", ["float32", "bfloat16"])
@pytest.mark.parametrize("bsz,res,c", [(2, 8, 96), (1, 14, 32), (3, 4, 32), (1, 4, 192)])
def test_kernel_tiles_match_the_twin(bsz, res, c, affine):
    x, g, b, w = _inputs(bsz, res, c, affine)
    a, got = kernel_tiles(x, g, b, w, res)
    assert got.shape == (bsz * (res // 2) ** 2, 2 * c) and torch.isfinite(got.float()).all()
    h = tfe.ln_rows_plain(tsm.merge_gather(x, res), g, b, EPS)
    np.testing.assert_allclose(a.float().numpy(), h.float().numpy(), **ONE_SPACING)
    twin = chain(x, g, b, w, res)
    np.testing.assert_allclose(got.float().numpy(), twin.float().numpy(), **BF16)
    # the chain's LayerNorm twin is ln_rows_plain of the gathered rows
    assert torch.equal(tsm.swin_merge_plain(x, g, b, res=res, eps=EPS), h)


@pytest.mark.parametrize("res,c", [(28, 32), (14, 96)])
def test_kernel_tiles_match_jax_k10(res, c):
    """JAX's K10 on window-major tokens (window 7, padded to 56 rows)
    against the emulation on raster rows; both in bf16."""
    x, g, b, w = _inputs(1, res, c, "float32", seed=3)
    win, n_pad = 7, 56
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16).reshape(1, res, res, c)
    xw = jswin.window_partition(xj, win)
    xw = jnp.pad(xw, ((0, 0), (0, n_pad - win * win), (0, 0)))
    out = swin_merge_forward(xw, {"norm_scale": jnp.asarray(g.numpy()),
                                  "norm_bias": jnp.asarray(b.numpy()),
                                  "kernel": jnp.asarray(w.float().numpy())},
                             res=res, window=win, eps=EPS)
    ref = jswin.window_reverse(out[:, :win * win], win, res // 2, res // 2)
    ref = np.asarray(ref.astype(jnp.float32)).reshape(-1, 2 * c)
    _, got = kernel_tiles(x, g, b, w, res)
    np.testing.assert_allclose(got.float().numpy(), ref, **BF16)


def test_compiled_tiles_and_shared_memory_mirror_the_source():
    """Both fused forms compile every one of linear's block shapes, rows as
    (WM, TM) warps of rows; their shared-memory sizes are mirrored."""
    for name in (swin_merge_ab.FUSED_SOURCE, swin_merge_ab.RESIDENT_SOURCE):
        src = (swin_merge_ab.HERE / name).read_text()
        tiles = re.findall(r"X\((\d+), (\d+)\)", swin_merge_ab._TILES.search(src).group(0))
        assert [(int(r), int(c)) for r, c in tiles] == list(swin_merge_ab.ALL_TILES)
        assert ("return merge_launch<(R >= 64 ? R / 32 : R / 16), (R >= 64 ? 32 : 16), CO / WN>("
                in src)
    fused = (swin_merge_ab.HERE / swin_merge_ab.FUSED_SOURCE).read_text()
    assert ("  return MERGE_STAGES * (rows * AS + BK * (cols + 8)) * 2 + rows * 8 + 2 * 4 * C * 4;"
            in fused and "constexpr int MERGE_STAGES = 4;" in fused)
    resident = (swin_merge_ab.HERE / swin_merge_ab.RESIDENT_SOURCE).read_text()
    assert ("  return rows * merge_lda(C) * 2 + STAGES * BK * (cols + 8) * 2 + rows * 4 +\n"
            "         (merge_lda(C) - 8) / 8 * 4 + 2 * 4 * C * 4;") in resident
    assert ("constexpr int merge_lda(int C) { return (4 * C + BK - 1) / BK * BK + 8; }"
            in resident)
    assert swin_merge_ab.fused_smem_bytes(64, 96, 384) == 4 * (64 * 72 + 64 * 104) * 2 + 512 + 12288
    # the resident row stride is an odd multiple of 16 bytes at every C % 8 == 0
    for c in range(8, 800, 8):
        kp = -(-4 * c // BK) * BK
        assert ((kp + 8) * 2) % 32 == 16


@pytest.mark.parametrize("model", sorted(SWIN_MERGES))
@pytest.mark.parametrize("batch", [1, 2, 4, 8, 32, 64, 128])
def test_merge_plan_is_linear_plan_with_the_rows_that_fit(model, batch):
    """The resident form's plan: linear's plan where it takes 32 or 16 rows,
    else RESIDENT_WIDE_TILE, its rows halved only as far as the block's
    resident rows and ring need to fit in shared memory.  The fused form's:
    96 columns and the most rows that give 1.5 blocks an SM, else 16 rows."""
    for c, res in SWIN_MERGES[model]:
        m, n, k = batch * (res // 2) ** 2, 2 * c, 4 * c
        rows, cols, group = swin_merge_ab.resident_plan(m, n, k, H100_SMS)
        lin_rows, lin_cols = tfe.linear_plan(m, n, k, H100_SMS)
        if lin_rows >= 64:
            lin_rows, lin_cols = swin_merge_ab.RESIDENT_WIDE_TILE
        assert (rows, cols) in swin_merge_ab.ALL_TILES and cols == lin_cols and rows <= lin_rows
        assert swin_merge_ab.resident_smem_bytes(rows, cols, c) <= MAX_SMEM
        assert (rows == lin_rows
                or swin_merge_ab.resident_smem_bytes(2 * rows, cols, c) > MAX_SMEM)
        # a row's tiles in the fewest even groups that keep RESIDENT_BLOCKS_PER_SM
        # blocks an SM
        row_tiles, tiles = -(-m // rows), -(-n // cols)
        groups, least = -(-tiles // group), swin_merge_ab.RESIDENT_BLOCKS_PER_SM * H100_SMS
        assert 1 <= group <= tiles and -(-tiles // groups) == group
        assert groups == tiles or row_tiles * groups >= least
        assert all(row_tiles * -(-tiles // more) < least for more in range(group + 1, tiles + 1)
                   if -(-tiles // more) < groups)
        rows, cols = swin_merge_ab.fused_plan(m, n, H100_SMS)
        blocks = -(-m // rows) * -(-n // cols)
        assert (cols == 96 and blocks >= 1.5 * H100_SMS) or rows == 16
        assert all(-(-m // more) * -(-n // 96) < 1.5 * H100_SMS
                   for more in tfe.LINEAR_ROWS if more > rows)


def test_every_width_of_the_port_fits_a_plan():
    for m in (1, 7, 49, 196, 784, 1568, 6272, 25088, 100352):
        for c in (8, 16, 48, 96, 128, 192, 256, 384, 512, 768):
            rows, cols, _ = swin_merge_ab.resident_plan(m, 2 * c, 4 * c, H100_SMS)
            assert (rows, cols) in swin_merge_ab.ALL_TILES
            assert swin_merge_ab.resident_smem_bytes(rows, cols, c) <= MAX_SMEM
            rows, cols = swin_merge_ab.fused_plan(m, 2 * c, H100_SMS)
            assert (rows, cols) in swin_merge_ab.ALL_TILES
            assert swin_merge_ab.fused_smem_bytes(rows, cols, c) <= MAX_SMEM


def test_swin_merge_ab_finds_every_anchor_in_the_committed_source():
    fused = (swin_merge_ab.HERE / swin_merge_ab.FUSED_SOURCE).read_text()
    resident = (swin_merge_ab.HERE / swin_merge_ab.RESIDENT_SOURCE).read_text()
    got = swin_merge_ab.variants(fused, resident)
    assert got[swin_merge_ab.FUSED] == (swin_merge_ab.FUSED, fused)
    assert got[swin_merge_ab.RESIDENT] == (swin_merge_ab.RESIDENT, resident)
    taken = swin_merge_ab.plans(H100_SMS)
    for name, (form, text) in got.items():
        if name in (swin_merge_ab.FUSED, swin_merge_ab.RESIDENT):
            continue
        # a floor compiles only its plan's block shapes and leaves out its parts
        tiles = re.findall(r"X\((\d+), (\d+)\)", swin_merge_ab._TILES.search(text).group(0))
        assert {(int(r), int(c)) for r, c in tiles} == taken[form]
        assert text != (fused if form == swin_merge_ab.FUSED else resident)
    assert swin_merge_ab._STATS not in got[swin_merge_ab.NO_STATS][1]
    assert swin_merge_ab._GATHER not in got[swin_merge_ab.R_PRODUCT][1]
