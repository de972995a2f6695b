"""The chunk walk of ``csrc/mlp.cu`` (the card's K14), emulated in a few
lines of PyTorch on the CPU and held against JAX's K14
(``edgevisiontransformer_tpu.ops.pallas.fused_mlp.mlp``, in interpret mode,
as ``tests/test_torch_vit_pallas.py`` runs it) and against the port's twin
``mlp_plain``.

The emulation follows the kernel: the hidden width in chunks of ``hc`` (32
or 64) units, zero-padded past ``hidden`` (zero W1 columns, b1 and W2
rows); per chunk fc1 in fp32, ``+ f32(b1)``, GELU on the fp32 value and one round to
the compute dtype, then fc2 accumulated in fp32; with a cluster split of S
blocks, block s walks its contiguous share of the chunks and the S partials
are summed in the order s = 0 .. S - 1 before ``+ f32(b2)`` and one round.
This pins down the padding and the split's order where they can run;
``tests/test_torch_kernels_cuda.py`` holds the kernel itself to the twin on
the card.  The plans that pick the kernels' grids (``fused_mlp.plan`` up
to dim 1,152, ``fused_mlp.wide_plan`` for csrc/mlp_wide.cu above, whose
arithmetic ``tests/test_torch_mlp_wide.py`` emulates) are checked here too.

Inputs come from a numpy seed.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from edgevisiontransformer_tpu.ops.pallas import fused_mlp as jfm
from edgevisiontransformer_tpu_torch.bench import mlp_ab
from edgevisiontransformer_tpu_torch.ops.cuda import build
from edgevisiontransformer_tpu_torch.ops.cuda import fused_mlp as tfm
from edgevisiontransformer_tpu_torch.ops.cuda.mathlib import gelu_kernel

torch.set_num_threads(1)

# fp32: the bound tests/test_torch_vit_pallas.py holds K14 to (the JAX
# package's own kernel tests, 1e-5); bf16: the kernel tolerance of PERF.md
# section 2 (fp32 summation order, or erff against JAX's erf_poly, can move
# a value across a bf16 rounding boundary, before or after fc2)
FP32 = dict(rtol=1e-5, atol=1e-5)
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 1e-2
H100_SMS = 132


def split_chunks(nc, split):
    """The chunks ``[c0, c1)`` that block s of a cluster of ``split`` walks,
    for each s: its contiguous share (csrc/mlp.cu ``c0``, ``c1``)."""
    return [(s * nc // split, (s + 1) * nc // split) for s in range(split)]


def kernel_tiles(x, w1, b1, w2, b2, approx, split, hc):
    """``mlp`` as csrc/mlp.cu computes it, chunk by chunk of ``hc`` units,
    ``split`` blocks sharing the chunks."""
    dt, hidden = x.dtype, w1.shape[1]
    pad = -hidden % hc
    w1p, b1p = F.pad(w1.float(), (0, pad)), F.pad(b1.float(), (0, pad))
    w2p = F.pad(w2.float(), (0, 0, 0, pad))
    xf, nc = x.float(), (hidden + pad) // hc
    y = torch.zeros(x.shape[0], w2.shape[1])
    for c0, c1 in split_chunks(nc, split):  # the partials, added in split order
        part = torch.zeros_like(y)
        for c in range(c0, c1):
            u = slice(c * hc, (c + 1) * hc)
            h = gelu_kernel(xf @ w1p[:, u] + b1p[u], approx).to(dt).float()
            part = part + h @ w2p[u]
        y = y + part
    return (y + b2.float()).to(dt)


ROWS = 394  # the most rows a case takes; a case of m rows takes the first m


@functools.lru_cache(maxsize=None)
def _inputs(dim, hidden):
    rng = np.random.default_rng(dim * 31 + hidden)
    x = (rng.standard_normal((ROWS, dim)) * 2).astype(np.float32)
    w1 = (rng.standard_normal((dim, hidden)) * dim ** -0.5).astype(np.float32)
    b1 = rng.standard_normal(hidden).astype(np.float32)
    w2 = (rng.standard_normal((hidden, dim)) * hidden ** -0.5).astype(np.float32)
    b2 = rng.standard_normal(dim).astype(np.float32)
    return x, w1, b1, w2, b2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _sides(dim, hidden, dtype):
    """(JAX operands, torch operands) in ``dtype``: bf16 values made once on
    the JAX side and handed to torch exactly."""
    arrays = _inputs(dim, hidden)
    if dtype == "float32":
        return arrays, tuple(map(torch.from_numpy, arrays))
    jax_side = tuple(jnp.asarray(a, jnp.bfloat16) for a in arrays)
    return jax_side, tuple(torch.from_numpy(_np(a)).bfloat16() for a in jax_side)


@functools.lru_cache(maxsize=None)
def _jax_k14(dim, hidden, dtype, approx):
    """K14 on all ``ROWS`` rows (its rows are independent: a case slices)."""
    return _np(jfm.mlp(*_sides(dim, hidden, dtype)[0], approx_gelu=approx))


def _close_bf16(got, ref):
    got, ref = _np(got), _np(ref)
    assert np.isfinite(got).all()
    err = np.abs(got - ref)
    assert (err <= BF16_ATOL + BF16_RTOL * np.abs(ref)).all(), err.max()


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("hc", [32, 64])
@pytest.mark.parametrize("split", [1, 2, 8])
@pytest.mark.parametrize("dim,hidden", [(64, 13), (192, 230), (192, 537), (192, 768),
                                        (384, 1152)])
@pytest.mark.parametrize("m", [1, 3, 197, ROWS])
def test_kernel_tiles_match_jax_k14_and_the_twin(m, dim, hidden, split, hc, approx):
    for dtype in ("float32", "bfloat16"):
        x, w1, b1, w2, b2 = _sides(dim, hidden, dtype)[1]
        x = x[:m]
        got = kernel_tiles(x, w1, b1, w2, b2, approx, split, hc)
        ref = _jax_k14(dim, hidden, dtype, approx)[:m]
        twin = tfm.mlp_plain(x, w1, b1, w2, b2, approx_gelu=approx)
        assert got.shape == (m, dim) and got.dtype == x.dtype
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), ref, **FP32)
            np.testing.assert_allclose(_np(got), _np(twin), **FP32)
        else:
            _close_bf16(got, ref)
            _close_bf16(got, twin)


@pytest.mark.parametrize("m,dim,hidden", [(197, 192, 768), (25216, 192, 768), (1, 192, 768),
                                          (1576, 768, 3072), (197, 384, 1152),
                                          (6304, 384, 1152), (197, 192, 230), (3, 64, 13),
                                          (197, 200, 768), (200, 1152, 4608),
                                          (257, 1280, 5120), (8 * 257, 1280, 5120),
                                          (257, 1408, 6144), (8 * 257, 1664, 8192),
                                          (1, 2048, 8192), (25216, 2048, 8192),
                                          (257, 2056, 8224), (8 * 257, 2304, 9216),
                                          (3, 1160, 13), (257, 1408, 6150)])
def test_plan_covers_every_unit_once_within_the_kernel_limits(m, dim, hidden):
    """mlp.cu's plan up to dim 1,152; above (ViT-H/14's 1,280, ViT-g/14's
    1,408, ViT-G/14's 1,664, 2,048, 2,056, 2,304 and ragged hidden widths)
    the wide kernel's."""
    if dim > tfm.MID_ROWS_DIM:
        _check_wide_plan(m, dim, hidden)
        return
    p = tfm.plan(m, dim, hidden, H100_SMS)
    assert p.rows in (64, 128) and p.nt in tfm.TILE_WIDTHS and p.hc in (32, 64)
    assert p.rows == 64 or dim <= tfm.WIDE_ROWS_DIM
    assert p.hc == 32 or (p.rows == 128 and p.split == 1)  # the forms csrc/mlp.cu compiles
    assert tfm._smem_bytes(dim, p.rows, p.nt, p.hc) <= tfm.MAX_SMEM
    assert 1 <= p.split <= tfm.MAX_SPLIT and p.split <= -(-hidden // p.hc)
    assert p.col_tiles == -(-dim // p.nt) and (p.col_tiles - 1) * p.nt < dim
    shares = split_chunks(-(-hidden // p.hc), p.split)
    assert len(shares) == p.split
    covered = [u for c0, c1 in shares for u in range(c0 * p.hc, min(c1 * p.hc, hidden))]
    assert covered == list(range(hidden))  # each unit once, in split order
    assert all(c1 > c0 for c0, c1 in shares)  # no block of a cluster idles


def _check_wide_plan(m, dim, hidden):
    """csrc/mlp_wide.cu under wide_plan: every output element in exactly one
    fc2 tile and every hidden unit in one fc1 tile and one share of fc2's K;
    the grid one wave at one block an SM; the shared memory within the
    card's limit."""
    p = tfm.wide_plan(m, dim, hidden, H100_SMS)
    assert (p.bm, p.bn, p.bk) == (tfm.WIDE_BM, tfm.WIDE_BN, tfm.WIDE_BK)
    assert (p.row_tiles - 1) * p.bm < m <= p.row_tiles * p.bm
    assert (p.dim_tiles - 1) * p.bn < dim <= p.dim_tiles * p.bn
    assert p.hp == p.hidden_tiles * p.bn and p.hp - p.bn < hidden <= p.hp
    shares = tfm.wide_shares(p.hp // p.bk, p.split)
    covered = [u for s0, s1 in shares for u in range(s0 * p.bk, min(s1 * p.bk, hidden))]
    assert covered == list(range(hidden))  # each unit once, in share order
    assert all(s1 > s0 for s0, s1 in shares)  # no unit of fc2 idles
    assert 1 <= p.split <= tfm.WIDE_MAX_SPLIT
    assert 1 <= p.grid <= H100_SMS * tfm.WIDE_BLOCKS_PER_SM  # one wave: co-resident
    assert p.grid == min(H100_SMS, max(p.row_tiles * p.hidden_tiles,
                                       p.row_tiles * p.dim_tiles * p.split))
    assert p.smem == tfm.wide_smem_bytes() <= tfm.MAX_SMEM
    assert p.h_bytes == m * p.hp * 2 and p.part_bytes == (p.split > 1) * p.split * m * dim * 4


def test_plan_splits_the_hidden_width_only_at_small_batches():
    tiny_b128 = tfm.plan(128 * 197, 192, 768, H100_SMS)
    assert tiny_b128.split == 1 and tiny_b128.rows == 128 and tiny_b128.col_tiles == 1
    tiny_b1 = tfm.plan(197, 192, 768, H100_SMS)
    blocks = -(-197 // tiny_b1.rows) * tiny_b1.col_tiles * tiny_b1.split
    assert tiny_b1.split > 1 and blocks >= H100_SMS // 2
    assert tfm.plan(197, 192, 768, H100_SMS, split=1).split == 1
    assert tfm.plan(197, 192, 768, H100_SMS, rows=128).rows == 128


def test_mlp_ab_finds_its_anchor_in_the_committed_source():
    src = (build.CSRC / "mlp.cu").read_text()
    found = mlp_ab.variants(src)
    assert list(found) == ["committed", "no GELU (products only)"]
    assert found["committed"] == src and found["no GELU (products only)"] != src
    wide = (build.CSRC / "mlp_wide.cu").read_text()
    found = mlp_ab.wide_variants(wide)
    assert list(found) == list(mlp_ab.WIDE_VARIANTS)
    assert found["committed"] == wide
    assert all(code != wide for name, code in found.items() if name != "committed")
    assert mlp_ab.wide_plans(257, 1280, 5120, H100_SMS)["plan"].split == 5
    assert [p.split for p in mlp_ab.wide_plans(2056, 1280, 5120, H100_SMS).values()] == [
        1, 1, 2, 4]
    plans = mlp_ab.plans(197, 192, 768, H100_SMS)
    assert plans["plan"].split > 1 and plans["split 1"].split == 1
    assert plans["64 rows"].rows == 64 and plans["128 rows"].rows == 128
    assert "128 rows" not in mlp_ab.plans(1576, 768, 3072, H100_SMS)
    assert mlp_ab.plans(128 * 197, 192, 768, H100_SMS)["hc 32"].hc == 32


def test_smem_bytes_mirrors_the_kernel_layout():
    """csrc/mlp.cu ``Layout`` at deit_tiny (one W1 slab a chunk: three W2
    buffers) and dim 1,152 (six slabs: two), worked by hand."""
    x, w1, w2 = 128 * 200 * 2, 3 * 192 * 72 * 2, 3 * 64 * 200 * 2
    assert tfm._smem_bytes(192, 128, 192, 64) == x + w1 + w2
    x, w1, w2 = 64 * 1160 * 2, 3 * 192 * 40 * 2, 2 * 32 * 264 * 2
    assert tfm._smem_bytes(1152, 64, 256, 32) == x + w1 + w2 <= tfm.MAX_SMEM
    # dim 1,280 (ViT-H): 64 rows of x would not fit beside the rings (mlp.cu
    # takes no wider dim); csrc/mlp_wide.cu's ring of four steps, each A 64 x
    # 64 and B 64 x 256, 1,024 bytes to align it and a full and an empty
    # mbarrier a step, at every dim
    assert tfm._smem_bytes(1280, 64, 256, 32) > tfm.MAX_SMEM
    a, b = 64 * 64 * 2, 64 * 256 * 2
    assert tfm.wide_smem_bytes() == 4 * (a + b) + 1024 + 4 * 2 * 8 == 164928 <= tfm.MAX_SMEM
    assert tfm._smem_bytes(64, 128, 256, 32) == 128 * 260 * 4  # the fp32 partial tile
