"""The wide form of the card's K14 (``csrc/mlp_wide.cu``, every ``dim`` above
1,152), emulated phase by phase in a few lines of PyTorch on the CPU and held
against JAX's K14 (``edgevisiontransformer_tpu.ops.pallas.fused_mlp.mlp``, in
interpret mode, as ``tests/test_torch_mlp_tiles.py`` runs it) and against the
port's twin ``mlp_plain``.

The emulation follows the kernel: phase 1 rounds H = gelu(f32(x @ w1) +
f32(b1)) once to the compute dtype over the hidden width padded to ``hp``
(zero W1 columns and b1 past ``hidden``, so H is 0 there); phase 2 cuts fc2's
K (``hp``) into the plan's S contiguous shares of whole 64-deep steps, each an
fp32 partial (zero W2 rows past ``hidden``); phase 3 sums the partials in the
order s = 0 .. S - 1, adds f32(b2) and rounds once.  S comes from
``fused_mlp.wide_plan``, and is forced to 1 and 4.  ``tests/
test_torch_kernels_cuda.py`` holds the kernel itself to the twin on the card.

Inputs come from a numpy seed.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from edgevisiontransformer_tpu.ops.pallas import fused_mlp as jfm
from edgevisiontransformer_tpu_torch.ops.cuda import fused_mlp as tfm
from edgevisiontransformer_tpu_torch.ops.cuda.mathlib import gelu_kernel

torch.set_num_threads(1)

# the bounds of tests/test_torch_mlp_tiles.py: fp32 1e-5 (the JAX package's
# own kernel tests); bf16 2^-6 |ref| + 1e-2 (PERF.md section 2: fp32
# summation order or erff against JAX's erf_poly can move a value across a
# bf16 rounding boundary, before or after fc2)
FP32 = dict(rtol=1e-5, atol=1e-5)
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 1e-2
H100_SMS = 132
ROWS = 40  # the most rows a case takes; a case of m rows takes the first m


def wide_tiles(x, w1, b1, w2, b2, approx, split):
    """``mlp`` as csrc/mlp_wide.cu computes it: H once over the padded hidden
    width, fc2's K in ``split`` shares of 64-deep steps, the partials summed
    in share order."""
    dt, hidden = x.dtype, w1.shape[1]
    p = tfm.wide_plan(x.shape[0], x.shape[1], hidden, H100_SMS, split=split)
    pad = p.hp - hidden
    w1p, b1p = F.pad(w1.float(), (0, pad)), F.pad(b1.float(), (0, pad))
    w2p = F.pad(w2.float(), (0, 0, 0, pad))
    h = gelu_kernel(x.float() @ w1p + b1p, approx).to(dt).float()  # phase 1
    assert not h[:, hidden:].any()  # gelu(0) past hidden
    y = torch.zeros(x.shape[0], w2.shape[1])
    for s0, s1 in tfm.wide_shares(p.hp // p.bk, p.split):  # phases 2 and 3
        k = slice(s0 * p.bk, s1 * p.bk)
        y = y + h[:, k] @ w2p[k]
    return (y + b2.float()).to(dt)


@functools.lru_cache(maxsize=None)
def _inputs(dim, hidden):
    rng = np.random.default_rng(dim * 37 + hidden)
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


@pytest.mark.parametrize("split", [None, 1, 4])
@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("m", [1, 3, ROWS])
@pytest.mark.parametrize("hidden", [13, 200, 300])
@pytest.mark.parametrize("dim", [1160, 1280])
def test_wide_tiles_match_jax_k14_and_the_twin(dim, hidden, m, approx, split):
    for dtype in ("float32", "bfloat16"):
        x, w1, b1, w2, b2 = _sides(dim, hidden, dtype)[1]
        x = x[:m]
        got = wide_tiles(x, w1, b1, w2, b2, approx, split)
        ref = _jax_k14(dim, hidden, dtype, approx)[:m]
        twin = tfm.mlp_plain(x, w1, b1, w2, b2, approx_gelu=approx)
        assert got.shape == (m, dim) and got.dtype == x.dtype
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), ref, **FP32)
            np.testing.assert_allclose(_np(got), _np(twin), **FP32)
        else:
            _close_bf16(got, ref)
            _close_bf16(got, twin)


def test_wide_plan_at_vit_h_b1_and_b8_by_hand():
    """ViT-H/14 (dim 1,280, hidden 5,120, 257 tokens): at b1 five 64-row
    tiles, 20 fc1 tiles of 256 hidden units each, fc2's 25 tiles cut into 5
    shares of 16 steps (125 blocks); at b8 33 row tiles and no split (165
    fc2 tiles: one block an SM).  The workspaces: H [m, 5,120] bf16, the
    partials [S, m, 1,280] fp32."""
    b1 = tfm.wide_plan(257, 1280, 5120, H100_SMS)
    assert (b1.row_tiles, b1.hidden_tiles, b1.dim_tiles, b1.split, b1.grid) == (5, 20, 5, 5, 125)
    assert b1.h_bytes == 257 * 5120 * 2 == 2_631_680
    assert b1.part_bytes == 5 * 257 * 1280 * 4 == 6_579_200
    b8 = tfm.wide_plan(2056, 1280, 5120, H100_SMS)
    assert (b8.row_tiles, b8.split, b8.grid) == (33, 1, 132)
    assert b8.h_bytes == 2056 * 5120 * 2 == 21_053_440 and b8.part_bytes == 0
    assert tfm.wide_plan(2056, 1280, 5120, H100_SMS, split=4).part_bytes == 4 * 2056 * 1280 * 4
    assert tfm.wide_plan(257, 1280, 5120, H100_SMS, itemsize=4).h_bytes == 2 * b1.h_bytes


def test_wide_plan_refuses_more_shares_than_steps():
    with pytest.raises(ValueError, match="a split of 5 shares of 4 steps"):
        tfm.wide_plan(40, 1160, 13, H100_SMS, split=5)
    with pytest.raises(ValueError, match="a split of 9 shares"):
        tfm.wide_plan(257, 1280, 5120, H100_SMS, split=9)
    with pytest.raises(ValueError, match="runs mlp_wide.cu"):
        tfm.plan(257, 1280, 5120, H100_SMS)
