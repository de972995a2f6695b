"""The arithmetic of ``csrc/t2t_stage1.cu`` (K8, the T2T stage-1 tokenizer
``kqv(LN(unfold(img, k7 s4 p2)))``), emulated in a few lines of numpy and
PyTorch on the CPU and held against the port's twin ``stage1_kqv_plain``
and against JAX's ``stage1_kqv_kernel`` in interpret mode.

The emulation follows the kernel.  It stages each token row's three padded
s2d rows from the NCHW image with the kernel's index arithmetic (cell
``(prow, 2 j + 1)`` and ``(prow, 2 j + 2)`` take the two halves of a
16-byte vector of pixels, at a cell stride of 56 values) and reads a
token's A row for shift ``s`` at cell ``(s / 3, x + s % 3)``.  The products
run in k16 steps in order over K = 432 (shift-major, three steps a shift)
into one fp32 accumulator: each step's exact products added in fp64 and
rounded to fp32, then added.  The LN statistics take 4 lanes a token: lane
``p`` adds ``v m`` and ``(v v) m`` for ``k = p, p + 4, ...`` in order, every
product and sum rounded to fp32 (no fma), then the two shuffles (xor 1,
xor 2).  The epilogue is ``((acc - mu c1) rs) + c2``, each operation
rounded to fp32, and one cast to bf16.  The bank groups of the kernel's
ldmatrix addresses and the anchors of ``bench/stage1_ab.py`` are checked
too; ``tests/test_torch_kernels_cuda.py`` holds the kernel itself to the
twin on the card.

Inputs come from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.ops.pallas.t2t_stage1 import stage1_kqv_kernel
from edgevisiontransformer_tpu_torch.bench import stage1_ab
from edgevisiontransformer_tpu_torch.models.t2t_vit import build_stage1_weights
from edgevisiontransformer_tpu_torch.ops.cuda import build
from edgevisiontransformer_tpu_torch.ops.cuda import t2t_stage1 as ts

torch.set_num_threads(1)

EPS = 1e-5
GRID, CH, CS, PCOLS = 56, 48, 56, 66  # csrc/t2t_stage1.cu's staging geometry
H100_SMS = 132
# against the twin and JAX's K8: the kernel tolerance of the card tests
# (fp32 summation order, and rsqrtf against a correctly rounded rsqrt, can
# move a value across a bf16 rounding boundary: ~2 bf16 spacings)
BF16 = dict(rtol=2.0 ** -6, atol=1e-2)


def staged_rows(img, b, y):
    """``[3, 66, 56]`` fp32: the three padded s2d rows of token row ``y`` of
    image ``b`` as the kernel stages them (zeros where no copy lands)."""
    im = img[b].float().numpy()
    sa = np.zeros((3, PCOLS, CS), np.float32)
    for prow in range(3):
        iy = y + prow - 1
        if not 0 <= iy < GRID:
            continue
        for cp in range(12):
            c, phy = cp >> 2, cp & 3
            for j in range(224 // 8):
                v = im[c, iy * 4 + phy, j * 8:j * 8 + 8]
                sa[prow, 2 * j + 1, c * 16 + phy * 4:c * 16 + phy * 4 + 4] = v[:4]
                sa[prow, 2 * j + 2, c * 16 + phy * 4:c * 16 + phy * 4 + 4] = v[4:]
    return sa


def a_rows(sa):
    """``[56, 432]``: each token's A row, shift s at cell ``(s / 3, x + s % 3)``."""
    return np.concatenate([sa[s // 3, s % 3:s % 3 + GRID, :CH] for s in range(9)], axis=1)


def lane_stats(big, m9):
    """The kernel's mu and rs of each token (``big [T, 432]`` fp32)."""
    s1 = np.zeros((big.shape[0], 4), np.float32)
    s2 = np.zeros((big.shape[0], 4), np.float32)
    for k0 in range(0, 432, 4):
        v, m = big[:, k0:k0 + 4], m9[k0:k0 + 4][None]
        s1 = s1 + v * m
        s2 = s2 + (v * v) * m
    for perm in ([1, 0, 3, 2], [2, 3, 0, 1]):
        s1, s2 = s1 + s1[:, perm], s2 + s2[:, perm]
    mu, sq = s1[:, 0] / np.float32(147.0), s2[:, 0] / np.float32(147.0)
    var = (sq - mu * mu) + np.float32(EPS)
    return mu, (np.float32(1.0) / np.sqrt(var)).astype(np.float32)


def kernel_tiles(img, w9, m9, c1, c2):
    """``stage1_kqv`` as csrc/t2t_stage1.cu computes it: ``[b, 3136, d]`` bf16."""
    bsz = img.shape[0]
    big = np.stack([np.concatenate([a_rows(staged_rows(img, b, y)) for y in range(GRID)])
                    for b in range(bsz)])                               # [b, 3136, 432]
    bd = torch.from_numpy(big).double()
    wd = w9.to(torch.bfloat16).double()
    acc = torch.zeros(bsz, big.shape[1], w9.shape[1])
    for k0 in range(0, 432, 16):  # one accumulator, k16 steps in order
        acc = acc + (bd[..., k0:k0 + 16] @ wd[k0:k0 + 16]).float()
    mu, rs = lane_stats(big.reshape(-1, 432), m9.reshape(-1).float().numpy())
    mu, rs = mu.reshape(bsz, -1, 1), rs.reshape(bsz, -1, 1)
    k1, k2 = c1.float().numpy(), c2.float().numpy()
    y = ((acc.numpy() - mu * k1) * rs) + k2
    return big, torch.from_numpy(y.astype(np.float32)).to(torch.bfloat16)


def _inputs(d, bsz=1, seed=0):
    rng = np.random.RandomState(seed + d)
    w = build_stage1_weights(rng.randn(147, d) * 147 ** -0.5, rng.randn(d) * 0.1,
                             1.0 + 0.1 * rng.randn(147), 0.1 * rng.randn(147))
    img = torch.from_numpy(rng.randn(bsz, 3, 224, 224).astype(np.float32)).bfloat16()
    return img, w[0].bfloat16(), w[1], w[2], w[3]


def test_staged_rows_are_the_shift_concat():
    """The kernel's staging and A addressing give ``shift_concat``'s rows,
    borders included."""
    img = torch.from_numpy(np.random.RandomState(5).randn(1, 3, 224, 224).astype(np.float32))
    ref = ts.shift_concat(img.bfloat16()).float().numpy()[0].reshape(GRID, GRID, 432)
    for y in (0, 1, 27, 54, 55):
        np.testing.assert_array_equal(a_rows(staged_rows(img.bfloat16(), 0, y)), ref[y])


def test_ldmatrix_rows_fall_in_eight_bank_groups():
    """Eight consecutive cells (the A rows of one 8 x 8 matrix), eight
    consecutive rows of either W9 slice and of either patch sit in eight
    distinct 16-byte bank groups."""
    for stride in (CS,) + tuple(c + 8 for c in ts.STAGE1_COLS) + tuple(
            c // 2 + 8 for c in ts.STAGE1_COLS):
        assert (stride * 2) % 16 == 0 and (stride * 2 // 16) % 2 == 1
        assert len({(r * stride * 2 // 16) % 8 for r in range(8)}) == 8


@pytest.mark.parametrize("batch,d,cols", [(1, 192, 96), (1, 64, 64), (1, 256, 64), (2, 192, 64),
                                          (4, 192, 64), (32, 192, 64), (1, 128, 64)])
def test_stage1_plan_takes_96_columns_only_where_it_keeps_one_block_an_sm(batch, d, cols):
    assert ts.stage1_plan(batch, d, H100_SMS) == cols
    assert ts._smem_bytes(cols) <= 232448


@pytest.mark.parametrize("d", [64, 192])
def test_kernel_tiles_match_the_twin_and_jax_k8(d):
    img, w9, m9, c1, c2 = _inputs(d)
    _, got = kernel_tiles(img, w9, m9, c1, c2)
    assert got.shape == (1, 3136, d) and torch.isfinite(got.float()).all()
    twin = ts.stage1_kqv_plain(img, w9, m9, c1, c2, EPS)
    np.testing.assert_allclose(got.float().numpy(), twin.float().numpy(), **BF16)
    ref = stage1_kqv_kernel(jnp.asarray(img.float().numpy()).astype(jnp.bfloat16),
                            jnp.asarray(w9.float().numpy()), jnp.asarray(m9.numpy()),
                            jnp.asarray(c1.numpy()), jnp.asarray(c2.numpy()), eps=EPS)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), **BF16)


def test_lane_statistics_are_the_twins_in_another_order():
    """The 4-lane order's mu and rs against fp64 sums of the same masked
    values: fp32 rounding of 108-term sums, at most a few ulps."""
    img, w9, m9, c1, c2 = _inputs(64, seed=7)
    big, _ = kernel_tiles(img, w9, m9, c1, c2)
    big = big.reshape(-1, 432)
    mu, rs = lane_stats(big, m9.reshape(-1).float().numpy())
    m = m9.reshape(-1).double().numpy()
    mu64 = (big.astype(np.float64) * m).sum(-1) / 147.0
    var64 = (big.astype(np.float64) ** 2 * m).sum(-1) / 147.0 - mu64 ** 2
    np.testing.assert_allclose(mu, mu64, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rs, 1.0 / np.sqrt(var64 + EPS), rtol=1e-5)


def test_an_image_gives_the_same_bits_alone_and_in_a_batch():
    """Each block reads one image's rows and writes them: image 1 of a
    b2 batch is image 1 alone."""
    img, w9, m9, c1, c2 = _inputs(64, bsz=2, seed=9)
    _, both = kernel_tiles(img, w9, m9, c1, c2)
    _, alone = kernel_tiles(img[1:], w9, m9, c1, c2)
    assert torch.equal(both[1:], alone)


def test_stage1_ab_finds_every_anchor_in_the_committed_source():
    src = (build.CSRC / "t2t_stage1.cu").read_text()
    got = stage1_ab.variants(src)
    assert got[stage1_ab.COMMITTED] == src
    for name, text in got.items():
        assert name == stage1_ab.COMMITTED or text != src
    assert "evt_t2t_stage1_old" in stage1_ab.OLD_SOURCE
    assert f"constexpr int CS = {CS};" in src
    assert [f"    case {c}: return launch<{c}>(" in src for c in ts.STAGE1_COLS] == [True, True]
    assert ("  return KTOT * w_stride(nt) * 2 + A_BYTES + (KTOT + 2 * MROWS) * 4 + WARPS * 16 * "
            "p_stride(nt) * 2;") in src
