"""The arithmetic of ``csrc/window_attention.cu`` (the Swin chain's window
attention: K9's, K11a/b's), emulated in a few lines of PyTorch on the CPU
and held against the port's twin ``window_attention_plain`` and against
K9's attention written in JAX around ``ops/pallas/common.softmax_unnorm``
(nomax, clamp 60), the lines of ``_swin_stage_kernel_pipelined`` with the
roll and partition bracket of JAX ``fused_swin_apply``.

The emulation follows the kernel: each window token's pixel row computed
from its window and offset (the block's ``sRow`` table), q, k and v
gathered from those rows and zero-filled to 16-key chunks (4 up to 64
tokens, 9 up to 144); the fp32 score scaled by one multiply, rounded, then
the bias and the mask added with a rounding after each add; ``exp2(min(s,
60))`` below ``n`` and 0 past it; the row sum over the unrounded fp32 p in
the kernel's order (each lane of a quad in key order, then the quad's two
shuffles); ``1 / max(r, 1e-30)``; ``bf16(p)`` into PV with fp32
accumulation, chunk by chunk; ``O * (1 / r)`` rounded once to bf16 and
scattered back to the query's pixel row.  The anchors of
``bench/window_attention_ab.py`` are checked too;
``tests/test_torch_kernels_cuda.py`` holds the kernel itself to the twin on
the card.

Inputs come from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from edgevisiontransformer_tpu.models import swin as jswin
from edgevisiontransformer_tpu.ops.pallas.common import softmax_unnorm
from edgevisiontransformer_tpu_torch.bench import window_attention_ab
from edgevisiontransformer_tpu_torch.ops.cuda import build
from edgevisiontransformer_tpu_torch.ops.cuda import swin_block as tsb

torch.set_num_threads(1)

CHUNK = 16  # keys per chunk (csrc/window_attention.cu: 4 or 9 chunks)
LOG2E = 1.4426950408889634
CLAMP = 60.0
# fp32: the same math, the scores and sums in another order; bf16: a value
# at most ~2 bf16 spacings off (a bf16(p) or an output rounding flipped),
# the bound the card tests hold the kernel to against the twin
FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2.0 ** -6, atol=1e-2)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def pixel_rows(res, window, shift):
    """``[nW, n]``: the block's ``sRow`` table, token ``t`` of window ``(wy,
    wx)`` reading pixel ``((wy w + t / w + shift) % res, (wx w + t % w +
    shift) % res)``."""
    w, nwx = window, res // window
    t, win = torch.arange(w * w), torch.arange(nwx * nwx)[:, None]
    wy, wx = win // nwx, win % nwx
    return ((wy * w + t // w + shift) % res) * res + (wx * w + t % w + shift) % res


def probs(s, bias, mask, n, scale2):
    """The kernel's ``probs`` over padded scores ``s [.., rows, 16 nc]``:
    ``p = exp2(min(fl(fl(s * scale2) + bias) (+ mask), 60))`` below ``n``, 0
    past it; rows past ``n`` read row ``n - 1`` of the bias and mask."""
    rows, keys = s.shape[-2:]
    at = torch.arange(rows).clamp(max=n - 1)
    pad = (0, keys - n)
    s = s * scale2  # one fp32 rounding
    s = s + F.pad(bias[..., at, :], pad)  # then one for each add
    if mask is not None:
        s = s + F.pad(mask[..., at, :], pad)
    p = torch.exp2(torch.clamp(s, max=CLAMP))
    return p.masked_fill(torch.arange(keys) >= n, 0.0)


def quad_sum_rows(p):
    """The row sums of ``p [.., 16 nc]`` as the kernel adds them: lane ``t``
    of a quad holds keys ``16 c + 8 j + 2 t + e`` and adds them from 0 in
    ``(c, j, e)`` order, then ``(l0 + l1) + (l2 + l3)``."""
    nc = p.shape[-1] // CHUNK
    lanes = []
    for t in range(4):
        acc = torch.zeros(p.shape[:-1], dtype=torch.float32)
        for c in range(nc):
            for j in range(2):
                for e in range(2):
                    acc = acc + p[..., c * CHUNK + 8 * j + 2 * t + e]
        lanes.append(acc)
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def kernel_tiles(qkv, bias, mask, *, res, window, shift, heads, head_dim):
    """``window_attention`` as csrc/window_attention.cu computes it."""
    dt = qkv.dtype
    n = window * window
    nc = 4 if n <= 64 else 9
    rows = CHUNK * nc
    bsz = qkv.shape[0] // (res * res)
    srow = pixel_rows(res, window, shift)  # [nW, n]
    g = qkv.reshape(bsz, res * res, 3, heads, head_dim)[:, srow].float()  # [b, nW, n, 3, h, hd]
    g = F.pad(g, (0, 0, 0, 0, 0, 0, 0, rows - n))  # zero-filled to 16 nc rows
    q, k, v = g.permute(3, 0, 1, 4, 2, 5)  # [b, nW, h, rows, hd]
    s = torch.cat([q @ k[..., c * CHUNK:(c + 1) * CHUNK, :].transpose(-1, -2)
                   for c in range(nc)], dim=-1)
    scale2 = torch.tensor(head_dim ** -0.5 * LOG2E, dtype=torch.float32)
    p = probs(s, bias.float(), None if mask is None else mask.float()[:, None], n, scale2)
    inv = 1.0 / torch.clamp(quad_sum_rows(p), min=1e-30)
    pb = p.to(dt).float()
    o = torch.zeros(q.shape, dtype=torch.float32)
    for c in range(nc):
        o = o + pb[..., c * CHUNK:(c + 1) * CHUNK] @ v[..., c * CHUNK:(c + 1) * CHUNK, :]
    o = (o * inv[..., None]).to(dt)[..., :n, :]  # rows past n dropped
    out = torch.empty((bsz, res * res, heads * head_dim), dtype=dt)
    out[:, srow.reshape(-1)] = o.permute(0, 1, 3, 2, 4).reshape(bsz, -1, heads * head_dim)
    return out.reshape(bsz * res * res, -1)


def jax_reference(qkv, bias, mask, *, res, window, shift, heads, head_dim, dt):
    """K9's attention lines (``ops/pallas/swin_block.py:454-481``) in jnp,
    inside the roll + partition bracket."""
    bsz = qkv.shape[0] // (res * res)
    x = jnp.asarray(qkv).astype(dt).reshape(bsz, res, res, -1)
    if shift:
        x = jnp.roll(x, (-shift, -shift), axis=(1, 2))
    xw = jswin.window_partition(x, window)  # [b nW, n, 3 h hd]
    nw, n = (res // window) ** 2, window * window
    parts = xw.reshape(bsz * nw, n, 3, heads, head_dim)
    outs = []
    for i in range(heads):
        q, k, v = parts[:, :, 0, i], parts[:, :, 1, i], parts[:, :, 2, i]
        s = jnp.einsum("bqd,bkd->bqk", q, k, preferred_element_type=jnp.float32)
        s = s * (head_dim ** -0.5 * LOG2E) + jnp.asarray(bias)[i][None]
        if mask is not None:
            s = (s.reshape(bsz, nw, n, n) + jnp.asarray(mask)[None]).reshape(bsz * nw, n, n)
        p, r = softmax_unnorm(s, dt)
        o = jnp.einsum("bqk,bkd->bqd", p.astype(dt), v, preferred_element_type=jnp.float32)
        outs.append((o * (1.0 / r)).astype(dt))
    o = jnp.concatenate(outs, axis=-1)
    y = jswin.window_reverse(o, window, res, res)
    if shift:
        y = jnp.roll(y, (shift, shift), axis=(1, 2))
    return y.reshape(bsz * res * res, -1)


def _inputs(images, window, heads, hd, dtype, shifted, seed=0, qk_scale=1.0):
    """qkv of ``images`` images of 2 x 2 windows, a log2(e)-scaled fp32 bias
    and, when shifted, the log2(e)-scaled fp32 mask, as
    ``models/swin.prepare_swin_fused`` builds them; the JAX and the torch
    sides hold the same values."""
    rng = np.random.default_rng(seed)
    n, res = window * window, 2 * window
    qkv = rng.standard_normal((images * res * res, 3 * heads * hd)).astype(np.float32)
    qkv[:, :2 * heads * hd] *= qk_scale
    bias = (0.5 * LOG2E * rng.standard_normal((heads, n, n))).astype(np.float32)
    mask = (jswin.shifted_window_mask(res, res, window, window // 2) * np.float32(LOG2E)
            if shifted else None)
    jd, td = DTYPES[dtype]
    tq = torch.from_numpy(np.array(jnp.asarray(qkv).astype(jd).astype(jnp.float32))).to(td)
    tm = None if mask is None else torch.from_numpy(mask)
    return qkv, bias, mask, tq, torch.from_numpy(bias), tm


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("res,window,shift", [(14, 7, 3), (56, 7, 0), (16, 8, 4), (24, 12, 6),
                                              (18, 9, 4), (7, 7, 0)])
def test_pixel_rows_gather_and_scatter_the_rolled_windows(res, window, shift):
    """The block's row table gathers ``torch.roll(-shift)`` +
    ``window_partition`` and scatters back through ``window_reverse`` +
    ``torch.roll(+shift)``: the port's ``window_rows``, bit for bit."""
    srow = pixel_rows(res, window, shift)
    assert torch.equal(srow.reshape(-1), tsb.window_rows(res, window, shift))
    x = torch.from_numpy(
        np.random.default_rng(1).standard_normal((2, res, res, 3)).astype(np.float32))
    got = x.reshape(2, res * res, 3)[:, srow].reshape(-1, window * window, 3)
    want = np.asarray(jswin.window_partition(
        jnp.roll(jnp.asarray(x.numpy()), (-shift, -shift), axis=(1, 2)), window))
    np.testing.assert_array_equal(got.numpy(), want)
    back = torch.empty_like(x).reshape(2, res * res, 3)
    back[:, srow.reshape(-1)] = got.reshape(2, -1, 3)
    assert torch.equal(back.reshape(x.shape), x)  # every pixel written once


# windows 7 (n = 49, 4 chunks: swin_tiny), 8 (64, a full 4 chunks), 9 (81,
# 9 chunks, 63 keys zero-filled) and 12 (144, 9 full chunks: Swin at 384)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("window", [7, 8, 9, 12])
def test_kernel_tiles_match_jax_k9_attention_and_the_twin(window, shifted, hd, dtype):
    images = 2 if window < 12 else 1
    heads, shift = 2, window // 2 if shifted else 0
    qkv, bias, mask, tq, tb, tm = _inputs(images, window, heads, hd, dtype, shifted)
    kw = dict(res=2 * window, window=window, shift=shift, heads=heads, head_dim=hd)
    got = kernel_tiles(tq, tb, tm, **kw)
    assert got.shape == (images * 4 * window ** 2, heads * hd) and got.dtype == tq.dtype
    assert torch.isfinite(got.float()).all()
    tol = FP32 if dtype == "float32" else BF16
    ref = jax_reference(qkv, bias, mask, dt=DTYPES[dtype][0], **kw)
    np.testing.assert_allclose(_np(got), _np(ref), **tol)
    np.testing.assert_allclose(_np(got), _np(tsb.window_attention_plain(tq, tb, tm, **kw)), **tol)


@pytest.mark.parametrize("window", [7, 12])
def test_kernel_tiles_clamp60_rows_tie(window):
    """Large q and k: log2-scaled scores far above 60 clamp, the clamped
    keys of a row tie at 2^60, and the sum stays finite, as in the twin and
    K9 (``test_window_attention_clamp60_rows_tie`` on the card)."""
    heads, hd = 2, 32
    qkv, bias, mask, tq, tb, tm = _inputs(1, window, heads, hd, "bfloat16", True, seed=3,
                                          qk_scale=8.0)
    kw = dict(res=2 * window, window=window, shift=window // 2, heads=heads, head_dim=hd)
    q, k = tq.float()[:, :hd], tq.float()[:, heads * hd:heads * hd + hd]
    assert (q @ k.T * hd ** -0.5 * LOG2E > CLAMP).float().mean() > 0.1
    got = kernel_tiles(tq, tb, tm, **kw)
    assert torch.isfinite(got.float()).all()
    ref = jax_reference(qkv, bias, mask, dt=jnp.bfloat16, **kw)
    np.testing.assert_allclose(_np(got), _np(ref), **BF16)
    np.testing.assert_allclose(_np(got), _np(tsb.window_attention_plain(tq, tb, tm, **kw)),
                               **BF16)


def test_score_rounds_after_the_product_and_after_each_add():
    """``probs`` rounds the product, then each add (the kernel's ``__fmul_rn``
    / ``__fadd_rn``), value for value as numpy's fp32 steps; one rounding of
    the exact expression (what an FMA contraction would give) differs."""
    rng = np.random.default_rng(4)
    n = 49
    s = rng.standard_normal((1, 64, 64)).astype(np.float32) * 40
    bias = rng.standard_normal((1, n, n)).astype(np.float32) * 3
    mask = np.where(rng.random((1, n, n)) < 0.3, np.float32(-100 * LOG2E), np.float32(0))
    scale2 = np.float32(32 ** -0.5 * LOG2E)
    got = probs(torch.from_numpy(s), torch.from_numpy(bias), torch.from_numpy(mask), n,
                torch.tensor(scale2)).numpy()
    x = (((s[:, :n, :n] * scale2).astype(np.float32) + bias).astype(np.float32)
         + mask).astype(np.float32)
    want = torch.exp2(torch.from_numpy(np.minimum(x, np.float32(CLAMP)))).numpy()
    np.testing.assert_array_equal(got[:, :n, :n], want)
    assert (got[:, :, n:] == 0).all()
    once = (s[:, :n, :n].astype(np.float64) * np.float64(scale2) + bias + mask).astype(np.float32)
    assert (once != x).any()


def test_quad_order_row_sum_is_the_sum_in_another_order():
    """The kernel's quad order sums the same values as a plain row sum, to
    fp32 rounding, and is not always its bits (hence the twin bound rather
    than bits against the parent's lane-strided warp_sum)."""
    p = torch.exp2(torch.from_numpy(
        np.random.default_rng(5).standard_normal((64, 144)).astype(np.float32) * 8))
    got = quad_sum_rows(p)
    want = p.double().sum(-1)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=1e-6)
    assert not torch.equal(got, p.sum(-1))


def test_window_attention_ab_finds_every_anchor_in_the_committed_source():
    src = (build.CSRC / "window_attention.cu").read_text()
    found = window_attention_ab.variants(src)
    assert list(found) == [window_attention_ab.COMMITTED, window_attention_ab.L2,
                           window_attention_ab.STAGED]
    assert found[window_attention_ab.COMMITTED] == src
    others = [found[window_attention_ab.L2], found[window_attention_ab.STAGED]]
    assert all(code != src for code in others) and others[0] != others[1]
    assert "stage_bias() { return false; }" in others[0]
    assert "stage_bias() { return true; }" in others[1]
    wmma = window_attention_ab.WMMA_SOURCE
    assert "evt_window_attention_wmma(" in wmma and "evt_window_attention(" not in wmma
    assert "wmma::mma_sync" in wmma and "wmma::" not in src
    assert "load_rows_gather" in src and "store_rows_scatter" in src

