"""The arithmetic of ``csrc/performer.cu`` (K16, the T2T tokenizer's
TokenPerformer), emulated in a few lines of PyTorch on the CPU and held
against the port's twins (``ops/cuda/performer.performer_*_plain``) and
against the JAX whole-TokenPerformer kernel ``performer_rest``
(``ops/pallas/performer.py``) in interpret mode.

The emulation follows the kernels.  ``t w^T`` on ``mma.sync.m16n8k16`` is a
sum of k16 steps, each exact products added in fp64 and rounded to fp32,
then added to the fp32 accumulator.  ``|t|^2``: lane ``t`` of a quad adds the
squares of its columns ``16 kk + (2t, 2t + 1, 2t + 8, 2t + 9)`` by fma in
``kk`` order, then the quad ``(l0 + l1) + (l2 + l3)``.  ``performer_reduce``:
each warp's 16 tokens, ``kp_sum`` added token by token and ``kptv`` by fma
token by token, the four warps of a 64-token tile in warp order, the tiles
of each group of seven in tile order, the groups of an image in group
order.  ``performer_rows``: one warp per 16 tokens, each warp on its
own; ``d`` by fma over each lane's 8
features (``16 c + 8 j + 2 t + e``) then the quad; ``y`` by fma over the 32
features in order, then one division by ``max(d, 1e-8)``; the three 64 x 64
products on bf16 operands as above; the LayerNorm's mean and variance over
each lane's 16 columns (``8 j + 2 t + e``) in order, then the quad, the
variance by fma; the cast points of the twin.  An fma is emulated as one
fp64 multiply-add rounded to fp32 (up to a double rounding).  The anchors
of ``bench/performer_ab.py`` are checked too;
``tests/test_torch_kernels_cuda.py`` holds the kernels themselves to the
twins on the card.

Inputs come from a numpy seed.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.ops.pallas.performer import performer_rest as jax_k16
from edgevisiontransformer_tpu_torch.bench import performer_ab
from edgevisiontransformer_tpu_torch.ops.cuda import build
from edgevisiontransformer_tpu_torch.ops.cuda import performer as tperf

torch.set_num_threads(1)

TS, M = 64, 32
WARP = 16  # tokens a warp owns, in both kernels
INV_SQRT_M = np.float32(1.0 / math.sqrt(M))
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# against the twin: fp32, the same math summed in another order; bf16, a
# value at most ~2 bf16 spacings off, the bound the card tests hold the
# kernels to
FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2.0 ** -6, atol=1e-2)
# against JAX's K16: test_torch_performer.py's bounds (fp32: 1e-5 of the
# largest value; bf16: the JAX package's own bound for K16 against the chain)
JAX_REL = {"float32": 1e-5, "bfloat16": 0.02}


def fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def cast(x, dt):
    """A cast point of the kernels: round to ``dt`` and back to fp32."""
    return x.to(dt).float()


def mma_k16(a, b):
    """``a [.., K] @ b [K, N]`` as mma.sync sums it: k16 steps in order."""
    acc = torch.zeros(*a.shape[:-1], b.shape[1])
    for k0 in range(0, a.shape[-1], 16):
        acc = acc + (a[..., k0:k0 + 16].double() @ b[k0:k0 + 16].double()).float()
    return acc


def quad(lanes):
    """``quad_sum`` over the four lanes' values: ``(l0 + l1) + (l2 + l3)``."""
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def prm_exp(t, w):
    """``prm_exp`` of token rows ``t [.., 64]`` (fp32 values of the operand
    dtype): ``exp(t w^T - |t|^2 / 2) / sqrt(m)``."""
    lanes = []
    for ln in range(4):
        acc = torch.zeros(t.shape[:-1])
        for kk in range(TS // 16):
            for c in (2 * ln, 2 * ln + 1, 2 * ln + 8, 2 * ln + 9):
                x = t[..., 16 * kk + c]
                acc = fma(x, x, acc)
        lanes.append(acc)
    td = quad(lanes) * np.float32(0.5)
    return torch.exp(mma_k16(t, w.T) - td[..., None]) * INV_SQRT_M


def reduce_tiles(x, w, dt):
    """performer_reduce's sums ``[b, m + ts m]`` of ``x [b, n, 192]``."""
    b, n, _ = x.shape
    tiles = -(-n // tperf.TILE)
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, tiles * tperf.TILE - n))
    xf = xf.reshape(b, tiles, tperf.REDUCE_WARPS, WARP, 3 * TS)
    kp = prm_exp(xf[..., :TS], cast(w, dt))
    row = torch.arange(tiles * tperf.TILE).reshape(tiles, tperf.REDUCE_WARPS, WARP, 1)
    kp = kp.masked_fill(row >= n, 0.0)
    v = xf[..., 2 * TS:]
    ksum = torch.zeros(b, tiles, tperf.REDUCE_WARPS, M)
    kptv = torch.zeros(b, tiles, tperf.REDUCE_WARPS, TS, M)
    for r in range(WARP):  # token by token
        ksum = ksum + kp[..., r, :]
        kptv = fma(v[..., r, :, None], kp[..., r, None, :], kptv)
    part = torch.cat([ksum, kptv.flatten(3)], dim=3)
    tile = part[:, :, 0]
    for i in range(1, tperf.REDUCE_WARPS):  # warp order
        tile = tile + part[:, :, i]
    groups = []
    for g0 in range(0, tiles, tperf.GROUP):  # tile order within a group
        group = tile[:, g0]
        for i in range(g0 + 1, min(g0 + tperf.GROUP, tiles)):
            group = group + tile[:, i]
        groups.append(group)
    out = groups[0]
    for group in groups[1:]:  # group order
        out = out + group
    return out


def lane_cols(t):
    """The 16 columns of a 64-wide row lane ``t`` of a quad holds in the
    accumulator layout, in the order it adds them: ``8 j + 2 t + e``."""
    return [8 * j + 2 * t + e for j in range(TS // 8) for e in range(2)]


def warp_rows(q, v, sums, ops, *, eps, approx, dt):
    """The chain of performer_rows for the warps' rows ``q, v [.., 16, 64]``
    (fp32 values of ``dt``)."""
    mats, vecs = ops
    w, wo, w1, w2 = mats[:M], mats[M:M + TS], mats[M + TS:M + 2 * TS], mats[M + 2 * TS:]
    bo, g2, be2, b1, b2 = vecs
    kp_sum, kptv = sums[:M], sums[M:].reshape(TS, M)
    qp = prm_exp(q, w)
    lanes = []
    for t in range(4):
        acc = torch.zeros(q.shape[:-1])
        for c in range(2):
            for j in range(2):
                for e in range(2):
                    f = 16 * c + 8 * j + 2 * t + e
                    acc = fma(qp[..., f], kp_sum[f], acc)
        lanes.append(acc)
    d = torch.clamp(quad(lanes), min=1e-8)
    y = torch.zeros(*q.shape[:-1], TS)
    for f in range(M):  # the features in order
        y = fma(qp[..., f, None], kptv[:, f], y)
    y = y / d[..., None]
    y2 = cast(v + (mma_k16(cast(y, dt), wo) + bo), dt)
    mean = quad([sum_in_order(y2, lane_cols(t)) for t in range(4)]) / TS
    dv = y2 - mean[..., None]
    lanes = []
    for t in range(4):
        acc = torch.zeros(q.shape[:-1])
        for col in lane_cols(t):
            acc = fma(dv[..., col], dv[..., col], acc)
        lanes.append(acc)
    rs = torch.rsqrt(quad(lanes) / TS + eps)
    h = cast(dv * rs[..., None] * g2 + be2, dt)
    hid = cast(mma_k16(h, w1) + b1, dt)
    g = cast(tperf.gelu_kernel(hid, approx), dt)
    return cast(y2 + (mma_k16(g, w2) + b2), dt)


def sum_in_order(x, cols):
    acc = torch.zeros(x.shape[:-1])
    for col in cols:
        acc = acc + x[..., col]
    return acc


def rows_tiles(x, sums, ops, *, eps, approx, dt):
    """performer_rows' output ``[b, n, 64]``: each warp on its 16 tokens,
    every image on its own sums."""
    b, n, _ = x.shape
    warps = -(-n // WARP)
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, warps * WARP - n))
    rows = xf.reshape(b, warps, WARP, 3 * TS)
    out = torch.stack([warp_rows(rows[img, ..., TS:2 * TS], rows[img, ..., 2 * TS:], sums[img],
                                 ops, eps=eps, approx=approx, dt=dt) for img in range(b)])
    return out.reshape(b, warps * WARP, TS)[:, :n].to(dt)


def emulated(x, p, w, *, approx, eps=1e-5):
    dt = x.dtype
    mats = torch.cat([w, p["attn_output"]["kernel"], p["mlp_fc1_kernel"],
                      p["mlp_fc2_kernel"]]).to(dt).float()
    vecs = torch.stack([p["attn_output"]["bias"], p["norm2_scale"], p["norm2_bias"],
                        p["mlp_fc1_bias"], p["mlp_fc2_bias"]]).float()
    sums = reduce_tiles(x, w, dt)
    return rows_tiles(x, sums, (mats, vecs), eps=eps, approx=approx, dt=dt)


@functools.lru_cache(maxsize=None)
def _setup(n: int, dtype: str, seed: int = 0):
    """Params, ``w`` and ``x [2, n, 192]`` from a numpy seed, as
    ``tests/test_torch_performer.py`` makes them, for JAX and the port."""
    r = np.random.RandomState(seed)
    p = {"attn_output": {"kernel": r.randn(TS, TS) * 0.1, "bias": r.randn(TS) * 0.1},
         "norm2_scale": 1 + r.randn(TS) * 0.1, "norm2_bias": r.randn(TS) * 0.1,
         "mlp_fc1_kernel": r.randn(TS, TS) * 0.1, "mlp_fc1_bias": r.randn(TS) * 0.1,
         "mlp_fc2_kernel": r.randn(TS, TS) * 0.1, "mlp_fc2_bias": r.randn(TS) * 0.1}
    p = {k: ({kk: vv.astype(np.float32) for kk, vv in v.items()} if isinstance(v, dict)
             else v.astype(np.float32)) for k, v in p.items()}
    w = (r.randn(M, TS) * 0.3).astype(np.float32)
    x = (r.randn(2, n, 3 * TS) * 0.5).astype(np.float32)
    jd, td = DTYPES[dtype]
    jp = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else jnp.asarray(v)) for k, v in p.items()}
    tp = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else torch.from_numpy(v)) for k, v in p.items()}
    return jp, jnp.asarray(w), jnp.asarray(x).astype(jd), tp, torch.from_numpy(w), \
        torch.from_numpy(x).to(td)


@functools.lru_cache(maxsize=None)
def _jax(n: int, dtype: str, approx: bool) -> np.ndarray:
    jp, jw, jx, _, _, _ = _setup(n, dtype)
    return np.asarray(jax_k16(jx, jp, jw, eps_ln=1e-5, approx_gelu=approx), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [50, 300, 784, 3200])
def test_reduce_tiles_match_the_twin(n, dtype):
    """The warp, tile and group order of the sums against the twin's; 3200
    tokens make 50 tiles, 8 groups."""
    _, _, _, _, tw, tx = _setup(n, dtype)
    got = reduce_tiles(tx, tw, tx.dtype)
    torch.testing.assert_close(got, tperf.performer_reduce_plain(tx, tw), **FP32)


@pytest.mark.parametrize("approx", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [50, 300, 784])
def test_kernel_tiles_match_the_twin_and_jax_k16(n, dtype, approx):
    """n = 784 is stage 2's token count; 50 and 300 leave a tile and a warp
    partly past n, whose rows must stay out of the sums and the output."""
    _, _, _, tp, tw, tx = _setup(n, dtype)
    got = emulated(tx, tp, tw, approx=approx)
    twin = tperf.performer_rest_plain(tx, tp, tw, eps_ln=1e-5, approx_gelu=approx)
    assert got.dtype == twin.dtype and got.shape == (2, n, TS)
    torch.testing.assert_close(got, twin, **(FP32 if dtype == "float32" else BF16))
    ref = _jax(n, dtype, approx)
    rel = float(np.abs(got.float().numpy() - ref).max() / np.abs(ref).max())
    assert rel <= JAX_REL[dtype]


@pytest.mark.parametrize("n", [50, 300])
def test_an_image_is_the_same_bits_alone_in_the_batch_and_in_every_block_size(n):
    """The reduce's partition is a constant (64-token tiles) and each rows
    warp carries its tokens alone (the rows block is a constant four warps,
    which share nothing but what they stage), so the batch does not enter
    an image's arithmetic."""
    _, _, _, tp, tw, tx = _setup(n, "bfloat16")
    batch = emulated(tx, tp, tw, approx=True)
    alone = emulated(tx[1:], tp, tw, approx=True)
    assert torch.equal(alone[0], batch[1])


def test_operands_hold_the_kernels_layout_and_refuse_other_widths():
    _, _, _, tp, tw, _ = _setup(50, "float32")
    ops = tperf.performer_operands(tp, tw)
    mats, vecs = ops["mats"], ops["vecs"]
    assert mats.dtype == torch.bfloat16 and mats.shape == (M + 3 * TS, TS)
    assert vecs.dtype == torch.float32 and vecs.shape == (5, TS)
    for got, ref in zip(mats.split([M, TS, TS, TS]),
                        (tw, tp["attn_output"]["kernel"], tp["mlp_fc1_kernel"],
                         tp["mlp_fc2_kernel"])):
        assert torch.equal(got, ref.to(torch.bfloat16))
    for got, key in zip(vecs, (("attn_output", "bias"), "norm2_scale", "norm2_bias",
                               "mlp_fc1_bias", "mlp_fc2_bias")):
        ref = tp[key[0]][key[1]] if isinstance(key, tuple) else tp[key]
        assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="ts = 64"):
        tperf.performer_operands(tp, tw[:16])
    wide = dict(tp, mlp_fc1_kernel=torch.zeros(TS, 2 * TS))
    with pytest.raises(ValueError, match="64-unit MLP"):
        tperf.performer_operands(wide, tw)


def test_performer_ab_finds_its_anchors_in_the_committed_source():
    src = (build.CSRC / "performer.cu").read_text()
    got = performer_ab.variants(src)
    assert got[performer_ab.COMMITTED] == src
    chunks = got[performer_ab.CHUNKS]
    assert chunks != src
    assert f"constexpr int CHUNK_TILES = {performer_ab.CHUNK_TILES};" in chunks
    assert performer_ab._CHUNK_TOKENS in chunks and performer_ab._TILE_TOKENS not in chunks
    assert performer_ab._CHUNK_GRID in chunks and performer_ab._GRID not in chunks
    assert performer_ab._ADD_PARTIALS in chunks and performer_ab._STAGE not in chunks
    assert chunks.count("  return;\n  // the image's counters") == 1
    for name, warps in ((performer_ab.ROWS_2, 2), (performer_ab.ROWS_1, 1)):
        assert got[name] == src.replace("ROWS_WARPS = 4,", f"ROWS_WARPS = {warps},")
    for name in (performer_ab.NO_SUMS, performer_ab.PREAMBLE, performer_ab.NO_GELU):
        assert got[name] != src and got[name].count("performer_rows_kernel(") == 1
    with pytest.raises(ValueError, match="add_tokens"):
        performer_ab.variants(src.replace("  add_tokens(acc,", "  add_tokens (acc,"))
    with pytest.raises(ValueError, match="ROWS_WARPS"):
        performer_ab.variants(src.replace("ROWS_WARPS = 4,", "ROWS_WARPS = 8,"))
    assert "evt_performer_reduce_old" in performer_ab.OLD_SOURCE
    assert "evt_performer_rows_old" in performer_ab.OLD_SOURCE
