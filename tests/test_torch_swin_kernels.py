"""The plain twins of the port's Swin kernels against the JAX Swin kernels,
run as the JAX package's own tests run them (CPU, Pallas interpret mode):

* ``window_rows`` and ``window_attention_plain`` against explicit
  ``torch.roll`` + ``window_partition`` (exact);
* ``swin_stage_forward_plain`` against K9 ``swin_stage_forward_pipelined``
  (full one-hot permutation at res 14, banded at res 56) and, block by
  block, against K11a and K11b ``swin_block_forward``;
* ``swin_merge_plain`` + ``linear_plain`` against K10 ``swin_merge_forward``.

Inputs and weights are drawn with numpy from a seed and handed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.models import swin as jswin
from edgevisiontransformer_tpu.ops.pallas import swin_block as jsb
from edgevisiontransformer_tpu.ops.pallas.swin_merge import swin_merge_forward
from edgevisiontransformer_tpu_torch.models import swin as tswin
from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as tfe
from edgevisiontransformer_tpu_torch.ops.cuda import swin_block as tsb
from edgevisiontransformer_tpu_torch.ops.cuda import swin_merge as tsm
from edgevisiontransformer_tpu_torch.utils.jax_bridge import to_torch

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LOG2E = 1.4426950408889634
EPS = 1e-5
# fp32: the same math in the same order; fp32 summation order and erf (the
# TPU kernels' polynomial erf, |err| <= 7.2e-7) differ
FP32 = dict(rtol=1e-4, atol=1e-4)
# bf16 stage / block outputs: both sides round at the same points, and a
# one-spacing flip anywhere spreads through the next matmuls: the bound of
# the bf16 encoder tests (tests/test_torch_encoder.py), 3% of the largest
# magnitude, the typical element within 2^-7
BF16_MAX, BF16_MEDIAN = 0.03, 2.0 ** -7
# one bf16 op (the merge): a value at most ~2 bf16 spacings off
BF16_OP = dict(rtol=2.0 ** -6, atol=1e-2)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _check(got, ref, dtype):
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, **FP32)
        return
    err = np.abs(got - ref)
    assert err.max() <= BF16_MAX * np.abs(ref).max(), (err.max(), np.abs(ref).max())
    assert np.median(err) <= BF16_MEDIAN * np.median(np.abs(ref)), np.median(err)


def _random_stage(seed, depth, c, hidden, heads, w, res, qkv_bias=True):
    """Numpy weights of a stage, as JAX per-block dicts (raw ``[heads, n, n]``
    bias, raw mask) for both packages."""
    rng = np.random.default_rng(seed)
    n = w * w

    def mat(k, m):
        return (rng.standard_normal((k, m)) * k ** -0.5).astype(np.float32)

    def vec(m, scale=0.1, base=0.0):
        return (base + scale * rng.standard_normal(m)).astype(np.float32)

    blocks = []
    for _ in range(depth):
        blocks.append({
            "ln1_g": vec(c, base=1.0), "ln1_b": vec(c),
            "qkv_w": mat(c, 3 * c),
            "qkv_b": vec(3 * c) if qkv_bias else np.zeros(3 * c, np.float32),
            "proj_w": mat(c, c), "proj_b": vec(c),
            "ln2_g": vec(c, base=1.0), "ln2_b": vec(c),
            "fc1_w": mat(c, hidden), "fc1_b": vec(hidden),
            "fc2_w": mat(hidden, c), "fc2_b": vec(c),
            "bias": (0.5 * rng.standard_normal((heads, n, n))).astype(np.float32),
        })
    mask = jswin.shifted_window_mask(res, res, w, w // 2) if res > w and depth > 1 else None
    return blocks, mask


def _jax_block(blk, dt):
    """K11's per-block params: matmul weights and biases in the compute
    dtype, LN affines fp32 (``models/swin._block_kernel_params``)."""
    keep = ("ln1_g", "ln1_b", "ln2_g", "ln2_b")
    return {k: jnp.asarray(v) if k in keep else jnp.asarray(v).astype(dt)
            for k, v in blk.items() if k != "bias"}


def _port_stage(blocks, mask, td):
    """The stage of ``models/swin.prepare_swin_fused`` from the same weights."""
    keep = ("ln1_g", "ln1_b", "ln2_g", "ln2_b")
    stage = {k: torch.stack([to_torch(b[k]) if k in keep else to_torch(b[k]).to(td)
                             for b in blocks]) for k in blocks[0] if k != "bias"}
    stage["bias"] = [to_torch(b["bias"]) * LOG2E for b in blocks]
    stage["mask"] = to_torch(mask) * LOG2E if mask is not None else None
    return stage


def _image(seed, b, res, c, td):
    x = np.random.default_rng(seed).standard_normal((b, res, res, c)).astype(np.float32)
    return x, torch.from_numpy(x).to(td)


# ---------------------------------------------------------------------------
# The shifted-window bracket as index arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("res,w,shift", [(14, 7, 3), (56, 7, 3), (8, 4, 2), (28, 7, 0),
                                         (7, 7, 0)])
def test_window_rows_equal_roll_and_partition(res, w, shift):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, res, res, 5)))
    idx = tsb.window_rows(res, w, shift)
    got = x.reshape(2, res * res, 5)[:, idx].reshape(-1, w * w, 5)
    ref = tswin.window_partition(torch.roll(x, (-shift, -shift), (1, 2)), w)
    assert torch.equal(got, ref)
    # the reverse bracket: writing each window token back to its row is
    # window_reverse followed by the roll by +shift
    back = torch.empty_like(x).reshape(2, res * res, 5)
    back[:, idx] = ref.reshape(2, -1, 5)
    ref_back = torch.roll(tswin.window_reverse(ref, w, res, res), (shift, shift), (1, 2))
    assert torch.equal(back.reshape(x.shape), ref_back)
    assert torch.equal(ref_back, x)


@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_plain_equals_explicit_roll_partition(shifted):
    """The twin's index arithmetic against the bracket written out: roll,
    partition, the same per-window math, reverse, roll back: bit for bit."""
    res, w, heads, hd, b = 14, 7, 2, 16, 2
    shift = w // 2 if shifted else 0
    blocks, mask = _random_stage(1, 2, heads * hd, 8, heads, w, res)
    stage = _port_stage(blocks, mask, torch.float32)
    m = stage["mask"] if shifted else None
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((b * res * res, 3 * heads * hd)).astype(np.float32))
    got = tsb.window_attention_plain(qkv, stage["bias"][1], m, res=res, window=w, shift=shift,
                                     heads=heads, head_dim=hd)

    img = torch.roll(qkv.reshape(b, res, res, -1), (-shift, -shift), (1, 2))
    win = tswin.window_partition(img, w)  # [b*nW, n, 3*h*hd]
    nw, n = (res // w) ** 2, w * w
    parts = win.reshape(b, nw, n, 3, heads, hd).permute(3, 0, 1, 4, 2, 5)
    s = (parts[0] @ parts[1].transpose(-1, -2)) * (hd ** -0.5 * LOG2E) + stage["bias"][1]
    if m is not None:
        s = s + m[None, :, None]
    p = torch.exp2(torch.clamp(s, max=60.0))
    r = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    o = (p @ parts[2]) * (1.0 / r)
    o = o.permute(0, 1, 3, 2, 4).reshape(b * nw, n, heads * hd)
    ref = torch.roll(tswin.window_reverse(o, w, res, res), (shift, shift), (1, 2))
    assert torch.equal(got, ref.reshape(b * res * res, -1))


# ---------------------------------------------------------------------------
# K9: the whole-stage kernel
# ---------------------------------------------------------------------------


def _jax_stage_kernel(blocks, mask, x, *, res, w, heads, dt):
    n = w * w
    n_pad = -(-n // 8) * 8
    jb = [_jax_block(b, dt) for b in blocks]
    stacked = {k: jnp.stack([b[k].reshape(1, -1) if b[k].ndim == 1 else b[k] for b in jb])
               for k in jb[0]}
    biases = jnp.stack([jsb._padded_bias(jnp.asarray(b["bias"]), n, n_pad) for b in blocks])
    xw = jswin.window_partition(jnp.asarray(x).astype(dt), w)
    out = jsb.swin_stage_forward_pipelined(
        xw, stacked, biases, heads=heads, head_dim=x.shape[-1] // heads, eps=EPS,
        nwin=(res // w) ** 2, res=res, window=w,
        mask=jnp.asarray(mask) if mask is not None else None)
    return jswin.window_reverse(out, w, res, res)


@pytest.mark.parametrize("dtype,res,c,heads,b", [
    ("float32", 14, 64, 2, 2),    # R = 4 * 56 = 224 rows: the one-hot permutation
    ("bfloat16", 14, 64, 2, 2),
    ("float32", 56, 32, 1, 1),    # R = 3584 > 1024: the banded permutation
])
def test_stage_forward_plain_matches_jax_stage_kernel(dtype, res, c, heads, b):
    jd, td = DTYPES[dtype]
    w = 7
    blocks, mask = _random_stage(3, 2, c, 2 * c, heads, w, res)
    x, tx = _image(4, b, res, c, td)
    ref = _jax_stage_kernel(blocks, mask, x, res=res, w=w, heads=heads, dt=jd)
    got = tsb.swin_stage_forward_plain(tx.reshape(-1, c), _port_stage(blocks, mask, td),
                                       res=res, window=w, heads=heads, head_dim=c // heads,
                                       eps=EPS)
    _check(got.reshape(b, res, res, c), ref, dtype)


def test_stage_forward_odd_depth_one_window_matches_jax_stage_kernel():
    """Depth 3 with one window (nwin 1, as every variant's last stage at
    224): no shift, and the odd tail block runs."""
    blocks, mask = _random_stage(5, 3, 64, 128, 2, 7, 7)
    assert mask is None
    x, tx = _image(6, 2, 7, 64, torch.float32)
    ref = _jax_stage_kernel(blocks, None, x, res=7, w=7, heads=2, dt=jnp.float32)
    got = tsb.swin_stage_forward_plain(tx.reshape(-1, 64), _port_stage(blocks, None,
                                                                       torch.float32),
                                       res=7, window=7, heads=2, head_dim=32, eps=EPS)
    _check(got.reshape(2, 7, 7, 64), ref, "float32")


# ---------------------------------------------------------------------------
# K11a / K11b: the per-block kernels
# ---------------------------------------------------------------------------


def _jax_blocks(blocks, mask, x, *, res, w, heads, dt):
    """K11 block by block, as JAX ``fused_swin_apply`` runs a stage the
    whole-stage kernel refuses: roll + partition, the block, reverse + roll."""
    c, n = x.shape[-1], w * w
    xs = jnp.asarray(x).astype(dt)
    for bi, blk in enumerate(blocks):
        shift = w // 2 if bi % 2 == 1 and w < res else 0
        if shift:
            xs = jnp.roll(xs, (-shift, -shift), axis=(1, 2))
        # the prepared (fp32, log2(e)-scaled) bias, as every CLI caller passes it
        bias = jsb._padded_bias(jnp.asarray(blk["bias"]), n, -(-n // 8) * 8)
        out = jsb.swin_block_forward(
            jswin.window_partition(xs, w), _jax_block(blk, dt), bias,
            jnp.asarray(mask) if shift else None, heads=heads, head_dim=c // heads, eps=EPS,
            bias_prepadded=True)
        xs = jswin.window_reverse(out, w, res, res)
        if shift:
            xs = jnp.roll(xs, (shift, shift), axis=(1, 2))
    return xs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stage_forward_plain_matches_jax_block_kernel_k11a(dtype):
    jd, td = DTYPES[dtype]
    res, w, c, heads, b = 14, 7, 64, 2, 2
    blocks, mask = _random_stage(7, 2, c, 4 * c, heads, w, res)
    x, tx = _image(8, b, res, c, td)
    ref = _jax_blocks(blocks, mask, x, res=res, w=w, heads=heads, dt=jd)
    got = tsb.swin_stage_forward_plain(tx.reshape(-1, c), _port_stage(blocks, mask, td),
                                       res=res, window=w, heads=heads, head_dim=c // heads,
                                       eps=EPS)
    _check(got.reshape(b, res, res, c), ref, dtype)


def test_stage_forward_plain_matches_jax_block_kernel_k11b():
    """fp32 C = 512, hidden 2048: 12.6 MB of weights (> 6 MB) and hidden a
    multiple of 1024, so JAX takes the MLP-streaming kernel K11b."""
    res, w, c, heads = 7, 7, 512, 16
    blocks, _ = _random_stage(9, 1, c, 4 * c, heads, w, res)
    assert (3 * c * c + c * c + 2 * c * 4 * c) * 4 > 6 * 1024 * 1024
    x, tx = _image(10, 1, res, c, torch.float32)
    ref = _jax_blocks(blocks, None, x, res=res, w=w, heads=heads, dt=jnp.float32)
    got = tsb.swin_stage_forward_plain(tx.reshape(-1, c), _port_stage(blocks, None,
                                                                      torch.float32),
                                       res=res, window=w, heads=heads, head_dim=c // heads,
                                       eps=EPS)
    _check(got.reshape(1, res, res, c), ref, "float32")


def test_cpu_stage_forward_takes_the_twins_and_counts_no_launch():
    blocks, mask = _random_stage(11, 2, 64, 128, 2, 7, 14)
    stage = _port_stage(blocks, mask, torch.bfloat16)
    _, tx = _image(12, 1, 14, 64, torch.bfloat16)
    kw = dict(res=14, window=7, heads=2, head_dim=32, eps=EPS)
    tfe.reset_launches()
    tsb.reset_launches()
    got = tsb.swin_stage_forward(tx.reshape(-1, 64), stage, **kw)
    assert torch.equal(got, tsb.swin_stage_forward_plain(tx.reshape(-1, 64), stage, **kw))
    assert sum(tfe.LAUNCHES.values()) == 0 and tsb.LAUNCHES == {"window_attention": 0}


# ---------------------------------------------------------------------------
# K10: patch merging
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_plain_matches_jax_merge_kernel(dtype):
    """res 28 -> 14 (two output window-row bands), window 7."""
    jd, td = DTYPES[dtype]
    res, w, c, b = 28, 7, 32, 2
    n, n_pad = w * w, 56
    rng = np.random.default_rng(13)
    x, tx = _image(14, b, res, c, td)
    g = (1.0 + 0.1 * rng.standard_normal(4 * c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(4 * c)).astype(np.float32)
    kern = (rng.standard_normal((4 * c, 2 * c)) * (4 * c) ** -0.5).astype(np.float32)
    xw = jswin.window_partition(jnp.asarray(x).astype(jd), w)
    xw = jnp.pad(xw, ((0, 0), (0, n_pad - n), (0, 0)))
    out = swin_merge_forward(xw, {"norm_scale": jnp.asarray(g), "norm_bias": jnp.asarray(beta),
                                  "kernel": jnp.asarray(kern)}, res=res, window=w, eps=EPS)
    ref = jswin.window_reverse(out[:, :n], w, res // 2, res // 2)
    h = tsm.swin_merge_plain(tx.reshape(-1, c), to_torch(g), to_torch(beta), res=res, eps=EPS)
    got = tfe.linear_plain(h, to_torch(kern).to(td), torch.zeros(2 * c, dtype=td),
                           epilogue=tfe.CAST_THEN_BIAS)
    got, ref = _f32(got.reshape(b, res // 2, res // 2, 2 * c)), _f32(ref)
    np.testing.assert_allclose(got, ref, **(FP32 if dtype == "float32" else BF16_OP))


def test_merge_gather_is_the_permuted_reference_concat():
    """The (dy, dx, c) gather with ``_merge_perm``-permuted features is the
    module's [x0; x1; x2; x3] concat."""
    res, c = 6, 3
    x = torch.arange(2 * res * res * c, dtype=torch.float32).reshape(2, res, res, c)
    ref = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                    dim=-1).reshape(-1, 4 * c)
    got = tsm.merge_gather(x.reshape(-1, c), res)
    perm = torch.from_numpy(tswin._merge_perm(c)).long()
    assert torch.equal(got, ref[:, perm])
    np.testing.assert_array_equal(tswin._merge_perm(c), jswin._merge_perm(c))
