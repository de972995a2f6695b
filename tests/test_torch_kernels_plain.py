"""Each CUDA kernel's plain PyTorch twin against the JAX kernel code it
ports (ops/cuda/fused_encoder.py vs ops/pallas/fused_encoder.py).

On the CPU the wrappers take the twins, so these tests also cover the
wrappers' CPU path.  Inputs come from numpy with a fixed seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from edgevisiontransformer_tpu.ops.pallas import common as jcommon
from edgevisiontransformer_tpu.ops.pallas import fused_encoder as jfe
from edgevisiontransformer_tpu.ops.pallas import mathlib as jmath
from edgevisiontransformer_tpu_torch.ops.cuda import build
from edgevisiontransformer_tpu_torch.ops.cuda import common as tcommon
from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as tfe
from edgevisiontransformer_tpu_torch.ops.cuda import mathlib as tmath

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a: np.ndarray, name: str):
    jd, td = DTYPES[name]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _ulps_bf16(got, ref, max_ulps):
    """|got - ref| <= max_ulps bf16 spacings (2^-7 relative) of ref, plus
    one spacing at 1/2 of max|ref|: a value that came out of a cancellation
    (``bf16(acc) + b`` near 0) carries the absolute error of its operands."""
    g, r = _f32(got), _f32(ref)
    atol = 2.0 ** -8 * np.abs(r).max() + 1e-6
    np.testing.assert_array_less(np.abs(g - r), max_ulps * 2.0 ** -7 * np.abs(r) + atol)


# ---------------------------------------------------------------------------
# ln_rows vs fused_encoder._ln
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,dim", [(197, 192), (50, 64)])
def test_ln_rows_plain_matches_jax_ln(dtype, rows, dim):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((rows, dim)) * 3 + 1).astype(np.float32)
    g = (rng.standard_normal(dim) + 1).astype(np.float32)
    b = rng.standard_normal(dim).astype(np.float32)
    (jx, tx), (jg, tg), (jb, tb) = _both(x, dtype), _both(g, dtype), _both(b, dtype)
    ref = jfe._ln(jx, jg, jb, 1e-6).astype(DTYPES[dtype][0])
    got = tfe.ln_rows(tx, tg, tb, 1e-6)
    assert got.dtype == DTYPES[dtype][1]
    if dtype == "float32":
        # same fp32 formula, different summation order: a few fp32 ulps
        np.testing.assert_allclose(_f32(got), _f32(ref), rtol=1e-5, atol=1e-5)
    else:
        # same fp32 values rounded once to bf16: an fp32-ulp difference can
        # cross a rounding boundary, so allow one bf16 spacing
        _ulps_bf16(got, ref, 1)


# ---------------------------------------------------------------------------
# linear epilogues vs the kernel's cast points (fused_encoder.py:202-243)
# ---------------------------------------------------------------------------


def _jax_epilogue(h, w, b, res, epilogue, approx, dt):
    """The TPU kernel's lines for each matmul, verbatim."""
    acc = jax.lax.dot(h, w, preferred_element_type=jnp.float32)
    if epilogue == tfe.BIAS_RESIDUAL:
        return (acc + b.astype(jnp.float32) + res.astype(jnp.float32)).astype(dt)
    y = acc.astype(dt) + b
    if epilogue == tfe.CAST_THEN_BIAS_GELU:
        y = jmath.gelu_kernel(y, approx).astype(dt)
    return y


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue,approx", [
    (tfe.CAST_THEN_BIAS, False),
    (tfe.CAST_THEN_BIAS_GELU, False),
    (tfe.CAST_THEN_BIAS_GELU, True),
    (tfe.BIAS_RESIDUAL, False),
])
def test_linear_plain_matches_kernel_epilogues(dtype, epilogue, approx):
    rng = np.random.default_rng(1)
    m, k, n = 197, 192, 256
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    b = (rng.standard_normal(n) * 0.5).astype(np.float32)
    r = rng.standard_normal((m, n)).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb), (jr, tr) = (_both(a, dtype) for a in (x, w, b, r))
    res_j, res_t = (jr, tr) if epilogue == tfe.BIAS_RESIDUAL else (None, None)
    ref = _jax_epilogue(jx, jw, jb, res_j, epilogue, approx, DTYPES[dtype][0])
    got = tfe.linear(tx, tw, tb, epilogue=epilogue, res=res_t, approx_gelu=approx)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (m, n)
    if dtype == "float32":
        # fp32 sums of 192 terms in another order; the exact-GELU kernel
        # uses a polynomial erf (|err| <= 7.2e-7, times |x|/2)
        np.testing.assert_allclose(_f32(got), _f32(ref), rtol=1e-5, atol=1e-5)
    else:
        # cast points are identical; fp32 order can flip each of the (up to)
        # two bf16 roundings by one spacing, and JAX evaluates the tanh GELU
        # in bf16 arithmetic where the twin uses fp32 (a few more spacings)
        _ulps_bf16(got, ref, 4 if approx else 2)


def test_linear_refuses_bad_epilogue_arguments():
    x, w, b = torch.zeros(4, 8), torch.zeros(8, 8), torch.zeros(8)
    with pytest.raises(ValueError):
        tfe.linear(x, w, b, epilogue="nope")
    with pytest.raises(ValueError):
        tfe.linear(x, w, b, epilogue=tfe.BIAS_RESIDUAL)  # res missing
    with pytest.raises(ValueError):
        tfe.linear(x, w, b, epilogue=tfe.CAST_THEN_BIAS, res=torch.zeros(4, 8))


# ---------------------------------------------------------------------------
# attention_rows vs fused_encoder._attention_rows (run inside an interpret-mode
# pallas_call: pl.reciprocal has no rule outside a kernel)
# ---------------------------------------------------------------------------


def _jax_attention_rows(qkv, *, bm, n_pad, heads, head_dim, seq_len, dtype):
    def kernel(q_ref, o_ref):
        col = jax.lax.broadcasted_iota(jnp.int32, (n_pad, n_pad), 1)
        o_ref[...] = jfe._attention_rows(
            q_ref[...], bm=bm, n_pad=n_pad, heads=heads, head_dim=head_dim,
            key_mask=col < seq_len, scale=head_dim ** -0.5, dtype=dtype)

    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((bm * n_pad, heads * head_dim), dtype),
        interpret=True)(qkv)


def _qkv(bm, n, heads, hd, seed=2, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bm, n, 3 * heads * hd)) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_rows_plain_unpadded_matches_jax_padded(dtype):
    """The TPU pads 197 tokens to 200 and masks the pad keys; the port runs
    unpadded.  Rows 0..196 of each image must agree."""
    bm, n, n_pad, heads, hd = 2, 197, 200, 3, 64
    q = _qkv(bm, n, heads, hd)
    qp = np.zeros((bm, n_pad, q.shape[-1]), np.float32)
    qp[:, :n] = q
    jq, _ = _both(qp.reshape(bm * n_pad, -1), dtype)
    _, tq = _both(q.reshape(bm * n, -1), dtype)
    ref = _jax_attention_rows(jq, bm=bm, n_pad=n_pad, heads=heads, head_dim=hd,
                              seq_len=n, dtype=DTYPES[dtype][0])
    ref = _f32(ref).reshape(bm, n_pad, -1)[:, :n].reshape(bm * n, -1)
    got = tfe.attention_rows(tq, heads=heads, head_dim=hd, tokens=n)
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), ref, rtol=1e-5, atol=1e-5)
    else:
        # p is rounded to bf16 before PV in both; an fp32-ulp difference in
        # the score sum can flip a p rounding, and the output rounding once
        np.testing.assert_allclose(_f32(got), ref, rtol=2 ** -6, atol=2e-3)


@pytest.mark.parametrize("case", ["padded", "fully_masked", "clamp60"])
def test_attention_rows_plain_corners_match_jax(case):
    bm, n_pad, heads, hd = 2, 24, 2, 32
    seq_len = {"padded": 21, "fully_masked": 0, "clamp60": 24}[case]
    q = _qkv(bm, n_pad, heads, hd, seed=3)
    if case == "clamp60":
        # scores * hd^-1/2 * log2e far above 60 for some rows: exp2 clamps
        # and those rows tie, unlike an eager softmax
        q[:, :4, : 2 * heads * hd] *= 6.0
    flat = q.reshape(bm * n_pad, -1)
    ref = _f32(_jax_attention_rows(jnp.asarray(flat), bm=bm, n_pad=n_pad, heads=heads,
                                   head_dim=hd, seq_len=seq_len, dtype=jnp.float32))
    got = tfe.attention_rows(torch.from_numpy(flat), heads=heads, head_dim=hd,
                             tokens=n_pad, seq_len=seq_len)
    np.testing.assert_allclose(_f32(got), ref, rtol=1e-5, atol=1e-5)
    if case == "fully_masked":
        assert not np.any(_f32(got))
    if case == "clamp60":
        s = np.einsum("bqd,bkd->bqk", q[:, :4, :hd], q[:, :, heads * hd:heads * hd + hd])
        assert (s * hd ** -0.5 * np.log2(np.e)).max() > 60


# ---------------------------------------------------------------------------
# gelu_kernel and softmax_unnorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("approx", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_kernel_matches_jax(approx, dtype):
    x = np.linspace(-8, 8, 4001).astype(np.float32)
    jx, tx = _both(x, dtype)
    ref = jmath.gelu_kernel(jx, approx)
    got = tmath.gelu_kernel(tx, approx)
    assert got.dtype == DTYPES[dtype][1]
    if dtype == "float32":
        # tanh form: same formula.  Exact form: true erf against the TPU
        # kernel's polynomial erf (|err| <= 7.2e-7), times |x|/2 <= 4
        np.testing.assert_allclose(_f32(got), _f32(ref), rtol=1e-6,
                                   atol=1e-6 if approx else 4e-6)
    else:
        # JAX evaluates the tanh form in bf16 arithmetic; the port in fp32
        # with one rounding
        _ulps_bf16(got, ref, 4 if approx else 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_softmax_unnorm_matches_jax(dtype):
    rng = np.random.default_rng(4)
    s = (rng.standard_normal((3, 40)) * 20).astype(np.float32)
    s[0, 30:] = -1e30  # masked keys
    s[1, :] = -1e30    # a fully masked row
    s[2, 5] = 90.0     # clamped score
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    jp, jr = jcommon.softmax_unnorm(jnp.asarray(s), jd)
    tp, tr = tcommon.softmax_unnorm(torch.from_numpy(s), td)
    # XLA's and torch's exp2 differ by a few fp32 ulps
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=0)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# Wrapper dispatch on the CPU
# ---------------------------------------------------------------------------


def test_cpu_wrappers_take_the_twins_and_count_no_launch():
    tfe.reset_launches()
    x = torch.randn(10, 16)
    g, b = torch.ones(16), torch.zeros(16)
    torch.testing.assert_close(tfe.ln_rows(x, g, b, 1e-6), tfe.ln_rows_plain(x, g, b, 1e-6),
                               rtol=0, atol=0)
    w = torch.randn(16, 24)
    tfe.linear(x, w, torch.zeros(24), epilogue=tfe.CAST_THEN_BIAS)
    tfe.attention_rows(torch.randn(10, 3 * 2 * 8), heads=2, head_dim=8, tokens=5)
    q, sc = tfe.quant_rows(x)
    tfe.linear_i8(q, sc, torch.ones(16, 16, dtype=torch.int8), torch.ones(16), torch.zeros(16),
                  epilogue=tfe.BIAS, out_dtype=torch.float32)
    assert tfe.LAUNCHES == {"ln_rows": 0, "linear": 0, "attention_rows": 0,
                            "quant_rows": 0, "linear_i8": 0}


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    x = torch.empty(10, 16, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        tfe.ln_rows(x, torch.ones(16), torch.zeros(16), 1e-6)
    with pytest.raises(ValueError):
        tfe.attention_rows(torch.empty(10, 48, device="meta"), heads=2, head_dim=8, tokens=5)


def test_build_names_library_by_source_hash():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert path == build.library_path()
    assert {p.name for p in build.sources()} >= {"ln_rows.cu", "linear.cu",
                                                 "attention_rows.cu", "quant_rows.cu",
                                                 "linear_i8.cu", "t2t_stage1.cu",
                                                 "window_attention.cu", "swin_merge.cu",
                                                 "common.cuh"}
