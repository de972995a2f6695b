"""The port's int8 quantization against the JAX package's on the same
params and inputs: weights, scales and act_inv bit for bit; the in-kernel
activation quantization of the TPU int8 kernels (run in interpret mode) bit
for bit; calibration to rtol 1e-5; the eager int8 oracles."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from edgevisiontransformer_tpu.models import vit as jvit
from edgevisiontransformer_tpu.ops import quant as jq
from edgevisiontransformer_tpu.ops.pallas import fused_encoder as jfe
from edgevisiontransformer_tpu_torch.models import vit as tvit
from edgevisiontransformer_tpu_torch.ops import quant as tq
from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as tfe
from edgevisiontransformer_tpu_torch.utils.jax_bridge import (flatten_tree, load_jax_params,
                                                              quantized_stack_from_jax,
                                                              stacked_from_params, to_torch)

torch.set_num_threads(1)

NARROW = dict(image_size=32, dim=64, depth=2, heads=2, mlp_dim=128, num_classes=10)
LAYERWISE = dict(NARROW, depth=2, heads_per_layer=(2, 1), mlp_dim_per_layer=(128, 64))
CONFIGS = {"narrow": NARROW, "layerwise": LAYERWISE}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _models(size: str = "narrow", dtype: str = "float32", style: str = "standard"):
    jd, td = DTYPES[dtype]
    jmodel = jvit.ViT(jvit.deit_config("tiny", style, dtype=jd, **CONFIGS[size]))
    n = jmodel.config.image_size
    variables = jmodel.init(jax.random.key(3), jnp.ones((1, 3, n, n)))
    rng = np.random.default_rng(5)
    params = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
                          if a.ndim == 1 else a, variables["params"])
    # one all-zero output channel: its weight scale is the 1.0 fallback
    params["block_0"]["attn"]["out_kernel"] = params["block_0"]["attn"]["out_kernel"].at[:, 3].set(0)
    variables = {"params": params}
    tmodel = tvit.ViT(tvit.deit_config("tiny", style, dtype=td, **CONFIGS[size]), device="cpu")
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    img = rng.standard_normal((2, 3, n, n)).astype(np.float32)
    return jmodel, variables, tmodel, img


def _scales(depth: int) -> np.ndarray:
    return np.random.default_rng(11).uniform(0.01, 0.2, (depth, 4)).astype(np.float32)


def _assert_trees_equal(got, want, path=""):
    """``got`` (torch leaves) equals ``want`` (JAX leaves) leaf for leaf,
    dtype and bits; a ``{"segments": [...]}`` stack segment by segment."""
    if "segments" in want:
        assert len(got["segments"]) == len(want["segments"]), path
        for i, (g, w) in enumerate(zip(got["segments"], want["segments"])):
            _assert_trees_equal(g, w, f"{path} segment {i}")
        return
    g, w = flatten_tree(got), flatten_tree(jax.tree.map(np.asarray, want))
    assert sorted(g) == sorted(w), (path, sorted(set(g) ^ set(w)))
    for k in w:
        ref = to_torch(w[k])
        assert g[k].dtype == ref.dtype, (path, k, g[k].dtype, ref.dtype)
        assert g[k].shape == ref.shape, (path, k)
        assert torch.equal(g[k], ref), (path, k, (g[k].float() - ref.float()).abs().max())


# ---------------------------------------------------------------------------
# Weights, stacks and trees: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 192), (192, 576), (768, 24)])
def test_quantize_weight_int8_bit_exact(shape):
    rng = np.random.default_rng(shape[0])
    w = (rng.standard_normal(shape) * rng.uniform(1e-3, 3, shape[1])).astype(np.float32)
    w[:, 1] = 0.0
    jqv, js = jq.quantize_weight_int8(jnp.asarray(w))
    tqv, ts = tq.quantize_weight_int8(torch.from_numpy(w))
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[1] == 1.0
    np.testing.assert_array_equal(tq.dequantize_weight_int8(tqv, ts).numpy(),
                                  np.asarray(jq.dequantize_weight_int8(jqv, js)))


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_quantize_vit_params_int8_bit_exact(mode):
    _, variables, tmodel, _ = _models()
    if mode == "dynamic":
        want = jq.quantize_vit_params_int8(variables)
        got = tq.quantize_vit_params_int8({"params": tmodel.params()})
    else:
        want = jq.quantize_vit_params_int8_static(variables, _scales(2))
        got = tq.quantize_vit_params_int8_static({"params": tmodel.params()}, _scales(2))
    _assert_trees_equal(got, want, mode)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_quantize_stacked_int8_bit_exact(mode):
    _, variables, _, _ = _models()
    p = variables["params"]
    jst = jfe.stack_vit_layer_params(p, 2, True)
    tst = stacked_from_params(jax.tree.map(np.asarray, p), 2, True)
    if mode == "dynamic":
        want, got = jfe.quantize_stacked_int8(jst), tfe.quantize_stacked_int8(tst)
    else:
        want = jfe.quantize_stacked_int8_static(jst, _scales(2))
        got = tfe.quantize_stacked_int8_static(tst, _scales(2))
        assert "act_inv" in got
    _assert_trees_equal(got, want, mode)


@pytest.mark.parametrize("size", ["narrow", "layerwise"])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_prepare_vit_int8_bit_exact(mode, size):
    jmodel, variables, tmodel, _ = _models(size)
    if mode == "dynamic":
        want = jvit.prepare_vit_int8(jmodel, variables)
        got = tvit.prepare_vit_int8(tmodel)
    else:
        want = jvit.prepare_vit_int8_static(jmodel, variables, act_scales=_scales(2))
        got = tvit.prepare_vit_int8_static(tmodel, act_scales=_scales(2))
    assert ("segments" in got) == (size == "layerwise")
    _assert_trees_equal(got, want, mode)
    _assert_trees_equal(quantized_stack_from_jax(jax.tree.map(np.asarray, want)), want, "bridge")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_stacks_from_quantized_tree_bit_exact(mode, dtype):
    """Re-stacking a saved quantized tree matches the JAX function in both
    dtypes, and matches prepare_vit_int8[_static] for fp32 configs only:
    both packages cast the float glue to cfg.dtype there."""
    jmodel, variables, tmodel, _ = _models("narrow", dtype)
    cfg = jmodel.config
    if mode == "dynamic":
        jtree = jq.quantize_vit_params_int8(variables)
        ttree = tq.quantize_vit_params_int8({"params": tmodel.params()})
        prepared = tvit.prepare_vit_int8(tmodel)
    else:
        jtree = jq.quantize_vit_params_int8_static(variables, _scales(2))
        ttree = tq.quantize_vit_params_int8_static({"params": tmodel.params()}, _scales(2))
        prepared = tvit.prepare_vit_int8_static(tmodel, act_scales=_scales(2))
    got = tvit.stacks_from_quantized_tree(tmodel.config, ttree)
    _assert_trees_equal(got, jvit.stacks_from_quantized_tree(cfg, jtree), mode)
    glue = {k for k in got if k.startswith("ln") or k.endswith("_b")}
    for k, v in got.items():
        if dtype == "float32" or k not in glue:
            assert torch.equal(v, prepared[k]), k
        else:
            assert v.dtype == torch.bfloat16 and prepared[k].dtype == torch.float32, k


# ---------------------------------------------------------------------------
# Activation quantization inside the TPU int8 kernels: bit for bit
# ---------------------------------------------------------------------------


def _rows(dtype: str, m: int = 300, k: int = 192) -> np.ndarray:
    rng = np.random.default_rng(7)
    h = (rng.standard_normal((m, k)) * rng.uniform(1e-3, 50, (m, 1))).astype(np.float32)
    h[5] = 0.0                       # absmax 0: the s = 1 fallback
    h[6, :] = 1e-30                  # a tiny scale, a huge reciprocal
    return np.asarray(jnp.asarray(h).astype(DTYPES[dtype][0]).astype(jnp.float32))


def _jax_quant_rows(h, dtype: str):
    """``_quant_rows_kernel`` as the TPU kernels run it, inside a Pallas
    kernel in interpret mode."""
    jd = DTYPES[dtype][0]
    m, k = h.shape

    def kern(h_ref, q_ref, s_ref):
        q, s = jfe._quant_rows_kernel(h_ref[:])
        q_ref[:] = q
        s_ref[:] = s

    q, s = pl.pallas_call(kern, out_shape=(jax.ShapeDtypeStruct((m, k), jnp.int8),
                                           jax.ShapeDtypeStruct((m, 1), jnp.float32)),
                          interpret=True)(jnp.asarray(h).astype(jd))
    return np.asarray(q), np.asarray(s)[:, 0]


def _jax_quant_static(h, inv_a, dtype: str):
    """The quantization of ``_int8_mm_static`` inside a Pallas kernel in
    interpret mode, read back exactly through an identity weight."""
    jd = DTYPES[dtype][0]
    m, k = h.shape

    def kern(h_ref, inv_ref, w_ref, cs_ref, o_ref):
        o_ref[:] = jfe._int8_mm_static(h_ref[:], w_ref[:], cs_ref[:], inv_ref[0, 0])

    out = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct((m, k), jnp.float32),
                         interpret=True)(
        jnp.asarray(h).astype(jd), jnp.full((1, 1), inv_a, jnp.float32),
        jnp.eye(k, dtype=jnp.int8), jnp.ones((1, k), jnp.float32))
    return np.asarray(out).astype(np.int8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_rows_plain_matches_jax_in_kernel_dynamic(dtype):
    h = _rows(dtype)
    jqv, js = _jax_quant_rows(h, dtype)
    tqv, ts = tfe.quant_rows(torch.from_numpy(h).to(DTYPES[dtype][1]))
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tqv.numpy(), jqv)
    assert ts[5] == 1.0 and not tqv[5].any()


def test_in_kernel_scale_is_the_product_with_the_rounded_reciprocal():
    """The TPU kernel's ``a / 127.0`` comes out of interpret mode as
    ``a * f32(1/127)``, not the IEEE quotient; the two part on some rows."""
    h = _rows("float32", m=2000)
    _, js = _jax_quant_rows(h, "float32")
    a = np.abs(h).max(axis=1)
    prod = np.where(a > 0, a * np.float32(1 / 127), np.float32(1))
    quot = np.where(a > 0, a / np.float32(127), np.float32(1))
    np.testing.assert_array_equal(js, prod)
    assert (js != quot).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_rows_plain_matches_jax_in_kernel_static(dtype):
    h = _rows(dtype)
    act_inv = torch.from_numpy(1.0 / _scales(3) * 4)  # [3, 4]; scales that clip some rows
    for index in (0, 6, 11):
        inv_a = float(act_inv.reshape(-1)[index])
        jqv = _jax_quant_static(h, inv_a, dtype)
        tqv, ts = tfe.quant_rows(torch.from_numpy(h).to(DTYPES[dtype][1]), act_inv, index)
        assert ts is None
        np.testing.assert_array_equal(tqv.numpy(), jqv)
        assert (np.abs(jqv) == 127).any()


# ---------------------------------------------------------------------------
# Eager int8 matmuls and oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eager_int8_matmuls_match_jax(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((2, 37, 64)) * 3).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)
    jqv, jsc = jq.quantize_activation_rows(jx.reshape(-1, 64))
    tqv, tsc = tq.quantize_activation_rows(tx.reshape(-1, 64))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    wq, ws = jq.quantize_weight_int8(jnp.asarray(w))
    twq, tws = to_torch(np.asarray(wq)), to_torch(np.asarray(ws))
    got = tq.int8_matmul_dynamic(tx, twq, tws)
    assert got.dtype == td and got.shape == (2, 37, 48)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jq.int8_matmul_dynamic(jx, wq, ws).astype(jnp.float32)))
    a = np.float32(0.021)
    np.testing.assert_array_equal(
        tq.quantize_activation_static(tx, torch.tensor(a)).numpy(),
        np.asarray(jq.quantize_activation_static(jx, jnp.float32(a))))
    got = tq.int8_matmul_static(tx, twq, tws * float(a), torch.tensor(a))
    want = jq.int8_matmul_static(jx, wq, ws * a, jnp.float32(a))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_int8_vit_apply_matches_jax(mode, dtype):
    jmodel, variables, tmodel, img = _models("narrow", dtype)
    if mode == "dynamic":
        want = jq.int8_vit_apply(jmodel, jq.quantize_vit_params_int8(variables), jnp.asarray(img))
        got = tq.int8_vit_apply(tmodel, tq.quantize_vit_params_int8(tmodel.params()),
                                torch.from_numpy(img))
    else:
        want = jq.int8_vit_apply_static(
            jmodel, jq.quantize_vit_params_int8_static(variables, _scales(2)), jnp.asarray(img))
        got = tq.int8_vit_apply_static(
            tmodel, tq.quantize_vit_params_int8_static(tmodel.params(), _scales(2)),
            torch.from_numpy(img))
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape == (2, 10)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    else:
        assert np.abs(got - want).max() <= 0.03 * np.abs(want).max()


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


def test_representative_batches_are_the_reference_stream():
    for a, b in zip(jq.representative_batches(n=3, batch=2, shape=(3, 8, 8), seed=4),
                    tq.representative_batches(n=3, batch=2, shape=(3, 8, 8), seed=4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 1000, 2 ** 24 + 5])
def test_percentile_linear_matches_numpy_beyond_quantile_limit(n):
    a = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = float(tq.percentile_linear(torch.from_numpy(a), 99.9))
    # the position is computed in fp32, as JAX computes it: its fraction
    # differs from float64's by up to ~n * 2^-24, and XLA folds the
    # position's constants in another order (one fp32 ulp of the position)
    np.testing.assert_allclose(got, np.percentile(a.astype(np.float64), 99.9), rtol=1e-5)
    if n < 10 ** 6:
        np.testing.assert_allclose(got, float(jnp.percentile(jnp.asarray(a), 99.9)), rtol=1e-5)


@pytest.mark.parametrize("percentile", [None, 99.9])
def test_calibrate_activation_scales_matches_jax(percentile):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((8, 5)).astype(np.float32)
    batches = [rng.standard_normal((4, 8)).astype(np.float32) for _ in range(3)]
    want = jq.calibrate_activation_scales(lambda x: {"a": x, "b": x @ jnp.asarray(w)},
                                          batches, percentile=percentile)
    got = tq.calibrate_activation_scales(lambda x: {"a": x, "b": x @ torch.from_numpy(w)},
                                         batches, percentile=percentile)
    assert list(got) == list(want)
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], rtol=1e-5)


@pytest.mark.parametrize("style", ["standard", "reference"])
@pytest.mark.parametrize("method", ["absmax", "percentile", "mse"])
def test_calibrate_vit_matches_jax(method, style):
    jmodel, variables, tmodel, _ = _models("narrow", "float32", style)
    kw = dict(percentile=99.9) if method == "percentile" else dict(method=method)
    batches = list(jq.representative_batches(n=3, batch=2, shape=(3, 32, 32), seed=1))
    want = jq.calibrate_vit(jmodel, variables, batches=batches, **kw)
    got = tq.calibrate_vit(tmodel, batches=batches, **kw)
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 4)
    # same fp32 forward, summed in another order
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_calibrate_vit_default_batches_and_unknown_method():
    jmodel, variables, tmodel, _ = _models()
    np.testing.assert_allclose(tq.calibrate_vit(tmodel, n=2),
                               jq.calibrate_vit(jmodel, variables, n=2), rtol=1e-5)
    with pytest.raises(ValueError, match="calibration method"):
        tq.calibrate_vit(tmodel, n=1, method="minmax")


def test_prepare_vit_int8_static_calibrates_like_jax():
    jmodel, variables, tmodel, _ = _models()
    batches = list(jq.representative_batches(n=2, shape=(3, 32, 32)))
    want = jvit.prepare_vit_int8_static(jmodel, variables, calib_batches=batches)
    got = tvit.prepare_vit_int8_static(tmodel, calib_batches=batches)
    np.testing.assert_allclose(got["act_inv"].numpy(), np.asarray(want["act_inv"]), rtol=1e-5)
    np.testing.assert_array_equal(got["qkv_w"].numpy(), np.asarray(want["qkv_w"]))
