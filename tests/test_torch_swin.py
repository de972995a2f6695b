"""The port's Swin Transformer against the JAX one on the same params,
constants and images: the window tables, ``SwinTransformer.forward``
against ``model.apply`` (``window_pack`` 1 and 2, and ``kernel_mode=
"pallas"``, whose window attention is K12), ``window_sdpa_plain`` against
K12 ``window_sdpa``, ``fused_swin_apply`` (on the CPU: the kernels' plain
twins) against the JAX ``fused_swin_apply`` with prepared constants (Pallas
in interpret mode) and ``model.apply``, the variables bridge, the stage
geometry and the registry.

Small sizes: image 56 (two stages, one merge) and image 112 (three stages,
two merges), narrow widths, head_dim 32."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.models import swin as jswin
from edgevisiontransformer_tpu.ops.pallas.window_attention import window_sdpa
from edgevisiontransformer_tpu_torch.config import dtype_name
from edgevisiontransformer_tpu_torch.models import registry
from edgevisiontransformer_tpu_torch.models import swin as tswin
from edgevisiontransformer_tpu_torch.ops.cuda import window_sdpa as tws
from edgevisiontransformer_tpu_torch.utils.jax_bridge import load_jax_variables, to_torch

torch.set_num_threads(1)

CONFIGS = {
    56: dict(image_size=56, embed_dim=64, depths=(2, 2), num_heads=(2, 4), num_classes=10),
    112: dict(image_size=112, embed_dim=32, depths=(2, 2, 2), num_heads=(1, 2, 4),
              num_classes=10),
}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fp32 logits against the JAX module: the bound of the JAX package's own
# fused-vs-apply Swin test (tests/test_swin.py:157); against the JAX fused
# path (same exp2 softmax, deferred normalisation and cast points) the
# fp32 summation order and the TPU kernels' polynomial erf remain
FP32_APPLY = dict(rtol=2e-3, atol=2e-3)
FP32_FUSED = dict(rtol=1e-4, atol=1e-4)
# the module against model.apply in fp32: the same ops; the JAX package's
# own window_pack parity bound (tests/test_swin.py:137)
FP32_MODULE = dict(rtol=2e-4, atol=2e-4)
# bf16 logits: single-spacing flips compound through the stages and the
# head; hold the largest deviation to 5% of the largest logit
BF16_REL = 0.05
# bf16 module outputs on the K12 path: the bf16 encoder bound
# (tests/test_torch_encoder.py), 3% of the largest magnitude, the typical
# element within 2^-7
BF16_MAX, BF16_MEDIAN = 0.03, 2.0 ** -7
# K12 alone: fp32, the same math in another summation order; bf16, a value
# at most ~2 bf16 spacings off (p rounds to bf16 after normalising)
SDPA_FP32 = dict(rtol=1e-5, atol=1e-6)
SDPA_BF16 = dict(rtol=2.0 ** -6, atol=1e-2)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _check(got, ref, dtype, fp32):
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, **fp32)
    else:
        err, scale = np.abs(got - ref).max(), np.abs(ref).max()
        assert err <= BF16_REL * scale, (err, scale)


@functools.lru_cache(maxsize=None)
def _variables(image: int):
    """JAX variables (1-d params and the bias tables perturbed, so biases,
    affines and the relative-position bias matter) and two images."""
    jmodel = jswin.SwinTransformer(jswin.swin_config("tiny", **CONFIGS[image]))
    v = jax.jit(jmodel.init)(jax.random.key(1), jnp.ones((1, 3, image, image)))
    rng = np.random.default_rng(7)

    def perturb(path, a):
        a = np.asarray(a)
        if a.ndim == 1:
            return a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if "relative_position_bias_table" in jax.tree_util.keystr(path):
            return a + 0.5 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    params = jax.tree_util.tree_map_with_path(perturb, v["params"])
    variables = {"params": params, "constants": jax.tree.map(np.asarray, v["constants"])}
    img = rng.standard_normal((2, 3, image, image)).astype(np.float32)
    return variables, img


@functools.lru_cache(maxsize=None)
def _models(image: int, dtype: str, window_pack: int = 1, kernel_mode: str = "xla"):
    jd, td = DTYPES[dtype]
    variables, img = _variables(image)
    cfg = dict(CONFIGS[image], window_pack=window_pack, kernel_mode=kernel_mode)
    jmodel = jswin.SwinTransformer(jswin.swin_config("tiny", dtype=jd, **cfg))
    tmodel = tswin.SwinTransformer(tswin.swin_config("tiny", dtype=td, **cfg), device="cpu")
    load_jax_variables(tmodel, variables)
    return jmodel, variables, tmodel, img


@functools.lru_cache(maxsize=None)
def _jax_apply(image: int, dtype: str, window_pack: int = 1):
    jmodel, variables, _, img = _models(image, dtype, window_pack)
    return _f32(jax.jit(jmodel.apply)(variables, jnp.asarray(img)))


# ---------------------------------------------------------------------------
# Window tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", [2, 4, 7])
def test_relative_position_index_matches_jax(w):
    np.testing.assert_array_equal(tswin.relative_position_index(w),
                                  jswin.relative_position_index(w))
    assert tswin.relative_position_index(w).dtype == np.int32


@pytest.mark.parametrize("res,w,shift", [(8, 4, 2), (14, 7, 3), (56, 7, 3)])
def test_shifted_window_mask_matches_jax(res, w, shift):
    np.testing.assert_array_equal(tswin.shifted_window_mask(res, res, w, shift),
                                  jswin.shifted_window_mask(res, res, w, shift))


def test_window_partition_and_reverse_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 5)).astype(np.float32)
    got = tswin.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jswin.window_partition(x, 4)))
    np.testing.assert_array_equal(tswin.window_reverse(got, 4, 8, 8).numpy(), x)


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window_pack", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_model_apply(dtype, window_pack):
    """``window_pack=2`` packs two windows per product in the JAX module; the
    port computes the same function unpacked."""
    _, _, tmodel, img = _models(56, dtype, window_pack)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img))
    _check(got, _jax_apply(56, dtype, window_pack), dtype, FP32_MODULE)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_module_pallas_kernel_mode_matches_jax(dtype):
    """``kernel_mode="pallas"``: the window attention on ``window_sdpa`` (on
    the CPU its twin) against the JAX module on K12 in interpret mode."""
    jmodel, variables, tmodel, img = _models(56, dtype, kernel_mode="pallas")
    ref = _f32(jax.jit(jmodel.apply)(variables, jnp.asarray(img)))
    with torch.no_grad():
        got = _f32(tmodel(torch.from_numpy(img)))
    assert got.shape == ref.shape and np.isfinite(got).all()
    if dtype == "float32":
        # the JAX package's own pallas-against-xla bound (tests/test_swin.py:122)
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, _jax_apply(56, dtype), rtol=2e-4, atol=2e-4)
    else:
        err = np.abs(got - ref)
        assert err.max() <= BF16_MAX * np.abs(ref).max(), (err.max(), np.abs(ref).max())
        assert np.median(err) <= BF16_MEDIAN * np.median(np.abs(ref)), np.median(err)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_sdpa_plain_matches_jax_window_sdpa(dtype, masked):
    """Three images of four windows (the mask tiles over the images: window
    ``j`` takes ``mask[j % 4]``), two heads of 32, a bias in the compute
    dtype, the fp32 shifted-window mask."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(11)
    heads, hd, n, nw, b = 2, 32, 49, 4, 3
    qkv = rng.standard_normal((b * nw, n, 3 * heads * hd)).astype(np.float32)
    bias = (0.5 * rng.standard_normal((heads, n, n))).astype(np.float32)
    mask = jswin.shifted_window_mask(14, 14, 7, 3) if masked else None
    assert mask is None or mask.shape == (nw, n, n)
    jq, jb = jnp.asarray(qkv).astype(jd), jnp.asarray(bias).astype(jd)
    ref = _f32(window_sdpa(jq, jb, None if mask is None else jnp.asarray(mask), heads, hd))
    got = tws.window_sdpa(to_torch(qkv).to(td), to_torch(bias).to(td),
                          None if mask is None else to_torch(mask), heads=heads, head_dim=hd)
    assert got.dtype == td and got.shape == (b * nw, n, heads * hd)
    np.testing.assert_allclose(_f32(got), ref, **(SDPA_FP32 if dtype == "float32" else SDPA_BF16))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_sdpa_plain_matches_jax_window_sdpa_at_window_12(dtype, masked):
    """Window 12 (n = 144, Swin at 384): one image of four windows, two
    heads of 32, as above."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(12)
    heads, hd, n, nw = 2, 32, 144, 4
    qkv = rng.standard_normal((nw, n, 3 * heads * hd)).astype(np.float32)
    bias = (0.5 * rng.standard_normal((heads, n, n))).astype(np.float32)
    mask = jswin.shifted_window_mask(24, 24, 12, 6) if masked else None
    assert mask is None or mask.shape == (nw, n, n)
    jq, jb = jnp.asarray(qkv).astype(jd), jnp.asarray(bias).astype(jd)
    ref = _f32(window_sdpa(jq, jb, None if mask is None else jnp.asarray(mask), heads, hd))
    got = tws.window_sdpa(to_torch(qkv).to(td), to_torch(bias).to(td),
                          None if mask is None else to_torch(mask), heads=heads, head_dim=hd)
    assert got.dtype == td and got.shape == (nw, n, heads * hd)
    np.testing.assert_allclose(_f32(got), ref, **(SDPA_FP32 if dtype == "float32" else SDPA_BF16))


# ---------------------------------------------------------------------------
# fused_swin_apply
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_fused(image: int, dtype: str):
    jmodel, variables, _, img = _models(image, dtype)
    prep = jswin.prepare_swin_fused(jmodel, variables)
    return _f32(jswin.fused_swin_apply(jmodel, variables, jnp.asarray(img), prepared=prep))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("image", [56, 112])
def test_fused_swin_apply_matches_jax_fused_and_apply(image, dtype):
    _, _, tmodel, img = _models(image, dtype)
    with torch.no_grad():
        got = tswin.fused_swin_apply(tmodel, torch.from_numpy(img))
        eager = tmodel(torch.from_numpy(img))
    _check(got, _jax_fused(image, dtype), dtype, FP32_FUSED)
    _check(got, _jax_apply(image, dtype), dtype, FP32_APPLY)
    _check(got, eager, dtype, FP32_APPLY)


def test_fused_swin_apply_prepared_and_plain_flag():
    _, _, tmodel, img = _models(112, "bfloat16")
    x = torch.from_numpy(img)
    with torch.no_grad():
        prep = tswin.prepare_swin_fused(tmodel)
        a = tswin.fused_swin_apply(tmodel, x)
        b = tswin.fused_swin_apply(tmodel, x, prepared=prep)
        c = tswin.fused_swin_apply(tmodel, x, prepared=prep, plain=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    # what the forward reads is built once: device tensors, the shifted
    # stages' masks, one bias per block
    assert [s["mask"] is not None for s in prep["stages"]] == [True, True, False]
    assert [len(s["bias"]) for s in prep["stages"]] == [2, 2, 2]
    assert prep["stages"][0]["bias"][0].shape == (1, 49, 49)
    assert prep["stages"][0]["qkv_w"].dtype == torch.bfloat16
    assert prep["merges"][1]["kernel"].shape == (256, 128)


def test_prepared_constants_match_jax():
    """The gathered, log2(e)-scaled biases (unpadded) and the permuted merge
    params equal the JAX prepare's, bit for bit."""
    jmodel, variables, tmodel, _ = _models(112, "float32")
    ref = jswin.prepare_swin_fused(jmodel, variables)
    got = tswin.prepare_swin_fused(tmodel)
    for si, stage in enumerate(got["stages"]):
        for bi, bias in enumerate(stage["bias"]):
            n = bias.shape[-1]
            np.testing.assert_array_equal(bias.numpy(), np.asarray(ref[f"{si}_{bi}"])[:, :n, :n])
    for si, m in enumerate(got["merges"]):
        for k in ("norm_scale", "norm_bias", "kernel"):
            np.testing.assert_array_equal(m[k].numpy(), np.asarray(ref[f"merge_{si}"][k]))
    jst = jswin._stack_stage_params(variables["params"], 1, 2, 64, jnp.float32)
    for k, v in jst.items():
        np.testing.assert_array_equal(got["stages"][1][k].numpy(),
                                      np.asarray(v).reshape(got["stages"][1][k].shape))


def test_fused_swin_apply_refuses_what_the_reference_cannot_run():
    _, _, tmodel, img = _models(56, "float32")
    # the JAX Swin calibration records the absmax only
    with pytest.raises(NotImplementedError, match="absmax"):
        tswin.calibrate_swin(tmodel, batches=[img[:1]], percentile=99.9)
    with pytest.raises(ValueError, match="method"):
        tswin.calibrate_swin(tmodel, batches=[img[:1]], method="kl")
    # window 7 does not tile the 16x16 map of a 64x64 image (one block per
    # stage, so no shifted mask, which could not be built either)
    cfg = tswin.swin_config("tiny", **{**CONFIGS[56], "image_size": 64, "depths": (1, 1)})
    model = tswin.SwinTransformer(cfg, device="cpu")
    with pytest.raises(ValueError, match="tile"):
        tswin.fused_swin_apply(model, torch.zeros(1, 3, 64, 64))


# ---------------------------------------------------------------------------
# Variables, geometry, registry, init
# ---------------------------------------------------------------------------


def test_load_jax_variables_round_trips_and_refuses_mismatches():
    variables, _ = _variables(56)
    tmodel = tswin.SwinTransformer(tswin.swin_config("tiny", **CONFIGS[56]), device="cpu")
    load_jax_variables(tmodel, variables)
    for coll, tree in (("params", tmodel.params()), ("constants", tmodel.constants())):
        flat_t = jax.tree_util.tree_leaves_with_path(tree)
        flat_j = dict(jax.tree_util.tree_leaves_with_path(variables[coll]))
        assert len(flat_t) == len(flat_j) > 0
        for path, leaf in flat_t:
            np.testing.assert_array_equal(leaf.numpy(), flat_j[path], err_msg=str(path))
            assert leaf.numpy().dtype == flat_j[path].dtype
    consts = tmodel.constants()
    assert "attn_mask" in consts["stage_0_block_1"]       # res 14: shifted
    assert "attn_mask" not in consts["stage_1_block_1"]   # res 7 = window: no shift

    def refused(change, exc):
        bad = jax.tree.map(lambda a: a, variables)
        change(bad)
        with pytest.raises(exc):
            load_jax_variables(tswin.SwinTransformer(tswin.swin_config("tiny", **CONFIGS[56]),
                                                     device="cpu"), bad)

    refused(lambda v: v["constants"]["stage_0_block_1"].pop("attn_mask"), KeyError)
    refused(lambda v: v["params"]["downsample_0"]["reduction"].update(bias=np.zeros(128)),
            KeyError)
    refused(lambda v: v["constants"]["stage_0_block_0"]["attn"].update(
        relative_position_index=np.zeros((49, 49), np.int64)), ValueError)


@pytest.mark.parametrize("size", ["tiny", "small", "base"])
def test_registry_configs_and_geometry_match_jax(size):
    def fields(cfg, name):
        return {**dataclasses.asdict(cfg), "dtype": name(cfg.dtype),
                "param_dtype": name(cfg.param_dtype)}

    jcfg, tcfg = jswin.swin_config(size), tswin.swin_config(size)
    assert fields(tcfg, dtype_name) == fields(jcfg, lambda d: jnp.dtype(d).name)
    with torch.device("meta"):
        model, shape = registry.build_model(f"swin_{size}", device="meta")
    assert shape == (3, 224, 224) and dtype_name(model.config.dtype) == "float32"
    jvars = jax.eval_shape(lambda: jswin.SwinTransformer(jcfg).init(
        jax.random.key(0), jnp.ones((1, 3, 224, 224))))
    for coll, tree in (("params", model.params()), ("constants", model.constants())):
        t = {jax.tree_util.keystr(p): tuple(v.shape)
             for p, v in jax.tree_util.tree_leaves_with_path(tree)}
        j = {jax.tree_util.keystr(p): tuple(v.shape)
             for p, v in jax.tree_util.tree_leaves_with_path(jvars[coll])}
        assert t == j
    assert (list(tswin._stage_geometry(tcfg, model.params()))
            == [tuple(g) for g in jswin._stage_geometry(jcfg, jvars["params"])])


def test_init_is_seeded():
    def build(seed):
        return tswin.SwinTransformer(tswin.swin_config("tiny", **CONFIGS[56]), device="cpu",
                                     generator=torch.Generator().manual_seed(seed))
    a, b, c = build(0), build(0), build(1)
    for (_, ta), (_, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        torch.testing.assert_close(ta, tb, rtol=0, atol=0)
    assert not torch.equal(a.stage_0_block_0.attn.qkv.kernel, c.stage_0_block_0.attn.qkv.kernel)
    assert torch.equal(a.stage_0_block_0.ln1_scale, torch.ones(64))
    assert a.downsample_0.reduction.bias is None and not a.training
