"""The port's int8 encoder and ``fused_vit_apply_int8`` (on the CPU: the
kernels' plain twins) against the JAX int8 kernels K4
(``encoder_forward_int8``) and K5 (``encoder_forward_int8_pipelined``), run
in interpret mode as the JAX package's own tests run them, and against the
eager int8 oracles of both packages; dynamic and static scales, both styles,
fp32 and bf16."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.models import vit as jvit
from edgevisiontransformer_tpu.ops import quant as jq
from edgevisiontransformer_tpu.ops.pallas import fused_encoder as jfe
from edgevisiontransformer_tpu_torch.models import vit as tvit
from edgevisiontransformer_tpu_torch.ops import quant as tq
from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as tfe
from edgevisiontransformer_tpu_torch.utils.jax_bridge import (load_jax_params,
                                                              quantized_stack_from_jax)

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
NARROW = dict(image_size=32, dim=64, depth=2, heads=2, mlp_dim=128, num_classes=10)
CONFIGS = {"narrow": NARROW, "tiny_depth2": dict(depth=2)}
JAX_KERNELS = {"encoder_forward_int8": jfe.encoder_forward_int8,
               "encoder_forward_int8_pipelined": jfe.encoder_forward_int8_pipelined}
# fp32: the bound of the JAX package's own int8 kernel-vs-XLA tests
# (tests/test_pallas_kernels.py, rtol = atol = 2e-3, at this NARROW config)
FP32 = dict(rtol=2e-3, atol=2e-3)
# fp32 at deit_tiny widths: an fp32-ulp difference before a rounding to int8
# (LayerNorm and softmax sums run in another order) moves a value into the
# next bucket, which the next matmul spreads.  The JAX package holds two of
# its own int8 forms that differ by ulps to this bound
# (tests/test_pallas_kernels.py:326-330).
FP32_QUANT_NOISE = dict(rtol=0.03, atol=0.06)
# bf16 logits: the bound of test_torch_vit's bf16 logits, 5% of max|logit|
LOGIT_REL = 0.05


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(a.astype(jnp.float32)) if hasattr(a, "astype") else np.asarray(a)


def _check_bf16(got, ref, rel=0.03, median=True):
    """Both sides round at the same points, but a one-spacing flip before a
    quantization moves a value into the next int8 bucket, which the next
    matmul spreads: the largest deviation within ``rel`` of the largest
    reference magnitude, the median (over activations) within 2^-7 of the
    median magnitude."""
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref)
    assert err.max() <= rel * np.abs(ref).max(), (err.max(), np.abs(ref).max())
    if median:
        assert np.median(err) <= 2.0 ** -7 * np.median(np.abs(ref)), np.median(err)


# ---------------------------------------------------------------------------
# The encoder: port vs K4 / K5 on identical int8 stacks
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _encoder_setup(size: str, style: str, mode: str):
    cfg = jvit.deit_config("tiny", style).replace(**CONFIGS[size])
    n = cfg.image_size
    params = jvit.ViT(cfg).init(jax.random.key(1), jnp.ones((1, 3, n, n)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
                          if a.ndim == 1 else a, params)
    x = rng.standard_normal((2, cfg.num_patches + 1, cfg.dim)).astype(np.float32)
    stacked = jfe.stack_vit_layer_params(params, 2, cfg.qkv_bias)
    if mode == "dynamic":
        sq = jfe.quantize_stacked_int8(stacked)
    else:
        sq = jfe.quantize_stacked_int8_static(
            stacked, rng.uniform(0.005, 0.05, (2, 4)).astype(np.float32))
    return cfg, sq, x


def _kw(cfg):
    return dict(heads=cfg.heads, head_dim=cfg.resolved_head_dim, eps=cfg.layernorm_eps,
                reference_residual=cfg.reference_residual, approx_gelu=cfg.gelu_approx)


def _port_encoder(x, sq, cfg, td):
    tsq = quantized_stack_from_jax(jax.tree.map(np.asarray, sq))
    assert ("act_inv" in tsq) == ("act_inv" in sq)
    got = tfe.encoder_forward_int8(torch.from_numpy(_f32(x)).to(td), tsq, **_kw(cfg))
    assert got.dtype == td
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jax_kernel", list(JAX_KERNELS))
@pytest.mark.parametrize("style", ["standard", "reference"])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_encoder_forward_int8_matches_jax_kernels(mode, style, jax_kernel, dtype):
    """deit_tiny widths, n = 197, layer by layer: each layer of the port
    gets the JAX kernel's input to that layer, as the JAX package composes
    its own int8 kernels per layer (tests/test_pallas_kernels.py:318-328),
    so a bucket flip in one layer is not carried into the next."""
    cfg, sq, x = _encoder_setup("tiny_depth2", style, mode)
    jd, td = DTYPES[dtype]
    y = jnp.asarray(x).astype(jd)
    for li in range(2):
        layer = {k: v[li:li + 1] for k, v in sq.items()}
        ref = JAX_KERNELS[jax_kernel](y, layer, **_kw(cfg))
        got = _port_encoder(y, layer, cfg, td)
        if dtype == "float32":
            np.testing.assert_allclose(_f32(got), _f32(ref), **FP32_QUANT_NOISE)
        else:
            _check_bf16(got, ref)
        y = ref


@pytest.mark.parametrize("jax_kernel", list(JAX_KERNELS))
@pytest.mark.parametrize("style", ["standard", "reference"])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_encoder_forward_int8_fp32_whole_depth_matches_jax_kernels(mode, style, jax_kernel):
    """The JAX int8 tests' config (5 tokens, dim 64), both layers at once."""
    cfg, sq, x = _encoder_setup("narrow", style, mode)
    ref = JAX_KERNELS[jax_kernel](jnp.asarray(x), sq, **_kw(cfg))
    np.testing.assert_allclose(_f32(_port_encoder(x, sq, cfg, torch.float32)), _f32(ref),
                               **FP32)


def test_encoder_forward_int8_plain_is_encoder_forward_int8_on_cpu():
    cfg, sq, x = _encoder_setup("tiny_depth2", "standard", "static")
    tsq = quantized_stack_from_jax(jax.tree.map(np.asarray, sq))
    tx = torch.from_numpy(x).bfloat16()
    tfe.reset_launches()
    got = tfe.encoder_forward_int8(tx, tsq, **_kw(cfg))
    plain = tfe.encoder_forward_int8_plain(tx, tsq, **_kw(cfg))
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert sum(tfe.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# The model: fused_vit_apply_int8 vs JAX, and vs the eager oracles
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _models(size: str, style: str, dtype: str):
    jd, td = DTYPES[dtype]
    jmodel = jvit.ViT(jvit.deit_config("tiny", style, dtype=jd, **CONFIGS[size]))
    n = jmodel.config.image_size
    variables = jmodel.init(jax.random.key(0), jnp.ones((1, 3, n, n)))
    rng = np.random.default_rng(7)
    variables = {"params": jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim == 1 else a, variables["params"])}
    tmodel = tvit.ViT(tvit.deit_config("tiny", style, dtype=td, **CONFIGS[size]), device="cpu")
    load_jax_params(tmodel, jax.tree.map(np.asarray, variables["params"]))
    img = rng.standard_normal((2, 3, n, n)).astype(np.float32)
    calib = list(jq.representative_batches(n=2, batch=2, shape=(3, n, n), seed=3))
    return jmodel, variables, tmodel, img, calib


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("style", ["standard", "reference"])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("size", ["narrow", "tiny_depth2"])
def test_fused_vit_apply_int8_matches_jax_and_oracles(size, mode, style, dtype):
    jmodel, variables, tmodel, img, calib = _models(size, style, dtype)
    jimg, timg = jnp.asarray(img), torch.from_numpy(img)
    if mode == "dynamic":
        jsq, tsq = jvit.prepare_vit_int8(jmodel, variables), tvit.prepare_vit_int8(tmodel)
        j_oracle = jq.int8_vit_apply(jmodel, jq.quantize_vit_params_int8(variables), jimg)
        t_oracle = tq.int8_vit_apply(tmodel, tq.quantize_vit_params_int8(tmodel.params()), timg)
    else:
        scales = jq.calibrate_vit(jmodel, variables, batches=calib)
        jsq = jvit.prepare_vit_int8_static(jmodel, variables, act_scales=scales)
        tsq = tvit.prepare_vit_int8_static(tmodel, calib_batches=calib)
        j_oracle = jq.int8_vit_apply_static(
            jmodel, jq.quantize_vit_params_int8_static(variables, scales), jimg)
        t_oracle = tq.int8_vit_apply_static(
            tmodel, tq.quantize_vit_params_int8_static(tmodel.params(), scales), timg)
    with torch.no_grad():
        got = tvit.fused_vit_apply_int8(tmodel, timg, stacked_q=tsq)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (2, tmodel.config.num_classes)
    jfused = jax.jit(functools.partial(jvit.fused_vit_apply_int8, jmodel))
    for ref in (jfused(variables, jimg, jsq), j_oracle, t_oracle):
        if dtype == "float32" and size == "narrow":
            np.testing.assert_allclose(_f32(got), _f32(ref), **FP32)
        else:
            # logits: bucket flips reach every logit through the cls token,
            # and the eager oracles round qkv before the bias; the JAX
            # package's own fused and oracle logits part by up to 3.3% of
            # max|logit| here
            _check_bf16(got, ref, rel=LOGIT_REL, median=False)


def test_fused_vit_apply_int8_defaults_variants_and_plain_flag():
    _, _, tmodel, img, _ = _models("narrow", "standard", "bfloat16")
    x = torch.from_numpy(img)
    with torch.no_grad():
        ref = tvit.fused_vit_apply_int8(tmodel, x, stacked_q=tvit.prepare_vit_int8(tmodel))
        outs = [tvit.fused_vit_apply_int8(tmodel, x),
                tvit.fused_vit_apply_int8(tmodel, x, plain=True)]
        outs += [tvit.fused_vit_apply_int8(tmodel, x, variant=v) for v in tvit.INT8_VARIANTS]
    for out in outs:
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="variant"):
        tvit.fused_vit_apply_int8(tmodel, x, variant="resident")


def test_fused_vit_apply_int8_refuses_multi_segment_models():
    """A two-segment model runs one int8 chain per segment; what it refuses,
    as the JAX function does, is a stack of another segmentation."""
    cfg = tvit.deit_config("tiny", **NARROW).replace(heads_per_layer=(2, 1),
                                                      mlp_dim_per_layer=(128, 64))
    model = tvit.ViT(cfg, device="cpu")
    sq = tvit.prepare_vit_int8(model)
    assert len(sq["segments"]) == 2
    img = torch.zeros(1, 3, 32, 32)
    with pytest.raises(ValueError, match="segments into 2"):
        tvit.fused_vit_apply_int8(model, img, stacked_q=sq["segments"][0])
    with pytest.raises(ValueError, match="segments into 2"):
        tvit.fused_vit_apply_int8(model, img, stacked_q={"segments": sq["segments"][:1]})
    torch.testing.assert_close(tvit.fused_vit_apply_int8(model, img),
                               tvit.fused_vit_apply_int8(model, img, stacked_q=sq),
                               rtol=0, atol=0)


def test_fused_vit_apply_int8_refuses_what_jax_refuses():
    """NoNorm / ReLU models are refused as by the JAX function, and a
    segmented stack for a uniform model is refused."""
    jmodel, variables, _, img, _ = _models("narrow", "standard", "float32")
    bad = dict(NARROW, norm_mode="nonorm", act="relu")
    with pytest.raises(ValueError, match="layernorm"):
        jvit.fused_vit_apply_int8(jvit.ViT(jvit.deit_config("tiny", **bad)), variables,
                                  jnp.asarray(img))
    with pytest.raises(ValueError, match="layernorm"):
        tvit.fused_vit_apply_int8(tvit.ViT(tvit.deit_config("tiny", **bad), device="cpu"),
                                  torch.from_numpy(img))
    model = tvit.ViT(tvit.deit_config("tiny", **NARROW), device="cpu")
    sq = tvit.prepare_vit_int8(model)
    with pytest.raises(ValueError, match="segments"):
        tvit.fused_vit_apply_int8(model, torch.from_numpy(img), stacked_q={"segments": [sq, sq]})
