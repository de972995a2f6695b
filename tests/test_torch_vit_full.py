"""The port's whole-model forward (``ops/cuda/fused_vit_full.vit_full_forward``;
on the CPU: its plain twin) against the JAX whole-model kernels K7a
(``vit_full_forward``) and K7b (``vit_full_forward_pipelined``), run in
interpret mode as the JAX package's own tests run them, on the same weights
and images; ``fully_fused_vit_apply`` end to end against JAX's; and the
refusals it keeps."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.models import vit as jvit
from edgevisiontransformer_tpu.ops.pallas import fused_vit_full as jfull
from edgevisiontransformer_tpu.ops.pallas.fused_encoder import stack_vit_layer_params
from edgevisiontransformer_tpu_torch.models import vit as tvit
from edgevisiontransformer_tpu_torch.ops.cuda import fused_vit_full as tfull
from edgevisiontransformer_tpu_torch.utils.jax_bridge import load_jax_params

torch.set_num_threads(1)

NARROW = dict(image_size=32, dim=64, depth=2, heads=2, mlp_dim=128, num_classes=10)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fp32: the bound of the JAX package's own whole-model test
# (tests/test_pallas_kernels.py:133-147)
FP32 = dict(rtol=1e-4, atol=5e-4)
# bf16: both sides round at the same points; single-spacing flips compound
# over two layers and the head, and JAX evaluates the tanh GELU in bf16
# arithmetic where the port rounds an fp32 GELU once
BF16_REL = 0.02
JAX_KERNELS = {"K7a": jfull.vit_full_forward, "K7b": jfull.vit_full_forward_pipelined}
# (reference_residual, approx_gelu, final_norm)
FORMS = {"res_x-erf-norm": (False, False, True), "res_h-tanh-norm": (True, True, True),
         "res_x-tanh-no_norm": (False, True, False), "res_h-erf-no_norm": (True, False, False)}


@functools.lru_cache(maxsize=None)
def _models(dtype: str, size: str = "narrow"):
    overrides = NARROW if size == "narrow" else dict(depth=2)
    jd, td = DTYPES[dtype]
    jmodel = jvit.ViT(jvit.deit_config("tiny", dtype=jd, **overrides))
    n = jmodel.config.image_size
    variables = jmodel.init(jax.random.key(0), jnp.ones((1, 3, n, n)))
    rng = np.random.default_rng(11)
    # non-zero biases and LN affines, so every bias and affine term matters
    variables = {"params": jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim == 1 else a, variables["params"])}
    tmodel = tvit.ViT(tvit.deit_config("tiny", dtype=td, **overrides), device="cpu")
    load_jax_params(tmodel, jax.tree.map(np.asarray, variables["params"]))
    img = rng.standard_normal((6 if size == "narrow" else 2, 3, n, n)).astype(np.float32)
    return jmodel, variables, tmodel, img


def _jax_inputs(jmodel, variables, img):
    """The arguments fully_fused_vit_apply hands the JAX kernels
    (models/vit.py:666-688)."""
    cfg, p = jmodel.config, variables["params"]
    dt, ps, b = cfg.dtype, cfg.patch_size, img.shape[0]
    g = cfg.image_size // ps
    x = jnp.asarray(img).astype(dt).reshape(b, 3, g, ps, g, ps)
    patches = jnp.transpose(x, (0, 2, 4, 3, 5, 1)).reshape(b, g * g, ps * ps * 3)
    pos = p["pos_embedding"].astype(dt)
    eb = pos.at[0].add(p["cls_token"].astype(dt)[0, 0]).at[1:].add(p["patch_bias"].astype(dt))
    stacked = jax.tree.map(lambda a: a.astype(dt),
                           stack_vit_layer_params(p, cfg.depth, cfg.qkv_bias))
    return (patches, stacked, p["patch_kernel"].astype(dt), eb,
            p["final_norm"]["scale"].astype(dt), p["final_norm"]["bias"].astype(dt),
            p["head"]["kernel"].astype(dt), p["head"]["bias"].astype(dt))


def _f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _check(got, ref, dtype):
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, **FP32)
    else:
        err, scale = np.abs(got - ref).max(), np.abs(ref).max()
        assert err <= BF16_REL * scale, (err, scale)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", list(JAX_KERNELS))
def test_twin_matches_jax_whole_model_kernels(kernel, dtype, form):
    """The twin (what the wrapper runs on a CPU tensor) against K7a and K7b
    at the narrow config, b6, both residual forms, both GELUs, with and
    without the final norm."""
    reference_residual, approx_gelu, final_norm = FORMS[form]
    jmodel, variables, tmodel, img = _models(dtype)
    cfg = jmodel.config
    kw = dict(heads=cfg.heads, head_dim=cfg.resolved_head_dim, eps=cfg.layernorm_eps,
              reference_residual=reference_residual, approx_gelu=approx_gelu,
              final_norm=final_norm)
    ref = JAX_KERNELS[kernel](*_jax_inputs(jmodel, variables, img), **kw)
    tfull.reset_launches()
    got = tfull.vit_full_forward(torch.from_numpy(img), tvit.prepare_vit_full(tmodel), **kw)
    assert tfull.LAUNCHES["vit_full"] == 0  # a CPU tensor takes the twin
    assert got.dtype == DTYPES[dtype][1] and got.shape == (6, 10)
    _check(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_fused_vit_apply_matches_jax(dtype):
    """End to end at deit_tiny widths, depth 2, b2: the port's
    fully_fused_vit_apply (CPU: the twin) against JAX's (its K7b, in
    interpret mode) and against the port's model forward."""
    jmodel, variables, tmodel, img = _models(dtype, "tiny")
    ref = jvit.fully_fused_vit_apply(jmodel, variables, jnp.asarray(img))
    x = torch.from_numpy(img)
    with torch.no_grad():
        got = tvit.fully_fused_vit_apply(tmodel, x)
        eager = tmodel(x)
    assert got.shape == (2, 1000)
    _check(got, ref, dtype)
    _check(got, eager, dtype)


def test_prepare_vit_full_folds_the_embedding_bias_as_jax():
    for dtype in DTYPES:
        jmodel, variables, tmodel, img = _models(dtype)
        ref = _jax_inputs(jmodel, variables, img)
        prep = tvit.prepare_vit_full(tmodel)
        for key, r in zip(("patch_w", "embed_bias", "fnorm_g", "fnorm_b", "head_w", "head_b"),
                          ref[2:]):
            assert prep[key].dtype == DTYPES[dtype][1], key
            np.testing.assert_array_equal(_f32(prep[key]), _f32(r), err_msg=key)
        for key, r in ref[1].items():
            np.testing.assert_array_equal(_f32(prep[key]), _f32(r), err_msg=key)


def test_plain_flag_prepared_and_batch_block():
    _, _, tmodel, img = _models("bfloat16")
    x = torch.from_numpy(img)
    prep = tvit.prepare_vit_full(tmodel)
    a = tvit.fully_fused_vit_apply(tmodel, x)
    outs = [tvit.fully_fused_vit_apply(tmodel, x, prepared=prep),
            tvit.fully_fused_vit_apply(tmodel, x, plain=True),
            tvit.fully_fused_vit_apply(tmodel, x, batch_block=2),
            tvit.fully_fused_vit_apply(tmodel, x.bfloat16())]
    for out in outs:
        torch.testing.assert_close(out, a, rtol=0, atol=0)
    for bad in (0, -1, 1.5, True):
        with pytest.raises(ValueError, match="batch_block"):
            tvit.fully_fused_vit_apply(tmodel, x, batch_block=bad)
    with pytest.raises(ValueError, match="patches"):
        tvit.fully_fused_vit_apply(tmodel, x[:, :, :, :16])


@pytest.mark.parametrize("what", ["reference_head", "per_layer"])
def test_refuses_what_jax_refuses(what):
    """A two-layer (reference-style) head and per-layer heads or widths
    raise, as JAX's fully_fused_vit_apply does (models/vit.py:663-664)."""
    if what == "reference_head":
        cfg = tvit.deit_config("tiny", "reference", depth=1)
        jcfg = jvit.deit_config("tiny", "reference", depth=1)
    else:
        cfg = tvit.pruned_vit_config("tiny", "all_head1_ffn0.3", depth=1)
        jcfg = jvit.pruned_vit_config("tiny", "all_head1_ffn0.3", depth=1)
    model = tvit.ViT(cfg, device="cpu")
    img = torch.zeros(1, 3, 224, 224)
    with pytest.raises(ValueError, match="uniform layers"):
        tvit.fully_fused_vit_apply(model, img)
    with pytest.raises(ValueError, match="uniform layers"):
        tvit.prepare_vit_full(model)
    jmodel = jvit.ViT(jcfg)
    jx = jnp.zeros((1, 3, 224, 224))
    with pytest.raises(ValueError):
        jvit.fully_fused_vit_apply(jmodel, jmodel.init(jax.random.key(0), jx), jx)
