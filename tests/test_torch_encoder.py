"""The port's encoder_forward (on the CPU: the kernels' plain twins) against
the JAX whole-encoder kernels K1 (encoder_forward), K2
(encoder_forward_pipelined), K6 (encoder_forward_blocked, its MLP in two
384-wide chunks) and K17 (encoder_forward_resident), run in interpret mode
as the JAX package's own tests run them, at deit_tiny widths, depth 2, b=2,
n=197.  The port's one encoder_forward covers all four."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.models.vit import ViT as JViT
from edgevisiontransformer_tpu.models.vit import deit_config as jdeit_config
from edgevisiontransformer_tpu.ops.pallas import fused_encoder as jfe
from edgevisiontransformer_tpu_torch.ops.attention import encoder_forward_xla
from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as tfe
from edgevisiontransformer_tpu_torch.utils.jax_bridge import stacked_from_params, to_torch

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# The JAX kernels the port's encoder_forward stands for, with their options:
# mlp_chunk=384 runs deit_tiny's 768-wide MLP in two chunks.
JAX_KERNELS = {
    "encoder_forward": jfe.encoder_forward,
    "encoder_forward_pipelined": jfe.encoder_forward_pipelined,
    "encoder_forward_blocked": functools.partial(jfe.encoder_forward_blocked, mlp_chunk=384),
    "encoder_forward_resident": jfe.encoder_forward_resident,
}


@functools.lru_cache(maxsize=None)
def _setup(style: str):
    cfg = jdeit_config("tiny", style).replace(depth=2)
    params = JViT(cfg).init(jax.random.key(1), jnp.ones((1, 3, 224, 224)))["params"]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 197, 192)).astype(np.float32)
    # non-zero biases and LN affines, so every epilogue term is exercised
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim == 1 else a, params)
    return cfg, params, x


def _kw(cfg):
    return dict(heads=cfg.heads, head_dim=cfg.resolved_head_dim, eps=cfg.layernorm_eps,
                reference_residual=cfg.reference_residual, approx_gelu=cfg.gelu_approx)


def _run(style, dtype):
    cfg, params, x = _setup(style)
    jd, td = DTYPES[dtype]
    jst = jax.tree.map(lambda a: a.astype(jd), jfe.stack_vit_layer_params(params, 2, cfg.qkv_bias))
    tst = {k: v.to(td) for k, v in
           stacked_from_params(jax.tree.map(np.asarray, params), 2, cfg.qkv_bias).items()}
    tx = torch.from_numpy(x).to(td)
    got = tfe.encoder_forward(tx, tst, **_kw(cfg)).float().numpy()
    return cfg, jst, jnp.asarray(x).astype(jd), tst, tx, got


@pytest.mark.parametrize("style", ["standard", "reference"])
@pytest.mark.parametrize("jax_kernel", list(JAX_KERNELS))
def test_encoder_forward_fp32_matches_jax_kernels(style, jax_kernel):
    cfg, jst, jx, _, _, got = _run(style, "float32")
    ref = np.asarray(JAX_KERNELS[jax_kernel](jx, jst, **_kw(cfg)))
    assert got.shape == ref.shape == (2, 197, 192)
    # same fp32 math; summation order and erf (the TPU kernel's polynomial
    # erf, |err| <= 7.2e-7) differ
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("style", ["standard", "reference"])
@pytest.mark.parametrize("jax_kernel", list(JAX_KERNELS))
def test_encoder_forward_bf16_matches_jax_kernels(style, jax_kernel):
    cfg, jst, jx, _, _, got = _run(style, "bfloat16")
    ref = np.asarray(JAX_KERNELS[jax_kernel](jx, jst, **_kw(cfg)).astype(jnp.float32))
    # both round at the same points; a one-spacing bf16 flip (2^-8..2^-7
    # relative) anywhere in a layer spreads through the next matmuls, so
    # two layers are held to 3% of the output's largest magnitude, and the
    # typical element to a few bf16 spacings
    err = np.abs(got - ref)
    scale = np.abs(ref).max()
    assert err.max() <= 0.03 * scale, (err.max(), scale)
    assert np.median(err) <= 2.0 ** -7 * np.median(np.abs(ref)), np.median(err)


@pytest.mark.parametrize("style", ["standard", "reference"])
def test_encoder_forward_matches_eager_encoder_fp32(style):
    """The kernel chain and the port's eager encoder (models' semantics)
    agree in fp32: max-free exp2 softmax with deferred normalisation is the
    same function as the eager softmax on bounded scores."""
    cfg, _, _, tst, tx, got = _run(style, "float32")
    ref = encoder_forward_xla(tx, tst, **_kw(cfg)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_encoder_forward_plain_is_encoder_forward_on_cpu():
    cfg, _, _, tst, tx, got = _run("standard", "bfloat16")
    tfe.reset_launches()
    plain = tfe.encoder_forward_plain(tx, tst, **_kw(cfg)).float().numpy()
    np.testing.assert_array_equal(got, plain)
    assert sum(tfe.LAUNCHES.values()) == 0


def test_stacked_params_feed_both_packages_identically():
    cfg, params, _ = _setup("standard")
    t = stacked_from_params(jax.tree.map(np.asarray, params), 2, True)
    for k, v in jfe.stack_vit_layer_params(params, 2, True).items():
        np.testing.assert_array_equal(t[k].numpy(), to_torch(np.asarray(v)).numpy())
