"""The port's ViT against the JAX one on the same params and images:
``ViT.forward`` vs ``model.apply``, and the port's ``fused_vit_apply`` (on
the CPU: the kernels' plain twins) vs JAX ``fused_vit_apply`` (Pallas in
interpret mode) and ``model.apply``, in both styles."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.models import vit as jvit
from edgevisiontransformer_tpu_torch.config import dtype_name
from edgevisiontransformer_tpu_torch.models import registry
from edgevisiontransformer_tpu_torch.models import swin as tswin
from edgevisiontransformer_tpu_torch.models import t2t_vit as tt2t
from edgevisiontransformer_tpu_torch.models import vit as tvit
from edgevisiontransformer_tpu_torch.utils.jax_bridge import load_jax_params

torch.set_num_threads(1)

NARROW = dict(image_size=32, dim=64, depth=2, heads=2, mlp_dim=128, num_classes=10)
TINY2 = dict(depth=2)
CONFIGS = {"narrow": NARROW, "tiny_depth2": TINY2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fp32: the tolerance of the JAX package's own fused-vs-XLA ViT test
FP32 = dict(rtol=1e-4, atol=5e-4)
# bf16: both sides round at the same points, but single-spacing flips
# (2^-8..2^-7 relative) compound over two layers and the head; hold the
# largest logit deviation to 5% of the largest logit
BF16_REL = 0.05


@functools.lru_cache(maxsize=None)
def _models(size: str, style: str, dtype: str, **extra):
    overrides = {**CONFIGS[size], **extra}
    jd, td = DTYPES[dtype]
    jcfg = jvit.deit_config("tiny", style, dtype=jd, **overrides)
    jmodel = jvit.ViT(jcfg)
    img_size = jcfg.image_size
    variables = jmodel.init(jax.random.key(0), jnp.ones((1, 3, img_size, img_size)))
    rng = np.random.default_rng(7)
    # non-zero biases and LN affines, so the bias / affine paths matter
    variables = {"params": jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim == 1 else a, variables["params"])}
    tmodel = tvit.ViT(tvit.deit_config("tiny", style, dtype=td, **overrides), device="cpu")
    load_jax_params(tmodel, jax.tree.map(np.asarray, variables["params"]))
    img = rng.standard_normal((2, 3, img_size, img_size)).astype(np.float32)
    return jmodel, variables, tmodel, img


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a.astype(jnp.float32))


def _check(got, ref, dtype):
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, **FP32)
    else:
        err, scale = np.abs(got - ref).max(), np.abs(ref).max()
        assert err <= BF16_REL * scale, (err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("style", ["standard", "reference"])
@pytest.mark.parametrize("size", ["narrow", "tiny_depth2"])
def test_forward_matches_model_apply(size, style, dtype):
    jmodel, variables, tmodel, img = _models(size, style, dtype)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img))
    _check(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("style", ["standard", "reference"])
@pytest.mark.parametrize("size", ["narrow", "tiny_depth2"])
def test_fused_vit_apply_matches_jax_fused_and_apply(size, style, dtype):
    jmodel, variables, tmodel, img = _models(size, style, dtype)
    with torch.no_grad():
        got = tvit.fused_vit_apply(tmodel, torch.from_numpy(img))
    jfused = jax.jit(functools.partial(jvit.fused_vit_apply, jmodel))
    _check(got, jfused(variables, jnp.asarray(img)), dtype)
    _check(got, jax.jit(jmodel.apply)(variables, jnp.asarray(img)), dtype)


def test_fused_vit_apply_prepared_stack_and_plain_flag():
    _, _, tmodel, img = _models("narrow", "standard", "bfloat16")
    x = torch.from_numpy(img)
    with torch.no_grad():
        a = tvit.fused_vit_apply(tmodel, x)
        b = tvit.fused_vit_apply(tmodel, x, stacked=tvit.prepare_vit_fused(tmodel))
        c = tvit.fused_vit_apply(tmodel, x, plain=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_nonorm_relu_forward_matches_and_fused_refuses():
    """Transitions-compiled models (NoNorm affine, ReLU) run eagerly like
    model.apply, and fused_vit_apply refuses them as the JAX one does."""
    jmodel, variables, tmodel, img = _models("narrow", "standard", "float32",
                                             norm_mode="nonorm", act="relu")
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img))
    _check(got, jmodel.apply(variables, jnp.asarray(img)), "float32")
    with pytest.raises(ValueError, match="layernorm"):
        jvit.fused_vit_apply(jmodel, variables, jnp.asarray(img))
    with pytest.raises(ValueError, match="layernorm"):
        tvit.fused_vit_apply(tmodel, torch.from_numpy(img))


def test_fused_vit_apply_refuses_multi_segment_models():
    """A two-segment model runs one chain per segment; what it refuses is a
    stack built for another segmentation (a uniform stack for a
    two-segment model, a segmented one under ``pack_layers``)."""
    cfg = tvit.deit_config("tiny", **NARROW).replace(heads_per_layer=(2, 1),
                                                      mlp_dim_per_layer=(128, 64))
    assert tvit.encoder_segments(cfg) == jvit.encoder_segments(cfg) == [
        (0, 1, 2, 128), (1, 1, 1, 64)]
    model = tvit.ViT(cfg, device="cpu")
    img = torch.zeros(1, 3, 32, 32)
    segmented = tvit.prepare_vit_fused(model)
    with pytest.raises(ValueError, match="segments into 2"):
        tvit.fused_vit_apply(model, img, stacked=segmented["segments"][0])
    with pytest.raises(ValueError, match="pack_layers=True"):
        tvit.fused_vit_apply(model, img, stacked=segmented, pack_layers=True)
    assert tvit.fused_vit_apply(model, img, stacked=segmented).shape == (1, 10)


@pytest.mark.parametrize("name", ["deit_tiny", "deit_small", "deit_base"])
def test_registry_configs_match_jax(name):
    size = name.split("_")[1]
    for style in ("standard", "reference"):
        j = jvit.deit_config(size, style)
        t = tvit.deit_config(size, style)
        assert t.to_json() == j.to_json()
    with torch.device("meta"):
        model, shape = registry.build_model(name, style="reference", device="meta")
    assert shape == (3, 224, 224)
    assert model.config.reference_residual and model.config.mlp_head
    assert dtype_name(model.config.dtype) == "float32"


_DEFAULT_DEVICE_BUILDS = {
    "ViT": lambda: tvit.ViT(tvit.deit_config("tiny", **NARROW)),
    "T2TViT": lambda: tt2t.T2TViT(tt2t.t2t_vit_config(7, depth=1)),
    "SwinTransformer": lambda: tswin.SwinTransformer(tswin.swin_config("tiny", depths=(1,))),
    "deit_tiny": lambda: registry.build_model("deit_tiny"),
    "t2t_vit_7": lambda: registry.build_model("t2t_vit_7"),
    "swin_tiny": lambda: registry.build_model("swin_tiny"),
}


@pytest.mark.parametrize("build", list(_DEFAULT_DEVICE_BUILDS))
def test_models_default_to_the_card_and_raise_without_one(build, monkeypatch):
    """Without a device argument a model goes to the card; with no card it
    raises and names the way out, rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _DEFAULT_DEVICE_BUILDS[build]()


def test_registry_refuses_unported_models():
    # since the CNN zoo, every name of the JAX registry is ported: an unknown
    # name is what the port still refuses
    from edgevisiontransformer_tpu.models import registry as jax_registry

    assert set(jax_registry.available_models()) <= set(registry.available_models())
    with pytest.raises(KeyError, match="not ported"):
        registry.build_model("vit_giant", device="cpu")


def test_init_is_seeded():
    def build(seed):
        return tvit.ViT(tvit.deit_config("tiny", **NARROW), device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    a, b, c = build(0), build(0), build(1)
    for (n, pa), (_, pb), (_, pc) in zip(a.named_parameters(), b.named_parameters(),
                                         c.named_parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    assert not torch.equal(a.block_0.attn.qkv_kernel, c.block_0.attn.qkv_kernel)
    assert torch.equal(a.block_0.ln1.scale, torch.ones(64))
