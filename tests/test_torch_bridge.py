"""Flax params move into the port exactly (utils/jax_bridge.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.models.vit import ViT as JViT
from edgevisiontransformer_tpu.models.vit import deit_config as jdeit_config
from edgevisiontransformer_tpu.ops.pallas.fused_encoder import stack_vit_layer_params
from edgevisiontransformer_tpu_torch.models.vit import ViT, deit_config, prepare_vit_fused
from edgevisiontransformer_tpu_torch.utils.jax_bridge import (flatten_tree, load_jax_params,
                                                              stacked_from_params, to_torch)

torch.set_num_threads(1)

NARROW = dict(image_size=32, dim=64, depth=3, heads=2, mlp_dim=128, num_classes=10)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_params(style, **kw):
    cfg = jdeit_config("tiny", style, **{**NARROW, **kw})
    return cfg, JViT(cfg).init(jax.random.key(0), jnp.ones((1, 3, 32, 32)))["params"]


def _same(t: torch.Tensor, a) -> bool:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return (t.dtype == torch.bfloat16
                and np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16)))
    return t.dtype == torch.from_numpy(np.array(a)).dtype and np.array_equal(t.numpy(), a)


@pytest.mark.parametrize("style", ["standard", "reference"])
def test_load_jax_params_is_exact(style):
    jcfg, params = _jax_params(style)
    model = ViT(deit_config("tiny", style, **NARROW))
    load_jax_params(model, _np(params))
    flat = flatten_tree(_np(params))
    named = dict(model.named_parameters())
    assert set(named) == set(flat)
    for name, arr in flat.items():
        assert _same(named[name].detach(), arr), name
    # params() gives back the Flax tree's structure
    assert set(flatten_tree(model.params())) == set(flat)


def test_load_jax_params_bf16_is_exact():
    _, params = _jax_params("standard", param_dtype=jnp.bfloat16)
    model = ViT(deit_config("tiny", "standard", param_dtype=torch.bfloat16, **NARROW))
    load_jax_params(model, _np(params))
    for name, arr in flatten_tree(_np(params)).items():
        assert _same(dict(model.named_parameters())[name].detach(), arr), name


def test_load_jax_params_refuses_mismatched_trees():
    _, params = _jax_params("standard")
    p = _np(params)
    model = ViT(deit_config("tiny", "reference", **NARROW))  # other head, no qkv bias
    with pytest.raises(KeyError):
        load_jax_params(model, p)
    model = ViT(deit_config("tiny", "standard", **{**NARROW, "mlp_dim": 64}))
    with pytest.raises(ValueError):
        load_jax_params(model, p)


@pytest.mark.parametrize("qkv_bias", [True, False])
@pytest.mark.parametrize("start,depth", [(0, 3), (1, 2)])
def test_stacked_from_params_is_exact(qkv_bias, start, depth):
    style = "standard" if qkv_bias else "reference"
    _, params = _jax_params(style)
    ref = stack_vit_layer_params(params, depth, qkv_bias, start=start)
    got = stacked_from_params(_np(params), depth, qkv_bias, start=start)
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
        assert _same(got[k], np.asarray(ref[k])), k


def test_prepare_vit_fused_matches_jax_stack():
    """The port's own stack of a model loaded from Flax params equals the
    JAX stack cast to the compute dtype, bit for bit."""
    _, params = _jax_params("standard")
    model = ViT(deit_config("tiny", "standard", dtype=torch.bfloat16, **NARROW))
    load_jax_params(model, _np(params))
    ref = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                       stack_vit_layer_params(params, 3, True))
    got = prepare_vit_fused(model)
    for k in ref:
        assert got[k].is_contiguous()
        assert _same(got[k], np.asarray(ref[k])), k


def test_to_torch_roundtrip_bf16():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 17), jnp.bfloat16))
    t = to_torch(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
