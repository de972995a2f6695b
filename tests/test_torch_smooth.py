"""The port's SmoothQuant against the JAX package on the same params and
batches: ``_collect_channel_maxes``, ``smooth_encoder_params`` (bit for bit
on the same channel maxima), ``smooth_vit`` and ``smooth_t2t``, in both
residual styles and with ``qkv_bias`` on and off, at a narrow DeiT and the
narrow T2T-ViT-7 of ``tests/test_torch_t2t.py``; and the smoothed tree's
forward against the unsmoothed one."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.models import t2t_vit as jt2t
from edgevisiontransformer_tpu.models import vit as jvit
from edgevisiontransformer_tpu.ops import quant as jq
from edgevisiontransformer_tpu_torch.models import t2t_vit as tt2t
from edgevisiontransformer_tpu_torch.models import vit as tvit
from edgevisiontransformer_tpu_torch.ops import quant as tq
from edgevisiontransformer_tpu_torch.utils.jax_bridge import (flatten_tree, load_jax_params,
                                                              load_jax_variables, to_torch)

torch.set_num_threads(1)

NARROW = dict(image_size=32, dim=64, depth=2, heads=2, mlp_dim=128, num_classes=10)
T2T_NARROW = dict(depth=2, num_classes=10, dim=128, heads=2, mlp_dim=256)
# (style, qkv_bias): the residual forms decide which folds apply, the bias
# whether the v columns' bias is scaled
CASES = [("standard", True), ("standard", False), ("reference", True), ("reference", False)]
# channel maxima and the smoothed trees: the same fp32 forward summed in
# another order (the ViT embedding, the T2T performers), rtol as
# calibrate_vit's and calibrate_t2t's tests; s = a^0.5 / w^0.5 halves it
VIT_RTOL = 1e-5
T2T_RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def _vit(style: str, qkv_bias: bool):
    kw = dict(NARROW, qkv_bias=qkv_bias)
    jmodel = jvit.ViT(jvit.deit_config("tiny", style, **kw))
    n = NARROW["image_size"]
    variables = jmodel.init(jax.random.key(4), jnp.ones((1, 3, n, n)))
    rng = np.random.default_rng(6)
    # outlier channels in the LayerNorm scales, as SmoothQuant targets
    params = jax.tree.map(lambda a: np.asarray(a) * rng.uniform(0.2, 4.0, a.shape).astype(
        np.float32) + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim == 1 else np.asarray(a), variables["params"])
    tmodel = tvit.ViT(tvit.deit_config("tiny", style, **kw), device="cpu")
    load_jax_params(tmodel, params)
    batches = list(jq.representative_batches(n=2, batch=2, shape=(3, n, n), seed=2))
    return jmodel, {"params": params}, tmodel, batches


@functools.lru_cache(maxsize=None)
def _t2t():
    jmodel = jt2t.T2TViT(jt2t.t2t_vit_config(7, "reference", **T2T_NARROW))
    v = jax.jit(jmodel.init)(jax.random.key(1), jnp.ones((1, 3, 224, 224)))
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(
        np.float32) if a.ndim == 1 else np.asarray(a), v["params"])
    variables = {"params": params, "constants": jax.tree.map(np.asarray, v["constants"])}
    tmodel = tt2t.T2TViT(tt2t.t2t_vit_config(7, "reference", **T2T_NARROW), device="cpu")
    load_jax_variables(tmodel, variables)
    batches = list(jq.representative_batches(n=1, batch=1, shape=(3, 224, 224), seed=3))
    return jmodel, variables, tmodel, batches


def _assert_trees_close(got: dict, want: dict, rtol: float):
    g = flatten_tree(got)
    w = {k: np.asarray(v) for k, v in flatten_tree(want).items()}
    assert sorted(g) == sorted(w), sorted(set(g) ^ set(w))
    for k, ref in w.items():
        assert g[k].dtype == to_torch(ref).dtype, k
        if rtol == 0:
            np.testing.assert_array_equal(g[k].numpy(), ref, err_msg=k)
        else:
            np.testing.assert_allclose(g[k].numpy(), ref, rtol=rtol, atol=1e-7, err_msg=k)


def _vit_embed_jax(jmodel):
    return lambda v, im: jq._embed_vit(jmodel.config, v["params"], im)


def _vit_embed_port(tmodel):
    return lambda p, im: tq._embed_vit(tmodel.config, p, im)


@pytest.mark.parametrize("style,qkv_bias", CASES)
def test_collect_channel_maxes_matches_jax(style, qkv_bias):
    jmodel, variables, tmodel, batches = _vit(style, qkv_bias)
    want = jq._collect_channel_maxes(_vit_embed_jax(jmodel), jmodel, variables, batches)
    got = tq._collect_channel_maxes(_vit_embed_port(tmodel), tmodel, tmodel.params(), batches)
    assert sorted(got) == sorted(want) == ["block_0", "block_1"]
    for blk in want:
        assert sorted(got[blk]) == sorted(tq.SMOOTH_KEYS) == sorted(jq.SMOOTH_KEYS)
        for key, ref in want[blk].items():
            assert got[blk][key].dtype == np.float32 and got[blk][key].shape == ref.shape
            np.testing.assert_allclose(got[blk][key], ref, rtol=VIT_RTOL, err_msg=(blk, key))


@pytest.mark.parametrize("style,qkv_bias", CASES)
def test_smooth_encoder_params_bit_for_bit(style, qkv_bias):
    """On the same channel maxima the folds are the same fp32 operations:
    the trees agree bit for bit, bare and wrapped."""
    jmodel, variables, tmodel, batches = _vit(style, qkv_bias)
    ch = jq._collect_channel_maxes(_vit_embed_jax(jmodel), jmodel, variables, batches)
    want = jq.smooth_encoder_params(jmodel.config, variables, ch)
    got = tq.smooth_encoder_params(tmodel.config, {"params": tmodel.params()}, ch)
    _assert_trees_close(got, want, rtol=0)
    bare = tq.smooth_encoder_params(tmodel.config, tmodel.params(), ch, alpha=0.7)
    _assert_trees_close(bare, jq.smooth_encoder_params(jmodel.config, variables["params"], ch,
                                                       alpha=0.7), rtol=0)
    # with the residual quirk the LayerNorms are not folded
    p = tmodel.params()
    same = [torch.equal(got["params"]["block_0"]["ln1"][k], p["block_0"]["ln1"][k])
            for k in ("scale", "bias")]
    assert all(same) == (style == "reference")


@pytest.mark.parametrize("style,qkv_bias", CASES)
def test_smooth_vit_matches_jax_and_keeps_the_function(style, qkv_bias):
    jmodel, variables, tmodel, batches = _vit(style, qkv_bias)
    want = jq.smooth_vit(jmodel, variables, batches=batches)
    got = tq.smooth_vit(tmodel, batches=batches)
    _assert_trees_close(got, want["params"], rtol=VIT_RTOL)
    # the same function re-parameterized: fp32 logits within the rounding
    # of the folded scales, 1e-4 of max|logit|
    img = torch.from_numpy(batches[0])
    ref = tvit.apply_params(tmodel, tmodel.params(), img)
    out = tvit.apply_params(tmodel, got, img)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_smooth_vit_default_batches_match_jax():
    jmodel, variables, tmodel, _ = _vit("standard", True)
    _assert_trees_close(tq.smooth_vit(tmodel, n=1), jq.smooth_vit(jmodel, variables, n=1)[
        "params"], rtol=VIT_RTOL)


def test_smooth_t2t_matches_jax_and_keeps_the_function():
    """T2T-ViT-7 (reference style: only the out_in fold) on the same batch;
    the performers sum in another order, so within calibrate_t2t's rtol."""
    jmodel, variables, tmodel, batches = _t2t()
    want = jq.smooth_t2t(jmodel, variables, batches=batches)
    got = tq.smooth_t2t(tmodel, batches=batches)
    _assert_trees_close(got, want["params"], rtol=T2T_RTOL)
    img = torch.from_numpy(batches[0])
    with torch.no_grad():
        ref = tmodel(img)
        try:
            out = tvit.load_params(tmodel, got)(img)
        finally:
            tvit.load_params(tmodel, _torch_params(variables["params"]))
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def _torch_params(params_np: dict) -> dict:
    out: dict = {}
    for k, v in flatten_tree(params_np).items():
        *path, leaf = k.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = to_torch(v)
    return out
