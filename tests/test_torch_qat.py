"""The port's parameter cast and quantization-aware training against the JAX
package on the same params and inputs: ``cast_params``, the weight and
activation fake quants bit for bit in fp32 with their straight-through
gradients against ``jax.grad``, ``fake_quant_tree`` / ``fake_quant_vit_encoder``
bit for bit, and the static-aware QAT forwards (logits, gradients and the
observed absmax) at a narrow DeiT of depth 2."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.models import vit as jvit
from edgevisiontransformer_tpu.ops import quant as jq
from edgevisiontransformer_tpu_torch.bench.qat_oracle import matmul_deviation
from edgevisiontransformer_tpu_torch.models import vit as tvit
from edgevisiontransformer_tpu_torch.ops import quant as tq
from edgevisiontransformer_tpu_torch.utils.jax_bridge import (flatten_tree, load_jax_params,
                                                              to_torch)

torch.set_num_threads(1)

NARROW = dict(image_size=32, dim=64, depth=2, heads=2, mlp_dim=128, num_classes=10)
# QAT logits and their gradients in fp32: the same quant points, the
# matmuls and LayerNorms summed in another order; a sum that lands next to a
# rounding tie of the next fake quant moves one quantum, so the bound is on
# max |err| / max |ref|
QAT_REL = 2e-4
GRAD_REL = 2e-3


def _tree_np(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def _torch_tree(tree_np: dict, requires_grad: bool = False) -> dict:
    out: dict = {}
    for k, v in flatten_tree(tree_np).items():
        *path, leaf = k.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = to_torch(v).requires_grad_(requires_grad)
    return out


@functools.lru_cache(maxsize=None)
def _models(style: str = "standard"):
    jmodel = jvit.ViT(jvit.deit_config("tiny", style, **NARROW))
    n = NARROW["image_size"]
    variables = jmodel.init(jax.random.key(3), jnp.ones((1, 3, n, n)))
    rng = np.random.default_rng(5)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(
        np.float32) if a.ndim == 1 else np.asarray(a), variables["params"])
    tmodel = tvit.ViT(tvit.deit_config("tiny", style, **NARROW), device="cpu")
    load_jax_params(tmodel, params)
    img = rng.standard_normal((2, 3, n, n)).astype(np.float32)
    scales = jq.calibrate_vit(jmodel, {"params": params}, batches=[img])
    return jmodel, params, tmodel, img, scales


# ---------------------------------------------------------------------------
# cast_params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cast_params_matches_jax(dtype):
    rng = np.random.default_rng(0)
    tree = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                  "i": np.arange(5, dtype=np.int32)},
            "b": rng.standard_normal(7).astype(np.float32),
            "q": np.array([1, -2, 3], np.int8)}
    want = _tree_np(jq.cast_params(tree, getattr(jnp, dtype)))
    got = flatten_tree(tq.cast_params(_torch_tree(tree), getattr(torch, dtype)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        ref = to_torch(w)
        assert got[k].dtype == ref.dtype, k
        assert torch.equal(got[k], ref), k


# ---------------------------------------------------------------------------
# The fake quants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 192), (192, 24), (5, 3)])
def test_fake_quant_ste_bit_for_bit_and_straight_through(shape):
    rng = np.random.default_rng(shape[0])
    w = (rng.standard_normal(shape) * rng.uniform(1e-3, 3, shape[1])).astype(np.float32)
    w[:, 0] = 0.0  # a dead output channel: scale 1
    gout = rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray(jq.fake_quant_ste(jnp.asarray(w)))
    ref_g = np.asarray(jax.grad(lambda a: jnp.sum(jq.fake_quant_ste(a) * gout))(jnp.asarray(w)))
    tw = torch.from_numpy(w).requires_grad_()
    got = tq.fake_quant_ste(tw)
    np.testing.assert_array_equal(got.detach().numpy(), ref)
    (got * torch.from_numpy(gout)).sum().backward()
    np.testing.assert_array_equal(tw.grad.numpy(), ref_g)
    np.testing.assert_array_equal(tw.grad.numpy(), gout)


def _act_inputs(scale: float) -> np.ndarray:
    """Values on either side of rounding ties (x / scale = k + 0.5 give or
    take an ulp), saturated ones past +-127 quanta, zeros and normals."""
    rng = np.random.default_rng(1)
    k = np.arange(-130, 131, dtype=np.float32)
    ties = ((k + np.float32(0.5)) * np.float32(scale)).astype(np.float32)
    near = np.concatenate([ties, np.nextafter(ties, np.float32(np.inf)),
                           np.nextafter(ties, np.float32(-np.inf))])
    return np.concatenate([near, np.float32(scale) * rng.uniform(-200, 200, 300).astype(
        np.float32), np.zeros(3, np.float32)]).astype(np.float32)


@pytest.mark.parametrize("scale", [0.1, 0.0137, 1.7e-3, 3.0])
def test_fake_quant_act_ste_bit_for_bit_with_clip_masked_gradient(scale):
    x = _act_inputs(scale)
    gout = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    ref = np.asarray(jq.fake_quant_act_ste(jnp.asarray(x), scale))
    ref_g = np.asarray(jax.grad(lambda a: jnp.sum(jq.fake_quant_act_ste(a, scale) * gout))(
        jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    got = tq.fake_quant_act_ste(tx, scale)
    np.testing.assert_array_equal(got.detach().numpy(), ref)
    (got * torch.from_numpy(gout)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), ref_g)
    assert (tx.grad.numpy()[np.abs(x / np.float32(scale)) > 127] == 0).all()


@pytest.mark.parametrize("scale", [0.1, 0.0137, 1.7e-3, 3.0])
def test_fake_quant_act_traced_scale_bit_for_bit(scale):
    x = _act_inputs(scale)
    gout = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    sc = jnp.float32(scale)
    ref = np.asarray(jq.fake_quant_act(jnp.asarray(x), sc))
    ref_g = np.asarray(jax.grad(lambda a: jnp.sum(jq.fake_quant_act(a, sc) * gout))(
        jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    got = tq.fake_quant_act(tx, torch.tensor(scale, dtype=torch.float32))
    np.testing.assert_array_equal(got.detach().numpy(), ref)
    np.testing.assert_array_equal(
        got.detach().numpy(), tq.fake_quant_act_ste(torch.from_numpy(x), scale).numpy())
    (got * torch.from_numpy(gout)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), ref_g)


@pytest.mark.parametrize("wrapped", [False, True])
def test_fake_quant_trees_bit_for_bit(wrapped):
    _, params, _, _, _ = _models()
    tree = {"params": params} if wrapped else params
    ttree = _torch_tree(tree)
    for jfn, tfn in ((jq.fake_quant_tree, tq.fake_quant_tree),
                     (jq.fake_quant_vit_encoder, tq.fake_quant_vit_encoder)):
        # eager, as the functions are defined: under jit XLA fuses the
        # round trip and moves some results by an ulp
        want = _tree_np(jfn(jax.tree.map(jnp.asarray, tree)))
        got = flatten_tree(tfn(ttree))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    # the encoder form quantizes the four encoder matmuls of each block only
    enc = flatten_tree(tq.fake_quant_vit_encoder(ttree))
    plain = flatten_tree(ttree)
    changed = sorted(k for k in plain if not torch.equal(enc[k], plain[k]))
    assert changed == sorted(f"{'params.' if wrapped else ''}block_{i}.{s}.{w}"
                             for i in range(2) for s, w in tq._VIT_MATMUL_KEYS)


# ---------------------------------------------------------------------------
# The static-aware QAT forwards
# ---------------------------------------------------------------------------


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("style", ["standard", "reference"])
def test_fake_quant_vit_apply_static_and_observed_match_jax(style):
    jmodel, params, tmodel, img, scales = _models(style)
    gout = np.random.default_rng(9).standard_normal((img.shape[0], 10)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jq.fake_quant_vit_apply_static(jmodel, p, scales, jnp.asarray(img))
                       * gout)

    jp = jax.tree.map(jnp.asarray, params)
    ref = np.asarray(jax.jit(lambda p: jq.fake_quant_vit_apply_static(
        jmodel, p, scales, jnp.asarray(img)))(jp))
    ref_g = _tree_np(jax.jit(jax.grad(jloss))(jp))
    ref_o, ref_seen = jax.jit(lambda p: jq.fake_quant_vit_apply_observed(
        jmodel, p, scales, jnp.asarray(img)))(jp)

    tparams = _torch_tree(params, requires_grad=True)
    timg = torch.from_numpy(img)
    got = tq.fake_quant_vit_apply_static(tmodel, tparams, scales, timg)
    assert _rel(got.detach().numpy(), ref) < QAT_REL
    (got * torch.from_numpy(gout)).sum().backward()
    for k, g in flatten_tree(tparams).items():
        assert g.grad is not None and torch.isfinite(g.grad).all(), k
        assert _rel(g.grad.numpy(), ref_g[k]) < GRAD_REL, k
    # the encoder weights reach their gradient through the weight STE
    assert float(tparams["block_0"]["attn"]["qkv_kernel"].grad.abs().sum()) > 0

    o, seen = tq.fake_quant_vit_apply_observed(tmodel, {"params": _torch_tree(params)},
                                               torch.from_numpy(scales), timg)
    assert torch.equal(o, got.detach())
    assert seen.shape == (2, 4) and seen.dtype == torch.float32 and not seen.requires_grad
    np.testing.assert_allclose(seen.numpy(), np.asarray(ref_seen), rtol=1e-5)
    assert _rel(o.numpy(), np.asarray(ref_o)) < QAT_REL
    # scales came from absmax / 127 on this batch: qkv_in's observed absmax
    # is its scale's 127 quanta
    assert abs(float(seen[0, 0]) / 127.0 - float(scales[0, 0])) < 1e-4


def test_fake_quant_vit_apply_static_matches_the_deployment_oracle():
    """The JAX package's own check (tests/test_quant.py:419-421): the QAT
    forward against the eager static-int8 oracle on the statically
    quantized tree, within 2e-2 of max|logit|."""
    _, params, tmodel, img, scales = _models()
    timg = torch.from_numpy(img)
    tree = _torch_tree(params)
    ref = tq.int8_vit_apply_static(tmodel, tq.quantize_vit_params_int8_static(tree, scales), timg)
    got = tq.fake_quant_vit_apply_static(tmodel, tree, scales, timg)
    assert _rel(got.numpy(), ref.numpy()) < 2e-2


def test_each_qat_matmul_reproduces_the_deployment_product():
    """Each encoder matmul on the oracle's input: the QAT product
    ``fq(x) @ fq(w)`` against the static-int8 product within fp32 rounding
    of the products' sum (1e-5 of max|product|; here no input sits on a
    rounding tie that the QAT's division and the oracle's reciprocal product
    would round apart), where the unquantized ``x @ w`` misses by the
    quantization noise."""
    _, params, tmodel, img, scales = _models()
    tree = _torch_tree(params)
    qtree = tq.quantize_vit_params_int8_static(tree, scales)
    dev = matmul_deviation(tmodel.config, tree, qtree, scales, torch.from_numpy(img))
    assert dev["qat_max"] < 1e-5 and dev["qat_share"] == 0.0, dev
    assert dev["plain_max"] > 1e-3 and dev["plain_share"] > 0.5, dev
