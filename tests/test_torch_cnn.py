"""The port's CNN zoo against the JAX zoo: parameter counts, names, and logits
on the same weights and BatchNorm statistics (fp32, CPU)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.models.cnn.zoo import CNN_ZOO as JAX_ZOO
from edgevisiontransformer_tpu.models.cnn.zoo import get_cnn as jax_cnn
from edgevisiontransformer_tpu_torch.models.cnn import common
from edgevisiontransformer_tpu_torch.models.cnn.zoo import CNN_ZOO, get_cnn
from edgevisiontransformer_tpu_torch.models.registry import available_models, build_model
from edgevisiontransformer_tpu_torch.utils.jax_bridge import load_flax_cnn

torch.set_num_threads(1)

NAMES = sorted(JAX_ZOO)
# fp32 on both sides, the same weights and statistics: the two frameworks'
# convolutions sum in other orders (1e-6 of max|logit| measured)
LOGIT_REL = 1e-5


def smallest_image(name: str) -> int:
    """The smallest square input each model accepts: 75 for the inception
    models (their VALID stem and two reductions), 32 for the rest."""
    return 75 if name.startswith("inception") else 32


@functools.lru_cache(maxsize=None)
def _jax_shapes(name: str, classes: int):
    x = jnp.zeros((2, 3, smallest_image(name), smallest_image(name)), jnp.float32)
    return jax.eval_shape(jax_cnn(name, num_classes=classes).init, jax.random.key(0), x)


def _random_variables(shapes, seed: int):
    """Every leaf drawn from a seed: kernels of variance 1 / fan_in, BatchNorm
    scales near 1, positive variances, small biases and means."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if name.endswith("['var']"):
            return (0.5 + rng.rand(*s.shape)).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_the_zoo_has_the_jax_models():
    assert sorted(CNN_ZOO) == NAMES and len(NAMES) == 15
    assert set(NAMES) <= set(available_models())


@pytest.mark.parametrize("name", NAMES)
def test_param_count_and_names_match_jax(name):
    shapes = _jax_shapes(name, 1000)
    model = get_cnn(name, device="meta")
    flat = {jax.tree_util.keystr(p): int(np.prod(s.shape))
            for p, s in jax.tree_util.tree_leaves_with_path(shapes["params"])}
    assert sum(p.numel() for p in model.parameters()) == sum(flat.values())
    names = {"".join(f"['{k}']" for k in n.split(".")) for n, _ in model.named_parameters()}
    assert names == set(flat)
    stats = {"".join(f"['{k}']" for k in n.split(".")) for n, _ in model.named_buffers()}
    assert stats == {jax.tree_util.keystr(p)
                     for p, _ in jax.tree_util.tree_leaves_with_path(shapes.get("batch_stats",
                                                                                {}))}


@pytest.mark.parametrize("name", NAMES)
def test_logits_match_jax(name):
    size = smallest_image(name)
    x = np.random.RandomState(0).randn(2, 3, size, size).astype(np.float32)
    # the shapes the parameter-count test traced; JAX's apply under jit
    # (eager dispatch of the deep models takes most of this file's time)
    variables = _random_variables(_jax_shapes(name, 1000), seed=1)
    ref = np.asarray(jax.jit(jax_cnn(name).apply)(variables, jnp.asarray(x)))
    model = load_flax_cnn(get_cnn(name, device="cpu"), variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 1000)
    assert np.abs(ref).max() > 0
    np.testing.assert_array_less(np.abs(got - ref).max(), LOGIT_REL * np.abs(ref).max())


def test_registry_builds_a_cnn_with_the_224_config():
    model, shape = build_model("mobilenet_v2", device="cpu", dtype=torch.bfloat16,
                               style="standard", generator=torch.Generator().manual_seed(0))
    assert model.config.image_size == 224 and shape == (3, 224, 224)
    assert next(model.parameters()).dtype == torch.float32
    with torch.no_grad():
        y = model(torch.randn(1, *shape, generator=torch.Generator().manual_seed(1)))
    assert y.shape == (1, 1000) and torch.isfinite(y).all()


def test_cnn_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_cnn("squeezenet")


def test_load_flax_cnn_raises_on_a_missing_or_extra_leaf():
    variables = _random_variables(_jax_shapes("squeezenet", 1000), seed=2)
    model = get_cnn("squeezenet", device="cpu")
    params = dict(variables["params"])
    params["Conv_9"] = {"kernel": np.zeros((1, 1, 2, 2), np.float32)}
    with pytest.raises(KeyError, match="Conv_9"):
        load_flax_cnn(model, {"params": params})
    params.pop("Conv_9")
    params.pop("Conv_0")
    with pytest.raises(KeyError, match="Conv_0"):
        load_flax_cnn(model, {"params": params})


@pytest.mark.parametrize("size,kernel,stride,want", [
    (224, 3, 2, (0, 1)), (225, 3, 2, (1, 1)), (32, 7, 2, (2, 3)), (5, 1, 2, (0, 0)),
    (17, 3, 1, (1, 1)), (8, 5, 1, (2, 2))])
def test_same_padding_is_tfs_rule(size, kernel, stride, want):
    assert common.same_pads(size, kernel, stride) == want
    # and the padded convolution is Flax's on an uneven split
    from flax import linen as fnn

    x = np.random.RandomState(3).randn(1, 2, size, size).astype(np.float32)
    conv = fnn.Conv(3, (kernel, kernel), strides=(stride, stride), padding="SAME")
    v = conv.init(jax.random.key(0), jnp.asarray(x.transpose(0, 2, 3, 1)))
    ref = np.asarray(conv.apply(v, jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    mine = common.Conv(2, 3, (kernel, kernel), stride)
    with torch.no_grad():
        mine.kernel.copy_(torch.from_numpy(np.array(v["params"]["kernel"]).transpose(3, 2, 0, 1)))
        mine.bias.copy_(torch.from_numpy(np.array(v["params"]["bias"])))
        got = mine(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size,stride", [(7, 2), (8, 2), (6, 1)])
def test_pools_match_flax(size, stride):
    from flax import linen as fnn

    x = np.random.RandomState(4).randn(2, 3, size, size).astype(np.float32)
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    for padding in ("SAME", "VALID"):
        ref = np.asarray(fnn.max_pool(xh, (3, 3), (stride, stride), padding=padding))
        got = common.max_pool(torch.from_numpy(x), 3, stride, padding).numpy()
        np.testing.assert_array_equal(got, ref.transpose(0, 3, 1, 2))
        ref = np.asarray(fnn.avg_pool(xh, (3, 3), (stride, stride), padding=padding))
        got = common.avg_pool(torch.from_numpy(x), 3, stride, padding).numpy()
        np.testing.assert_allclose(got, ref.transpose(0, 3, 1, 2), rtol=1e-6, atol=1e-6)


def test_channel_shuffle_matches_jax():
    from edgevisiontransformer_tpu.models.cnn.common import channel_shuffle as jax_shuffle

    x = np.arange(2 * 12 * 2 * 3, dtype=np.float32).reshape(2, 12, 2, 3)
    ref = np.asarray(jax_shuffle(jnp.asarray(x.transpose(0, 2, 3, 1)), 3)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(common.channel_shuffle(torch.from_numpy(x), 3).numpy(), ref)


@pytest.mark.parametrize("name,eps", [("resnet50", {1e-3}), ("resnet50_v2", {1e-3, 1e-5}),
                                      ("inception_v3", {1e-3})])
def test_batchnorm_epsilon_per_block(name, eps):
    model = get_cnn(name, device="meta")
    found = {m.epsilon for m in model.modules() if isinstance(m, common.BatchNorm)}
    assert found == eps
