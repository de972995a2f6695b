"""The port's head pruning (``pruning/policy``, ``magnitude_pruners``,
``apply``, ``head_importance``, ``iterative``) against the JAX package on
the same params and images, at the tiny config of tests/test_movement.py
(dim 64, depth 2, 4 heads of 16, mlp 128, 32x32 images, 10 classes):
policy outputs, masks and sliced params exactly; the importance of one
batch against ``jax.grad`` and its accumulation within 1e-5 relative; the
iterative loop's descriptors per level, its checkpoints and accuracy
markers."""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.models import vit as jvit
from edgevisiontransformer_tpu.pruning import apply as japply
from edgevisiontransformer_tpu.pruning import head_importance as jhi
from edgevisiontransformer_tpu.pruning import iterative as jit_
from edgevisiontransformer_tpu.pruning import magnitude_pruners as jmp
from edgevisiontransformer_tpu.pruning import policy as jpol
from edgevisiontransformer_tpu_torch.models import vit as tvit
from edgevisiontransformer_tpu_torch.pruning import apply as tapply
from edgevisiontransformer_tpu_torch.pruning import head_importance as thi
from edgevisiontransformer_tpu_torch.pruning import iterative as tit
from edgevisiontransformer_tpu_torch.pruning import magnitude_pruners as tmp
from edgevisiontransformer_tpu_torch.pruning import policy as tpol
from edgevisiontransformer_tpu_torch.utils.checkpoint import load_checkpoint, load_meta
from edgevisiontransformer_tpu_torch.utils.imagenet import has_accuracy_marker
from edgevisiontransformer_tpu_torch.utils.jax_bridge import flatten_tree, tree_to_torch

torch.set_num_threads(1)

# tests/test_movement.py:27-31
TINY = dict(image_size=32, patch_size=16, dim=64, depth=2, heads=4, mlp_dim=128,
            num_classes=10, head_dim=16)
# fp32 sums in another order (XLA against torch's CPU kernels) through two
# layers and a backward
REL = 1e-5


@functools.lru_cache(maxsize=None)
def _setup(style="standard"):
    jcfg = jvit.deit_config("tiny", style).replace(**TINY)
    tcfg = tvit.deit_config("tiny", style).replace(**TINY)
    assert tcfg.to_json() == jcfg.to_json()
    variables = jvit.ViT(jcfg).init(jax.random.key(0), jnp.ones((1, 3, 32, 32)))
    rng = np.random.default_rng(11)
    # biases and LN affines off their init values, so every leaf matters
    params = jax.tree.map(lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape)
                                                     ).astype(np.float32)
                          if a.ndim == 1 else np.asarray(a), variables["params"])
    images = [rng.standard_normal((3, 3, 32, 32)).astype(np.float32) for _ in range(2)]
    return jcfg, tcfg, params, images


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_trees_equal(got, want):
    g, w = flatten_tree(got), flatten_tree(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(_np(g[k]), _np(w[k]), err_msg=k)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("descs,reverse", [(["1:1,3", "2:2", "1:4"], False),
                                           (["1:1", "2:2,3"], True)])
def test_descriptors_match_jax(descs, reverse):
    want = jpol.parse_head_pruning_descriptors(descs, reverse, n_heads=4)
    got = tpol.parse_head_pruning_descriptors(descs, reverse, n_heads=4)
    assert got == want
    assert tpol.to_pruning_descriptor(got) == jpol.to_pruning_descriptor(want)


@pytest.mark.parametrize("numbers,percents,at_least", [
    ((12, 4, 30), None, 0), (None, (10, 20, 50, 90), 1), (None, (25, 50, 75, 100), 2)])
def test_pruning_sequence_matches_jax(numbers, percents, at_least):
    args = (numbers, percents, 12, 12, at_least)
    assert tpol.determine_pruning_sequence(*args) == jpol.determine_pruning_sequence(*args)


@pytest.mark.parametrize("n,at_least,rescale", [(5, 0, False), (9, 1, False), (7, 2, True)])
def test_what_to_prune_matches_jax(n, at_least, rescale):
    imp = np.random.default_rng(3).random((6, 4))
    prior = {1: {0}, 4: {2, 3}}
    want = jpol.what_to_prune(imp, n, prior, at_least, rescale)
    got = tpol.what_to_prune(imp, n, prior, at_least, rescale)
    assert got == want
    assert prior == {1: {0}, 4: {2, 3}}  # the caller's dict is not touched


def test_importance_txt_round_trip(tmp_path):
    imp = np.random.default_rng(4).random((3, 4))
    tpol.save_head_importance_txt(str(tmp_path / "imp.txt"), imp)
    np.testing.assert_array_equal(tpol.load_head_importance_txt(str(tmp_path / "imp.txt")),
                                  jpol.load_head_importance_txt(str(tmp_path / "imp.txt")))


# ---------------------------------------------------------------------------
# magnitude pruners
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("amount", [0.25, 3, 0.0])
def test_magnitude_masks_match_jax(amount):
    w = np.random.default_rng(5).standard_normal((16, 24)).astype(np.float32)
    pairs = [
        (lambda m: m.block_prune_mask(w, amount, 4, 8)),
        (lambda m: m.block_prune_mask(w, amount, 4, 8, ord=1)),
        (lambda m: m.ln_smart_structured_mask(w, amount, ord=1)),
        (lambda m: m.ln_smart_structured_mask(w.T, amount, ord=2)),
        (lambda m: m.ln_structured_mask(w, amount, dim=0)),
        (lambda m: m.ln_structured_mask(w, amount, dim=1, ord=2)),
        (lambda m: m.l1_unstructured_mask(w, amount)),
        (lambda m: m.random_unstructured_mask(w, amount, seed=3)),
    ]
    for f in pairs:
        want, got = f(jmp), f(tmp)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_hybrid_prune_params_matches_jax():
    jcfg, tcfg, params, _ = _setup()
    want = jmp.hybrid_prune_params(jcfg, {"params": params}, 0.5)
    got = tmp.hybrid_prune_params(tcfg, {"params": tree_to_torch(params)}, 0.5)
    _assert_trees_equal(got, want)
    assert float((got["params"]["block_0"]["ffn"]["fc1_kernel"] == 0).float().mean()) > 0.3
    with pytest.raises(ValueError, match="out of range"):
        tmp.block_prune_mask(np.ones((4, 4), np.float32), 5, 2, 2)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


TO_PRUNE = {0: {1, 3}, 1: {0}}


def test_prune_heads_params_matches_jax():
    jcfg, tcfg, params, _ = _setup()
    jnew_cfg, want = japply.prune_heads_params(jcfg, {"params": params}, TO_PRUNE)
    tnew_cfg, got = tapply.prune_heads_params(tcfg, {"params": tree_to_torch(params)}, TO_PRUNE)
    assert tnew_cfg.to_json() == jnew_cfg.to_json()
    assert tnew_cfg.heads_per_layer == (2, 3)
    _assert_trees_equal(got, want)
    # the sliced tree runs in the port's model at its new shapes
    model = tvit.ViT(tnew_cfg, device="cpu")
    tvit.load_params(model, got)


def test_prune_ffn_params_matches_jax():
    jcfg, tcfg, params, _ = _setup()
    keep = {0: [0, 5, 127], 1: [3]}
    jnew_cfg, want = japply.prune_ffn_params(jcfg, params, keep)
    tnew_cfg, got = tapply.prune_ffn_params(tcfg, tree_to_torch(params), keep)
    assert tnew_cfg.to_json() == jnew_cfg.to_json()
    assert tnew_cfg.mlp_dim_per_layer == (3, 1)
    _assert_trees_equal(got, want)


def test_mask_heads_params_matches_jax():
    jcfg, tcfg, params, images = _setup()
    want = japply.mask_heads_params(jcfg, {"params": params}, TO_PRUNE)
    tparams = tree_to_torch(params)
    got = tapply.mask_heads_params(tcfg, {"params": tparams}, TO_PRUNE)
    _assert_trees_equal(got, want)
    # the input tree is untouched; masking equals pruning on the logits
    assert bool(tparams["block_0"]["attn"]["out_kernel"][16:32].any())
    pcfg, pruned = tapply.prune_heads_params(tcfg, {"params": tparams}, TO_PRUNE)
    x = torch.from_numpy(images[0])
    with torch.no_grad():
        masked = tvit.apply_params(tvit.ViT(tcfg, device="cpu"), got, x)
        sliced = tvit.apply_params(tvit.ViT(pcfg, device="cpu"), pruned, x)
    torch.testing.assert_close(masked, sliced, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# head importance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("style,pruned", [("standard", False), ("reference", False),
                                          ("standard", True)])
def test_head_importance_batch_matches_jax_grad(style, pruned):
    """The per-(layer, head) sums of |d sum(logits) / d mask| on one batch
    against JAX's ``jax.grad``; a pruned config keeps the mask at
    ``cfg.heads`` rows and uses its first ``layer_heads(i)``."""
    jcfg, tcfg, params, images = _setup(style)
    tparams = {"params": tree_to_torch(params)}
    jparams = {"params": params}
    if pruned:
        jcfg, jparams = japply.prune_heads_params(jcfg, jparams, TO_PRUNE)
        tcfg, tparams = tapply.prune_heads_params(tcfg, tparams, TO_PRUNE)
    want = np.asarray(jax.jit(lambda p, x: jhi.head_importance_batch(jcfg, p, x))(
        jparams, jnp.asarray(images[0])))
    got = thi.head_importance_batch(tcfg, tparams, torch.from_numpy(images[0]))
    assert got.shape == (2, 4) and want.shape == (2, 4)
    if pruned:  # the pruned rows carry no gradient on either side
        assert not want[0, 2:].any() and not want[1, 3:].any()
        assert not got[0, 2:].any() and not got[1, 3:].any()
    assert _rel(_np(got), want) <= REL


@pytest.mark.parametrize("normalize", [True, False])
def test_calculate_head_importance_matches_jax(normalize):
    jcfg, tcfg, params, images = _setup()
    want = jhi.calculate_head_importance(jcfg, {"params": params}, iter(images), normalize)
    got = thi.calculate_head_importance(tcfg, tree_to_torch(params), iter(images), normalize)
    assert got.dtype == np.float64 and got.shape == (2, 4)
    assert _rel(got, want) <= REL
    if normalize:
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-12)


def test_calculate_head_importance_mesh_raises():
    """On a mesh each batch is split over dp (tests/test_torch_parallel.py
    holds the sum against JAX's): a batch that does not split is refused
    before any rank computes."""
    _, tcfg, params, images = _setup()
    mesh = SimpleNamespace(shape={"dp": 2, "tp": 1}, index=lambda axis: 0)
    assert all(x.shape[0] % 2 for x in images)
    with pytest.raises(ValueError, match="does not split over dp=2"):
        thi.calculate_head_importance(tcfg, tree_to_torch(params), iter(images), mesh=mesh)


# ---------------------------------------------------------------------------
# the iterative loop
# ---------------------------------------------------------------------------


def test_iterative_head_prune_matches_jax_descriptors(tmp_path):
    """Three levels (2, 4, 6 heads of 8, at least one a layer) structurally
    pruned: the port's descriptors and configs equal JAX's per level; the
    port also saves each level and writes its accuracy marker, and a second
    run reads the markers instead of evaluating."""
    jcfg, tcfg, params, images = _setup()
    prune = dict(prune_numbers=(2, 4, 6), at_least_x_heads_per_layer=1, actually_prune=True,
                 output_dir=str(tmp_path), model_tag="tiny")
    jlevels = list(jit_.iterative_head_prune(
        jcfg, {"params": params}, jit_.IterativePruneConfig(**prune),
        importance_batches=lambda: iter(images)))
    calls = []

    def eval_fn(cfg, p):
        calls.append(cfg.heads_per_layer)
        return 0.125 * len(calls)

    def run():
        return list(tit.iterative_head_prune(
            tcfg, {"params": tree_to_torch(params)}, tit.IterativePruneConfig(**prune),
            importance_batches=lambda: iter(images), eval_fn=eval_fn, save=True))

    levels = run()
    assert [r.descriptor for r in levels] == [r.descriptor for r in jlevels]
    assert [r.cfg.to_json() for r in levels] == [r.cfg.to_json() for r in jlevels]
    assert [r.n_pruned_total for r in levels] == [2, 4, 6]
    assert levels[-1].cfg.heads_per_layer == (1, 1)
    for r in levels:
        assert load_meta(r.save_dir) == {"descriptor": r.descriptor,
                                         "heads_per_layer": list(r.cfg.heads_per_layer)}
        _assert_trees_equal(load_checkpoint(r.save_dir), r.params)
        assert has_accuracy_marker(r.save_dir) == r.accuracy
        # the importance before this level's pruning: the heads of earlier levels +inf
        assert np.isinf(r.importance).sum() == 2 * r.level
    again = run()
    assert len(calls) == 3 and [r.accuracy for r in again] == [0.125, 0.25, 0.375]


def test_iterative_head_prune_soft_masks_and_retrain():
    """``actually_prune=False`` masks the out-projection rows at unchanged
    shapes, and ``retrain_fn`` sees each level's (cfg, params)."""
    jcfg, tcfg, params, images = _setup()
    prune = dict(prune_numbers=(3,), at_least_x_heads_per_layer=1, actually_prune=False)
    want = next(jit_.iterative_head_prune(jcfg, {"params": params},
                                          jit_.IterativePruneConfig(**prune),
                                          importance_batches=lambda: iter(images)))
    seen = []

    def retrain(c, p):  # updates in place, as the port's train steps do
        seen.append(c)
        p["params"]["block_0"]["attn"]["qkv_kernel"].mul_(2.0)
        return p

    start = tree_to_torch(params)
    got = next(tit.iterative_head_prune(tcfg, {"params": start},
                                        tit.IterativePruneConfig(**prune),
                                        importance_batches=lambda: iter(images),
                                        retrain_fn=retrain))
    assert got.descriptor == want.descriptor and got.cfg == tcfg and seen == [tcfg]
    got.params["params"]["block_0"]["attn"]["qkv_kernel"].div_(2.0)
    _assert_trees_equal(got.params, want.params)
    # the retrain took a copy: the tree every level slices from is untouched
    _assert_trees_equal(start, params)
