"""The port's movement pruning engine (``pruning/movement``,
``pruning/transitions``, ``sparse_driver.sparse_config_from_preset`` and
the preset copies) against the JAX package, at the tiny config of
tests/test_movement.py: the presets byte for byte and field by field, the
binarizers' masks on the same scores (tied and separated) exactly, their
straight-through gradients, ``expand_block_mask``, ``schedule_thresholds``,
``apply_masks`` and ``compile_sparse_model`` (config, report, params)
exactly; the losses and the transition functions within 1e-5 relative.
JAX's mask scores and accumulators are carried across
(``utils/jax_bridge.tree_to_torch``), since the two packages draw different
random numbers."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.models import vit as jvit
from edgevisiontransformer_tpu.pruning import movement as jmv
from edgevisiontransformer_tpu.pruning import sparse_driver as jsd
from edgevisiontransformer_tpu.pruning import transitions as jtr
from edgevisiontransformer_tpu_torch.models import vit as tvit
from edgevisiontransformer_tpu_torch.pruning import movement as tmv
from edgevisiontransformer_tpu_torch.pruning import sparse_driver as tsd
from edgevisiontransformer_tpu_torch.pruning import transitions as ttr
from edgevisiontransformer_tpu_torch.utils.jax_bridge import flatten_tree, tree_to_torch

torch.set_num_threads(1)

TINY = dict(image_size=32, patch_size=16, dim=64, depth=2, heads=4, mlp_dim=128,
            num_classes=10, head_dim=16)
REL = 1e-5
PRESETS = sorted(f[:-5] for f in os.listdir(jsd.PRESET_DIR) if f.endswith(".json"))
# one head-granular preset, its 2D-block form at dim 64 (64 x 192 blocks: one
# block a matrix, the _head_alive branch of compile), and 32 x 32 blocks
# (2 x 2 a matrix) with 2D dense blocks
MASK_PRESETS = [("topk-hybrid-struct", {}),
                ("topk-hybrid-struct-layerwise-tiny", {}),
                ("topk-hybrid", dict(dense_pruning="blocks", dense_block_rows=16,
                                     dense_block_cols=32))]
LAYERWISE = "h_0.5_d_0.3-h_0.25_d_0.6"


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jvit.deit_config("tiny").replace(**TINY)
    tcfg = tvit.deit_config("tiny").replace(**TINY)
    variables = jvit.ViT(jcfg).init(jax.random.key(0), jnp.ones((1, 3, 32, 32)))
    rng = np.random.default_rng(12)
    params = jax.tree.map(lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape)
                                                     ).astype(np.float32)
                          if a.ndim == 1 else np.asarray(a), variables["params"])
    images = rng.standard_normal((3, 3, 32, 32)).astype(np.float32)
    return jcfg, tcfg, params, images


def _sparse(name, **kw):
    return (jsd.sparse_config_from_preset(name, warmup_steps=2, layerwise_thresholds=LAYERWISE,
                                          **kw),
            tsd.sparse_config_from_preset(name, warmup_steps=2, layerwise_thresholds=LAYERWISE,
                                          **kw))


def _scores(jcfg, jsparse, seed=1, scale=0.3):
    """JAX's scores at ``mask_init_scale`` ``scale`` (numpy), and the port's
    copy."""
    s = jmv.init_mask_scores(jcfg, dataclasses.replace(jsparse, mask_init_scale=scale),
                             jax.random.key(seed))
    s = jax.tree.map(np.asarray, s)
    return s, tree_to_torch(s)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_trees_equal(got, want):
    g, w = flatten_tree(got), flatten_tree(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(_np(g[k]), _np(w[k]), err_msg=k)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------


def test_presets_are_the_jax_packages_bytes():
    ours = sorted(f for f in os.listdir(tsd.PRESET_DIR) if f.endswith(".json"))
    assert len(ours) == 12 and ours == sorted(p + ".json" for p in PRESETS)
    for f in ours:
        with open(os.path.join(tsd.PRESET_DIR, f), "rb") as a, \
                open(os.path.join(jsd.PRESET_DIR, f), "rb") as b:
            assert a.read() == b.read(), f
    assert os.path.realpath(tsd.PRESET_DIR) != os.path.realpath(jsd.PRESET_DIR)


@pytest.mark.parametrize("name", PRESETS)
def test_sparse_config_from_preset_matches_jax(name):
    jsp, tsp = _sparse(name, distil_alpha=0.7)
    assert dataclasses.asdict(tsp) == dataclasses.asdict(jsp)
    path = os.path.join(tsd.PRESET_DIR, name + ".json")
    assert tsd.sparse_config_from_preset(path) == tsd.sparse_config_from_preset(name)


# ---------------------------------------------------------------------------
# binarizers
# ---------------------------------------------------------------------------


SEPARATED = np.random.default_rng(0).standard_normal(128).astype(np.float32)


@pytest.mark.parametrize("scores", [
    np.zeros(64, np.float32),                  # the tied start: every score at the cut
    SEPARATED,
    SEPARATED[:11],                            # 0.5 * (11 - 1) = 5: the cut IS a score
    SEPARATED.reshape(8, 16),
    np.repeat(SEPARATED[:8], 4),               # ties of four straddling some cuts
])
@pytest.mark.parametrize("thr", [1.0, 0.75, 0.5, 0.34, 0.3, 0.05, 0.0])
def test_topk_mask_matches_jax(scores, thr):
    """The masks of a Python-float threshold (compile's) and an fp32 tensor
    threshold (the train step's) equal JAX's.  Where the quantile's position
    is an integer the cut equals a score, and that score is kept on both
    sides (``>=``)."""
    want = np.asarray(jmv.topk_mask(jnp.asarray(scores), thr))
    got = tmv.topk_mask(torch.from_numpy(scores), thr)
    np.testing.assert_array_equal(_np(got), want)
    want32 = np.asarray(jax.jit(jmv.topk_mask)(jnp.asarray(scores), jnp.float32(thr)))
    got32 = tmv.topk_mask(torch.from_numpy(scores), torch.tensor(thr))
    np.testing.assert_array_equal(_np(got32), want32)
    assert want.sum() >= 1


def test_quantile_is_jnp_quantile():
    rng = np.random.default_rng(1)
    for n in (2, 7, 128, 1000):
        a = rng.standard_normal(n).astype(np.float32)
        for q in np.linspace(0.0, 0.9999, 41).astype(np.float32):
            want = np.asarray(jnp.quantile(jnp.asarray(a), jnp.float32(q)))
            got = tmv.quantile_linear(torch.from_numpy(a), torch.tensor(float(q)))
            assert _np(got) == want, (n, q)


@pytest.mark.parametrize("sigmoid", [True, False])
@pytest.mark.parametrize("thr", [0.9, 0.5, 0.1, -0.2])
def test_threshold_mask_matches_jax(sigmoid, thr):
    scores = np.concatenate([SEPARATED, np.full(72, -10.0, np.float32)])
    want = np.asarray(jmv.threshold_mask(jnp.asarray(scores), thr, sigmoid))
    got = tmv.threshold_mask(torch.from_numpy(scores), thr, sigmoid)
    np.testing.assert_array_equal(_np(got), want)
    floor = np.asarray(jmv.threshold_mask(jnp.full(40, -10.0).at[3].set(-5.0), 0.9, sigmoid))
    np.testing.assert_array_equal(
        _np(tmv.threshold_mask(torch.full((40,), -10.0).index_fill(0, torch.tensor([3]), -5.0),
                               0.9, sigmoid)), floor)


def test_magnitude_and_l0_match_jax():
    w = np.abs(SEPARATED).reshape(8, 16)
    np.testing.assert_array_equal(_np(tmv.magnitude_mask(torch.from_numpy(w), 0.4)),
                                  np.asarray(jmv.magnitude_mask(jnp.asarray(w), 0.4)))
    s = 3 * SEPARATED
    assert _rel(_np(tmv.l0_gate(torch.from_numpy(s))), jmv.l0_gate(jnp.asarray(s))) <= REL
    assert _rel(_np(tmv.l0_penalty(torch.from_numpy(s))), jmv.l0_penalty(jnp.asarray(s))) <= REL
    g1 = tmv.l0_gate(torch.from_numpy(s), torch.Generator().manual_seed(3))
    g2 = tmv.l0_gate(torch.from_numpy(s), torch.Generator().manual_seed(3))
    assert torch.equal(g1, g2) and float(g1.min()) >= 0 and float(g1.max()) <= 1
    assert not torch.equal(g1, tmv.l0_gate(torch.from_numpy(s)))


@pytest.mark.parametrize("method", ["topk", "threshold", "sigmoied_threshold", "magnitude", "l0"])
def test_binarizer_gradients_match_jax(method):
    """The straight-through gradient (and l0's own) of a weighted sum of
    the mask, against ``jax.grad``."""
    scores = SEPARATED.reshape(8, 16)
    wts = np.random.default_rng(2).standard_normal((8, 16)).astype(np.float32)
    jsp = jmv.SparseConfig(method=method)
    tsp = tmv.SparseConfig(method=method)
    want = jax.grad(lambda s: jnp.sum(jmv._binarize(s, 0.4, jsp) * wts))(jnp.asarray(scores))
    x = torch.from_numpy(scores).requires_grad_()
    (tmv._binarize(x, 0.4, tsp) * torch.from_numpy(wts)).sum().backward()
    assert _rel(_np(x.grad), want) <= REL
    if method != "l0":
        np.testing.assert_array_equal(_np(x.grad), wts)


def test_expand_block_mask_and_layerwise_dsl_match_jax():
    m = (SEPARATED[:6].reshape(2, 3) > 0).astype(np.float32)
    np.testing.assert_array_equal(_np(tmv.expand_block_mask(torch.from_numpy(m), 8, 12)),
                                  np.asarray(jmv.expand_block_mask(jnp.asarray(m), 8, 12)))
    s = "h_0.34_d_0.3-h_0.3_d_0.5"
    assert tmv.parse_layerwise_thresholds(s, 2) == jmv.parse_layerwise_thresholds(s, 2)
    pairs = [(0.34, 0.3), (0.3, 0.5)]
    assert tmv.format_layerwise_thresholds(pairs) == jmv.format_layerwise_thresholds(pairs)
    with pytest.raises(ValueError, match="tokens for depth"):
        tmv.parse_layerwise_thresholds(s, 3)


# ---------------------------------------------------------------------------
# scores, masks, schedule, losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", MASK_PRESETS + [("topk-unstructured", {})])
def test_init_mask_scores_shapes_match_jax(name, kw):
    jcfg, tcfg, _, _ = _setup()
    jsp, tsp = _sparse(name, **kw)
    want = jax.tree.map(np.shape, jmv.init_mask_scores(jcfg, jsp, jax.random.key(0)))
    got = tmv.init_mask_scores(tcfg, tsp, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in flatten_tree(got).items()} == flatten_tree(want)
    assert all(v.dtype == torch.float32 for v in flatten_tree(got).values())
    again = tmv.init_mask_scores(tcfg, tsp, torch.Generator().manual_seed(0), device="cpu")
    _assert_trees_equal(again, got)


@pytest.mark.parametrize("name,kw", MASK_PRESETS)
@pytest.mark.parametrize("step", [0, 3, 100])
def test_apply_masks_matches_jax(name, kw, step):
    jcfg, tcfg, params, _ = _setup()
    jsp, tsp = _sparse(name, **kw)
    jscores, tscores = _scores(jcfg, jsp)
    thr, _ = jmv.schedule_thresholds(step, 6, jcfg, jsp)
    want = jmv.apply_masks(jcfg, {"params": params}, jscores, thr, jsp)
    got = tmv.apply_masks(tcfg, {"params": tree_to_torch(params)}, tscores, thr, tsp)
    _assert_trees_equal(got, want)
    # thresholds as the train step feeds them: a [depth, 2] fp32 array
    want32 = jax.jit(lambda p, s, t: jmv.apply_masks(
        jcfg, p, s, [(t[i, 0], t[i, 1]) for i in range(2)], jsp))(
        {"params": params}, jscores, jnp.asarray(thr))
    t32 = torch.tensor(thr, dtype=torch.float32)
    got32 = tmv.apply_masks(tcfg, {"params": tree_to_torch(params)}, tscores, t32, tsp)
    _assert_trees_equal(got32, want32)


@pytest.mark.parametrize("layerwise", [None, LAYERWISE])
def test_schedule_thresholds_matches_jax(layerwise):
    jcfg, tcfg, _, _ = _setup()
    jsp = jmv.SparseConfig(warmup_steps=3, final_warmup=2, layerwise_thresholds=layerwise)
    tsp = tmv.SparseConfig(warmup_steps=3, final_warmup=2, layerwise_thresholds=layerwise)
    for step in range(0, 25):
        assert tmv.schedule_thresholds(step, 20, tcfg, tsp) == \
            jmv.schedule_thresholds(step, 20, jcfg, jsp)


@pytest.mark.parametrize("regu", ["l1", "l0", None])
def test_regularization_loss_matches_jax(regu):
    jcfg, _, _, _ = _setup()
    jsp = jmv.SparseConfig(regularization=regu, regu_lambda_attention=2.0,
                           regu_lambda_dense=0.5)
    tsp = tmv.SparseConfig(regularization=regu, regu_lambda_attention=2.0,
                           regu_lambda_dense=0.5)
    jscores, tscores = _scores(jcfg, jsp, scale=2.0)
    want = jmv.regularization_loss(jscores, jsp, 0.7)
    got = tmv.regularization_loss(tscores, tsp, 0.7)
    if regu is None:
        assert got == 0.0 and want == 0.0
    else:
        assert _rel(_np(got), want) <= REL


def test_distillation_loss_matches_jax():
    rng = np.random.default_rng(5)
    s, t = (3 * rng.standard_normal((2, 6, 10))).astype(np.float32)
    ce = np.float32(1.7)
    want = jmv.distillation_loss(jnp.asarray(s), jnp.asarray(t), jnp.asarray(ce), 0.6, 2.0)
    got = tmv.distillation_loss(torch.from_numpy(s), torch.from_numpy(t), torch.tensor(ce),
                                0.6, 2.0)
    assert _rel(_np(got), want) <= REL


# ---------------------------------------------------------------------------
# compile, unzero, sparsity report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", MASK_PRESETS)
def test_compile_sparse_model_matches_jax(name, kw):
    """Config, report and params exactly.  The head-granular preset keeps
    ceil(thr * heads) heads by their q/k/v scores; the 2D presets take the
    ``_head_alive`` branch; an FFN keeps the units both of its masks keep,
    at least one."""
    jcfg, tcfg, params, images = _setup()
    jsp, tsp = _sparse(name, **kw)
    jscores, tscores = _scores(jcfg, jsp)
    jnew, want, jrep = jmv.compile_sparse_model(jcfg, {"params": params}, jscores, jsp)
    tnew, got, trep = tmv.compile_sparse_model(tcfg, {"params": tree_to_torch(params)},
                                               tscores, tsp)
    assert tnew.to_json() == jnew.to_json()
    assert trep == jrep
    _assert_trees_equal(got, want)
    assert tnew.heads_per_layer == (2, 1)
    model = tvit.ViT(tnew, device="cpu")
    tvit.load_params(model, got)
    with torch.no_grad():
        out = model(torch.from_numpy(images))
    assert out.shape == (3, 10) and torch.isfinite(out).all()


def test_compile_keeps_one_ffn_unit_where_the_masks_share_none():
    """fc1 and fc2 keep disjoint halves: no unit survives both, and the
    layer compiles to one hidden unit (unit 0), as JAX's does."""
    jcfg, tcfg, params, _ = _setup()
    jsp, tsp = _sparse("topk-hybrid-struct")
    jscores, _ = _scores(jcfg, jsp)
    up = np.arange(128, dtype=np.float32)
    jscores["block_1"]["fc1"], jscores["block_1"]["fc2"] = up, -up
    thr = [(1.0, 1.0), (1.0, 0.5)]
    jnew, want, jrep = jmv.compile_sparse_model(jcfg, {"params": params}, jscores, jsp, thr)
    tnew, got, trep = tmv.compile_sparse_model(tcfg, {"params": tree_to_torch(params)},
                                               tree_to_torch(jscores), tsp, thr)
    assert tnew.mlp_dim_per_layer == jnew.mlp_dim_per_layer == (128, 1)
    assert trep == jrep
    _assert_trees_equal(got, want)


def test_unzero_params_and_sparsity_report():
    jcfg, tcfg, params, _ = _setup()
    jsp, tsp = _sparse("topk-hybrid-struct")
    jscores, tscores = _scores(jcfg, jsp)
    _, want, _ = jmv.compile_sparse_model(jcfg, {"params": params}, jscores, jsp,
                                          [(1.0, 0.5), (1.0, 0.5)])
    _, got, _ = tmv.compile_sparse_model(tcfg, {"params": tree_to_torch(params)}, tscores, tsp,
                                         [(1.0, 0.5), (1.0, 0.5)])
    masked = tmv.apply_masks(tcfg, {"params": tree_to_torch(params)}, tscores,
                             [(0.5, 0.5)] * 2, tsp)
    jmasked = jmv.apply_masks(jcfg, {"params": params}, jscores, [(0.5, 0.5)] * 2, jsp)
    assert tmv.sparsity_report(masked) == jmv.sparsity_report(jmasked)
    assert tmv.sparsity_report(got) == jmv.sparsity_report(want)
    rep = tmv.sparsity_report(masked)
    assert rep["__overall__"] > 0.1 and "['block_0']['attn']['qkv_kernel']" in rep
    un = tmv.unzero_params(masked, torch.Generator().manual_seed(4))
    for k, v in flatten_tree(masked).items():
        u = flatten_tree(un)[k]
        if v.dim() < 2:
            assert torch.equal(u, v)
        else:
            assert torch.equal(u[v != 0], v[v != 0]) and bool((u[v == 0] != 0).all())
            assert float(torch.cat([u[v == 0].abs(), torch.zeros(1)]).max()) < 0.2
    assert tmv.sparsity_report(un)["__overall__"] == 0.0


# ---------------------------------------------------------------------------
# transitions
# ---------------------------------------------------------------------------


def _acc(jcfg, seed=6):
    rng = np.random.default_rng(seed)
    acc = jax.tree.map(lambda a: np.asarray(
        [0.3 * rng.standard_normal(), 1.0 + rng.random(), 0.5 + rng.random()], np.float32),
        jtr.init_ln_accumulators(jcfg))
    return acc, tree_to_torch(acc)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("mix,delta", [(1.0, 0.99), (0.4, 0.995), (0.0, 1.0)])
def test_layer2nonorm_and_compile_nonorm_match_jax(train, mix, delta):
    rng = np.random.default_rng(7)
    x = (2 * rng.standard_normal((3, 5, 64)) + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    acc = np.asarray([0.2, 1.3, 0.7], np.float32)
    jy, jacc = jtr.layer2nonorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), jnp.asarray(acc),
                                mix, delta, 1e-6, train)
    ty, tacc = ttr.layer2nonorm(*(torch.from_numpy(a) for a in (x, g, b, acc)), mix, delta,
                                1e-6, train)
    assert _rel(_np(ty), jy) <= REL and _rel(_np(tacc), jacc) <= REL
    jw, jb = jtr.compile_nonorm(jnp.asarray(g), jnp.asarray(b), jnp.asarray(acc), 1e-6)
    tw, tb = ttr.compile_nonorm(torch.from_numpy(g), torch.from_numpy(b), torch.from_numpy(acc),
                                1e-6)
    assert _rel(_np(tw), jw) <= REL and _rel(_np(tb), jb) <= REL


@pytest.mark.parametrize("approx", [False, True])
def test_gelu2relu_and_schedules_match_jax(approx):
    x = 3 * SEPARATED
    for mix in (1.0, 0.3, 0.0):
        assert _rel(_np(ttr.gelu2relu(torch.from_numpy(x), mix, approx)),
                    jtr.gelu2relu(jnp.asarray(x), mix, approx)) <= REL
    for step in (0, 1, 7, 50, 60):
        assert ttr.transition_mix(step, 50) == jtr.transition_mix(step, 50)
        assert ttr.transition_delta(step, 50, 0.98) == jtr.transition_delta(step, 50, 0.98)


@pytest.mark.parametrize("ln_patch,gelu_patch", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("mix,delta,train", [(1.0, 0.99, True), (0.5, 0.995, True),
                                             (0.0, 1.0, False)])
def test_vit_forward_transitions_matches_jax(ln_patch, gelu_patch, mix, delta, train):
    jcfg, tcfg, params, images = _setup()
    jacc, tacc = _acc(jcfg)
    jl, jnew = jtr.vit_forward_transitions(jcfg, {"params": params}, jnp.asarray(images), jacc,
                                           mix, delta, mix, ln_patch, gelu_patch, train)
    tl, tnew = ttr.vit_forward_transitions(tcfg, {"params": tree_to_torch(params)},
                                           torch.from_numpy(images), tacc, mix, delta, mix,
                                           ln_patch, gelu_patch, train)
    assert _rel(_np(tl), jl) <= REL
    for k, v in flatten_tree(jax.tree.map(np.asarray, jnew)).items():
        assert _rel(_np(flatten_tree(tnew)[k]), v) <= REL, k


def test_compile_transitions_matches_jax_and_serves_in_the_module():
    """Compiled to nonorm / relu: params within 1e-5 of JAX's, and the
    port's ViT module on them equals the transition forward at mix 0,
    delta 1 (the schedules' end) without the accumulator update."""
    jcfg, tcfg, params, images = _setup()
    jacc, tacc = _acc(jcfg)
    jnew_cfg, want = jtr.compile_transitions(jcfg, {"params": params}, jacc)
    tnew_cfg, got = ttr.compile_transitions(tcfg, {"params": tree_to_torch(params)}, tacc)
    assert tnew_cfg.to_json() == jnew_cfg.to_json()
    assert (tnew_cfg.norm_mode, tnew_cfg.act) == ("nonorm", "relu")
    w = flatten_tree(jax.tree.map(np.asarray, want))
    for k, v in flatten_tree(got).items():
        assert _rel(_np(v), w[k]) <= REL, k
    model = tvit.ViT(tnew_cfg, device="cpu")
    tvit.load_params(model, got)
    x = torch.from_numpy(images)
    with torch.no_grad():
        served = model(x)
        ref, _ = ttr.vit_forward_transitions(tcfg, {"params": tree_to_torch(params)}, x, tacc,
                                             0.0, 1.0, 0.0, train=False)
    torch.testing.assert_close(served, ref, rtol=1e-5, atol=1e-5)
