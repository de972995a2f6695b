"""The port's sparse training and ``run_sparse_finetune`` (``pruning/sparse_train``,
``pruning/sparse_driver.run_sparse_finetune``) against the JAX package, at
the tiny config of tests/test_movement.py: three steps of the sparse step
(plain, with a teacher, with QAT, with the transitions) from the same
params, scores and batches, within 1e-5 relative; ``run_sparse_finetune``
end to end to the same compiled shapes; the compiled model through the
port's ``fused_vit_apply`` (the twins, on the CPU) against JAX's in
interpret mode; and the refusals of a NoNorm / ReLU model by both fused
paths."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edgevisiontransformer_tpu.models import vit as jvit
from edgevisiontransformer_tpu.pruning import movement as jmv
from edgevisiontransformer_tpu.pruning import sparse_driver as jsd
from edgevisiontransformer_tpu.pruning import sparse_train as jst
from edgevisiontransformer_tpu.pruning import transitions as jtr
from edgevisiontransformer_tpu_torch.models import vit as tvit
from edgevisiontransformer_tpu_torch.parallel.train import Optimizer
from edgevisiontransformer_tpu_torch.pruning import sparse_driver as tsd
from edgevisiontransformer_tpu_torch.pruning import sparse_train as tst
from edgevisiontransformer_tpu_torch.pruning import transitions as ttr
from edgevisiontransformer_tpu_torch.utils.jax_bridge import (flatten_tree, load_jax_params,
                                                              tree_to_torch)

torch.set_num_threads(1)

TINY = dict(image_size=32, patch_size=16, dim=64, depth=2, heads=4, mlp_dim=128,
            num_classes=10, head_dim=16)
LAYERWISE = "h_0.5_d_0.3-h_0.25_d_0.6"
LR, MASK_LR = 1e-3, 1e-2
STEPS = 3
# three steps in fp32 on the CPU, XLA against torch's kernels, SGD with
# momentum on both trees: every param within 1e-5 of its leaf's largest
# |value|, every score within 1e-5 of the tree's largest |score| (a score's
# gradient sums a matrix's products with its gradient, which nearly cancel
# for some: block 1's one-block k matrix here moves by a 1e-3 step whose
# gradient the two sides round apart by 6e-6 of itself), every metric
# within 1e-5 of itself
REL = 1e-5
# run_sparse_finetune's optimizers (AdamW on the params, Adam on the scores) against
# optax's: tests/test_torch_train.py's AdamW rule, one fp32 spacing plus
# 1e-3 of the largest update.  torch.optim takes Adam's bias corrections
# 1 - beta^t in float64 and optax in fp32 (1 - 0.999f^t is 1.3e-5 off at
# t = 1, 3e-5 at t = 2), so an update parts by a few 1e-5 of itself: the
# scores, which start at 1e-3 N(0, 1), are mostly their updates.  The key
# bias is left out: its gradient is zero in exact arithmetic (the softmax
# ignores a per-query constant), both sides hold rounding noise of either
# sign there, and Adam turns that into steps of up to lr.
ADAM_STEP_REL = 1e-3
# the fused encoders on the CPU (the twins) against JAX's in interpret
# mode: tests/test_torch_vit_pallas.py's pruned-model bound
FP32_FUSED = dict(rtol=1e-4, atol=5e-4)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jvit.deit_config("tiny").replace(**TINY)
    tcfg = tvit.deit_config("tiny").replace(**TINY)
    jmodel = jvit.ViT(jcfg)
    variables = jmodel.init(jax.random.key(0), jnp.ones((1, 3, 32, 32)))
    rng = np.random.default_rng(13)
    params = jax.tree.map(lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape)
                                                     ).astype(np.float32)
                          if a.ndim == 1 else np.asarray(a), variables["params"])
    teacher = jax.tree.map(lambda a: a + (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                           params)
    batches = [(rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
                rng.integers(0, 10, 4).astype(np.int32)) for _ in range(STEPS)]
    tmodel = tvit.ViT(tcfg, device="cpu")
    load_jax_params(tmodel, params)
    return jcfg, tcfg, jmodel, tmodel, params, teacher, batches


def _sparse(name="topk-hybrid-struct", **kw):
    kw = dict(warmup_steps=1, layerwise_thresholds=LAYERWISE, **kw)
    return (jsd.sparse_config_from_preset(name, **kw), tsd.sparse_config_from_preset(name, **kw))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _dev(got: dict, want: dict, start: dict | None = None, tree_scale: bool = False) -> float:
    """The largest max|got - want| over the leaves, each relative to its
    leaf's scale (the largest |value| it held, at ``start`` or now), or with
    ``tree_scale`` to the whole tree's."""
    g, w = flatten_tree(got), flatten_tree(want)
    s0 = flatten_tree(start) if start is not None else w
    assert sorted(g) == sorted(w)
    scale = {k: max(float(np.abs(np.asarray(w[k])).max()), float(np.abs(np.asarray(s0[k])).max()),
                    1e-30) for k in w}
    if tree_scale:
        scale = dict.fromkeys(w, max(scale.values()))
    return max(float(np.abs(_np(g[k]).astype(np.float64) - np.asarray(w[k], np.float64)).max())
               / scale[k] for k in w)


def _optimizers(kind: str):
    """(JAX's params and scores optimizers, the port's)."""
    if kind == "sgd":
        return ((optax.sgd(LR, momentum=0.9), optax.sgd(MASK_LR, momentum=0.9)),
                (Optimizer(torch.optim.SGD, {"lr": LR, "momentum": 0.9}),
                 Optimizer(torch.optim.SGD, {"lr": MASK_LR, "momentum": 0.9})))
    return (optax.adamw(LR), optax.adam(MASK_LR)), tsd.sparse_optimizers(LR, MASK_LR)


def _run_steps(mode: str, opt: str = "sgd"):
    """STEPS sparse steps on both sides from the same params, scores and
    batches; returns (port trees per step, JAX trees per step, the last
    thresholds)."""
    jcfg, tcfg, jmodel, tmodel, params, teacher, batches = _setup()
    jsp, tsp = _sparse(qat=mode == "qat", layer_norm_patch=mode == "transitions",
                       gelu_patch=mode == "transitions", layer_norm_patch_steps=4,
                       gelu_patch_steps=4)
    s = jmv.init_mask_scores(jcfg, jsp, jax.random.key(1))
    jscores = jax.tree.map(np.asarray, s)
    japply = jmodel.apply
    tapply = lambda p, x: tvit.apply_params(tmodel, p, x)  # noqa: E731
    teach = mode == "teacher"
    (jopt_p, jopt_s), (topt_p, topt_s) = _optimizers(opt)
    trans = mode == "transitions"
    if trans:
        jstep = jax.jit(jst.make_sparse_train_step_transitions(
            jcfg, jsp, jopt_p, jopt_s, japply if teach else None, with_teacher_params=teach))
        tstep = tst.make_sparse_train_step_transitions(
            tcfg, tsp, topt_p, topt_s, tapply if teach else None, with_teacher_params=teach)
        jacc, tacc = jtr.init_ln_accumulators(jcfg), ttr.init_ln_accumulators(tcfg, "cpu")
    else:
        jstep = jax.jit(jst.make_sparse_train_step(
            japply, jcfg, jsp, jopt_p, jopt_s, japply if teach else None,
            with_teacher_params=teach))
        tstep = tst.make_sparse_train_step(tapply, tcfg, tsp, topt_p, topt_s,
                                           tapply if teach else None, with_teacher_params=teach)
    jp, js = {"params": params}, jscores
    tp, ts = {"params": tree_to_torch(params)}, tree_to_torch(jscores)
    jst_p, jst_s = jopt_p.init(jp), jopt_s.init(js)
    state = tst.init_sparse_state(tp, ts, topt_p, topt_s)
    tteacher = {"params": tree_to_torch(teacher)} if teach else None
    jteacher = {"params": teacher} if teach else None
    out_t, out_j = [], []
    for i, (x, y) in enumerate(batches):
        thr, mul = jmv.schedule_thresholds(i, 5, jcfg, jsp)
        tmix = [jtr.transition_mix(i, 4), jtr.transition_delta(i, 4, 0.99),
                jtr.transition_mix(i, 4)]
        if trans:
            jp, js, jacc, jst_p, jst_s, jm = jstep(
                jp, js, jacc, jst_p, jst_s, jnp.asarray(x), jnp.asarray(y), jnp.asarray(thr),
                jnp.asarray(mul), jnp.asarray(tmix), jteacher)
            tp, ts, tacc, state.opt_state_p, state.opt_state_s, tm = tstep(
                tp, ts, tacc, state.opt_state_p, state.opt_state_s, torch.from_numpy(x),
                torch.from_numpy(y), torch.tensor(thr), torch.tensor(mul), tmix, tteacher)
        else:
            jp, js, jst_p, jst_s, jm = jstep(jp, js, jst_p, jst_s, jnp.asarray(x), jnp.asarray(y),
                                             jnp.asarray(thr), jnp.asarray(mul), jteacher)
            tp, ts, state.opt_state_p, state.opt_state_s, tm = tstep(
                tp, ts, state.opt_state_p, state.opt_state_s, torch.from_numpy(x),
                torch.from_numpy(y), torch.tensor(thr), torch.tensor(mul), tteacher)
        clone = lambda t: {k: v.clone() for k, v in flatten_tree(t).items()}  # noqa: E731
        out_t.append((clone(tp), clone(ts), {k: float(v) for k, v in tm.items()},
                      clone(tacc) if trans else None))
        out_j.append((jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js),
                      {k: float(v) for k, v in jm.items()},
                      jax.tree.map(np.asarray, jacc) if trans else None))
    return out_t, out_j, thr


@pytest.mark.parametrize("mode", ["plain", "teacher", "qat", "transitions"])
def test_sparse_steps_match_jax(mode):
    """Params, scores and metrics after each of three steps (thresholds
    1.0, 1.0, then the layerwise finals: the masks cut on the third), and
    the LayerNorm accumulators of the transition step."""
    jcfg, _, _, _, params, _, _ = _setup()
    jsp, _ = _sparse()
    scores0 = jax.tree.map(np.asarray, jmv.init_mask_scores(jcfg, jsp, jax.random.key(1)))
    out_t, out_j, last_thr = _run_steps(mode)
    assert last_thr[1] == (0.25, 0.6)
    for step, ((tp, ts, tm, tacc), (jp, js, jm, jacc)) in enumerate(zip(out_t, out_j)):
        dev_p, dev_s = _dev(tp, jp, {"params": params}), _dev(ts, js, scores0, tree_scale=True)
        assert dev_p <= REL, (step, "params", dev_p)
        assert dev_s <= REL, (step, "scores", dev_s)
        for k in ("ce", "loss", "regu"):
            assert abs(tm[k] - jm[k]) <= REL * max(abs(jm[k]), 1e-30), (step, k, tm[k], jm[k])
        if tacc is not None:
            assert _dev(tacc, jacc) <= REL, (step, "ln_acc")
    assert out_t[-1][2]["regu"] > 0  # the regularizer ramped in with the thresholds


def _spacing_dev(got: dict, want: dict, start: dict) -> tuple:
    """max |got - want| less one fp32 spacing of ``want`` over the leaves
    (the key bias left out), and the largest update |want - start|."""
    g, w, s0 = flatten_tree(got), flatten_tree(want), flatten_tree(start)
    dev = upd = 0.0
    for k in w:
        a, b = _np(g[k]).astype(np.float64), np.asarray(w[k], np.float64)
        d = np.abs(a - b) - np.spacing(np.abs(np.asarray(w[k])))
        if k.endswith("qkv_bias"):
            d = np.concatenate([d[:len(d) // 3], d[2 * len(d) // 3:]])
        dev = max(dev, float(d.max()))
        upd = max(upd, float(np.abs(b - np.asarray(s0[k], np.float64)).max()))
    return dev, upd


def test_sparse_steps_with_adam_match_jax():
    """``run_sparse_finetune``'s AdamW (weight decay 1e-4, optax's default) and Adam
    against optax's, three plain steps: params and scores within one
    spacing plus ADAM_STEP_REL of the largest update, the metrics within
    1e-5."""
    jcfg, _, _, _, params, _, _ = _setup()
    jsp, _ = _sparse()
    scores0 = jax.tree.map(np.asarray, jmv.init_mask_scores(jcfg, jsp, jax.random.key(1)))
    out_t, out_j, _ = _run_steps("plain", "adam")
    for step, ((tp, ts, tm, _), (jp, js, jm, _)) in enumerate(zip(out_t, out_j)):
        dev, upd = _spacing_dev(tp, jp, {"params": params})
        assert dev <= ADAM_STEP_REL * upd, (step, "params", dev, upd)
        dev, upd = _spacing_dev(ts, js, scores0)
        assert dev <= ADAM_STEP_REL * upd, (step, "scores", dev, upd)
        for k in ("ce", "loss"):
            assert abs(tm[k] - jm[k]) <= REL * abs(jm[k]), (step, k)


def test_run_sparse_finetune_matches_jax_compiled_shapes(monkeypatch):
    """``run_sparse_finetune`` end to end (6 steps, a teacher, compile, then a 2-step
    final finetune) from JAX's initial scores: the same compiled heads and
    hidden widths as JAX's, finite logits from the compiled model, and the
    compiled model through ``fused_vit_apply`` against JAX's."""
    jcfg, tcfg, jmodel, tmodel, params, teacher, batches = _setup()
    jsp, tsp = _sparse("topk-hybrid-struct-layerwise-tiny")
    scores0 = jax.tree.map(np.asarray, jmv.init_mask_scores(jcfg, jsp, jax.random.key(0)))

    def gen():
        yield from batches[:2]

    jres = jsd.run_sparse_finetune(jmodel.apply, jcfg, {"params": params}, jsp, gen,
                                   total_steps=6, lr=LR,
                                   teacher_apply=jmodel.apply, teacher_params={"params": teacher},
                                   log=lambda s: None)
    # JAX's run_sparse_finetune draws its scores from key(seed); the port starts from them
    assert _dev(jax.tree.map(np.asarray, jmv.init_mask_scores(jcfg, jsp, jax.random.key(0))),
                scores0) == 0.0
    monkeypatch.setattr(tsd, "init_mask_scores", lambda *a, **k: tree_to_torch(scores0))
    logs = []
    tres = tsd.run_sparse_finetune(
        lambda p, x: tvit.apply_params(tmodel, p, x), tcfg, {"params": tree_to_torch(params)},
        tsp, gen, total_steps=6, lr=LR,
        teacher_apply=lambda p, x: tvit.apply_params(tmodel, p, x),
        teacher_params={"params": tree_to_torch(teacher)}, final_finetune_steps=2,
        log=logs.append)
    assert tres.compiled_cfg.heads_per_layer == jres.compiled_cfg.heads_per_layer == (2, 1)
    assert tres.compiled_cfg.mlp_dim_per_layer == jres.compiled_cfg.mlp_dim_per_layer
    assert tres.report == jres.report
    assert any(s.startswith("compiled: heads_per_layer=(2, 1)") for s in logs)
    assert set(tres.sparsity) == set(jres.sparsity)
    model = tvit.ViT(tres.compiled_cfg, device="cpu")
    tvit.load_params(model, tres.compiled_params)
    x = torch.from_numpy(batches[0][0])
    with torch.no_grad():
        out = model(x)
    assert out.shape == (4, 10) and torch.isfinite(out).all()
    # the compiled model before the final finetune, on the fused encoder:
    # the port's twins against JAX's interpret-mode kernels
    tcomp = tvit.ViT(tres.compiled_cfg, device="cpu")
    load_jax_params(tcomp, jax.tree.map(np.asarray, jres.compiled_params["params"]))
    jcomp = jvit.ViT(jres.compiled_cfg)
    want = jax.jit(functools.partial(jvit.fused_vit_apply, jcomp))(jres.compiled_params,
                                                                   jnp.asarray(batches[0][0]))
    with torch.no_grad():
        segmented = tvit.fused_vit_apply(tcomp, x)
        packed = tvit.fused_vit_apply(tcomp, x, pack_layers=True)
        plain = tcomp(x)
    np.testing.assert_allclose(_np(segmented), np.asarray(want), **FP32_FUSED)
    np.testing.assert_allclose(_np(packed), np.asarray(want), **FP32_FUSED)
    np.testing.assert_allclose(_np(plain), np.asarray(jcomp.apply(jres.compiled_params,
                                                                  jnp.asarray(batches[0][0]))),
                               rtol=1e-5, atol=1e-5)


def test_run_sparse_finetune_transitions_compiles_to_nonorm_relu(monkeypatch):
    """A transition run compiles to a NoNorm / ReLU config, the same as
    JAX's; both fused paths refuse it, as JAX's do, and the module runs it
    within 1e-5 of JAX's module."""
    jcfg, tcfg, jmodel, tmodel, params, _, batches = _setup()
    jsp, tsp = _sparse(layer_norm_patch=True, gelu_patch=True, layer_norm_patch_steps=4,
                       gelu_patch_steps=4)
    scores0 = jax.tree.map(np.asarray, jmv.init_mask_scores(jcfg, jsp, jax.random.key(0)))

    def gen():
        yield from batches

    jres = jsd.run_sparse_finetune(jmodel.apply, jcfg, {"params": params}, jsp, gen,
                                   total_steps=4, lr=LR, log=lambda s: None)
    monkeypatch.setattr(tsd, "init_mask_scores", lambda *a, **k: tree_to_torch(scores0))
    tres = tsd.run_sparse_finetune(None, tcfg, {"params": tree_to_torch(params)}, tsp, gen,
                                   total_steps=4, lr=LR, log=lambda s: None)
    cfg = tres.compiled_cfg
    assert cfg.to_json() == jres.compiled_cfg.to_json()
    assert (cfg.norm_mode, cfg.act) == ("nonorm", "relu")
    assert _dev(tres.ln_acc, jax.tree.map(np.asarray, jres.ln_acc)) <= REL
    model = tvit.ViT(cfg, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jres.compiled_params["params"]))
    x = torch.from_numpy(batches[0][0])
    with pytest.raises(ValueError, match="norm_mode='layernorm'"):
        tvit.fused_vit_apply(model, x)
    with pytest.raises(ValueError, match="norm_mode='layernorm'"):
        tvit.fused_vit_apply_int8(model, x)
    jm = jvit.ViT(jres.compiled_cfg)
    with pytest.raises(ValueError, match="norm_mode='layernorm'"):
        jvit.fused_vit_apply(jm, jres.compiled_params, jnp.asarray(batches[0][0]))
    with torch.no_grad():
        got = model(x)
        module = tvit.ViT(cfg.replace(kernel_mode="pallas"), device="cpu")
        load_jax_params(module, jax.tree.map(np.asarray, jres.compiled_params["params"]))
        got_module = module(x)
    want = jm.apply(jres.compiled_params, jnp.asarray(batches[0][0]))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got_module), np.asarray(want), rtol=1e-5, atol=1e-5)
