"""The port's training, eval and checkpoints against the JAX package on the
same params and batches: ``cross_entropy``, one and two SGD and AdamW steps
against optax (``grad_accum`` 1 and 2), the eval step, ``finetune`` bounded
by ``max_steps``, a resume equal to the steps it stands for, the checkpoint,
metrics and accuracy-marker round trips; ``remat`` against no ``remat``
and dropout off in the train step, for ViT and T2T-ViT; and the kernel
wrappers, whose backward raises instead of leaving the weights behind them
without a gradient."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edgevisiontransformer_tpu.models import t2t_vit as jt2t
from edgevisiontransformer_tpu.models import vit as jvit
from edgevisiontransformer_tpu.parallel import train as jtrain
from edgevisiontransformer_tpu.utils import finetune as jft
from edgevisiontransformer_tpu.utils import imagenet as jimagenet
from edgevisiontransformer_tpu.utils import metrics as jmetrics
from edgevisiontransformer_tpu_torch.models import t2t_vit as tt2t
from edgevisiontransformer_tpu_torch.models import vit as tvit
from edgevisiontransformer_tpu_torch.ops.cuda import fused_attention as tfa
from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as tfe
from edgevisiontransformer_tpu_torch.ops.cuda import fused_mlp as tfm
from edgevisiontransformer_tpu_torch.parallel import train as ttrain
from edgevisiontransformer_tpu_torch.utils import checkpoint as tckpt
from edgevisiontransformer_tpu_torch.utils import finetune as tft
from edgevisiontransformer_tpu_torch.utils import imagenet as timagenet
from edgevisiontransformer_tpu_torch.utils import metrics as tmetrics
from edgevisiontransformer_tpu_torch.utils.jax_bridge import (flatten_tree, load_jax_params,
                                                              load_jax_variables, to_torch)

torch.set_num_threads(1)

NARROW = dict(image_size=32, dim=64, depth=2, heads=2, mlp_dim=128, num_classes=10)
# T2T runs at its fixed 224 input; narrow encoder, as tests/test_torch_t2t.py
T2T_NARROW = dict(depth=2, num_classes=10, dim=128, heads=2, mlp_dim=256)
# params after SGD / AdamW steps in fp32: the same gradients summed in
# another order and the update's fp32 rounding (torch.optim fuses
# p - lr * u, one rounding where optax has two): within one fp32 spacing of
# each param plus this share of the largest update taken; AdamW's second
# step normalizes moments that may nearly cancel between the two gradients,
# which scales up their rounding (1.9e-4 seen at grad_accum 2)
STEP_REL = {"sgd": 1e-4, "adamw": 1e-3}
# AdamW divides a gradient by its own size, g / (|g| + 1e-8): where a
# gradient is zero in exact arithmetic (the key bias: softmax ignores a
# per-query constant) both sides hold rounding noise of either sign, and the
# update there is noise of size lr; where it is a few eps, the rounding of a
# sum that cancels moves it by a share of lr.  AdamW is compared where JAX's
# gradient of every step so far is above 1000 eps (99.8% of the elements)
ADAM_GRAD_FLOOR = 1e-5
LR = {"sgd": 0.05, "adamw": 1e-3}


def _torch_tree(tree_np: dict) -> dict:
    out: dict = {}
    for k, v in flatten_tree(tree_np).items():
        *path, leaf = k.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = to_torch(np.asarray(v))
    return out


@functools.lru_cache(maxsize=None)
def _setup():
    jmodel = jvit.ViT(jvit.deit_config("tiny", "standard", **NARROW))
    n = NARROW["image_size"]
    variables = jmodel.init(jax.random.key(2), jnp.ones((1, 3, n, n)))
    params = jax.tree.map(np.asarray, variables["params"])
    tmodel = tvit.ViT(tvit.deit_config("tiny", "standard", **NARROW), device="cpu")
    load_jax_params(tmodel, params)
    rng = np.random.default_rng(8)
    batches = [(rng.standard_normal((4, 3, n, n)).astype(np.float32),
                rng.integers(0, 10, 4).astype(np.int32)) for _ in range(2)]
    return jmodel, params, tmodel, batches


@functools.lru_cache(maxsize=None)
def _t2t_setup():
    jmodel = jt2t.T2TViT(jt2t.t2t_vit_config(7, "reference", **T2T_NARROW))
    v = jax.jit(jmodel.init)(jax.random.key(3), jnp.ones((1, 3, 224, 224)))
    variables = jax.tree.map(np.asarray, {"params": v["params"], "constants": v["constants"]})
    tmodel = tt2t.T2TViT(tt2t.t2t_vit_config(7, "reference", **T2T_NARROW), device="cpu")
    load_jax_variables(tmodel, variables)
    rng = np.random.default_rng(9)
    batch = (rng.standard_normal((2, 3, 224, 224)).astype(np.float32),
             rng.integers(0, 10, 2).astype(np.int32))
    return jmodel, variables, tmodel, batch


def _port_apply(tmodel):
    return lambda p, x: tvit.apply_params(tmodel, p, x)


def _max_dev(got: dict, want: dict, start: dict, where: dict | None = None) -> tuple:
    """max |got - want| less one fp32 spacing of ``want`` (over the
    elements ``where`` marks) and the largest update |want - start|, over
    leaves."""
    g, w, s = flatten_tree(got), flatten_tree(want), flatten_tree(start)
    assert sorted(g) == sorted(w)
    dev = max(float(np.where(where[k] if where else True,
                             np.abs(g[k].detach().numpy() - np.asarray(w[k]))
                             - np.spacing(np.abs(np.asarray(w[k]))), 0).max())
              for k in w)
    upd = max(float(np.abs(np.asarray(w[k]) - np.asarray(s[k])).max()) for k in w)
    return dev, upd


def test_cross_entropy_and_scaled_lr_match_jax():
    rng = np.random.default_rng(0)
    logits = (5 * rng.standard_normal((6, 11))).astype(np.float32)
    labels = rng.integers(0, 11, 6).astype(np.int32)
    want = float(jtrain.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = ttrain.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    got16 = ttrain.cross_entropy(torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels))
    assert got16.dtype == torch.float32
    assert ttrain.scaled_lr(0.1, 4, 32) == jtrain.scaled_lr(0.1, 4, 32)


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_train_steps_match_optax(opt, grad_accum):
    """Two steps from the same params on two batches: the losses and the
    params after each step against the jitted JAX step with optax."""
    jmodel, params, tmodel, batches = _setup()
    cfg = tft.FinetuneConfig(lr=LR[opt], optimizer=opt, weight_decay=0.05)
    jtx = jft.build_optimizer(cfg)
    jstep = jax.jit(jtrain.make_train_step(jmodel.apply, jtx, grad_accum=grad_accum))
    jp, jstate = {"params": params}, jtx.init({"params": params})
    tx = tft.build_optimizer(cfg)
    tstep = ttrain.make_train_step(_port_apply(tmodel), tx, grad_accum=grad_accum)
    tp = {"params": _torch_tree(params)}
    tstate = tx.init(tp)
    jgrad = jax.jit(jax.grad(lambda p, x, y: jtrain.cross_entropy(jmodel.apply(p, x), y)))
    where = None
    for images, labels in batches:
        if opt == "adamw":
            g = flatten_tree(jgrad(jp, jnp.asarray(images), jnp.asarray(labels)))
            big = {k: np.abs(np.asarray(v)) > ADAM_GRAD_FLOOR for k, v in g.items()}
            where = big if where is None else {k: where[k] & big[k] for k in big}
        jp, jstate, jm = jstep(jp, jstate, jnp.asarray(images), jnp.asarray(labels))
        out, tstate, tm = tstep(tp, tstate, torch.from_numpy(images), torch.from_numpy(labels))
        assert out is tp
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        dev, upd = _max_dev(tp, jp, {"params": params}, where)
        assert upd > 0 and dev <= STEP_REL[opt] * upd, (dev, upd)
    if where is not None:  # the floor leaves out the key bias and little else
        assert sum(int(m.sum()) for m in where.values()) > 0.995 * sum(
            m.size for m in where.values())


def test_t2t_train_step_matches_optax():
    """One SGD step of T2T-ViT through ``apply_params`` against the jitted
    JAX step with optax, the module left in training mode: the performers'
    and the blocks' dropout follow ``train=False`` as ``model.apply``'s do.
    The JAX step trains the ``params`` collection; the ``constants`` (the
    performers' ``w``, the position table) are fixed, as the port's buffers."""
    jmodel, variables, tmodel, (images, labels) = _t2t_setup()
    consts = variables["constants"]
    cfg = tft.FinetuneConfig(lr=LR["sgd"], optimizer="sgd")
    jtx = jft.build_optimizer(cfg)
    jstep = jax.jit(jtrain.make_train_step(
        lambda p, x: jmodel.apply({**p, "constants": consts}, x), jtx))
    params = {"params": variables["params"]}
    jp, _, jm = jstep(params, jtx.init(params), jnp.asarray(images), jnp.asarray(labels))
    tmodel.train()
    try:
        tx = tft.build_optimizer(cfg)
        tstep = ttrain.make_train_step(_port_apply(tmodel), tx)
        tp = {"params": _torch_tree(variables["params"])}
        tp, _, tm = tstep(tp, tx.init(tp), torch.from_numpy(images), torch.from_numpy(labels))
    finally:
        tmodel.eval()
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    dev, upd = _max_dev(tp, jp, params)
    assert upd > 0 and dev <= STEP_REL["sgd"] * upd, (dev, upd)


def test_optimizer_state_and_hyper_parameters():
    tp = {"w": torch.ones(3, 2)}
    sgd = tft.build_optimizer(tft.FinetuneConfig(lr=0.1))
    assert sgd.cls is torch.optim.SGD and sgd.hyper == {"lr": 0.1, "momentum": 0.9}
    assert torch.equal(sgd.init(tp)["w"]["momentum_buffer"], torch.zeros(3, 2))
    adamw = tft.build_optimizer(tft.FinetuneConfig(lr=0.1, optimizer="adamw",
                                                   lr_scale_batch=256, n_devices=2))
    # weight decay passed explicitly: FinetuneConfig's 0.0, not torch's 0.01
    assert adamw.hyper == {"lr": jtrain.scaled_lr(0.1, 2, 256), "weight_decay": 0.0}
    assert sorted(adamw.init(tp)["w"]) == ["exp_avg", "exp_avg_sq", "step"]
    with pytest.raises(ValueError):
        tft.build_optimizer(tft.FinetuneConfig(optimizer="lamb"))
    with pytest.raises(ValueError):
        ttrain.Optimizer(torch.optim.Adagrad, {})
    with pytest.raises(ValueError, match="fused"):
        ttrain.Optimizer(torch.optim.AdamW, {"lr": 0.1, "fused": True})
    # bind shares the state tree's tensors: a step moves them in place
    state = sgd.init(tp)
    opt = sgd.bind({"w": tp["w"]}, state)
    assert opt.state[tp["w"]]["momentum_buffer"] is state["w"]["momentum_buffer"]


def test_eval_step_matches_jax():
    jmodel, params, tmodel, batches = _setup()
    images, labels = batches[0]
    labels = np.array(jnp.argmax(jmodel.apply({"params": params}, images), -1))
    labels[:2] = (labels[:2] + 1) % 10  # two wrong
    want = jtrain.make_eval_step(jmodel.apply)({"params": params}, jnp.asarray(images),
                                               jnp.asarray(labels))
    got = ttrain.make_eval_step(_port_apply(tmodel))(
        tmodel.params(), torch.from_numpy(images), torch.from_numpy(labels))
    assert (int(got[0]), got[1]) == (int(want[0]), want[1]) == (2, 4)


def _stream(batches):
    return lambda: iter(batches)


def test_finetune_max_steps_matches_jax():
    """epochs 2 over 2 batches, bounded at 3 steps by the islice: the same
    steps, logs and params as the JAX function."""
    jmodel, params, tmodel, batches = _setup()
    cfg = dict(lr=0.05, epochs=2, max_steps=3, log_every=1)
    jlog, tlog = [], []
    want = jft.finetune(jmodel.apply, {"params": params}, _stream(batches),
                        jft.FinetuneConfig(**cfg), log=jlog.append)
    got = tft.finetune(_port_apply(tmodel), {"params": _torch_tree(params)}, _stream(batches),
                       tft.FinetuneConfig(**cfg), log=tlog.append)
    steps = [line.split(" loss ")[0] for line in tlog]
    assert steps == [line.split(" loss ")[0] for line in jlog] == [
        "epoch 0 step 1", "epoch 0 step 2", "epoch 1 step 3"]
    dev, upd = _max_dev(got, want, {"params": params})
    assert dev <= STEP_REL["sgd"] * upd, (dev, upd)


def test_finetune_resume_equals_the_steps_it_stands_for(tmp_path):
    """AdamW (its step count and moments must come back): 2 steps with a
    checkpoint, then a resumed run to 4 steps, against 4 train steps on the
    batches the two runs saw (each epoch restarts the batch stream)."""
    _, params, tmodel, batches = _setup()
    cfg = dict(lr=1e-3, optimizer="adamw", checkpoint_dir=str(tmp_path / "ck"),
               checkpoint_every=2)
    logs = []
    tft.finetune(_port_apply(tmodel), _torch_tree(params), _stream(batches),
                 tft.FinetuneConfig(max_steps=2, **cfg), log=logs.append)
    assert tckpt.load_meta(tmp_path / "ck" / "latest") == {"step": 2}
    resumed = tft.finetune(_port_apply(tmodel), _torch_tree(params), _stream(batches),
                           tft.FinetuneConfig(max_steps=4, **cfg), log=logs.append)
    assert any("resumed from" in line and "at step 2" in line for line in logs)

    tx = tft.build_optimizer(tft.FinetuneConfig(lr=1e-3, optimizer="adamw"))
    step = ttrain.make_train_step(_port_apply(tmodel), tx)
    ref = _torch_tree(params)
    state = tx.init(ref)
    for images, labels in batches + batches:
        ref, state, _ = step(ref, state, torch.from_numpy(images), torch.from_numpy(labels))
    for k, v in flatten_tree(ref).items():
        assert torch.equal(flatten_tree(resumed)[k], v), k


def test_checkpoint_round_trip(tmp_path):
    tree = {"params": {"a": torch.randn(3, 4), "b": {"c": torch.arange(5)}},
            "opt_state": {"a": {"step": torch.tensor(3.0)}}, "n": 7}
    tckpt.save_checkpoint(tmp_path / "c", tree, meta={"step": 3, "model": "deit_tiny"})
    assert tckpt.load_meta(tmp_path / "c") == {"step": 3, "model": "deit_tiny"}
    assert tckpt.load_meta(tmp_path / "none") is None
    back = tckpt.load_checkpoint(tmp_path / "c")
    assert back["n"] == 7 and torch.equal(back["params"]["a"], tree["params"]["a"])
    # a target gives the structure, dtypes and devices
    target = {"params": {"a": torch.zeros(3, 4, dtype=torch.float64),
                         "b": {"c": torch.zeros(5, dtype=torch.int64)}},
              "opt_state": {"a": {"step": torch.tensor(0.0)}}, "n": 0}
    filled = tckpt.load_checkpoint(tmp_path / "c", target)
    assert filled["params"]["a"].dtype == torch.float64 and filled["n"] == 7
    assert torch.equal(filled["params"]["a"], tree["params"]["a"].double())
    assert float(filled["opt_state"]["a"]["step"]) == 3.0
    with pytest.raises(KeyError):
        tckpt.load_checkpoint(tmp_path / "c", {"params": target["params"]})
    target["params"]["a"] = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(tmp_path / "c", target)
    # saving again replaces the checkpoint
    tckpt.save_checkpoint(tmp_path / "c", {"n": 8})
    assert tckpt.load_checkpoint(tmp_path / "c") == {"n": 8}


def test_metrics_logger_and_markers_round_trip(tmp_path, capsys):
    path = tmp_path / "m" / "metrics.jsonl"
    log = tmetrics.MetricsLogger(str(path))
    rec = log.log("step", step=1, loss=0.5)
    jmetrics.MetricsLogger(str(path), echo=False).log("step", step=2, loss=0.25)
    log.log("eval", acc=0.75)
    log.close()
    assert "step step=1 loss=0.5" in capsys.readouterr().out
    got = tmetrics.read_metrics(str(path))
    assert got == jmetrics.read_metrics(str(path))
    assert [(r["event"], r.get("step")) for r in got] == [("step", 1), ("step", 2), ("eval", None)]
    assert got[0] == rec and tmetrics.is_rank_zero()
    tmetrics.dist_print("rank zero")
    assert capsys.readouterr().out == "rank zero\n"
    d = str(tmp_path / "model")
    assert timagenet.has_accuracy_marker(d) is None
    marker = timagenet.write_accuracy_marker(d, 0.72345)
    assert marker.endswith("accuracy7234.txt")
    assert timagenet.has_accuracy_marker(d) == jimagenet.has_accuracy_marker(d) == 0.7234
    d2 = str(tmp_path / "jax")
    jimagenet.write_accuracy_marker(d2, 0.5)
    assert timagenet.has_accuracy_marker(d2) == 0.5


# ---------------------------------------------------------------------------
# remat, dropout
# ---------------------------------------------------------------------------


def _grads(model, tree, img):
    flat = {k: v.detach().clone().requires_grad_() for k, v in flatten_tree(tree).items()}
    out = tvit.apply_params(model, _torch_tree_live(flat), img)
    return out, torch.autograd.grad((out ** 2).mean(), list(flat.values()))


def _torch_tree_live(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def test_remat_gives_the_same_gradients():
    """Per-block checkpointing recomputes the same ops: logits and every
    gradient bit for bit, also when the model's own parameters are not the
    tree's (the recompute reads the tree)."""
    _, params, tmodel, batches = _setup()
    remat = tvit.ViT(tmodel.config.replace(remat=True), device="cpu",
                     generator=torch.Generator().manual_seed(1))
    img = torch.from_numpy(batches[0][0])
    tree = _torch_tree(params)
    o1, g1 = _grads(tmodel, tree, img)
    o2, g2 = _grads(remat, tree, img)
    assert torch.equal(o1, o2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    with torch.no_grad():  # inference takes the plain forward
        assert torch.equal(tvit.apply_params(remat, tree, img), o1)


def test_t2t_remat_and_dropout_follow_the_arguments():
    """T2T-ViT with ``remat``: the same logits and gradients as without;
    dropout (the performers' 0.1 and the blocks') only with ``train=True``,
    whatever the module's mode."""
    _, variables, tmodel, (images, _) = _t2t_setup()
    remat = tt2t.T2TViT(tmodel.config.replace(remat=True), device="cpu",
                        generator=torch.Generator().manual_seed(1))
    remat.load_state_dict(tmodel.state_dict())
    img = torch.from_numpy(images[:1])
    tree = _torch_tree(variables["params"])
    o1, g1 = _grads(tmodel, tree, img)
    o2, g2 = _grads(remat, tree, img)
    assert torch.equal(o1, o2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    remat.train()
    with torch.no_grad():
        assert torch.equal(tvit.apply_params(remat, tree, img), o1.detach())
        a = tvit.apply_params(remat, tree, img, train=True)
    assert not torch.equal(a, o1.detach())


def test_train_step_runs_dropout_off_unless_asked():
    _, params, _, batches = _setup()
    model = tvit.ViT(tvit.deit_config("tiny", "standard", dropout_rate=0.5, **NARROW),
                     device="cpu")
    tree = _torch_tree(params)
    img, labels = (torch.from_numpy(a) for a in batches[0])
    assert model.training  # nn.Module's default, which no longer turns dropout on
    with torch.no_grad():
        ref = tvit.load_params(model, tree)(img)
        assert torch.equal(tvit.apply_params(model, tree, img), ref)
        a = tvit.apply_params(model, tree, img, train=True)
        b = tvit.apply_params(model, tree, img, train=True)
    assert not torch.equal(a, b) and not torch.equal(a, ref)
    tx = tft.build_optimizer(tft.FinetuneConfig(lr=0.0))
    step = ttrain.make_train_step(lambda p, x: tvit.apply_params(model, p, x), tx)
    _, _, m = step(tree, tx.init(tree), img, labels)
    assert float(m["loss"]) == float(ttrain.cross_entropy(ref, labels))


def test_apply_params_and_load_params_check_the_tree():
    _, params, tmodel, batches = _setup()
    tree = _torch_tree(params)
    del tree["head"]
    with pytest.raises(KeyError, match="head"):
        tvit.apply_params(tmodel, tree, torch.from_numpy(batches[0][0]))
    with pytest.raises(KeyError, match="head"):
        tvit.load_params(tmodel, tree)
    bad = _torch_tree(params)
    bad["head"]["bias"] = bad["head"]["bias"].double()
    with pytest.raises(ValueError, match="head.bias"):
        tvit.load_params(tmodel, bad)


# ---------------------------------------------------------------------------
# No kernel has a backward: the wrappers raise instead of cutting the graph
# ---------------------------------------------------------------------------


def test_module_path_backward_raises_and_the_forward_is_unchanged():
    """kernel_mode="pallas" (sdpa and mlp): on the CPU the wrappers take
    their twins, and the backward raises as on the card."""
    _, params, _, batches = _setup()
    model = tvit.ViT(tvit.deit_config("tiny", "standard", kernel_mode="pallas", **NARROW),
                     device="cpu")
    load_jax_params(model, params)
    img = torch.from_numpy(batches[0][0])
    out = model(img)
    assert out.requires_grad
    with torch.no_grad():
        assert torch.equal(out, model(img))
    with pytest.raises(RuntimeError, match="no backward kernel yet"):
        out.square().mean().backward()


def test_fused_entry_point_backward_raises():
    _, _, tmodel, batches = _setup()
    img = torch.from_numpy(batches[0][0]).requires_grad_()
    out = tvit.fused_vit_apply(tmodel, img)
    with torch.no_grad():
        assert torch.equal(out, tvit.fused_vit_apply(tmodel, img))
    with pytest.raises(RuntimeError, match="no backward kernel yet"):
        torch.autograd.grad(out.sum(), img)
    stacked = {k: v.clone().requires_grad_() for k, v in tvit.prepare_vit_fused(tmodel).items()}
    out = tvit.fused_vit_apply(tmodel, img.detach(), stacked=stacked)
    with pytest.raises(RuntimeError, match="linear: no backward kernel yet"):
        out.sum().backward()


def test_wrappers_mark_outputs_and_twins_stay_differentiable():
    rng = torch.Generator().manual_seed(0)
    x = torch.randn(5, 16, generator=rng)
    w = torch.randn(16, 8, generator=rng, requires_grad=True)
    b = torch.zeros(8)
    y = tfe.linear(x, w, b, epilogue=tfe.CAST_THEN_BIAS)
    assert y.grad_fn is not None
    with pytest.raises(RuntimeError, match="linear: no backward kernel yet"):
        y.sum().backward()
    y_plain = tfe.linear_plain(x, w, b, epilogue=tfe.CAST_THEN_BIAS)
    assert torch.equal(y.detach(), y_plain.detach())
    y_plain.sum().backward()
    assert w.grad is not None and torch.isfinite(w.grad).all()
    # int8 outputs carry no gradient; the scales do, through the raising node
    q, s = tfe.quant_rows(x @ w)
    assert q.dtype == torch.int8 and not q.requires_grad and s.requires_grad
    with pytest.raises(RuntimeError, match="quant_rows: no backward kernel yet"):
        s.sum().backward()
    # a kernel that writes into a given out: the out (and its base) carry it
    qkv = torch.randn(1, 4, 3 * 2 * 16, generator=rng) @ torch.eye(96).requires_grad_()
    o = torch.empty(1, 4, 32)
    q_, k_, v_ = (t for t in qkv.reshape(1, 4, 3, 2, 16).permute(2, 0, 3, 1, 4))
    tfa.sdpa(q_, k_, v_, out=o.view(1, 4, 2, 16).transpose(1, 2))
    assert o.requires_grad
    with pytest.raises(RuntimeError, match="sdpa: no backward kernel yet"):
        o.sum().backward()
    # no input requires grad, or grad mode off: the result as it was
    w2 = torch.randn(16, 16, generator=rng)
    assert not tfm.mlp(x, w2, torch.zeros(16), w2, torch.zeros(16)).requires_grad
    with torch.no_grad():
        assert not tfe.linear(x, w, b, epilogue=tfe.CAST_THEN_BIAS).requires_grad
