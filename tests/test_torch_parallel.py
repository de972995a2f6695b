"""The port's dp x tp mesh against the JAX package's on the CPU: ``make_mesh``,
the partition rules and ``shard_params`` / ``gather_params``, the sharded
train step at tp 1 and 2 and with ``grad_accum=2`` (two SGD steps with
momentum, so the sharded optimizer state counts), ``evaluate_sharded`` and
``calculate_head_importance(mesh=...)``, each against JAX on its virtual
CPU devices; the dryrun at 4 ranks; ``parallel/launch.spawn``'s failures
(a rank that raises, a rank that never joins a collective) and a rank that
finds no kernel library.

The port's ranks are gloo processes (``parallel/launch.spawn``).  One world
of 4 ranks runs every port-side case of this file once (module fixture) and
the cases read its results.  A rank imports this module to find its
function, so JAX is imported only inside the test functions and fixtures:
the ranks stay light and import no JAX.
"""

import functools
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu_torch.ops.cuda import build
from edgevisiontransformer_tpu_torch.parallel import launch
from edgevisiontransformer_tpu_torch.parallel import mesh as tmesh

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
DEADLINE_S = 300.0
SMALL = dict(image_size=32, patch_size=16, dim=64, depth=2, heads=2, mlp_dim=128,
             num_classes=16)
# (dp, tp, grad_accum) of the sharded train step cases, over WORLD ranks
STEPS = [(4, 1, 1), (2, 2, 1), (2, 2, 2)]
STEP_IDS = ["dp4-tp1", "dp2-tp2", "dp2-tp2-accum2"]
MESHES = [(4, 1), (2, 2)]
LR, MOMENTUM, N_STEPS = 0.1, 0.9, 2
EVAL_BATCH = 8


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# The port's ranks
# ---------------------------------------------------------------------------


def _parallel_rank(rank, world, params_np, x, labels, eval_params_np, folder, imgs):
    """Every port-side case of this file on one rank of a 4-rank world."""
    from edgevisiontransformer_tpu_torch.models import vit as tvit
    from edgevisiontransformer_tpu_torch.pruning.head_importance import (
        calculate_head_importance)
    from edgevisiontransformer_tpu_torch.utils.imagenet import evaluate, evaluate_sharded
    from edgevisiontransformer_tpu_torch.utils.jax_bridge import (flatten_tree, load_jax_params,
                                                                  sharded_from_jax, tree_to_torch)
    from edgevisiontransformer_tpu_torch.parallel import train as ttrain

    out = {}
    m22 = tmesh.make_mesh(dp=2, tp=2)
    out["shape"] = dict(m22.shape)
    out["default_shape"] = dict(tmesh.make_mesh(tp=2).shape)
    try:
        tmesh.make_mesh(dp=3, tp=2)
        out["bad_mesh"] = None
    except ValueError as e:
        out["bad_mesh"] = str(e)
    out["coords"] = (m22.index("dp"), m22.index("tp"), m22.members("dp"), m22.members("tp"))
    full = tree_to_torch(params_np)
    local = sharded_from_jax(params_np, m22)
    out["local"] = {k: v.clone() for k, v in flatten_tree(local).items()}
    back = tmesh.gather_params(local, m22)
    out["round_trip"] = all(torch.equal(a, flatten_tree(full)[k])
                            for k, a in flatten_tree(back).items())

    cfg = tvit.deit_config("tiny", "standard", **SMALL)
    model = tvit.ViT(cfg, device="cpu")
    opt = ttrain.Optimizer(torch.optim.SGD, {"lr": LR, "momentum": MOMENTUM})
    xt, yt = torch.from_numpy(x), torch.from_numpy(labels).long()
    out["steps"] = []
    for dp, tp, accum in STEPS:
        mesh = tmesh.make_mesh(dp=dp, tp=tp)
        step = ttrain.jit_sharded_train_step(
            ttrain.make_train_step(lambda p, xx: tvit.apply_params(model, p, xx), opt,
                                   grad_accum=accum), mesh, None, config=cfg)
        params = sharded_from_jax(params_np, mesh)
        state = opt.init(params)
        losses = []
        for _ in range(N_STEPS):
            params, state, metrics = step(params, state, xt, yt)
            losses.append(float(metrics["loss"]))
        out["steps"].append((losses, flatten_tree(tmesh.gather_params(params, mesh))))

    eval_cfg = tvit.deit_config("tiny", "standard", **{**SMALL, "num_classes": 2})
    emodel = tvit.ViT(eval_cfg, device="cpu")
    load_jax_params(emodel, eval_params_np)
    forward = lambda xx: emodel(xx)  # noqa: E731
    kw = dict(batch_size=EVAL_BATCH, crop=32, resize=36, device="cpu", native=False)
    out["evaluate"] = evaluate(forward, folder, **kw)
    out["evaluate_sharded"] = [evaluate_sharded(forward, folder, tmesh.make_mesh(dp=dp, tp=tp),
                                                **kw) for dp, tp in MESHES]
    out["importance"] = [calculate_head_importance(eval_cfg, emodel.params(), [imgs],
                                                   mesh=tmesh.make_mesh(dp=dp, tp=tp))
                         for dp, tp in MESHES]
    out["importance_one"] = calculate_head_importance(eval_cfg, emodel.params(), [imgs])
    return out


# ---------------------------------------------------------------------------
# The JAX side and the world, once per module
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_setup():
    import jax
    import jax.numpy as jnp

    from edgevisiontransformer_tpu.models.vit import ViT, deit_config

    model = ViT(deit_config("tiny").replace(**SMALL))
    x = np.array(jax.random.normal(jax.random.key(0), (8, 3, 32, 32)))
    labels = (np.arange(8) % 16).astype(np.int32)
    params = model.init(jax.random.key(1), jnp.asarray(x))
    ecfg = deit_config("tiny").replace(**{**SMALL, "num_classes": 2})
    emodel = ViT(ecfg)
    eparams = emodel.init(jax.random.key(4), jnp.ones((1, 3, 32, 32)))
    imgs = np.asarray(jax.random.normal(jax.random.key(3), (8, 3, 32, 32)))
    return model, params, x, labels, emodel, eparams, imgs


def _write_folder(root: Path):
    """Two classes of 5 BMPs (10 images over batches of 8: a padded tail)."""
    from edgevisiontransformer_tpu_torch.utils.imagenet import write_bmp

    rng = np.random.RandomState(0)
    for cls in ("a", "b"):
        (root / cls).mkdir(parents=True)
        for i in range(5):
            write_bmp(root / cls / f"{i}.bmp", rng.randint(0, 255, (40, 40, 3), np.uint8))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax

    model, params, x, labels, emodel, eparams, imgs = _jax_setup()
    folder = tmp_path_factory.mktemp("val")
    _write_folder(folder)
    results = launch.spawn(
        _parallel_rank, WORLD, backend="gloo", device="cpu", deadline_s=DEADLINE_S,
        args=(jax.tree.map(np.asarray, params["params"]), x, labels,
              jax.tree.map(np.asarray, eparams["params"]), str(folder), imgs))
    return results, str(folder)


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------


def test_make_mesh_shapes_and_error_match_jax(world):
    from edgevisiontransformer_tpu.parallel import make_mesh

    results, _ = world
    jmesh = make_mesh(dp=2, tp=2, devices=__import__("jax").devices()[:4])
    for rank, r in enumerate(results):
        assert r["shape"] == dict(jmesh.shape) == {"dp": 2, "tp": 2}
        assert r["default_shape"] == {"dp": 2, "tp": 2}
        assert r["bad_mesh"] is not None and "dp*tp=6" in r["bad_mesh"]
        # rank i * tp + j at (i, j), as JAX lays out its devices
        assert r["coords"][:2] == divmod(rank, 2)
        assert r["coords"][2] == [rank % 2, 2 + rank % 2]
        assert r["coords"][3] == [rank - rank % 2, rank - rank % 2 + 1]
    with pytest.raises(ValueError):
        make_mesh(dp=3, tp=2)


@pytest.mark.parametrize("path", [
    "params/block_0/attn/qkv_kernel", "params/block_0/attn/qkv_bias",
    "params/block_1/attn/out_kernel", "params/block_0/ffn/fc1_kernel",
    "params/block_0/ffn/fc1_bias", "params/block_3/ffn/fc2_kernel",
    "params/block_0/ffn/fc2_bias", "params/cls_token", "params/head/kernel",
    "params/t2t/attention1/kqv/kernel", "params/t2t/attention1/attn_output/kernel",
])
def test_param_partition_spec_matches_jax(path):
    from edgevisiontransformer_tpu.parallel import param_partition_spec

    got, want = tmesh.param_partition_spec(path), param_partition_spec(path)
    assert tuple(got) == tuple(want)
    assert got.layout == ("qkv" if re.search(r"(qkv|kqv)/?(_kernel|_bias|kernel|bias)$", path)
                          else "")


def test_shard_params_local_shapes_and_the_qkv_layout(world):
    results, _ = world
    _, params, *_ = _jax_setup()
    full = _flat(__import__("jax").tree.map(np.asarray, params["params"]))
    d, inner, hidden = SMALL["dim"], 3 * SMALL["dim"], SMALL["mlp_dim"]
    want_shapes = {"block_0/attn/qkv_kernel": (d, inner // 2), "block_0/attn/qkv_bias": (inner // 2,),
                   "block_0/attn/out_kernel": (d // 2, d), "block_0/ffn/fc1_kernel": (d, hidden // 2),
                   "block_0/ffn/fc1_bias": (hidden // 2,), "block_0/ffn/fc2_kernel": (hidden // 2, d),
                   "block_0/ffn/fc2_bias": (d,), "cls_token": (1, 1, d),
                   "head/kernel": (d, SMALL["num_classes"])}
    for rank, r in enumerate(results):
        local = {k.replace(".", "/"): v.numpy() for k, v in r["local"].items()}
        assert sorted(local) == sorted(full)
        for k, shape in want_shapes.items():
            assert local[k].shape == shape, k
        tp_i = rank % 2
        # whole heads per rank: [q_r | k_r | v_r], not JAX's contiguous slice
        q, k, v = np.split(full["block_0/attn/qkv_kernel"], 3, axis=1)
        mine = np.concatenate([np.split(s, 2, axis=1)[tp_i] for s in (q, k, v)], axis=1)
        np.testing.assert_array_equal(local["block_0/attn/qkv_kernel"], mine)
        jax_slice = np.split(full["block_0/attn/qkv_kernel"], 2, axis=1)[tp_i]
        assert not np.array_equal(mine, jax_slice)
        np.testing.assert_array_equal(local["block_1/attn/out_kernel"],
                                      np.split(full["block_1/attn/out_kernel"], 2)[tp_i])
        np.testing.assert_array_equal(local["cls_token"], full["cls_token"])
        assert r["round_trip"]


@functools.lru_cache(maxsize=None)
def _jax_steps():
    import jax
    import optax

    from edgevisiontransformer_tpu.parallel import (jit_sharded_train_step, make_mesh,
                                                    make_train_step, shard_params)

    model, params, x, labels, *_ = _jax_setup()
    optimizer = optax.sgd(LR, momentum=MOMENTUM)
    out = []
    for dp, tp, accum in STEPS:
        step = make_train_step(model.apply, optimizer, grad_accum=accum)
        mesh = make_mesh(dp=dp, tp=tp, devices=jax.devices()[:WORLD])
        with mesh:
            p = shard_params(params, mesh)
            state = optimizer.init(p)
            jstep = jit_sharded_train_step(step, mesh, params)
            losses = []
            for _ in range(N_STEPS):
                p, state, metrics = jstep(p, state, x, labels)
                losses.append(float(metrics["loss"]))
        out.append((losses, _flat(jax.tree.map(np.asarray, p["params"]))))
    return out


@pytest.mark.parametrize("case", range(len(STEPS)), ids=STEP_IDS)
def test_sharded_train_step_matches_jax(world, case):
    results, _ = world
    want_losses, want = _jax_steps()[case]
    for r in results:
        losses, got = r["steps"][case]
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        got = {k.replace(".", "/"): v.numpy() for k, v in got.items()}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", range(len(STEPS)), ids=STEP_IDS)
def test_sharded_train_step_matches_one_process(world, case):
    """The gathered tree after the sharded steps is the port's one-process
    ``make_train_step`` on the whole batch (same grad_accum), and every rank
    holds the same."""
    from edgevisiontransformer_tpu_torch.models import vit as tvit
    from edgevisiontransformer_tpu_torch.parallel import train as ttrain
    from edgevisiontransformer_tpu_torch.utils.jax_bridge import flatten_tree, tree_to_torch

    results, _ = world
    _, params, x, labels, *_ = _jax_setup()
    accum = STEPS[case][2]
    model = tvit.ViT(tvit.deit_config("tiny", "standard", **SMALL), device="cpu")
    opt = ttrain.Optimizer(torch.optim.SGD, {"lr": LR, "momentum": MOMENTUM})
    step = ttrain.make_train_step(lambda p, xx: tvit.apply_params(model, p, xx), opt,
                                  grad_accum=accum)
    p = tree_to_torch(__import__("jax").tree.map(np.asarray, params["params"]))
    state = opt.init(p)
    losses = []
    for _ in range(N_STEPS):
        p, state, metrics = step(p, state, torch.tensor(x), torch.tensor(labels).long())
        losses.append(float(metrics["loss"]))
    want = flatten_tree(p)
    for r in results:
        got_losses, got = r["steps"][case]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        for k, v in results[0]["steps"][case][1].items():
            assert torch.equal(got[k], v), k


@pytest.mark.parametrize("mesh_i", range(len(MESHES)), ids=["dp4", "dp2-tp2"])
def test_evaluate_sharded_matches_jax_and_evaluate(world, mesh_i):
    import jax

    from edgevisiontransformer_tpu.parallel import make_mesh
    from edgevisiontransformer_tpu.utils.imagenet import evaluate_sharded

    results, folder = world
    *_, emodel, eparams, _ = _jax_setup()
    dp, tp = MESHES[mesh_i]
    want = evaluate_sharded(emodel.apply, eparams, folder,
                            make_mesh(dp=dp, tp=tp, devices=jax.devices()[:WORLD]),
                            batch_size=EVAL_BATCH, crop=32, resize=36)
    for r in results:
        assert r["evaluate_sharded"][mesh_i] == r["evaluate"] == want
    assert 0.0 < want < 1.0  # a count the pad or a lost share would move


@pytest.mark.parametrize("mesh_i", range(len(MESHES)), ids=["dp4", "dp2-tp2"])
def test_head_importance_on_a_mesh_matches_jax(world, mesh_i):
    import jax

    from edgevisiontransformer_tpu.models.vit import deit_config
    from edgevisiontransformer_tpu.parallel import make_mesh
    from edgevisiontransformer_tpu.pruning import calculate_head_importance

    results, _ = world
    *_, eparams, imgs = _jax_setup()
    dp, tp = MESHES[mesh_i]
    ecfg = deit_config("tiny").replace(**{**SMALL, "num_classes": 2})
    want = calculate_head_importance(ecfg, eparams, [imgs],
                                     mesh=make_mesh(dp=dp, tp=tp, devices=jax.devices()[:WORLD]))
    for r in results:
        got = r["importance"][mesh_i]
        assert got.shape == want.shape == (SMALL["depth"], SMALL["heads"])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got, r["importance_one"], rtol=0, atol=1e-6)


def test_dryrun_four_ranks_prints_the_jax_tail():
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-m", "edgevisiontransformer_tpu_torch.parallel.dryrun",
                          "4", "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                         timeout=DEADLINE_S)
    assert out.returncode == 0, out.stdout + out.stderr
    tail = out.stdout.strip().splitlines()[-1]
    m = re.fullmatch(r"dryrun_multichip ok: mesh=\{'dp': 2, 'tp': 2\}, loss=(\S+), pp=2 sp=tp2 "
                     r"max\|pp-sp\|=(\S+) pp4-train-loss=(\S+) eval-count=(\S+) "
                     r"importance-psum-err=(\S+)", tail)
    assert m, tail
    loss, err, pl_loss, acc, imp = map(float, m.groups())
    assert np.isfinite(loss) and np.isfinite(pl_loss)
    assert err < 1e-4 and imp < 1e-4 and 0.0 <= acc <= 1.0
    assert time.monotonic() - t0 < DEADLINE_S


def _raising_rank(rank, world):
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    torch.distributed.barrier()
    return rank


def _absent_rank(rank, world):
    if rank == 1:
        time.sleep(600)  # never joins the all-reduce
    t = torch.ones(3)
    torch.distributed.all_reduce(t)
    return t


def test_spawn_returns_each_ranks_result_in_order():
    """Results in rank order, tensors by value, one CPU thread a rank."""
    got = launch.spawn(_echo_rank, 3, backend="gloo", device="cpu", deadline_s=60, args=(5,))
    assert [g[0] for g in got] == [0, 1, 2]
    assert all(torch.equal(g[1], torch.full((2,), 15.0)) for g in got)
    assert [g[2] for g in got] == [1, 1, 1]  # one CPU thread a rank


def _echo_rank(rank, world, k):
    t = torch.full((2,), float(k))
    torch.distributed.all_reduce(t)
    return rank, t, torch.get_num_threads()


def test_spawn_raises_with_the_failing_ranks_traceback():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 failed:(.|\n)*rank one fails on purpose"):
        launch.spawn(_raising_rank, 2, backend="gloo", device="cpu", deadline_s=30)
    assert time.monotonic() - t0 < 30


def test_spawn_ends_a_hung_collective_at_its_deadline():
    deadline = 10.0
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        launch.spawn(_absent_rank, 2, backend="gloo", device="cpu", deadline_s=deadline)
    assert time.monotonic() - t0 < deadline + 5


def test_a_rank_never_builds_the_kernel_library(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_build_allowed", True)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "torch_kernels")
    monkeypatch.setattr(build, "compile_library",
                        lambda *a, **k: pytest.fail("a forbidden build was started"))
    build.forbid_build()
    with pytest.raises(build.KernelBuildError, match="may not build"):
        build.load()
    assert not (tmp_path / "torch_kernels").exists()
