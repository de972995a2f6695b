"""The port's GPipe pipeline (pp) and sequence parallelism (sp) against the
JAX package's on the CPU: ``vit_block_apply``, the pipeline forward at
(pp, microbatches) = (2, 2), (4, 2), (2, 4) and its shape guards, the
pipeline train step (loss, updated stages and head) at pp 4 and 2, and the
sequence-sharded forward and its gradients over groups of 2 and 4 ranks at
16 tokens and at 17 (padded, its keys masked), each against JAX on its
virtual CPU devices at the JAX tests' tolerances.

One world of 4 gloo ranks (``parallel/launch.spawn``) runs every port-side
case once (module fixture); a rank imports this module, so JAX is imported
only inside the test functions and fixtures.
"""

import functools

import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu_torch.parallel import launch
from edgevisiontransformer_tpu_torch.parallel import pipeline as tpipe
from edgevisiontransformer_tpu_torch.parallel.mesh import Mesh, make_mesh
from edgevisiontransformer_tpu_torch.utils.jax_bridge import stacked_from_params

WORLD = 4
DEADLINE_S = 300.0
PP_CASES = [(2, 2), (4, 2), (2, 4)]
# (pp, microbatches) of the train step cases: JAX's test's, and pp = 2
TRAIN_CASES = [(4, 4), (2, 2)]
TRAIN_LR = 1e-2
# (group size, heads, dim) of the sp cases, and their token counts: heads
# that divide the group, and deit_tiny's 3 heads over 2 and 4 ranks (2 + 1;
# 1 + 1 + 1 + 0)
SP_GROUPS = [(2, 2, 32), (4, 4, 32), (2, 3, 48), (4, 3, 48)]
SP_TOKENS = [16, 17]
SP_IDS = [f"g{g}-h{h}-n{n}" for g, h, _ in SP_GROUPS for n in SP_TOKENS]


def _kw(cfg) -> dict:
    return dict(heads=cfg["heads"], eps=cfg["eps"], approx_gelu=cfg["approx_gelu"],
                reference_residual=cfg["reference_residual"])


def _stack(params_np, cfg) -> dict:
    return stacked_from_params(params_np, cfg["depth"], cfg["qkv_bias"])


# ---------------------------------------------------------------------------
# The port's ranks
# ---------------------------------------------------------------------------


def _pipeline_rank(rank, world, models, data):
    """Every port-side case of this file on one rank of a 4-rank world."""
    out = {"pp": [], "guards": [], "train": [], "sp": []}
    cfg4, p4 = models["depth4"]
    st4 = _stack(p4, cfg4)
    h = torch.from_numpy(data["h"])
    for pp, m in PP_CASES:
        mesh = Mesh(np.arange(pp), ("pp",))
        with torch.no_grad():
            out["pp"].append(tpipe.pipeline_encoder_apply(st4, h, mesh, microbatches=m,
                                                          **_kw(cfg4))
                             if rank in mesh else None)
    for pp, m in ((3, 2), (2, 3)):
        try:
            tpipe.pipeline_encoder_apply(st4, h, Mesh(np.arange(pp), ("pp",)), microbatches=m,
                                         **_kw(cfg4))
            out["guards"].append(None)
        except ValueError as e:
            out["guards"].append(str(e))

    cfg8, p8 = models["depth8"]
    st8 = _stack(p8, cfg8)
    for pp, m in TRAIN_CASES:
        mesh = Mesh(np.arange(pp), ("pp",))
        if rank not in mesh:
            out["train"].append(None)
            continue
        step = tpipe.make_pipeline_train_step(mesh, microbatches=m, learning_rate=TRAIN_LR,
                                              **_kw(cfg8))
        new, head, loss = step(st8, torch.from_numpy(data["head_w"]),
                               torch.from_numpy(data["h8"]), torch.from_numpy(data["labels"]))
        out["train"].append((new, head, float(loss)))

    for g, heads, dim in SP_GROUPS:
        cfg, p = models[f"heads{heads}"]
        mesh = make_mesh(dp=WORLD // g, tp=g)
        for n in SP_TOKENS:
            st = {k: v.requires_grad_() for k, v in _stack(p, cfg).items()}
            y = tpipe.sequence_sharded_encoder_apply(st, torch.from_numpy(data[f"h{n}d{dim}"]),
                                                     mesh, **_kw(cfg))
            grads = torch.autograd.grad((y ** 2).sum(), list(st.values()))
            out["sp"].append((y.detach(), dict(zip(st, grads))))
    return out


# ---------------------------------------------------------------------------
# The JAX side and the world, once per module
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_model(depth=4, heads=2, dim=32):
    import jax
    import jax.numpy as jnp

    from edgevisiontransformer_tpu.models.vit import ViT, deit_config
    from edgevisiontransformer_tpu.ops.pallas.fused_encoder import stack_vit_layer_params

    cfg = deit_config("tiny").replace(image_size=32, patch_size=16, dim=dim, depth=depth,
                                      heads=heads, mlp_dim=2 * dim, num_classes=8)
    params = ViT(cfg).init(jax.random.key(0), jnp.ones((2, 3, 32, 32)))["params"]
    stacked = stack_vit_layer_params(params, depth, cfg.qkv_bias)
    desc = dict(depth=depth, heads=heads, eps=cfg.layernorm_eps, approx_gelu=cfg.gelu_approx,
                reference_residual=cfg.reference_residual, qkv_bias=cfg.qkv_bias)
    return cfg, params, stacked, desc


@functools.lru_cache(maxsize=None)
def _data():
    import jax

    out = {"h": jax.random.normal(jax.random.key(2), (4, 16, 32)),
           "h8": jax.random.normal(jax.random.key(4), (4, 16, 32)),
           "head_w": jax.random.normal(jax.random.key(5), (32, 8)) * 0.02,
           "labels": np.arange(4, dtype=np.int32) % 8}
    for n in SP_TOKENS:
        for dim in (32, 48):
            out[f"h{n}d{dim}"] = jax.random.normal(jax.random.key(6 + n + dim), (4, n, dim))
    return {k: np.asarray(v) for k, v in out.items()}


def _jkw(cfg) -> dict:
    return dict(heads=cfg.heads, eps=cfg.layernorm_eps, approx_gelu=cfg.gelu_approx,
                reference_residual=cfg.reference_residual)


@pytest.fixture(scope="module")
def world():
    import jax

    models = {}
    for name, kw in (("depth4", dict(depth=4)), ("depth8", dict(depth=8)),
                     ("heads2", dict(depth=2, heads=2)), ("heads4", dict(depth=2, heads=4)),
                     ("heads3", dict(depth=2, heads=3, dim=48))):
        _, params, _, desc = _jax_model(**kw)
        models[name] = (desc, jax.tree.map(np.asarray, params))
    return launch.spawn(_pipeline_rank, WORLD, backend="gloo", device="cpu",
                        deadline_s=DEADLINE_S, args=(models, _data()))


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("style", ["standard", "reference"])
def test_vit_block_apply_matches_jax(style):
    import jax
    import jax.numpy as jnp

    from edgevisiontransformer_tpu.models.vit import EncoderBlock, ViT, deit_config
    from edgevisiontransformer_tpu.ops.pallas.fused_encoder import stack_vit_layer_params
    from edgevisiontransformer_tpu.parallel.pipeline import vit_block_apply

    cfg = deit_config("tiny", style).replace(image_size=32, patch_size=16, dim=32, depth=2,
                                             heads=2, mlp_dim=64, num_classes=8)
    params = ViT(cfg).init(jax.random.key(0), jnp.ones((2, 3, 32, 32)))["params"]
    h = jax.random.normal(jax.random.key(1), (3, 16, cfg.dim))
    ref = EncoderBlock(cfg, 0).apply({"params": params["block_0"]}, h)
    jst = stack_vit_layer_params(params, cfg.depth, cfg.qkv_bias)
    jgot = vit_block_apply(jax.tree.map(lambda a: a[0], jst), h, **_jkw(cfg))
    st = stacked_from_params(jax.tree.map(np.asarray, params), cfg.depth, cfg.qkv_bias)
    got = tpipe.vit_block_apply({k: v[0] for k, v in st.items()}, torch.tensor(np.asarray(h)),
                                **_jkw(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-5, atol=1e-5)


def _jax_encoder(cfg, params, h):
    from edgevisiontransformer_tpu.models.vit import EncoderBlock

    for i in range(cfg.depth):
        h = EncoderBlock(cfg, i).apply({"params": params[f"block_{i}"]}, h)
    return h


@pytest.mark.parametrize("case", range(len(PP_CASES)),
                         ids=[f"pp{pp}-m{m}" for pp, m in PP_CASES])
def test_pipeline_encoder_matches_jax(world, case):
    import jax

    from edgevisiontransformer_tpu.parallel.pipeline import pipeline_encoder_apply
    from jax.sharding import Mesh as JMesh

    pp, m = PP_CASES[case]
    cfg, params, stacked, _ = _jax_model()
    h = _data()["h"]
    mesh = JMesh(np.asarray(jax.devices()[:pp]), ("pp",))
    want = jax.jit(lambda s, x: pipeline_encoder_apply(s, x, mesh, microbatches=m,
                                                       **_jkw(cfg)))(stacked, h)
    ref = jax.jit(functools.partial(_jax_encoder, cfg))(params, h)
    for rank, r in enumerate(world):
        got = r["pp"][case]
        if rank >= pp:
            assert got is None
            continue
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_pipeline_shape_guards_match_jax(world):
    import jax

    from edgevisiontransformer_tpu.parallel.pipeline import pipeline_encoder_apply
    from jax.sharding import Mesh as JMesh

    cfg, _, stacked, _ = _jax_model()
    h = np.ones((4, 16, cfg.dim), np.float32)
    for (pp, m), match in (((3, 2), "not divisible by pp"),
                           ((2, 3), "not divisible by microbatches")):
        with pytest.raises(ValueError, match=match):
            pipeline_encoder_apply(stacked, h, JMesh(np.asarray(jax.devices()[:pp]), ("pp",)),
                                   microbatches=m, heads=cfg.heads)
    for r in world:
        assert "not divisible by pp" in r["guards"][0]
        assert "not divisible by microbatches" in r["guards"][1]


@functools.lru_cache(maxsize=None)
def _jax_train(case):
    import jax

    from edgevisiontransformer_tpu.parallel.pipeline import make_pipeline_train_step
    from jax.sharding import Mesh as JMesh

    pp, m = TRAIN_CASES[case]
    cfg, _, stacked, _ = _jax_model(depth=8)
    d = _data()
    step = make_pipeline_train_step(JMesh(np.asarray(jax.devices()[:pp]), ("pp",)),
                                    microbatches=m, learning_rate=TRAIN_LR, **_jkw(cfg))
    new, head, loss = step(stacked, d["head_w"], d["h8"], d["labels"])
    return jax.tree.map(np.asarray, new), np.asarray(head), float(loss), stacked


@pytest.mark.parametrize("case", range(len(TRAIN_CASES)),
                         ids=[f"pp{pp}-m{m}" for pp, m in TRAIN_CASES])
def test_pipeline_train_step_matches_jax(world, case):
    """The loss, every updated stage and the head: the gradients through the
    schedule, not the loss alone; the update moved every leaf."""
    new_j, head_j, loss_j, start = _jax_train(case)
    pp = TRAIN_CASES[case][0]
    for rank, r in enumerate(world):
        got = r["train"][case]
        if rank >= pp:
            assert got is None
            continue
        new, head, loss = got
        np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
        assert sorted(new) == sorted(new_j)
        for k in new_j:
            np.testing.assert_allclose(new[k].numpy(), new_j[k], rtol=2e-4, atol=2e-5,
                                       err_msg=k)
            if k not in ("ln1_g", "ln2_g"):  # the scales' steps are the smallest
                assert not np.array_equal(new[k].numpy(), np.asarray(start[k])), k
        np.testing.assert_allclose(head.numpy(), head_j, rtol=2e-4, atol=2e-5)


@functools.lru_cache(maxsize=None)
def _jax_sp(case):
    import jax
    import jax.numpy as jnp

    from edgevisiontransformer_tpu.parallel import make_mesh as jmake_mesh
    from edgevisiontransformer_tpu.parallel.pipeline import sequence_sharded_encoder_apply

    g, heads, dim = SP_GROUPS[case // len(SP_TOKENS)]
    n = SP_TOKENS[case % len(SP_TOKENS)]
    cfg, _, stacked, _ = _jax_model(depth=2, heads=heads, dim=dim)
    mesh = jmake_mesh(dp=8 // g, tp=g)
    h = _data()[f"h{n}d{dim}"]
    fwd = lambda s: sequence_sharded_encoder_apply(s, h, mesh, **_jkw(cfg))  # noqa: E731
    with mesh:
        y = jax.jit(fwd)(stacked)
        grads = jax.jit(jax.grad(lambda s: jnp.sum(fwd(s) ** 2)))(stacked)
    return np.asarray(y), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("case", range(len(SP_IDS)), ids=SP_IDS)
def test_sequence_sharded_encoder_matches_jax(world, case):
    want, _ = _jax_sp(case)
    for r in world:
        got, _ = r["sp"][case]
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", range(len(SP_IDS)), ids=SP_IDS)
def test_sequence_sharded_encoder_grads_match_jax(world, case):
    _, want = _jax_sp(case)
    for r in world:
        _, grads = r["sp"][case]
        assert sorted(grads) == sorted(want)
        for k in want:
            np.testing.assert_allclose(grads[k].numpy(), want[k], rtol=5e-4, atol=5e-5,
                                       err_msg=k)
