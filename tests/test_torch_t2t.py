"""The port's T2T-ViT against the JAX one on the same params, constants and
images: ``unfold``, the stage-1 tokenizer (the plain twin of the stage-1
kernel against JAX ``fast_stage1_kqv`` and the Pallas ``stage1_kqv_kernel``
in interpret mode), ``TokenPerformer``, ``t2t_tokenize``, ``T2TViT.forward``
and ``fused_t2t_apply`` (on the CPU: the kernels' plain twins), the int8
stacks, calibration and ``fused_t2t_apply_int8``, and the variables bridge.

Small sizes: T2T-ViT-7 in the reference style at depth 2 with a narrower
encoder (dim 128, 2 heads, mlp 256); images are 224x224, the size the
stage-1 tokenizer is built for."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.models import t2t_vit as jt2t
from edgevisiontransformer_tpu.ops import quant as jq
from edgevisiontransformer_tpu.ops.pallas.t2t_stage1 import stage1_kqv_kernel
from edgevisiontransformer_tpu.ops.unfold import unfold as junfold
from edgevisiontransformer_tpu_torch.config import dtype_name
from edgevisiontransformer_tpu_torch.models import registry
from edgevisiontransformer_tpu_torch.models import t2t_vit as tt2t
from edgevisiontransformer_tpu_torch.ops import quant as tq
from edgevisiontransformer_tpu_torch.ops.cuda import performer as tperf
from edgevisiontransformer_tpu_torch.ops.cuda import t2t_stage1 as ts
from edgevisiontransformer_tpu_torch.ops.unfold import unfold as tunfold
from edgevisiontransformer_tpu_torch.ops.unfold import unfold_output_size
from edgevisiontransformer_tpu_torch.utils.jax_bridge import (load_jax_variables,
                                                              quantized_stack_from_jax, to_torch)

torch.set_num_threads(1)

NARROW = dict(depth=2, num_classes=10, dim=128, heads=2, mlp_dim=256)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fp32 logits: the bound of the JAX package's own fused-vs-apply T2T test
# (tests/test_t2t.py:296)
FP32 = dict(rtol=2e-3, atol=2e-3)
# bf16 logits, and int8 logits on the same stack: single-spacing flips (int8:
# bucket flips) compound through the tokenizer, two layers and the head
LOGIT_REL = 0.05
# stage-1 output, max |err| / max |ref|: the JAX package's own bounds for its
# kernel against fast_stage1_kqv (tests/test_t2t.py:446)
STAGE1_REL = {"float32": 2e-5, "bfloat16": 0.04}
# tokenizer and performer outputs in fp32, max |err| / max |ref|
TOKENIZER_REL = 1e-4


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _rel(got, ref) -> float:
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@functools.lru_cache(maxsize=None)
def _variables():
    """JAX variables for NARROW (params with perturbed 1-d leaves, so the
    biases and norm affines matter; constants as the model made them) and
    two images."""
    jmodel = jt2t.T2TViT(jt2t.t2t_vit_config(7, "reference", **NARROW))
    v = jax.jit(jmodel.init)(jax.random.key(1), jnp.ones((1, 3, 224, 224)))
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(
        np.float32) if a.ndim == 1 else np.asarray(a), v["params"])
    variables = {"params": params, "constants": jax.tree.map(np.asarray, v["constants"])}
    img = rng.standard_normal((2, 3, 224, 224)).astype(np.float32)
    return variables, img


@functools.lru_cache(maxsize=None)
def _models(dtype: str):
    jd, td = DTYPES[dtype]
    variables, img = _variables()
    jmodel = jt2t.T2TViT(jt2t.t2t_vit_config(7, "reference", dtype=jd, **NARROW))
    tmodel = tt2t.T2TViT(tt2t.t2t_vit_config(7, "reference", dtype=td, **NARROW), device="cpu")
    load_jax_variables(tmodel, variables)
    return jmodel, variables, tmodel, img


@functools.lru_cache(maxsize=None)
def _jax_fused(dtype: str, batch: int):
    jmodel, variables, _, img = _models(dtype)
    return _f32(jt2t.fused_t2t_apply(jmodel, variables, jnp.asarray(img[:batch])))


@functools.lru_cache(maxsize=None)
def _jax_apply(dtype: str):
    jmodel, variables, _, img = _models(dtype)
    return _f32(jax.jit(jmodel.apply)(variables, jnp.asarray(img)))


# ---------------------------------------------------------------------------
# unfold, the stage-1 weights and the stage-1 tokenizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channel_order", ["torch", "tf"])
@pytest.mark.parametrize("k,s,p,shape", [(7, 4, 2, (2, 3, 32, 32)), (3, 2, 1, (1, 64, 28, 28))])
def test_unfold_matches_jax_bit_for_bit(k, s, p, shape, channel_order):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    got = tunfold(torch.from_numpy(x), k, s, p, channel_order=channel_order)
    ref = np.asarray(junfold(jnp.asarray(x), k, s, p, channel_order=channel_order))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.shape[1] == unfold_output_size(shape[2], k, s, p) ** 2
    with pytest.raises(ValueError, match="channel_order"):
        tunfold(torch.from_numpy(x), k, s, p, channel_order="nhwc")


def test_build_stage1_weights_bit_for_bit():
    jmodel, variables, tmodel, _ = _models("float32")
    ref = jt2t.prepare_t2t_fused(jmodel, variables)
    got = tt2t.prepare_t2t_fused(tmodel)
    assert got["W9"].shape == (432, 192) and got["M9"].shape == (432, 1)
    assert float(got["M9"].sum()) == 147.0
    for k in ("W9", "M9", "c1", "c2"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    _, _, bmodel, _ = _models("bfloat16")
    assert tt2t.prepare_t2t_fused(bmodel)["W9"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stage1_plain_twin_matches_jax_fast_form_and_kernel(dtype):
    """The twin of the stage-1 kernel (what the wrapper runs on a CPU tensor)
    and the port's eager fast form against JAX ``fast_stage1_kqv`` and
    ``stage1_kqv_kernel`` (Pallas, interpret mode) on the same weights."""
    jd, td = DTYPES[dtype]
    jmodel, variables, tmodel, img = _models("float32")
    prep = jt2t.prepare_t2t_fused(jmodel, variables)
    eps = jt2t.TokenPerformer.layernorm_eps
    x = jnp.asarray(img).astype(jd)
    w9 = prep["W9"].astype(jd)
    refs = {"fast": jt2t.fast_stage1_kqv(x, w9, prep["M9"].astype(jd), prep["c1"], prep["c2"],
                                         eps=eps),
            "kernel": stage1_kqv_kernel(x, w9, prep["M9"], prep["c1"], prep["c2"], eps=eps)}
    tp = tt2t.prepare_t2t_fused(tmodel)
    tx = torch.from_numpy(_f32(x)).to(td)
    args = (tx, tp["W9"].to(td), tp["M9"], tp["c1"], tp["c2"])
    ts.reset_launches()
    got = ts.stage1_kqv(*args, eps=eps)
    assert ts.LAUNCHES["stage1_kqv"] == 0  # a CPU tensor takes the twin
    torch.testing.assert_close(got, ts.stage1_kqv_plain(*args, eps=eps), rtol=0, atol=0)
    fast = tt2t.fast_stage1_kqv(*args, eps=eps)
    assert got.dtype == fast.dtype == td and got.shape == (2, 3136, 192)
    for name, ref in refs.items():
        assert _rel(got, ref) < STAGE1_REL[dtype], name
        assert _rel(fast, ref) < STAGE1_REL[dtype], name


def test_stage1_refuses_other_image_sizes():
    _, _, tmodel, _ = _models("float32")
    tp = tt2t.prepare_t2t_fused(tmodel)
    small = torch.zeros(1, 3, 64, 64)
    with pytest.raises(ValueError, match="224"):
        ts.stage1_kqv(small, tp["W9"], tp["M9"], tp["c1"], tp["c2"])
    with pytest.raises(ValueError, match="224"):
        tt2t.fast_stage1_kqv(small, tp["W9"], tp["M9"], tp["c1"], tp["c2"])
    with pytest.raises(ValueError, match="224"):
        tt2t.t2t_tokenize(tmodel, small, fast=True)


# ---------------------------------------------------------------------------
# TokenPerformer, the tokenizer and the float model
# ---------------------------------------------------------------------------


def test_token_performer_matches_jax():
    jmodel, variables, tmodel, img = _models("float32")
    x = _f32(junfold(jnp.asarray(img), 7, 4, 2))
    p1 = {"params": variables["params"]["tokens_to_token"]["performer1"],
          "constants": variables["constants"]["tokens_to_token"]["performer1"]}
    ref = jt2t.TokenPerformer(64).apply(p1, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.tokens_to_token.performer1(torch.from_numpy(x))
    assert _rel(got, ref) < TOKENIZER_REL


@pytest.mark.parametrize("fast,stage1_impl", [(True, "auto"), (True, "fast"), (False, "auto")])
def test_t2t_tokenize_matches_jax(fast, stage1_impl):
    jmodel, variables, tmodel, img = _models("float32")
    ref = jt2t.t2t_tokenize(jmodel, variables, jnp.asarray(img), fast=fast,
                            stage1_impl=stage1_impl)
    with torch.no_grad():
        got = tt2t.t2t_tokenize(tmodel, torch.from_numpy(img), fast=fast,
                                stage1_impl=stage1_impl)
    assert got.shape == (2, 197, 128)
    assert _rel(got, ref) < TOKENIZER_REL


def test_t2t_tokenize_refuses_what_is_not_ported():
    _, _, tmodel, img = _models("float32")
    x = torch.from_numpy(img[:1])
    with pytest.raises(ValueError, match="stage1_impl"):
        tt2t.t2t_tokenize(tmodel, x, stage1_impl="pallas")


def _check(got, ref, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), ref, **FP32)
    else:
        assert _rel(got, ref) <= LOGIT_REL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_model_apply(dtype):
    _, _, tmodel, img = _models(dtype)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img))
    assert got.dtype == DTYPES[dtype][1] and got.shape == (2, 10)
    _check(got, _jax_apply(dtype), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,fast", [(1, None), (2, None), (2, False)])
def test_fused_t2t_apply_matches_jax_fused_and_apply(batch, fast, dtype):
    """b1 and b2 take the stage-1 form (batch < 8), ``fast=False`` the plain
    unfold; JAX's fused function takes the stage-1 form at both batches."""
    _, _, tmodel, img = _models(dtype)
    with torch.no_grad():
        got = tt2t.fused_t2t_apply(tmodel, torch.from_numpy(img[:batch]), fast=fast)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (batch, 10)
    _check(got, _jax_fused(dtype, batch), dtype)
    _check(got, _jax_apply(dtype)[:batch], dtype)


def test_fused_t2t_apply_prepared_and_plain_flag():
    """``plain=True`` runs the kernels' twins, whose performers keep K16's
    cast points, where a CPU tensor otherwise takes JAX's eager performer
    chain: the two agree within the bf16 logit bound, and with JAX."""
    _, _, tmodel, img = _models("bfloat16")
    x = torch.from_numpy(img[:1])
    ts.reset_launches()
    tperf.reset_launches()
    with torch.no_grad():
        a = tt2t.fused_t2t_apply(tmodel, x)
        b = tt2t.fused_t2t_apply(tmodel, x, prepared=tt2t.prepare_t2t_fused(tmodel),
                                 stacked=tt2t.prepare_vit_fused(tmodel))
        c = tt2t.fused_t2t_apply(tmodel, x, plain=True)
    assert ts.LAUNCHES["stage1_kqv"] == 0
    assert sum(tperf.LAUNCHES.values()) == 0
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert _rel(c, a) <= LOGIT_REL
    _check(c, _jax_fused("bfloat16", 1), "bfloat16")


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _calib():
    return list(jq.representative_batches(n=2, batch=1, shape=(3, 224, 224), seed=3))


@functools.lru_cache(maxsize=None)
def _jax_scales():
    jmodel, variables, _, _ = _models("float32")
    return jq.calibrate_t2t(jmodel, variables, batches=_calib())


def test_calibrate_t2t_matches_jax():
    """Absmax scales: the performer chain sums in another order, so within
    rtol 1e-4 rather than equal."""
    _, _, tmodel, _ = _models("float32")
    got = tq.calibrate_t2t(tmodel, batches=_calib())
    ref = _jax_scales()
    assert got.shape == ref.shape == (2, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_prepare_t2t_int8_bit_for_bit(mode):
    jmodel, variables, tmodel, _ = _models("float32")
    if mode == "dynamic":
        ref, got = jt2t.prepare_t2t_int8(jmodel, variables), tt2t.prepare_t2t_int8(tmodel)
    else:
        scales = _jax_scales()
        ref = jt2t.prepare_t2t_int8_static(jmodel, variables, act_scales=scales)
        got = tt2t.prepare_t2t_int8_static(tmodel, act_scales=scales)
    assert set(got) == set(ref) and ("act_inv" in got) == (mode == "static")
    for k, r in ref.items():
        r = np.asarray(r)
        assert got[k].dtype == quantized_stack_from_jax({k: r})[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), r, err_msg=k)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_fused_t2t_apply_int8_matches_jax_and_oracles(mode):
    """On the same int8 stack: the port's fused int8 path (CPU: the kernels'
    twins) against JAX ``fused_t2t_apply_int8`` (Pallas int8 encoder in
    interpret mode), and against the eager oracles of both packages."""
    jmodel, variables, tmodel, img = _models("float32")
    scales = _jax_scales()
    if mode == "dynamic":
        jsq = jt2t.prepare_t2t_int8(jmodel, variables)
        j_oracle = jq.int8_t2t_apply(jmodel, jq.quantize_vit_params_int8(variables),
                                     jnp.asarray(img))
        t_oracle = tq.int8_t2t_apply(tmodel, tq.quantize_vit_params_int8(tmodel.params()),
                                     torch.from_numpy(img))
    else:
        jsq = jt2t.prepare_t2t_int8_static(jmodel, variables, act_scales=scales)
        j_oracle = jq.int8_t2t_apply_static(
            jmodel, jq.quantize_vit_params_int8_static(variables, scales), jnp.asarray(img))
        t_oracle = tq.int8_t2t_apply_static(
            tmodel, tq.quantize_vit_params_int8_static(tmodel.params(), scales),
            torch.from_numpy(img))
    tsq = quantized_stack_from_jax(jax.tree.map(np.asarray, jsq))
    with torch.no_grad():
        got = tt2t.fused_t2t_apply_int8(tmodel, torch.from_numpy(img), stacked_q=tsq)
    assert got.shape == (2, 10)
    jfused = jt2t.fused_t2t_apply_int8(jmodel, variables, jnp.asarray(img), jsq)
    for ref in (jfused, j_oracle, t_oracle):
        assert _rel(got, ref) <= LOGIT_REL


def test_fused_t2t_apply_int8_defaults_variants_and_plain_flag():
    _, _, tmodel, img = _models("bfloat16")
    x = torch.from_numpy(img[:1])
    with torch.no_grad():
        ref = tt2t.fused_t2t_apply_int8(tmodel, x, stacked_q=tt2t.prepare_t2t_int8(tmodel))
        outs = [tt2t.fused_t2t_apply_int8(tmodel, x)]
        outs += [tt2t.fused_t2t_apply_int8(tmodel, x, variant=v) for v in tt2t.INT8_VARIANTS]
        plain = tt2t.fused_t2t_apply_int8(tmodel, x, plain=True)
    for out in outs:
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    # the twins' performers keep K16's cast points (see the bf16 test above)
    assert _rel(plain, ref) <= LOGIT_REL
    with pytest.raises(ValueError, match="variant"):
        tt2t.fused_t2t_apply_int8(tmodel, x, variant="resident")


@functools.lru_cache(maxsize=None)
def _stems(dtype: str = "float32"):
    """The int8 stem of both packages, calibrated on the same two batches."""
    jmodel, variables, tmodel, _ = _models(dtype)
    return (jt2t.prepare_t2t_stem_int8_static(jmodel, variables, batches=_calib()),
            tt2t.prepare_t2t_stem_int8_static(tmodel, batches=_calib()))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prepare_t2t_stem_int8_static_bit_for_bit(dtype):
    """Calibration on the plain-unfold form through the performers, then the
    per-channel int8 weights with the act scale folded in: equal to JAX's
    bit for bit in bf16, where every calibrated tensor is a bf16 value.  In
    fp32 the performers' sums run in another order, so the stage-3 absmax
    (a performer output) may sit one fp32 spacing apart, and the combined
    scales built on it two; the int8 weights stay equal."""
    ref, got = _stems(dtype)
    assert set(got) == set(ref) == {"kqv1", "kqv2", "project"}
    for key, entry in ref.items():
        assert set(got[key]) == set(entry), key
        for k, r in entry.items():
            r = np.asarray(r)
            assert got[key][k].dtype == quantized_stack_from_jax({k: r})[k].dtype, (key, k)
            if dtype == "bfloat16" or k in ("q", "bias"):
                np.testing.assert_array_equal(got[key][k].numpy(), r, err_msg=f"{key}/{k}")
            else:
                np.testing.assert_allclose(got[key][k].numpy(), r, rtol=2.0 ** -21, atol=0,
                                           err_msg=f"{key}/{k}")


@pytest.mark.parametrize("fast", [True, False])
def test_t2t_tokenize_with_int8_stem_matches_jax(fast):
    """The tokenizer with the static int8 stem, on JAX's stem: the fast form
    (stage-1 kernel, kqv2 and the projection int8) and the plain-unfold
    form (all three int8)."""
    jmodel, variables, tmodel, img = _models("float32")
    jstem, _ = _stems()
    tstem = {k: {n: to_torch(np.asarray(v)) for n, v in e.items()} for k, e in jstem.items()}
    ref = jt2t.t2t_tokenize(jmodel, variables, jnp.asarray(img[:1]), fast=fast, stem_q=jstem)
    with torch.no_grad():
        got = tt2t.t2t_tokenize(tmodel, torch.from_numpy(img[:1]), fast=fast, stem_q=tstem)
        flt = tt2t.t2t_tokenize(tmodel, torch.from_numpy(img[:1]), fast=fast)
    assert _rel(got, ref) <= LOGIT_REL
    assert 0 < _rel(got, flt) <= LOGIT_REL  # int8, and close to the float stem


def test_fused_t2t_apply_int8_with_int8_stem_matches_jax():
    """b1 (the fast form) with the static int8 encoder and the int8 stem."""
    jmodel, variables, tmodel, img = _models("float32")
    scales = _jax_scales()
    jstem, tstem = _stems()
    jsq = jt2t.prepare_t2t_int8_static(jmodel, variables, act_scales=scales)
    ref = jt2t.fused_t2t_apply_int8(jmodel, variables, jnp.asarray(img[:1]), jsq, stem_q=jstem)
    with torch.no_grad():
        got = tt2t.fused_t2t_apply_int8(tmodel, torch.from_numpy(img[:1]),
                                        stacked_q=tt2t.prepare_t2t_int8_static(
                                            tmodel, act_scales=scales), stem_q=tstem)
    assert got.shape == (1, 10)
    assert _rel(got, ref) <= LOGIT_REL


# ---------------------------------------------------------------------------
# Variables, registry, init
# ---------------------------------------------------------------------------


def test_load_jax_variables_round_trips_and_refuses_mismatches():
    variables, _ = _variables()
    tmodel = tt2t.T2TViT(tt2t.t2t_vit_config(7, "reference", **NARROW), device="cpu")
    load_jax_variables(tmodel, variables)
    for coll, tree in (("params", tmodel.params()), ("constants", tmodel.constants())):
        flat_t = jax.tree_util.tree_leaves_with_path(tree)
        flat_j = dict(jax.tree_util.tree_leaves_with_path(variables[coll]))
        assert len(flat_t) == len(flat_j) > 0
        for path, leaf in flat_t:
            np.testing.assert_array_equal(leaf.numpy(), flat_j[path], err_msg=str(path))
    assert tmodel.constants()["tokens_to_token"]["performer2"]["w"].shape == (32, 64)

    def refused(change, exc):
        bad = jax.tree.map(lambda a: a, variables)
        change(bad)
        with pytest.raises(exc):
            load_jax_variables(tt2t.T2TViT(tt2t.t2t_vit_config(7, "reference", **NARROW),
                                             device="cpu"), bad)

    refused(lambda v: v["constants"].pop("pos_embedding"), KeyError)
    refused(lambda v: v["constants"].update(extra=np.zeros(3, np.float32)), KeyError)
    refused(lambda v: v["params"]["head"].pop("bias"), KeyError)
    refused(lambda v: v.pop("constants"), KeyError)
    refused(lambda v: v["constants"].update(pos_embedding=np.zeros((196, 128), np.float32)),
            ValueError)


def test_registry_configs_match_jax():
    for v in (7, 10, 12, 14):
        for style in ("standard", "reference"):
            assert (tt2t.t2t_vit_config(v, style).to_json()
                    == jt2t.t2t_vit_config(v, style).to_json())
    with torch.device("meta"):
        model, shape = registry.build_model("t2t_vit_14", device="meta")
    assert shape == (3, 224, 224)
    cfg = model.config
    assert (cfg.dim, cfg.depth, cfg.heads, cfg.mlp_dim) == (384, 14, 6, 1152)
    assert cfg.reference_residual and cfg.final_norm and not cfg.mlp_head
    assert dtype_name(cfg.dtype) == "float32"
    assert "t2t_vit_7" in registry.available_models()


def test_init_is_seeded_and_performer_w_is_scaled_orthogonal():
    def build(seed):
        return tt2t.T2TViT(tt2t.t2t_vit_config(7, "reference", **NARROW), device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    a, b, c = build(0), build(0), build(1)
    for (_, ta), (_, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        torch.testing.assert_close(ta, tb, rtol=0, atol=0)
    assert not torch.equal(a.block_0.attn.qkv_kernel, c.block_0.attn.qkv_kernel)
    w = a.tokens_to_token.performer1.w
    torch.testing.assert_close(w @ w.T, 32.0 * torch.eye(32), rtol=0, atol=1e-4)
    assert not a.training
    np.testing.assert_array_equal(a.pos_embedding.numpy(), jt2t.sinusoid_encoding(197, 128))
