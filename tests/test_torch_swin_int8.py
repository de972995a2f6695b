"""The port's int8 Swin against the JAX package's on the same params and
images: K9's VMEM gate (which fixes the int8 stages), ``prepare_swin_int8
[_static]`` (bit for bit), ``calibrate_swin`` (absmax and mse),
``smooth_swin``, the int8 stage chain against K9's int8 mode
(``swin_stage_forward_pipelined(int8=True)``, Pallas in interpret mode) and
``fused_swin_apply(int8_prepared=...)`` against the JAX one and against the
port's own float path.  On the CPU every kernel wrapper takes its plain
twin.

Small sizes: image 56, embed 32, depths (2, 2), heads (2, 4) (the JAX
package's own int8 Swin tests), ``min_dim=0`` so both stages qualify."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.models import swin as jswin
from edgevisiontransformer_tpu.ops.pallas import swin_block as jsb
from edgevisiontransformer_tpu_torch.models import swin as tswin
from edgevisiontransformer_tpu_torch.ops.cuda import swin_block as tsb
from edgevisiontransformer_tpu_torch.ops.quant import MSE_CLIP_RATIOS, representative_batches
from edgevisiontransformer_tpu_torch.utils.jax_bridge import (flatten_tree, load_jax_variables,
                                                              swin_int8_from_jax, to_torch)

torch.set_num_threads(1)

CFG = dict(image_size=56, embed_dim=32, depths=(2, 2), num_heads=(2, 4), num_classes=11)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
EPS = 1e-5
# fp32 stage outputs: an fp32-ulp difference before a rounding to int8 (LN
# and softmax sums in another order) moves a value into the next bucket,
# which the next matmul spreads; the JAX package holds two of its own int8
# forms that differ by ulps to this bound (tests/test_pallas_kernels.py:326-330)
FP32_QUANT_NOISE = dict(rtol=0.03, atol=0.06)
# bf16 stage outputs: the bf16 encoder bound, 3% of the largest magnitude,
# the typical element within 2^-7
BF16_MAX, BF16_MEDIAN = 0.03, 2.0 ** -7
# logits: the largest deviation within 5% of the largest logit, as for DeiT int8
LOGIT_REL = 0.05
# int8 against the float path: the JAX package's own bounds
# (tests/test_swin.py:340, :369)
VS_FLOAT = {"dynamic": dict(rtol=0.1, atol=0.15), "static": dict(rtol=0.1, atol=0.2)}


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _setup(dtype: str):
    """Both models on the same variables (1-d params and bias tables
    perturbed), two images and two calibration batches."""
    jd, td = DTYPES[dtype]
    jmodel = jswin.SwinTransformer(jswin.swin_config("tiny", dtype=jd, **CFG))
    v = jax.jit(jmodel.init)(jax.random.key(1), jnp.ones((1, 3, 56, 56)))
    rng = np.random.default_rng(5)

    def perturb(path, a):
        a = np.asarray(a)
        if a.ndim == 1:
            return a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if "relative_position_bias_table" in jax.tree_util.keystr(path):
            return a + 0.5 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    variables = {"params": jax.tree_util.tree_map_with_path(perturb, v["params"]),
                 "constants": jax.tree.map(np.asarray, v["constants"])}
    tmodel = tswin.SwinTransformer(tswin.swin_config("tiny", dtype=td, **CFG), device="cpu")
    load_jax_variables(tmodel, variables)
    img = rng.standard_normal((2, 3, 56, 56)).astype(np.float32)
    batches = tuple(representative_batches(n=2, shape=(3, 56, 56)))
    return jmodel, variables, tmodel, img, batches


@functools.lru_cache(maxsize=None)
def _jax_int8(dtype: str, mode: str, method: str = "absmax"):
    jmodel, variables, _, _, batches = _setup(dtype)
    if mode == "dynamic":
        q = jswin.prepare_swin_int8(jmodel, variables, min_dim=0)
    else:
        q = jswin.prepare_swin_int8_static(jmodel, variables, batches=list(batches), min_dim=0,
                                           method=method)
    return jax.tree.map(np.asarray, q)


@functools.lru_cache(maxsize=None)
def _jax_scales(dtype: str, method: str):
    jmodel, variables, _, _, batches = _setup(dtype)
    return jswin.calibrate_swin(jmodel, variables, batches=list(batches), method=method)


def _port_int8(dtype: str, mode: str, method: str = "absmax"):
    _, _, tmodel, _, batches = _setup(dtype)
    if mode == "dynamic":
        return tswin.prepare_swin_int8(tmodel, min_dim=0)
    return tswin.prepare_swin_int8_static(tmodel, batches=batches, min_dim=0, method=method)


def _assert_stacks_equal(got: dict, ref_np: dict):
    ref = swin_int8_from_jax(ref_np)
    assert list(got) == list(ref)
    for si in ref:
        assert set(got[si]) == set(ref[si])
        for k, r in ref[si].items():
            g = got[si][k]
            assert g.shape == r.shape and g.dtype == r.dtype, (si, k, g.shape, r.shape)
            assert torch.equal(g, r), (si, k)


# ---------------------------------------------------------------------------
# K9's gate: which stages are int8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,hidden,depth,nwin,n_pad,heads", [
    (96, 384, 2, 64, 56, 3),      # swin_tiny stage 0: R = 3584, the banded permutation
    (192, 768, 2, 16, 56, 6),     # stage 1: R = 896, the full permutation
    (384, 1536, 6, 4, 56, 12),    # stage 2
    (768, 3072, 2, 1, 56, 24),    # stage 3: one window
    (384, 1536, 18, 4, 56, 12),   # swin_small / base stage 2
    (1024, 4096, 2, 1, 56, 32),   # swin_base stage 3
    (128, 512, 2, 16, 64, 4),     # R = 1024: at the banded threshold
    (128, 512, 2, 16, 72, 4),     # R = 1152: past it
    (64, 256, 3, 4, 56, 2),       # odd depth, shifted: refused
    (64, 256, 9, 1, 56, 2),       # odd depth above 8, one window: refused
    (64, 256, 7, 1, 56, 2),       # odd depth up to 8, one window
    (2048, 8192, 2, 1, 56, 8),    # too large for the VMEM cap
])
def test_stage_gate_matches_jax(c, hidden, depth, nwin, n_pad, heads):
    for itemsize in (1, 2, 4):
        for act in (None, 2, 4):
            kw = dict(nwin=nwin, n_pad=n_pad, heads=heads, act_itemsize=act)
            assert (tsb.swin_stage_pipelined_fits(c, hidden, depth, itemsize, **kw)
                    == jsb.swin_stage_pipelined_fits(c, hidden, depth, itemsize, **kw))
            kw["act_itemsize"] = act or 2
            assert (tsb.swin_stage_resident_bytes(c, hidden, itemsize, **kw)
                    == jsb.swin_stage_resident_bytes(c, hidden, itemsize, **kw))


def test_swin_tiny_int8_stages_match_jax():
    """At swin_tiny's widths the JAX default (min_dim 128) makes stages 1-3
    int8; the port picks the same from its own geometry and gate."""
    jcfg, tcfg = jswin.swin_config("tiny", dtype=jnp.bfloat16), tswin.swin_config("tiny")
    with torch.device("meta"):
        tmodel = tswin.SwinTransformer(tcfg, device="meta")
    jparams = jax.eval_shape(lambda: jswin.SwinTransformer(jcfg).init(
        jax.random.key(0), jnp.ones((1, 3, 224, 224))))["params"]

    def jax_stages():
        return [g.si for g in jswin._stage_geometry(jcfg, jparams) if g.dim >= 128 and g.nwin >= 1
                and jsb.swin_stage_pipelined_fits(g.dim, g.hidden, g.depth, 1, nwin=g.nwin,
                                                  n_pad=g.n_pad, heads=g.heads, act_itemsize=2)]

    port = [g.si for g in tswin._stage_geometry(tcfg, tmodel.params())
            if g.dim >= 128 and tswin._int8_stage_fits(g, torch.bfloat16)]
    assert port == jax_stages() == [1, 2, 3]


# ---------------------------------------------------------------------------
# prepare_swin_int8[_static], calibrate_swin, smooth_swin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("min_dim", [0, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prepare_swin_int8_matches_jax_bit_for_bit(dtype, min_dim):
    """Same stages, and every int8 weight, scale, bias and affine equal."""
    jmodel, variables, tmodel, _, _ = _setup(dtype)
    ref = (_jax_int8(dtype, "dynamic") if min_dim == 0
           else jax.tree.map(np.asarray, jswin.prepare_swin_int8(jmodel, variables,
                                                                 min_dim=min_dim)))
    got = tswin.prepare_swin_int8(tmodel, min_dim=min_dim)
    assert list(got) == {0: [0, 1], 64: [1], 128: []}[min_dim]
    _assert_stacks_equal(got, ref)
    for stack in got.values():
        assert stack["qkv_w"].dtype == torch.int8 and stack["qkv_s"].dtype == torch.float32
        assert stack["qkv_b"].dtype == DTYPES[dtype][1]  # biases in the compute dtype


@pytest.mark.parametrize("method", ["absmax", "mse"])
def test_calibrate_swin_matches_jax(method):
    _, _, tmodel, _, batches = _setup("float32")
    ref = _jax_scales("float32", method)
    got = tswin.calibrate_swin(tmodel, batches=batches, method=method)
    assert list(got) == list(ref) == [0, 1]
    for si in ref:
        assert got[si].shape == (2, 4) and got[si].dtype == np.float32
        np.testing.assert_allclose(got[si], np.asarray(ref[si]), rtol=1e-5, atol=0)
    if method == "mse":
        # the same clip ratio per tensor, and some tensor really clipped
        absmax = tswin.calibrate_swin(tmodel, batches=batches)
        ratio_t = np.concatenate([(got[si] / absmax[si]).ravel() for si in got])
        jabs = _jax_scales("float32", "absmax")
        ratio_j = np.concatenate([(np.asarray(ref[si]) / np.asarray(jabs[si])).ravel()
                                  for si in ref])
        pick = lambda r: np.abs(r[:, None] - np.asarray(MSE_CLIP_RATIOS)[None]).argmin(1)  # noqa
        np.testing.assert_array_equal(pick(ratio_t), pick(ratio_j))
        assert (ratio_t < 1 - 1e-6).any()


@pytest.mark.parametrize("method", ["absmax", "mse"])
def test_prepare_swin_int8_static_matches_jax_bit_for_bit(method, monkeypatch):
    """Both fold the same scales (the JAX package's calibration): stacks,
    folded scales and ``act_inv`` bit for bit."""
    _, _, tmodel, _, batches = _setup("float32")
    scales = _jax_scales("float32", method)
    monkeypatch.setattr(tswin, "calibrate_swin",
                        lambda *a, **k: {si: np.asarray(s) for si, s in scales.items()})
    got = tswin.prepare_swin_int8_static(tmodel, batches=batches, min_dim=0, method=method)
    ref = _jax_int8("float32", "static", method)
    _assert_stacks_equal(got, ref)
    assert all(s["act_inv"].shape == (2, 4) for s in got.values())


def test_prepare_swin_int8_static_own_calibration_and_empty_selection(monkeypatch):
    """With its own calibration the static stack's int8 weights equal the
    JAX one's and its scales agree to calibration noise; with no stage
    qualifying it returns ``{}`` before calibrating."""
    _, _, tmodel, _, batches = _setup("float32")
    got = tswin.prepare_swin_int8_static(tmodel, batches=batches, min_dim=0)
    ref = swin_int8_from_jax(_jax_int8("float32", "static"))
    for si in ref:
        for k, r in ref[si].items():
            if k.endswith(("_s", "act_inv")):
                np.testing.assert_allclose(_f32(got[si][k]), _f32(r), rtol=1e-5)
            else:
                assert torch.equal(got[si][k], r), (si, k)

    def refuse(*a, **k):
        raise AssertionError("calibrated although no stage qualifies")

    monkeypatch.setattr(tswin, "calibrate_swin", refuse)
    assert tswin.prepare_swin_int8_static(tmodel, batches=batches) == {}


def test_smooth_swin_matches_jax_and_keeps_the_forward():
    jmodel, variables, tmodel, img, _ = _setup("float32")
    ref = jswin.smooth_swin(jmodel, variables, batches=[img], alpha=0.5)
    got = tswin.smooth_swin(tmodel, batches=[img], alpha=0.5)
    flat_j = flatten_tree(jax.tree.map(np.asarray, ref["params"]))
    flat_t = flatten_tree(got)
    assert set(flat_j) == set(flat_t)
    # rtol 1e-6; the qkv kernel is scaled twice (rows by s, v columns by
    # 1/s), each s from channel maxima that the two forwards sum in another
    # order, so a few of its elements part by 1.02e-6: atol 1e-7 covers them
    for k, r in flat_j.items():
        np.testing.assert_allclose(_f32(flat_t[k]), r, rtol=1e-6, atol=1e-7, err_msg=k)
    blk, blk0 = got["stage_0_block_0"], tmodel.params()["stage_0_block_0"]
    assert (blk["ln1_scale"] - blk0["ln1_scale"]).abs().max() > 1e-6
    assert (blk["attn"]["proj"]["kernel"] - blk0["attn"]["proj"]["kernel"]).abs().max() > 1e-6
    # an exact reparameterisation: the float forward stays (the JAX package's
    # own bound, tests/test_swin.py:506)
    x = torch.from_numpy(img)
    with torch.no_grad():
        y0 = tmodel(x)
        y1 = torch.func.functional_call(tmodel, flatten_tree(got), (x,))
    np.testing.assert_allclose(_f32(y1), _f32(y0), atol=5e-4, rtol=0)


def test_collector_sees_every_matmul_input_and_leaves_the_forward_unchanged():
    _, _, tmodel, img, _ = _setup("float32")
    seen = {}

    def collect(block, key, a):
        seen[block, key] = tuple(a.shape)

    x = torch.from_numpy(img)
    with torch.no_grad():
        plain, collected = tmodel(x), tmodel(x, collect=collect)
    assert torch.equal(plain, collected)
    assert seen == {("stage_0_block_0", "qkv_in"): (8, 49, 32),
                    ("stage_0_block_0", "proj_in"): (8, 49, 32),
                    ("stage_0_block_0", "fc1_in"): (2, 196, 32),
                    ("stage_0_block_0", "fc2_in"): (2, 196, 128),
                    **{(f"stage_{si}_block_{bi}", k): s for si, bi in ((0, 1), (1, 0), (1, 1))
                       for k, s in (("qkv_in", (8 >> 2 * si, 49, 32 << si)),
                                    ("proj_in", (8 >> 2 * si, 49, 32 << si)),
                                    ("fc1_in", (2, 196 >> 2 * si, 32 << si)),
                                    ("fc2_in", (2, 196 >> 2 * si, 128 << si)))}}


# ---------------------------------------------------------------------------
# The int8 stage chain against K9's int8 mode
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_prepared(dtype: str):
    jmodel, variables, _, _, _ = _setup(dtype)
    return jswin.prepare_swin_fused(jmodel, variables)


@pytest.mark.parametrize("si", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_int8_stage_chain_matches_jax_stage_kernel(mode, dtype, si):
    """One stage of the model, port twin chain against the JAX kernel on
    the same int8 stack and input: stage 0 (res 14, four windows, the
    shifted block) and stage 1 (one window)."""
    jd, td = DTYPES[dtype]
    jmodel, variables, tmodel, _, _ = _setup(dtype)
    g = list(jswin._stage_geometry(jmodel.config, variables["params"]))[si]
    stack_np = _jax_int8(dtype, mode)[si]
    jprep = _jax_prepared(dtype)
    x = np.random.default_rng(si).standard_normal((2, g.res, g.res, g.dim)).astype(np.float32)
    mask = jswin.shifted_window_mask(g.res, g.res, g.w, g.w // 2) if g.nwin > 1 else None
    xw = jswin.window_partition(jnp.asarray(x).astype(jd), g.w)
    out = jsb.swin_stage_forward_pipelined(
        xw, jax.tree.map(jnp.asarray, stack_np),
        jnp.stack([jprep[f"{si}_{bi}"] for bi in range(g.depth)]), heads=g.heads,
        head_dim=g.dim // g.heads, eps=EPS, nwin=g.nwin, res=g.res, window=g.w,
        mask=None if mask is None else jnp.asarray(mask), int8=True)
    ref = _f32(jswin.window_reverse(out, g.w, g.res, g.res))

    stage = tswin.prepare_swin_fused(tmodel)["stages"][si]
    stack = {**swin_int8_from_jax({si: stack_np})[si], "bias": stage["bias"],
             "mask": stage["mask"]}
    got = tsb.swin_stage_forward_int8_plain(to_torch(x).to(td).reshape(-1, g.dim), stack,
                                            res=g.res, window=g.w, heads=g.heads,
                                            head_dim=g.dim // g.heads, eps=EPS)
    assert got.dtype == td
    got = _f32(got).reshape(ref.shape)
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, **FP32_QUANT_NOISE)
    else:
        err = np.abs(got - ref)
        assert err.max() <= BF16_MAX * np.abs(ref).max(), (err.max(), np.abs(ref).max())
        assert np.median(err) <= BF16_MEDIAN * np.median(np.abs(ref)), np.median(err)


def test_int8_stage_forward_takes_the_twins_on_the_cpu():
    _, _, tmodel, _, _ = _setup("bfloat16")
    stage = tswin.prepare_swin_fused(tmodel)["stages"][0]
    stack = {**tswin.prepare_swin_int8(tmodel, min_dim=0)[0], "bias": stage["bias"],
             "mask": stage["mask"]}
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2 * 196, 32))).bfloat16()
    kw = dict(res=14, window=7, heads=2, head_dim=16, eps=EPS)
    from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as tfe

    tfe.reset_launches()
    tsb.reset_launches()
    got = tsb.swin_stage_forward_int8(x, stack, **kw)
    assert torch.equal(got, tsb.swin_stage_forward_int8_plain(x, stack, **kw))
    assert sum(tfe.LAUNCHES.values()) == 0 and tsb.LAUNCHES == {"window_attention": 0}


# ---------------------------------------------------------------------------
# fused_swin_apply(int8_prepared=...)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_fused_swin_apply_int8_matches_jax(mode, dtype):
    jmodel, variables, tmodel, img, _ = _setup(dtype)
    ref = _f32(jswin.fused_swin_apply(jmodel, variables, jnp.asarray(img),
                                      prepared=_jax_prepared(dtype),
                                      int8_prepared=jax.tree.map(jnp.asarray,
                                                                 _jax_int8(dtype, mode))))
    with torch.no_grad():
        got = tswin.fused_swin_apply(tmodel, torch.from_numpy(img),
                                     int8_prepared=_port_int8(dtype, mode))
    assert got.dtype == DTYPES[dtype][1] and got.shape == (2, 11)
    got = _f32(got)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= LOGIT_REL * np.abs(ref).max()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("mode,method", [("dynamic", None), ("static", "absmax"),
                                         ("static", "mse")])
def test_fused_swin_apply_int8_tracks_the_float_path(mode, method):
    """Quantized (not equal to the float logits) within the JAX package's
    int8-against-float bounds, with the same argmax; ``plain=True`` and the
    prepared constants give the same result on the CPU."""
    _, _, tmodel, img, _ = _setup("float32")
    x = torch.from_numpy(img)
    q = _port_int8("float32", mode, method or "absmax")
    with torch.no_grad():
        prep = tswin.prepare_swin_fused(tmodel)
        y_float = _f32(tswin.fused_swin_apply(tmodel, x, prepared=prep))
        y_int8 = tswin.fused_swin_apply(tmodel, x, prepared=prep, int8_prepared=q)
        y_plain = tswin.fused_swin_apply(tmodel, x, int8_prepared=q, plain=True)
    assert torch.equal(y_int8, y_plain)
    y_int8 = _f32(y_int8)
    assert not np.allclose(y_int8, y_float)
    np.testing.assert_allclose(y_int8, y_float, **VS_FLOAT[mode])
    np.testing.assert_array_equal(y_int8.argmax(-1), y_float.argmax(-1))


def test_every_prepared_stage_dispatches_int8(monkeypatch):
    """Window 4 at image 128: resolutions 32, 16, 8, 4, windows 64, 16, 4,
    1; every stage ``prepare_swin_int8`` emits runs the int8 chain, and an
    empty stack runs the float path unchanged."""
    cfg = tswin.swin_config("tiny", image_size=128, window_size=4, embed_dim=32,
                            depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4), num_classes=5)
    model = tswin.SwinTransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    geoms = list(tswin._stage_geometry(cfg, model.params()))
    assert [(g.res, g.w, g.nwin) for g in geoms] == [(32, 4, 64), (16, 4, 16), (8, 4, 4),
                                                     (4, 4, 1)]
    q = tswin.prepare_swin_int8(model, min_dim=0)
    assert list(q) == [0, 1, 2, 3]
    calls = []
    orig = tsb.swin_stage_forward_int8

    def spy(x, stage, **kw):
        calls.append(kw["res"])
        return orig(x, stage, **kw)

    monkeypatch.setattr(tsb, "swin_stage_forward_int8", spy)
    x = torch.ones(1, 3, 128, 128)
    with torch.no_grad():
        y = tswin.fused_swin_apply(model, x, int8_prepared=q)
        assert torch.equal(tswin.fused_swin_apply(model, x, int8_prepared={}),
                           tswin.fused_swin_apply(model, x))
    assert torch.isfinite(y).all() and calls == [32, 16, 8, 4]


def test_a_stage_the_gate_refuses_runs_the_float_path():
    """As in JAX ``fused_swin_apply``: a stack for a stage K9's gate refuses
    at int8 weights (odd depth with several windows) is not used."""
    cfg = tswin.swin_config("tiny", **{**CFG, "depths": (3, 2)})
    model = tswin.SwinTransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert list(tswin.prepare_swin_int8(model, min_dim=0)) == [1]
    from edgevisiontransformer_tpu_torch.ops.cuda.fused_encoder import quantize_stacked_int8

    stack0 = quantize_stacked_int8(tswin._stack_stage_params(model.params(), 0, 3, 32,
                                                             torch.float32),
                                   keys=tsb.MATMUL_KEYS)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 3, 56, 56))).float()
    with torch.no_grad():
        assert torch.equal(tswin.fused_swin_apply(model, x, int8_prepared={0: stack0}),
                           tswin.fused_swin_apply(model, x))
