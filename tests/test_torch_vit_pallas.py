"""The ViT module's ``kernel_mode="pallas"`` path and the pruned DeiT models
of the port against the JAX package, on the CPU (the port's wrappers take
their plain twins; the JAX side runs its Pallas kernels in interpret mode,
as its own tests do):

- the ``sdpa`` twin (K13), ``attention``, the ``mlp`` twin (K14) and
  ``layer_norm`` (K15) against the JAX kernels;
- the ViT module with ``kernel_mode="pallas"`` against JAX's;
- ``pruned_vit_config`` / ``build_model("pruned_deit_...")`` shapes;
- segmented and packed ``fused_vit_apply`` and segmented
  ``fused_vit_apply_int8`` (dynamic and static) against JAX, with the
  pruned int8 stacks bit-identical.

Inputs come from a numpy seed; parameters reach the port through
``utils/jax_bridge``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu import config as jconfig
from edgevisiontransformer_tpu.models import registry as jregistry
from edgevisiontransformer_tpu.models import vit as jvit
from edgevisiontransformer_tpu.ops import quant as jq
from edgevisiontransformer_tpu.ops.pallas import fused_attention as jfa
from edgevisiontransformer_tpu.ops.pallas import fused_mlp as jfm
from edgevisiontransformer_tpu.ops.pallas import layernorm as jln
from edgevisiontransformer_tpu_torch import config as tconfig
from edgevisiontransformer_tpu_torch.models import registry, t2t_vit as tt2t, vit as tvit
from edgevisiontransformer_tpu_torch.ops.cuda import fused_attention as tfa
from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as tfe
from edgevisiontransformer_tpu_torch.ops.cuda import fused_mlp as tfm
from edgevisiontransformer_tpu_torch.ops.cuda import layernorm as tln
from edgevisiontransformer_tpu_torch.utils.jax_bridge import (load_jax_params,
                                                              quantized_stack_from_jax)

torch.set_num_threads(1)

# fp32: the bounds of the JAX package's own kernel tests
# (tests/test_pallas_kernels.py: sdpa, mlp and layer_norm 1e-5, attention and
# the module 1e-4; the fused encoder against XLA rtol 1e-4, atol 5e-4)
FP32 = dict(rtol=1e-5, atol=1e-5)
FP32_BLOCK = dict(rtol=1e-4, atol=1e-4)
FP32_FUSED = dict(rtol=1e-4, atol=5e-4)
# bf16: both sides compute the scores, sums and products in fp32 and round
# at the same points, so they part only where fp32 summation order (or, in
# the MLP, erff against the JAX kernel's erf_poly, within 7.2e-7) moves a
# value across a bf16 rounding boundary: one spacing of the output, or of p
# before PV.  Bound: 2 spacings of the largest output, 2^-7 * max|ref|.
BF16_SPACINGS = 2.0 ** -7
# the int8 bounds of tests/test_torch_int8.py: fp32 logits at the JAX int8
# tests' 2e-3 (narrow widths); bf16 logits at 5% of max|logit|
INT8_FP32 = dict(rtol=2e-3, atol=2e-3)
LOGIT_REL = 0.05

NARROW = dict(image_size=32, patch_size=16, dim=64, depth=2, heads=2, mlp_dim=128,
              num_classes=10)
# tests/test_pallas_kernels.py:183-198 and :212-230: 12 layers at dim 64,
# head_dim 16 (the twins here; the card takes 16 too)
SEGMENTED = "layerwise_" + "_".join(["h2-d0.5"] * 6 + ["h3-d1.0"] * 6)
# the same two segments, two layers each: the int8 comparison, at the JAX
# int8 tests' narrow widths and a depth where their bound holds
SEGMENTED_4 = "layerwise_" + "_".join(["h2-d0.5"] * 2 + ["h3-d1.0"] * 2)
ALTERNATING = "layerwise_" + "_".join(["h2-d0.5", "h1-d0.3"] * 6)
LAYERWISE_KW = dict(image_size=32, patch_size=16, dim=64, mlp_dim=64, num_classes=10)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_pair(a: np.ndarray):
    """One bf16 array for each side, equal bit for bit."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).bfloat16()


def _check_bf16(got, ref, spacings=BF16_SPACINGS):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= spacings * scale, (err, scale)


# ---------------------------------------------------------------------------
# K13 sdpa, attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,n,d", [(1, 3, 197, 64), (2, 2, 50, 32)])
def test_sdpa_twin_matches_jax_kernel(b, h, n, d, dtype):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
    if dtype == "float32":
        ref = jfa.sdpa(q, k, v)
        got = tfa.sdpa(*map(torch.from_numpy, (q, k, v)))
        np.testing.assert_allclose(_np(got), _np(ref), **FP32)
    else:
        (jq_, tq), (jk, tk), (jv, tv) = map(_bf16_pair, (q, k, v))
        got = tfa.sdpa(tq, tk, tv)
        assert got.dtype == torch.bfloat16
        _check_bf16(got, jfa.sdpa(jq_, jk, jv))


def test_sdpa_writes_into_out_and_launches_nothing_on_the_cpu():
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal((2, 50, 3 * 2 * 32)).astype(np.float32))
    q, k, v = qkv.view(2, 50, 3, 2, 32).permute(2, 0, 3, 1, 4)
    merged = torch.empty(2, 50, 64)
    tfa.reset_launches()
    got = tfa.sdpa(q, k, v, out=merged.view(2, 50, 2, 32).transpose(1, 2))
    assert tfa.LAUNCHES["sdpa"] == 0
    torch.testing.assert_close(merged, tfa.sdpa_plain(q, k, v).transpose(1, 2).reshape(2, 50, 64),
                               rtol=0, atol=0)
    assert got.data_ptr() == merged.data_ptr()


def test_attention_matches_jax_attention():
    """tests/test_pallas_kernels.py:28-38, fp32 rtol 1e-4."""
    b, n, dim, h, d = 2, 197, 192, 3, 64
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, n, dim)).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.05).astype(np.float32)
          for s in ((dim, 3 * h * d), (3 * h * d,), (h * d, dim), (dim,))]
    ref = jfa.attention(x, *ws, h, d)
    got = tfa.attention(torch.from_numpy(x), *map(torch.from_numpy, ws), h, d)
    np.testing.assert_allclose(_np(got), _np(ref), **FP32_BLOCK)


# ---------------------------------------------------------------------------
# K14 mlp, K15 layer_norm
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _mlp_inputs(rows, dim, hidden):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, rows, dim)).astype(np.float32)
    ws = tuple((rng.standard_normal(s) * 0.05).astype(np.float32)
               for s in ((dim, hidden), (hidden,), (hidden, dim), (dim,)))
    return x, ws


@pytest.mark.parametrize("approx", [True, False])
@pytest.mark.parametrize("rows,dim,hidden", [(197, 192, 768), (64, 128, 256), (197, 192, 230),
                                             (20, 1280, 5120), (20, 1536, 256),
                                             (20, 2048, 128)])
def test_mlp_twin_matches_jax_kernel(rows, dim, hidden, approx):
    """fp32 at 1e-5 (erff against erf_poly stays far inside it); hidden 230
    is a pruned ffn0.3 width; dim 1280 is ViT-H/14's (hidden 5120), 2048 the
    card kernel's widest."""
    x, ws = _mlp_inputs(rows, dim, hidden)
    ref = jfm.mlp(x, *ws, approx_gelu=approx)
    got = tfm.mlp(torch.from_numpy(x), *map(torch.from_numpy, ws), approx_gelu=approx)
    np.testing.assert_allclose(_np(got), _np(ref), **FP32)


@pytest.mark.parametrize("approx", [True, False])
def test_mlp_twin_matches_jax_kernel_bf16(approx):
    x, ws = _mlp_inputs(197, 192, 230)
    (jx, tx), *pairs = map(_bf16_pair, (x,) + ws)
    ref = jfm.mlp(jx, *(p[0] for p in pairs), approx_gelu=approx)
    got = tfm.mlp(tx, *(p[1] for p in pairs), approx_gelu=approx)
    assert got.dtype == torch.bfloat16
    _check_bf16(got, ref)


@pytest.mark.parametrize("rows,dim", [(197, 192), (50, 64)])
def test_layer_norm_matches_jax_kernel(rows, dim):
    """tests/test_pallas_kernels.py:55-63: K15 against ``layer_norm`` on
    ``ln_rows``' twin, which the card launches once."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, rows, dim)) * 3.0).astype(np.float32)
    g = (rng.standard_normal(dim) + 1.0).astype(np.float32)
    b = rng.standard_normal(dim).astype(np.float32)
    ref = jln.layer_norm(x, g, b, 1e-5)
    tfe.reset_launches()
    got = tln.layer_norm(*map(torch.from_numpy, (x, g, b)), 1e-5)
    assert sum(tfe.LAUNCHES.values()) == 0 and got.shape == x.shape
    np.testing.assert_allclose(_np(got), _np(ref), **FP32)
    torch.testing.assert_close(got, tln.layer_norm_plain(*map(torch.from_numpy, (x, g, b)), 1e-5),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The module with kernel_mode="pallas"
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _vit_pair(dtype: str, style: str = "standard", name: str = "deit_tiny", **overrides):
    """The JAX and the port's ViT with ``kernel_mode="pallas"`` on the same
    (perturbed) params, and an image batch."""
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = dict(style=style, dtype=jd, kernel_mode="pallas", **overrides)
    jmodel, shape = jregistry.build_model(name, **kw)
    rng = np.random.default_rng(5)
    params = jmodel.init(jax.random.key(0), jnp.ones((1, *shape)))["params"]
    params = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
                          if a.ndim == 1 else a, params)
    tmodel, _ = registry.build_model(name, device="cpu", **{**kw, "dtype": td})
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    img = rng.standard_normal((2, *shape)).astype(np.float32)
    return jmodel, {"params": params}, tmodel, img


@pytest.mark.parametrize("style,dtype", [("standard", "float32"), ("standard", "bfloat16"),
                                         ("reference", "float32")])
def test_vit_module_pallas_kernel_mode_matches_jax(style, dtype):
    """tests/test_pallas_kernels.py:66-79's config: fp32 rtol 1e-4; bf16
    logits within 5% of max|logit| (single-spacing flips compound over the
    layers and the head)."""
    jmodel, variables, tmodel, img = _vit_pair(dtype, style, **NARROW)
    assert tmodel.config.kernel_mode == "pallas"
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    tfa.reset_launches()
    tfm.reset_launches()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img))
    assert tfa.LAUNCHES["sdpa"] == tfm.LAUNCHES["mlp"] == 0  # the twins, on the CPU
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(ref), **FP32_BLOCK)
    else:
        _check_bf16(got, ref, spacings=LOGIT_REL)


def test_vit_module_pallas_kernel_mode_pruned_layerwise_matches_jax():
    """Per-layer heads (2, 1) and widths (hidden 76 and 128) on the module
    path."""
    jmodel, variables, tmodel, img = _vit_pair(
        "float32", name="pruned_deit_tiny@layerwise_h2-d0.6_h1-d1.0", head_dim=32, **NARROW)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img))
    np.testing.assert_allclose(_np(got), _np(ref), **FP32_BLOCK)


def test_vit_module_other_kernel_modes_run_the_plain_path():
    """As in JAX, any kernel_mode but "pallas" is the XLA path, and
    act="relu" keeps the plain MLP under "pallas"."""
    _, _, tmodel, img = _vit_pair("float32", **NARROW)
    x = torch.from_numpy(img)
    with torch.no_grad():
        ref = tvit.ViT(tmodel.config.replace(kernel_mode="xla"), device="cpu")
        ref.load_state_dict(tmodel.state_dict())
        want = ref(x)
        for mode in ("fused", "int8"):
            other = tvit.ViT(tmodel.config.replace(kernel_mode=mode), device="cpu")
            other.load_state_dict(tmodel.state_dict())
            torch.testing.assert_close(other(x), want, rtol=0, atol=0)
    relu = tmodel.config.replace(act="relu")
    calls = []
    orig = tfm.mlp
    tfm.mlp = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        with torch.no_grad():
            tvit.ViT(relu, device="cpu")(x)
            tvit.ViT(tmodel.config, device="cpu")(x)
    finally:
        tfm.mlp = orig
    assert len(calls) == tmodel.config.depth


def test_t2t_module_pallas_kernel_mode_matches_its_xla_mode():
    """T2T-ViT shares the encoder block, so kernel_mode="pallas" reaches
    its encoder too: the same params through both modes (t2t_vit_7 cut to
    two layers; the XLA mode is held to JAX in test_torch_t2t.py)."""
    cfg = tt2t.t2t_vit_config(7, depth=2, kernel_mode="pallas")
    model = tt2t.T2TViT(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    xla = tt2t.T2TViT(cfg.replace(kernel_mode="xla"), device="cpu")
    xla.load_state_dict(model.state_dict())
    img = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 3, 224, 224))
                           .astype(np.float32))
    calls = []
    orig = tfa.sdpa
    tfa.sdpa = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        with torch.no_grad():
            got, ref = model(img), xla(img)
    finally:
        tfa.sdpa = orig
    assert len(calls) == cfg.depth
    np.testing.assert_allclose(_np(got), _np(ref), **FP32_BLOCK)


# ---------------------------------------------------------------------------
# Pruned configs and the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,enc", [
    ("tiny", "all_head1_ffn0.3"), ("tiny", "all_head2_ffn0.7"), ("small", "all_head3_ffn0.3"),
    ("base", "all_head12_ffn1.0"), ("tiny", "layerwise_" + "_".join(
        ["h1-d0.3"] * 6 + ["h2-d0.5"] * 6))])
def test_pruned_configs_and_registry_shapes_match_jax(size, enc):
    for style in ("standard", "reference"):
        assert (tvit.pruned_vit_config(size, enc, style=style).to_json()
                == jvit.pruned_vit_config(size, enc, style=style).to_json())
    assert tconfig.decode_prune_encoding(enc, 12, 768) == jconfig.decode_prune_encoding(
        enc, 12, 768)
    name = f"pruned_deit_{size}@{enc}"
    jmodel, jshape = jregistry.build_model(name)
    tmodel, tshape = registry.build_model(name, device="meta")
    assert tshape == jshape and tmodel.config.to_json() == jmodel.config.to_json()
    jparams = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.ones((1, *jshape)))["params"]
    want = {k: tuple(v.shape) for k, v in _flat(jparams).items()}
    assert {k: tuple(v.shape) for k, v in tmodel.named_parameters()} == want


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def test_registry_pruned_default_encoding_is_unpruned():
    m, _ = registry.build_model("pruned_deit_tiny", device="meta")
    assert m.config.heads_per_layer == (12,) * 12 and m.config.mlp_dim_per_layer == (768,) * 12
    assert m.config.resolved_head_dim == 64


# ---------------------------------------------------------------------------
# Segmented and packed fused_vit_apply, segmented fused_vit_apply_int8
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pruned_pair(enc: str, dtype: str = "float32", head_dim: int = 16, **overrides):
    """tests/test_pallas_kernels.py's layerwise models (12 layers at dim 64,
    head_dim 16, mlp 64): JAX and port on the same params, and images."""
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = {**LAYERWISE_KW, **overrides}
    jcfg = jvit.pruned_vit_config("tiny", enc, head_dim=head_dim, dtype=jd, **kw)
    jmodel = jvit.ViT(jcfg)
    rng = np.random.default_rng(7)
    img = rng.standard_normal((2, 3, kw["image_size"], kw["image_size"])).astype(np.float32)
    params = jmodel.init(jax.random.key(0), jnp.asarray(img))["params"]
    params = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
                          if a.ndim == 1 else a, params)
    tmodel = tvit.get_pruned_vit(size="tiny", prune_encoding=enc, head_dim=head_dim, dtype=td,
                                 device="cpu", **kw)
    assert tmodel.config.to_json() == jcfg.to_json()
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    return jmodel, {"params": params}, tmodel, img


def test_segmented_fused_vit_apply_matches_jax():
    """tests/test_pallas_kernels.py:183-198: two segments (h2 mlp 32, h3
    mlp 64), one chain each, against ``model.apply`` (which that test holds
    JAX's segmented path to at this bound) and packed; two layers of each
    segment against JAX's segmented ``fused_vit_apply`` itself."""
    jmodel4, variables4, tmodel4, img4 = _pruned_pair(SEGMENTED_4, depth=4)
    ref4 = jax.jit(functools.partial(jvit.fused_vit_apply, jmodel4))(variables4,
                                                                      jnp.asarray(img4))
    with torch.no_grad():
        got4 = tvit.fused_vit_apply(tmodel4, torch.from_numpy(img4))
    np.testing.assert_allclose(_np(got4), _np(ref4), **FP32_FUSED)
    jmodel, variables, tmodel, img = _pruned_pair(SEGMENTED)
    assert tvit.encoder_segments(tmodel.config) == [(0, 6, 2, 32), (6, 6, 3, 64)]
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    stacked = tvit.prepare_vit_fused(tmodel)
    assert [s["qkv_w"].shape for s in stacked["segments"]] == [(6, 64, 96), (6, 64, 144)]
    with torch.no_grad():
        got = tvit.fused_vit_apply(tmodel, torch.from_numpy(img), stacked=stacked)
        packed = tvit.fused_vit_apply(tmodel, torch.from_numpy(img), pack_layers=True)
    np.testing.assert_allclose(_np(got), _np(ref), **FP32_FUSED)
    np.testing.assert_allclose(_np(packed), _np(got), **FP32)


def test_packed_fused_vit_apply_matches_jax():
    """tests/test_pallas_kernels.py:212-230: twelve one-layer segments
    (h2 mlp 32, h1 mlp 19 alternating) as one zero-padded chain, against
    ``model.apply`` (which that test holds JAX's packed path to at this
    bound) and equal to the segmented path; the default never packs."""
    jmodel, variables, tmodel, img = _pruned_pair(ALTERNATING)
    assert len(tvit.encoder_segments(tmodel.config)) == 12
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    packed_stack = tvit.prepare_vit_fused(tmodel, pack_layers=True)
    assert packed_stack["qkv_w"].shape == (12, 64, 96)
    assert packed_stack["fc1_w"].shape == (12, 64, 32)
    x = torch.from_numpy(img)
    with torch.no_grad():
        packed = tvit.fused_vit_apply(tmodel, x, stacked=packed_stack, pack_layers=True)
        seg = tvit.fused_vit_apply(tmodel, x, pack_layers=False)
        auto = tvit.fused_vit_apply(tmodel, x)
    np.testing.assert_allclose(_np(packed), _np(ref), **FP32_FUSED)
    np.testing.assert_allclose(_np(packed), _np(seg), **FP32)
    torch.testing.assert_close(auto, seg, rtol=0, atol=0)
    with pytest.raises(ValueError, match="pack_layers=True"):
        tvit.fused_vit_apply(tmodel, x, stacked=tvit.prepare_vit_fused(tmodel), pack_layers=True)


def test_packed_stack_matches_jax_packed_stack():
    from edgevisiontransformer_tpu.ops.pallas import fused_encoder as jfe

    _, variables, tmodel, _ = _pruned_pair(ALTERNATING)
    cfg = tmodel.config
    heads = [cfg.layer_heads(i) for i in range(cfg.depth)]
    mlps = [cfg.layer_mlp_dim(i) for i in range(cfg.depth)]
    want = jfe.stack_vit_layer_params_packed(variables["params"], heads, mlps, 16, True)
    got = tfe.stack_vit_layer_params_packed(tmodel.params(), heads, mlps, 16, True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_segmented_fused_vit_apply_int8_matches_jax(mode):
    """A two-segment model in int8: the port's ``{"segments": [...]}``
    stacks equal JAX's bit for bit, and the logits JAX's at its int8 bound."""
    jmodel, variables, tmodel, img = _pruned_pair(SEGMENTED_4, depth=4)
    if mode == "dynamic":
        jsq, tsq = jvit.prepare_vit_int8(jmodel, variables), tvit.prepare_vit_int8(tmodel)
    else:
        calib = list(jq.representative_batches(n=2, batch=2, shape=(3, 32, 32), seed=3))
        scales = jq.calibrate_vit(jmodel, variables, batches=calib)
        jsq = jvit.prepare_vit_int8_static(jmodel, variables, act_scales=scales)
        tsq = tvit.prepare_vit_int8_static(tmodel, act_scales=np.asarray(scales))
    jsq_np = jax.tree.map(np.asarray, jsq)
    assert len(tsq["segments"]) == len(jsq_np["segments"]) == 2
    for t, j in zip(tsq["segments"], jsq_np["segments"]):
        assert set(t) == set(j)
        for k in j:
            np.testing.assert_array_equal(t[k].numpy(), j[k], err_msg=k)
    ref = jax.jit(functools.partial(jvit.fused_vit_apply_int8, jmodel))(
        variables, jnp.asarray(img), jsq)
    with torch.no_grad():
        got = tvit.fused_vit_apply_int8(tmodel, torch.from_numpy(img), stacked_q=tsq)
        via_jax_stack = tvit.fused_vit_apply_int8(tmodel, torch.from_numpy(img),
                                                  stacked_q=quantized_stack_from_jax(jsq_np))
    np.testing.assert_allclose(_np(got), _np(ref), **INT8_FP32)
    torch.testing.assert_close(via_jax_stack, got, rtol=0, atol=0)


def test_uniform_pruned_ffn03_fused_paths_match_jax():
    """``all_head1_ffn0.3``: one head of 64 and 230 hidden units (not a
    multiple of 8) through fused_vit_apply (against ``model.apply``) and
    fused_vit_apply_int8 (static, against JAX's), deit_tiny's widths cut to
    two layers at image 32."""
    jmodel, variables, tmodel, img = _pruned_pair(
        "all_head1_ffn0.3", head_dim=64, dim=192, mlp_dim=768, depth=2)
    assert tmodel.block_0.ffn.fc1_kernel.shape == (192, 230)
    x = torch.from_numpy(img)
    calib = list(jq.representative_batches(n=2, batch=2, shape=(3, 32, 32), seed=4))
    scales = jq.calibrate_vit(jmodel, variables, batches=calib)
    jsq = jvit.prepare_vit_int8_static(jmodel, variables, act_scales=scales)
    with torch.no_grad():
        got = tvit.fused_vit_apply(tmodel, x)
        got8 = tvit.fused_vit_apply_int8(tmodel, x, stacked_q=tvit.prepare_vit_int8_static(
            tmodel, act_scales=np.asarray(scales)))
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    ref8 = jax.jit(functools.partial(jvit.fused_vit_apply_int8, jmodel))(
        variables, jnp.asarray(img), jsq)
    np.testing.assert_allclose(_np(got), _np(ref), **FP32_FUSED)
    np.testing.assert_allclose(_np(got8), _np(ref8), **INT8_FP32)


def test_uniform_pruned_ffn03_bf16_matches_jax_model_apply():
    """The same model in bf16: fused_vit_apply's logits within 5% of
    max|logit| of JAX's ``model.apply``."""
    jmodel, variables, tmodel, img = _pruned_pair(
        "all_head1_ffn0.3", "bfloat16", head_dim=64, dim=192, mlp_dim=768, depth=2)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    with torch.no_grad():
        got = tvit.fused_vit_apply(tmodel, torch.from_numpy(img))
    _check_bf16(got, ref, spacings=LOGIT_REL)
