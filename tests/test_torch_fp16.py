"""float16 on the port's kernel paths against the JAX package in float16.

On the CPU every kernel wrapper takes its plain twin, so these hold the
twins' float16 arithmetic (the kernels' fp16 instances compute the same
function; ``tests/test_torch_kernels_cuda.py`` holds them to the twins on
the card) against the JAX functions run in float16, their Pallas kernels in
interpret mode:

* the twins with an fp16-specific path: ``attention_rows`` on
  ``softmax_unnorm``'s float16 branch (the row max) against
  ``_attention_rows``; K9's window attention (the whole stage) against
  ``swin_stage_forward_pipelined``; ``linear_i8`` writing fp16 against K4's
  ``_int8_mm`` helpers; K16's twins on fp16 operands against JAX's K16;
* the entry points: ``fused_vit_apply``, ``fused_vit_apply_int8`` (dynamic
  and static), ``fully_fused_vit_apply``, the ViT module with
  ``kernel_mode="pallas"``, ``fused_swin_apply`` (float and int8) and
  ``fused_t2t_apply[_int8]``, each against JAX's own fp16 run and (the
  float paths) ``model.apply``.

Sizes are the narrow configs of the bf16 parity files (ViT image 32, dim 64,
depth 2; Swin image 56; T2T-ViT-7 at 224 with one narrow layer), and the
bounds theirs: logits within 5% of max|logit|, a kernel's output within its
bf16 file's tolerance.  Each test prints the deviation it measured.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.models import swin as jswin
from edgevisiontransformer_tpu.models import t2t_vit as jt2t
from edgevisiontransformer_tpu.models import vit as jvit
from edgevisiontransformer_tpu.models.registry import build_model as jbuild_model
from edgevisiontransformer_tpu.ops import quant as jq
from edgevisiontransformer_tpu.ops.pallas.performer import performer_rest as jax_k16
from edgevisiontransformer_tpu_torch.models import registry
from edgevisiontransformer_tpu_torch.models import swin as tswin
from edgevisiontransformer_tpu_torch.models import t2t_vit as tt2t
from edgevisiontransformer_tpu_torch.models import vit as tvit
from edgevisiontransformer_tpu_torch.ops import quant as tq
from edgevisiontransformer_tpu_torch.ops.cuda import fused_attention as tfa
from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as tfe
from edgevisiontransformer_tpu_torch.ops.cuda import fused_mlp as tfm
from edgevisiontransformer_tpu_torch.ops.cuda import performer as tperf
from edgevisiontransformer_tpu_torch.ops.cuda import swin_block as tsb
from edgevisiontransformer_tpu_torch.utils.jax_bridge import (load_jax_params,
                                                              load_jax_variables,
                                                              quantized_stack_from_jax)
from test_torch_kernels_plain import _jax_attention_rows, _qkv
from test_torch_linear_i8_tiles import _jax_int8_layer_mm
from test_torch_swin_kernels import (EPS, _image, _jax_stage_kernel, _port_stage,
                                     _random_stage)

torch.set_num_threads(1)

# logits: single-spacing flips compound over the layers and the head (the
# bf16 files' bound; int8: bucket flips, the int8 files' bound)
LOGIT_REL = 0.05
# one attention output: p rounds to the compute dtype before PV on both
# sides; an fp32 ulp in the scores can flip a rounding
# (tests/test_torch_kernels_plain.py's bf16 bound)
ATTN = dict(rtol=2 ** -6, atol=2e-3)
# a K9 stage: the bf16 encoder bound, 3% of the largest magnitude, the
# typical element within 2^-7 (tests/test_torch_swin_kernels.py)
STAGE_MAX, STAGE_MEDIAN = 0.03, 2.0 ** -7
# linear_i8's GELU epilogue: the kernel tolerance
# (tests/test_torch_linear_i8_tiles.py)
GELU_RTOL, GELU_ATOL = 2.0 ** -6, 1e-2
# K16 against JAX's K16: the JAX package's own bound for K16 in bf16
K16_REL = 0.02

VIT = dict(image_size=32, dim=64, depth=2, heads=2, mlp_dim=128, num_classes=10)
SWIN = dict(image_size=56, embed_dim=64, depths=(2, 2), num_heads=(2, 4), num_classes=10)
T2T = dict(depth=1, num_classes=10, dim=128, heads=2, mlp_dim=256)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, ref, what) -> float:
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"{what}: max|port - jax| / max|jax| = {rel:.3g}")
    return rel


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        if a.ndim == 1:
            return a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if "relative_position_bias_table" in jax.tree_util.keystr(path):
            return a + 0.5 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, params), rng


# ---------------------------------------------------------------------------
# The twins with a float16 path of their own
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["unpadded", "padded", "large_scores", "one_key"])
def test_attention_rows_float16_branch_matches_jax(case):
    """``attention_rows`` (CPU: its twin) takes ``softmax_unnorm``'s float16
    branch, ``p = exp2(s - max s)`` with no clamp, as JAX's
    ``_attention_rows`` does at dtype float16: scores far above the bf16
    clamp (``large_scores``) come out as an exact softmax, not tied rows."""
    bm, n, heads, hd = (2, 197, 3, 64) if case == "unpadded" else (2, 24, 2, 32)
    n_pad = 200 if case == "unpadded" else n
    seq_len = {"unpadded": n, "padded": 21, "large_scores": n, "one_key": 1}[case]
    q = _qkv(bm, n, heads, hd, seed=6)
    if case == "large_scores":
        q[:, :4, : 2 * heads * hd] *= 6.0
    qp = np.zeros((bm, n_pad, q.shape[-1]), np.float32)
    qp[:, :n] = q
    jx = jnp.asarray(qp.reshape(bm * n_pad, -1)).astype(jnp.float16)
    ref = _f32(_jax_attention_rows(jx, bm=bm, n_pad=n_pad, heads=heads, head_dim=hd,
                                   seq_len=seq_len, dtype=jnp.float16))
    ref = ref.reshape(bm, n_pad, -1)[:, :n].reshape(bm * n, -1)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).reshape(bm, n_pad, -1)[:, :n]
    tfe.reset_launches()
    got = tfe.attention_rows(tx.reshape(bm * n, -1).to(torch.float16), heads=heads,
                             head_dim=hd, tokens=n, seq_len=seq_len)
    assert got.dtype == torch.float16 and tfe.LAUNCHES["attention_rows"] == 0
    err = np.abs(_f32(got) - ref)
    print(f"attention_rows {case}: max |port - jax| {err.max():.3g}")
    np.testing.assert_allclose(_f32(got), ref, **ATTN)
    if case == "large_scores":  # the max-free bf16 form would tie these rows at the clamp
        s = np.einsum("bqd,bkd->bqk", q[:, :4, :hd], q[:, :, heads * hd:heads * hd + hd])
        assert (s * hd ** -0.5 * np.log2(np.e)).max() > 60


@pytest.mark.parametrize("res,c,heads,b,w", [(14, 64, 2, 2, 7), (24, 64, 2, 1, 12)])
def test_window_attention_float16_branch_matches_jax_k9(res, c, heads, b, w):
    """A Swin stage through the port's chain (CPU: the twins; its window
    attention on the float16 branch) against JAX's K9 at float16, windows 7
    and 12, shifted and unshifted blocks."""
    blocks, mask = _random_stage(3, 2, c, 2 * c, heads, w, res)
    x, tx = _image(4, b, res, c, torch.float16)
    ref = _f32(_jax_stage_kernel(blocks, mask, x, res=res, w=w, heads=heads, dt=jnp.float16))
    got = tsb.swin_stage_forward_plain(tx.reshape(-1, c), _port_stage(blocks, mask, torch.float16),
                                       res=res, window=w, heads=heads, head_dim=c // heads,
                                       eps=EPS)
    assert got.dtype == torch.float16
    got = _f32(got.reshape(b, res, res, c))
    assert np.isfinite(got).all()
    err = np.abs(got - ref)
    print(f"K9 stage res {res} window {w}: max |port - jax| {err.max():.3g} of max|jax| "
          f"{np.abs(ref).max():.3g}, median {np.median(err):.3g}")
    assert err.max() <= STAGE_MAX * np.abs(ref).max()
    assert np.median(err) <= STAGE_MEDIAN * np.median(np.abs(ref))


@pytest.mark.parametrize("kind", ["_int8_mm", "_int8_mm_static"])
@pytest.mark.parametrize("code", [0, 1, 2, 3])
def test_linear_i8_writes_float16_as_jax_int8_helpers(kind, code):
    """``linear_i8`` with ``out_dtype=float16`` (CPU: its twin) against K4's
    int8 helpers and epilogue lines at float16: the non-GELU epilogues within
    one fp16 spacing (XLA contracts JAX's dequant into fused multiply-adds,
    tests/test_torch_linear_i8_tiles.py, an fp32 ulp that fp16's finer
    rounding can carry, where bf16's does not), GELU within the kernel
    tolerance."""
    m, k, n = 37, 230, 96
    rng = np.random.default_rng(13)
    h = (rng.standard_normal((m, k)) * rng.uniform(0.5, 4.0, (m, 1))).astype(np.float32)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    ws = (rng.uniform(0.5, 1.5, (1, n)) / (127.0 * k ** 0.5)).astype(np.float32)
    b = (rng.standard_normal((1, n)) * 0.5).astype(np.float32)
    res = rng.standard_normal((m, n)).astype(np.float32)
    jh, jres = jnp.asarray(h).astype(jnp.float16), jnp.asarray(res).astype(jnp.float16)
    th = torch.from_numpy(np.array(jh.astype(jnp.float32))).half()
    tres = torch.from_numpy(np.array(jres.astype(jnp.float32))).half()
    static = kind == "_int8_mm_static"
    inv_a = 127.0 / 6.0  # clips the largest rows, as a calibrated scale does
    # static: the kernel's w_s is the combined scale w_s * act_scale
    w_s = torch.from_numpy(ws[0])
    if static:
        w_s = w_s * torch.tensor(1.0 / inv_a, dtype=torch.float32)
    ref = _jax_int8_layer_mm(kind, jh, jnp.asarray(wq), jnp.asarray(w_s.numpy()[None]),
                             jnp.asarray(b), jres, code, jnp.float16, inv_a)
    q, s_row = tfe.quant_rows_plain(th, torch.tensor([[inv_a]]) if static else None, 0)
    epi = {0: tfe.BIAS, 1: tfe.BIAS_GELU, 2: tfe.BIAS_GELU, 3: tfe.BIAS_RESIDUAL}[code]
    got = tfe.linear_i8(q, s_row, torch.from_numpy(wq), w_s, torch.from_numpy(b[0]),
                        epilogue=epi, out_dtype=torch.float16,
                        res=tres if code == 3 else None, approx_gelu=code == 1)
    assert got.dtype == torch.float16
    got, ref = _f32(got), _f32(ref)
    err = np.abs(got - ref)
    print(f"linear_i8 {kind} code {code}: max |port - jax| {err.max():.3g}")
    if code in (1, 2):
        assert (err <= GELU_ATOL + GELU_RTOL * np.abs(ref)).all()
    else:
        print(f"  {int((err > 0).sum())} of {err.size} values one fp16 spacing apart")
        assert (err <= np.spacing(np.abs(ref).astype(np.float16)).astype(np.float32)).all()


@functools.lru_cache(maxsize=None)
def _k16(n: int):
    r = np.random.RandomState(0)
    p = {"attn_output": {"kernel": r.randn(64, 64) * 0.1, "bias": r.randn(64) * 0.1},
         "norm2_scale": 1 + r.randn(64) * 0.1, "norm2_bias": r.randn(64) * 0.1,
         "mlp_fc1_kernel": r.randn(64, 64) * 0.1, "mlp_fc1_bias": r.randn(64) * 0.1,
         "mlp_fc2_kernel": r.randn(64, 64) * 0.1, "mlp_fc2_bias": r.randn(64) * 0.1}
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    w = (r.randn(32, 64) * 0.3).astype(np.float32)
    x = (r.randn(2, n, 192) * 0.5).astype(np.float32)
    return p, w, x


@pytest.mark.parametrize("approx", [True, False])
@pytest.mark.parametrize("n", [784, 50])
def test_performer_twins_on_float16_operands_match_jax_k16(n, approx):
    """``performer_reduce_plain`` then ``performer_rows_plain`` on fp16
    ``x_kqv`` (w and the weights cast to fp16 where the kernels read them)
    against JAX's K16 at float16; ``performer_operands`` builds the fp16
    matrix the fp16 kernels take."""
    p, w, x = _k16(n)
    jx = jnp.asarray(x).astype(jnp.float16)
    ref = jax_k16(jx, jax.tree.map(jnp.asarray, p), jnp.asarray(w), eps_ln=1e-5,
                  approx_gelu=approx)
    tp = jax.tree.map(torch.from_numpy, p)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x).half()
    sums = tperf.performer_reduce_plain(tx, tw)
    got = tperf.performer_rows_plain(tx, sums, tp, tw, eps_ln=1e-5, approx_gelu=approx)
    tperf.reset_launches()
    ops = tperf.performer_operands(tp, tw, torch.float16)
    via_wrappers = tperf.performer_rest(tx, tp, tw, eps_ln=1e-5, approx_gelu=approx,
                                        operands=ops)
    assert sum(tperf.LAUNCHES.values()) == 0 and ops["mats"].dtype == torch.float16
    assert got.dtype == torch.float16 and torch.equal(got, via_wrappers)
    assert _rel(got, ref, f"K16 n {n} {'tanh' if approx else 'erf'}") <= K16_REL


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _vit(style: str, kernel_mode: str = "xla"):
    kw = dict(VIT, kernel_mode=kernel_mode)
    jmodel = jvit.ViT(jvit.deit_config("tiny", style, dtype=jnp.float16, **kw))
    variables = jmodel.init(jax.random.key(0), jnp.ones((1, 3, 32, 32)))
    params, rng = _perturbed(variables["params"], 7)
    tmodel = tvit.ViT(tvit.deit_config("tiny", style, dtype=torch.float16, **kw), device="cpu")
    load_jax_params(tmodel, params)
    img = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    calib = list(jq.representative_batches(n=2, batch=2, shape=(3, 32, 32), seed=3))
    return jmodel, {"params": params}, tmodel, img, calib


@pytest.mark.parametrize("style", ["standard", "reference"])
def test_fused_vit_apply_float16_matches_jax(style):
    jmodel, variables, tmodel, img, _ = _vit(style)
    with torch.no_grad():
        got = tvit.fused_vit_apply(tmodel, torch.from_numpy(img))
    assert got.dtype == torch.float16 and got.shape == (2, 10)
    jimg = jnp.asarray(img)
    fused = jax.jit(functools.partial(jvit.fused_vit_apply, jmodel))(variables, jimg)
    assert _rel(got, fused, f"fused_vit_apply {style} vs JAX fused") <= LOGIT_REL
    assert _rel(got, jax.jit(jmodel.apply)(variables, jimg),
                f"fused_vit_apply {style} vs model.apply") <= LOGIT_REL


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_fused_vit_apply_int8_float16_matches_jax(mode):
    """The int8 path at float16 against JAX's fused int8 path (K4 in
    interpret mode) and its eager int8 oracle, on the same scales."""
    jmodel, variables, tmodel, img, calib = _vit("standard")
    jimg, timg = jnp.asarray(img), torch.from_numpy(img)
    if mode == "dynamic":
        jsq, tsq = jvit.prepare_vit_int8(jmodel, variables), tvit.prepare_vit_int8(tmodel)
        oracle = jq.int8_vit_apply(jmodel, jq.quantize_vit_params_int8(variables), jimg)
    else:
        scales = jq.calibrate_vit(jmodel, variables, batches=calib)
        jsq = jvit.prepare_vit_int8_static(jmodel, variables, act_scales=scales)
        tsq = tvit.prepare_vit_int8_static(tmodel, act_scales=scales)
        oracle = jq.int8_vit_apply_static(
            jmodel, jq.quantize_vit_params_int8_static(variables, scales), jimg)
    with torch.no_grad():
        got = tvit.fused_vit_apply_int8(tmodel, timg, stacked_q=tsq)
    assert got.dtype == torch.float16 and got.shape == (2, 10)
    fused = jax.jit(functools.partial(jvit.fused_vit_apply_int8, jmodel))(variables, jimg, jsq)
    assert _rel(got, fused, f"fused_vit_apply_int8 {mode} vs JAX fused") <= LOGIT_REL
    assert _rel(got, oracle, f"fused_vit_apply_int8 {mode} vs JAX oracle") <= LOGIT_REL


def test_fully_fused_vit_apply_float16_matches_jax():
    """The whole-model path (CPU: the vit_full twin) against JAX's (K7 in
    interpret mode) and model.apply; K7 rounds the cls + pos + patch-bias
    fold to float16, as the port's does."""
    jmodel, variables, tmodel, img, _ = _vit("standard")
    x = torch.from_numpy(img)
    with torch.no_grad():
        got = tvit.fully_fused_vit_apply(tmodel, x)
    assert got.dtype == torch.float16 and got.shape == (2, 10)
    assert tvit.prepare_vit_full(tmodel)["embed_bias"].dtype == torch.float16
    jimg = jnp.asarray(img)
    jvars = jax.tree.map(jnp.asarray, variables)
    assert _rel(got, jvit.fully_fused_vit_apply(jmodel, jvars, jimg),
                "fully_fused_vit_apply vs JAX") <= LOGIT_REL
    assert _rel(got, jax.jit(jmodel.apply)(variables, jimg),
                "fully_fused_vit_apply vs model.apply") <= LOGIT_REL


def test_vit_module_pallas_float16_matches_jax():
    """The ViT module with ``kernel_mode="pallas"`` (CPU: the sdpa and mlp
    twins) against JAX's module on K13 and K14 in interpret mode."""
    jmodel, shape = jbuild_model("deit_tiny", style="standard", dtype=jnp.float16,
                                 kernel_mode="pallas", image_size=32, patch_size=16, dim=64,
                                 depth=2, heads=2, mlp_dim=128, num_classes=10)
    params, rng = _perturbed(jmodel.init(jax.random.key(0), jnp.ones((1, *shape)))["params"], 5)
    tmodel, _ = registry.build_model("deit_tiny", device="cpu", style="standard",
                                     dtype=torch.float16, kernel_mode="pallas", image_size=32,
                                     patch_size=16, dim=64, depth=2, heads=2, mlp_dim=128,
                                     num_classes=10)
    load_jax_params(tmodel, params)
    img = rng.standard_normal((2, *shape)).astype(np.float32)
    tfa.reset_launches()
    tfm.reset_launches()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img))
    assert tfa.LAUNCHES["sdpa"] == tfm.LAUNCHES["mlp"] == 0
    assert got.dtype == torch.float16
    ref = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(img))
    assert _rel(got, ref, "ViT module pallas vs JAX") <= LOGIT_REL


@functools.lru_cache(maxsize=None)
def _swin():
    jmodel = jswin.SwinTransformer(jswin.swin_config("tiny", dtype=jnp.float16, **SWIN))
    v = jax.jit(jmodel.init)(jax.random.key(1), jnp.ones((1, 3, 56, 56)))
    params, rng = _perturbed(v["params"], 7)
    variables = {"params": params, "constants": jax.tree.map(np.asarray, v["constants"])}
    tmodel = tswin.SwinTransformer(tswin.swin_config("tiny", dtype=torch.float16, **SWIN),
                                   device="cpu")
    load_jax_variables(tmodel, variables)
    img = rng.standard_normal((2, 3, 56, 56)).astype(np.float32)
    batches = tuple(tq.representative_batches(n=2, shape=(3, 56, 56)))
    return jmodel, variables, tmodel, img, batches


def test_fused_swin_apply_float16_matches_jax():
    jmodel, variables, tmodel, img, _ = _swin()
    with torch.no_grad():
        got = tswin.fused_swin_apply(tmodel, torch.from_numpy(img))
    assert got.dtype == torch.float16 and got.shape == (2, 10)
    jimg = jnp.asarray(img)
    prep = jswin.prepare_swin_fused(jmodel, variables)
    assert _rel(got, jswin.fused_swin_apply(jmodel, variables, jimg, prepared=prep),
                "fused_swin_apply vs JAX fused") <= LOGIT_REL
    assert _rel(got, jax.jit(jmodel.apply)(variables, jimg),
                "fused_swin_apply vs model.apply") <= LOGIT_REL


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_fused_swin_apply_int8_float16_matches_jax(mode):
    """Every stage int8 (``min_dim=0``), each package on its own stack (the
    static scales from the same batches, bit for bit in fp32)."""
    jmodel, variables, tmodel, img, batches = _swin()
    if mode == "dynamic":
        jq8 = jswin.prepare_swin_int8(jmodel, variables, min_dim=0)
        tq8 = tswin.prepare_swin_int8(tmodel, min_dim=0)
    else:
        jq8 = jswin.prepare_swin_int8_static(jmodel, variables, batches=list(batches),
                                             min_dim=0)
        tq8 = tswin.prepare_swin_int8_static(tmodel, batches=list(batches), min_dim=0)
    assert sorted(tq8) == sorted(jq8) and len(tq8) > 0
    with torch.no_grad():
        got = tswin.fused_swin_apply(tmodel, torch.from_numpy(img), int8_prepared=tq8)
    assert got.dtype == torch.float16 and got.shape == (2, 10)
    ref = jswin.fused_swin_apply(jmodel, variables, jnp.asarray(img),
                                 prepared=jswin.prepare_swin_fused(jmodel, variables),
                                 int8_prepared=jq8)
    assert _rel(got, ref, f"fused_swin_apply int8 {mode} vs JAX") <= LOGIT_REL


@functools.lru_cache(maxsize=None)
def _t2t():
    jmodel = jt2t.T2TViT(jt2t.t2t_vit_config(7, "reference", dtype=jnp.float16, **T2T))
    v = jax.jit(jmodel.init)(jax.random.key(1), jnp.ones((1, 3, 224, 224)))
    params, rng = _perturbed(v["params"], 7)
    variables = {"params": params, "constants": jax.tree.map(np.asarray, v["constants"])}
    tmodel = tt2t.T2TViT(tt2t.t2t_vit_config(7, "reference", dtype=torch.float16, **T2T),
                         device="cpu")
    load_jax_variables(tmodel, variables)
    img = rng.standard_normal((2, 3, 224, 224)).astype(np.float32)
    return jmodel, variables, tmodel, img


def test_fused_t2t_apply_float16_matches_jax():
    """b2 through the stage-1 form (batch < 8) and K16's twins (``plain``),
    and the default CPU path, against JAX's fused function and
    ``model.apply`` at float16."""
    jmodel, variables, tmodel, img = _t2t()
    x = torch.from_numpy(img)
    with torch.no_grad():
        got = tt2t.fused_t2t_apply(tmodel, x)
        twins = tt2t.fused_t2t_apply(tmodel, x, plain=True)
    assert got.dtype == twins.dtype == torch.float16 and got.shape == (2, 10)
    jimg = jnp.asarray(img)
    fused = jt2t.fused_t2t_apply(jmodel, variables, jimg)
    applied = jax.jit(jmodel.apply)(variables, jimg)
    for name, out in (("fused_t2t_apply", got), ("fused_t2t_apply plain", twins)):
        assert _rel(out, fused, f"{name} vs JAX fused") <= LOGIT_REL
        assert _rel(out, applied, f"{name} vs model.apply") <= LOGIT_REL


def test_fused_t2t_apply_int8_float16_matches_jax():
    """Static int8 on JAX's stack (scales from two representative batches)
    against JAX's fused int8 function at float16."""
    jmodel, variables, tmodel, img = _t2t()
    calib = list(jq.representative_batches(n=2, batch=1, shape=(3, 224, 224), seed=3))
    scales = jq.calibrate_t2t(jmodel, variables, batches=calib)
    jsq = jt2t.prepare_t2t_int8_static(jmodel, variables, act_scales=scales)
    tsq = quantized_stack_from_jax(jax.tree.map(np.asarray, jsq))
    with torch.no_grad():
        got = tt2t.fused_t2t_apply_int8(tmodel, torch.from_numpy(img), stacked_q=tsq)
    assert got.dtype == torch.float16 and got.shape == (2, 10)
    ref = jt2t.fused_t2t_apply_int8(jmodel, variables, jnp.asarray(img), jsq)
    assert _rel(got, ref, "fused_t2t_apply_int8 static vs JAX") <= LOGIT_REL


# ---------------------------------------------------------------------------
# Dispatch on the CPU
# ---------------------------------------------------------------------------


def test_cpu_wrappers_keep_float16_and_launch_nothing():
    """A CPU fp16 tensor takes the twin, which returns fp16: the same
    dispatch as bf16 (the fp16 instances run only on the card)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(10, 64, generator=g).half()
    w, b = (torch.randn(64, 32, generator=g) * 0.1).half(), torch.randn(32, generator=g).half()
    tfe.reset_launches()
    outs = [tfe.ln_rows(x, torch.ones(64).half(), torch.zeros(64).half(), 1e-6),
            tfe.linear(x, w, b, epilogue=tfe.CAST_THEN_BIAS),
            tfe.attention_rows(torch.randn(10, 3 * 64, generator=g).half(), heads=2,
                               head_dim=32, tokens=5)]
    assert all(o.dtype == torch.float16 for o in outs)
    q, s = tfe.quant_rows(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert sum(tfe.LAUNCHES.values()) == 0
