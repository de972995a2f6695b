"""ViT-H/14 and the head dims and widths of the largest published ViTs
(head_dim 80 and 88, model width 1,280), against the JAX package on the
CPU.

ViT-H/14 (google/vit-huge-patch14-224-in21k: hidden 1280, 32 layers, 16
heads of 80, MLP 5120, patch 14) cut to narrow sizes: its transformers key
names (``chip_smoke.hf_vit_state_dict`` under ``chip_smoke.HF_VIT_H14``'s
config, which ``tests/test_torch_hf_import.py`` holds to transformers' own
names) go through the port's ``utils/hf_import`` and the JAX package's, and
the four ViT entry points run on the same weights and a numpy-seeded image
batch: ``fused_vit_apply`` (K1/K2), static ``fused_vit_apply_int8`` (K4/K5),
the ``kernel_mode="pallas"`` module (K13, K14) and ``fully_fused_vit_apply``
(K7a/K7b).  On the CPU the port's wrappers take their plain twins; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do.  The
tolerances are those of ``tests/test_torch_vit_pallas.py`` and
``tests/test_torch_vit_full.py``.

The plans of the four kernels are checked at the full published shapes of
ViT-H/14, ViT-g/14 and ViT-G/14 (b1 and b8) against the card's shared
memory.
"""

import functools
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.models import vit as jvit
from edgevisiontransformer_tpu.ops import quant as jq
from edgevisiontransformer_tpu.utils import hf_import as jhi
from edgevisiontransformer_tpu_torch.models import vit as tvit
from edgevisiontransformer_tpu_torch.ops.cuda import fused_attention as tfa
from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as tfe
from edgevisiontransformer_tpu_torch.ops.cuda import fused_mlp as tfm
from edgevisiontransformer_tpu_torch.ops.cuda import fused_vit_full as tvf
from edgevisiontransformer_tpu_torch.utils import hf_import as thi
from edgevisiontransformer_tpu_torch.utils.jax_bridge import load_jax_params

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

# fp32: the bounds of tests/test_torch_vit_pallas.py (the fused encoder and
# the whole model rtol 1e-4, atol 5e-4; the module 1e-4; int8 2e-3); bf16
# logits within 5% of max|logit| (single-spacing flips compound over the
# layers and the head)
FP32_FUSED = dict(rtol=1e-4, atol=5e-4)
FP32_BLOCK = dict(rtol=1e-4, atol=1e-4)
INT8_FP32 = dict(rtol=2e-3, atol=2e-3)
LOGIT_REL = 0.05
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
H100_SMS = 132
# the most dynamic shared memory an H100 block may take (227 KB)
MAX_BLOCK_SMEM = 232448
# ViT-H/14 at image 28 (four patches of 14 and the cls token): two layers
# of two heads of 80 (ViT-H's head_dim), of 88 (ViT-g/14's, on the kernels'
# 96-wide instance), and one layer at ViT-H's full width (dim 1280, 16
# heads, MLP 5120: mlp on 32-row blocks)
NARROW = dict(image_size=28, num_labels=10)
CONFIGS = {"head_dim 80": dict(hidden_size=160, num_attention_heads=2, intermediate_size=320,
                               num_hidden_layers=2),
           "head_dim 88": dict(hidden_size=176, num_attention_heads=2, intermediate_size=352,
                               num_hidden_layers=2),
           "dim 1280": dict(hidden_size=1280, num_attention_heads=16, intermediate_size=5120,
                            num_hidden_layers=1)}
# the published shapes (hidden, heads, MLP) at patch 14 and 224^2
PUBLISHED = {"ViT-H/14": (1280, 16, 5120), "ViT-g/14": (1408, 16, 6144),
             "ViT-G/14": (1664, 16, 8192)}
TOKENS = (224 // 14) ** 2 + 1


@functools.lru_cache(maxsize=None)
def _pair(config: str, dtype: str, kernel_mode: str = "xla"):
    """The JAX and the port's ViT with ``kernel_mode``, both imported from one
    state dict under ViT-H/14's key names, and an image batch."""
    hf = SimpleNamespace(**{**chip_smoke.HF_VIT_H14, **NARROW, **CONFIGS[config]})
    sd = {k: v.numpy() for k, v in chip_smoke.hf_vit_state_dict(
        torch, hf, torch.Generator().manual_seed(25)).items()}
    jd, td = DTYPES[dtype]
    jcfg = jhi.vit_config_from_hf(hf).replace(dtype=jd, kernel_mode=kernel_mode)
    cfg = thi.vit_config_from_hf(hf).replace(dtype=td, kernel_mode=kernel_mode)
    assert cfg.to_json() == jcfg.to_json()
    assert (cfg.patch_size, cfg.layernorm_eps, cfg.qkv_bias) == (14, 1e-12, True)
    variables = jhi.import_hf_vit(sd, jcfg)
    tmodel = load_jax_params(tvit.ViT(cfg, device="cpu"), thi.import_hf_vit(sd, cfg)["params"])
    img = np.random.default_rng(26).standard_normal((2, 3, 28, 28)).astype(np.float32)
    return jvit.ViT(jcfg), variables, tmodel, img


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _check(got, ref, dtype, fp32):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape == (2, 10) and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, **fp32)
    else:
        err, scale = np.abs(got - ref).max(), np.abs(ref).max()
        assert err <= LOGIT_REL * scale, (err, scale)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_fused_vit_apply_matches_jax(config, dtype):
    jmodel, variables, tmodel, img = _pair(config, dtype)
    ref = jax.jit(functools.partial(jvit.fused_vit_apply, jmodel))(variables, jnp.asarray(img))
    tfe.reset_launches()
    with torch.no_grad():
        got = tvit.fused_vit_apply(tmodel, torch.from_numpy(img))
    assert not any(tfe.LAUNCHES.values())  # the twins, on the CPU
    _check(got, ref, dtype, FP32_FUSED)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_static_fused_vit_apply_int8_matches_jax(config, dtype):
    """Scales calibrated by JAX on two representative batches; the port's
    static stack from the same scales equals JAX's bit for bit, and the
    logits JAX's at the int8 bound."""
    jmodel, variables, tmodel, img = _pair(config, dtype)
    calib = list(jq.representative_batches(n=2, batch=2, shape=(3, 28, 28), seed=27))
    scales = jq.calibrate_vit(jmodel, variables, batches=calib)
    jsq = jvit.prepare_vit_int8_static(jmodel, variables, act_scales=scales)
    tsq = tvit.prepare_vit_int8_static(tmodel, act_scales=np.asarray(scales))
    for k, v in jax.tree.map(np.asarray, jsq).items():
        np.testing.assert_array_equal(_np(tsq[k]), v.astype(np.float32), err_msg=k)
    ref = jax.jit(functools.partial(jvit.fused_vit_apply_int8, jmodel))(
        variables, jnp.asarray(img), jsq)
    with torch.no_grad():
        got = tvit.fused_vit_apply_int8(tmodel, torch.from_numpy(img), stacked_q=tsq)
    _check(got, ref, dtype, INT8_FP32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_pallas_module_matches_jax(config, dtype):
    """The ``kernel_mode="pallas"`` module: ``sdpa`` at head_dim 80 / 88 and
    ``mlp`` at dim 160 / 176 / 1280."""
    jmodel, variables, tmodel, img = _pair(config, dtype, "pallas")
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    tfa.reset_launches()
    tfm.reset_launches()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img))
    assert tfa.LAUNCHES["sdpa"] == tfm.LAUNCHES["mlp"] == 0
    _check(got, ref, dtype, FP32_BLOCK)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_fully_fused_vit_apply_matches_jax(config, dtype):
    """The whole-model path at patch 14: the embedding's K is 3 x 14^2 = 588."""
    jmodel, variables, tmodel, img = _pair(config, dtype)
    ref = jvit.fully_fused_vit_apply(jmodel, variables, jnp.asarray(img))
    prep = tvit.prepare_vit_full(tmodel)
    assert prep["patch_w"].shape == (588, tmodel.config.dim)
    tvf.reset_launches()
    with torch.no_grad():
        got = tvit.fully_fused_vit_apply(tmodel, torch.from_numpy(img), prepared=prep)
    assert tvf.LAUNCHES["vit_full"] == 0
    _check(got, ref, dtype, FP32_FUSED)


# ---------------------------------------------------------------------------
# The plans at the published shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("model", list(PUBLISHED))
def test_attention_plans_fit_the_card(model, batch):
    """``attention_rows`` (``attention_plan``'s warps, a 2-stage ring of 64-key
    tiles) and ``sdpa`` (the streamed form: 257 keys are above every
    instance's resident limit) on the instance of the next multiple of 16,
    within a block's shared memory."""
    dim, heads, _ = PUBLISHED[model]
    hd = dim // heads
    width = tfe.head_dim_instance(hd)
    assert hd in tfe.ATTENTION_HEAD_DIMS and width % 16 == 0 and 0 <= width - hd < 16
    warps = tfe.attention_plan(batch, heads, TOKENS, H100_SMS)
    assert warps == (8 if batch == 8 else 4)
    assert (warps * 16 + 2 * 2 * 64) * (width + 8) * 2 <= MAX_BLOCK_SMEM
    assert TOKENS > 256  # sdpa streams: 64 query rows, two stages of K and V
    assert (64 + 2 * 2 * 64) * (width + 8) * 2 <= MAX_BLOCK_SMEM


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("model", list(PUBLISHED))
def test_vit_full_plan_fits_one_block_an_sm(model, batch):
    dim, heads, mlp = PUBLISHED[model]
    hd = dim // heads
    plan = tvf.vit_full_plan(batch, TOKENS, dim, heads, hd, mlp, 1000, H100_SMS)
    assert tvf.strip_head_dim(hd) == 128 and plan.blocks == 1
    smem = tvf.vit_full_smem_bytes(plan, hd, dim)
    assert smem + tvf.BLOCK_RESERVE_BYTES <= tvf.SM_SHARED_BYTES
    assert smem == max((plan.attn_warps * 16 + 256) * 136 * 2 * (8 // plan.attn_warps),
                       *(tvf.VIT_FULL_TILES[c][2] * tfe._linear_smem_bytes(
                           *tvf.VIT_FULL_TILES[c][:2]) for c in plan.tiles), 8 * dim * 4)
    assert 1 <= plan.grid <= H100_SMS


def test_vit_full_plan_at_vit_h_b1_by_hand():
    """ViT-H/14 b1: 16 x 32 tiles but fc1 (257 x 5120 in 128 x 96 tiles: 162
    of them), two 4-warp strips of 64 Q rows and two stages of 64-key K and
    V, 136 values a row (the 128-wide strip)."""
    plan = tvf.vit_full_plan(1, TOKENS, 1280, 16, 80, 5120, 1000, H100_SMS)
    assert plan.tiles == (1, 1, 1, 0, 1) and plan.attn_warps == 4
    assert tvf.vit_full_smem_bytes(plan, 80, 1280) == 2 * (64 + 256) * 136 * 2 == 174080


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("model", list(PUBLISHED))
def test_mlp_wide_plan_fits_one_wave_within_shared_memory(model, batch):
    """Every published dim above 1,152 runs csrc/mlp_wide.cu: one block an
    SM, the ring within the card's shared memory, fc2's K split at b1; the
    workspaces by hand at ViT-H/14."""
    dim, _, hidden = PUBLISHED[model]
    m = batch * TOKENS
    assert dim > tfm.MID_ROWS_DIM
    p = tfm.wide_plan(m, dim, hidden, H100_SMS)
    assert 1 <= p.grid <= H100_SMS * tfm.WIDE_BLOCKS_PER_SM and p.smem <= tfm.MAX_SMEM
    assert p.row_tiles * p.bm >= m and p.dim_tiles * p.bn >= dim and p.hp >= hidden
    assert p.split > 1 or batch > 1  # at b1 the fc2 tiles are few: K is split
    if model == "ViT-H/14":  # H [m, 5,120] bf16; the fp32 partials [S, m, 1,280]
        assert p.h_bytes == m * 5120 * 2 and p.part_bytes == (p.split > 1) * p.split * m * 1280 * 4
        assert (p.h_bytes, p.part_bytes) == ((2_631_680, 6_579_200) if batch == 1
                                             else (21_053_440, 0))
