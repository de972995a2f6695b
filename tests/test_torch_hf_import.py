"""The port's checkpoint import against the JAX package's and transformers':
``import_hf_vit`` / ``import_hf_swin`` trees leaf for leaf, logits against
the HF torch models and JAX's on the same weights, the official T2T-ViT
layout through ``import_t2t_torch`` and ``load_t2t_checkpoint``, and
``load_hf_model_params`` on a ``save_pretrained`` directory (CPU, random
init, no download).  Also holds ``chip_smoke.py``'s builders of published
state dicts (the GPU machine has no transformers) to transformers' own
names and shapes."""

import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from edgevisiontransformer_tpu.models.swin import SwinTransformer as JSwin  # noqa: E402
from edgevisiontransformer_tpu.models.t2t_vit import T2TViT as JT2T  # noqa: E402
from edgevisiontransformer_tpu.models.vit import ViT as JViT  # noqa: E402
from edgevisiontransformer_tpu.utils import hf_import as jhi  # noqa: E402
from edgevisiontransformer_tpu_torch.models.swin import SwinTransformer  # noqa: E402
from edgevisiontransformer_tpu_torch.models.t2t_vit import T2TViT  # noqa: E402
from edgevisiontransformer_tpu_torch.models.vit import ViT, fused_vit_apply  # noqa: E402
from edgevisiontransformer_tpu_torch.utils import hf_import as thi  # noqa: E402
from edgevisiontransformer_tpu_torch.utils.jax_bridge import (flatten_tree,  # noqa: E402
                                                              load_jax_params,
                                                              load_jax_variables)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

# fp32 logits, port against transformers and against JAX: the bound of
# tests/test_hf_parity.py (JAX against transformers)
FP32 = dict(rtol=1e-4, atol=1e-4)
# tests/test_hf_parity.py's small configs
VIT_SMALL = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
                 intermediate_size=128, image_size=32, patch_size=16, num_labels=10,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
SWIN_SMALL = dict(image_size=32, patch_size=2, embed_dim=24, depths=[2, 2], num_heads=[3, 6],
                  window_size=4, num_labels=10, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0, drop_path_rate=0.0)


def _hf_vit(**kw):
    from transformers import ViTConfig, ViTForImageClassification

    torch.manual_seed(0)
    return ViTForImageClassification(ViTConfig(**{**VIT_SMALL, **kw})).eval()


def _hf_swin(**kw):
    from transformers import SwinConfig, SwinForImageClassification

    torch.manual_seed(0)
    return SwinForImageClassification(SwinConfig(**{**SWIN_SMALL, **kw})).eval()


def _same_trees(port: dict, jax_tree: dict) -> None:
    got = flatten_tree(port)
    want = {k: np.asarray(v) for k, v in flatten_tree(jax.tree.map(np.asarray, jax_tree)).items()}
    assert set(got) == set(want)
    for k, v in got.items():
        assert isinstance(v, np.ndarray), k
        assert v.dtype == want[k].dtype and v.shape == want[k].shape, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_vit_config_from_hf_keeps_hf_defaults():
    from transformers import ViTConfig

    hf = ViTConfig()
    cfg = thi.vit_config_from_hf(hf)
    jcfg = jhi.vit_config_from_hf(hf)
    assert cfg.layernorm_eps == 1e-12 and cfg.num_classes == 2
    assert cfg.to_json() == jcfg.to_json()
    assert thi.vit_config_from_hf(hf, num_classes=1000).num_classes == 1000


def test_import_hf_vit_tree_equals_jax_and_logits_match_hf():
    hf = _hf_vit()
    cfg = thi.vit_config_from_hf(hf.config, num_classes=10)
    tree = thi.import_hf_vit(hf.state_dict(), cfg)
    jtree = jhi.import_hf_vit(hf.state_dict(), jhi.vit_config_from_hf(hf.config, num_classes=10))
    _same_trees(tree, jtree)

    model = load_jax_params(ViT(cfg, device="cpu"), tree["params"])
    x = np.random.RandomState(0).randn(2, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(x)).logits.numpy()
        got = model(torch.from_numpy(x)).numpy()
        fused = fused_vit_apply(model, torch.from_numpy(x)).numpy()
    jgot = np.asarray(JViT(jhi.vit_config_from_hf(hf.config, num_classes=10)).apply(
        jtree, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, **FP32)
    np.testing.assert_allclose(got, jgot, **FP32)
    np.testing.assert_allclose(fused, ref, **FP32)


def test_import_hf_vit_headless_gets_a_zero_head():
    hf = _hf_vit()
    sd = {k: v for k, v in hf.state_dict().items() if not k.startswith("classifier")}
    cfg = thi.vit_config_from_hf(hf.config, num_classes=7)
    head = thi.import_hf_vit(sd, cfg)["params"]["head"]
    assert head["kernel"].shape == (64, 7) and not head["kernel"].any() and not head["bias"].any()


def test_import_hf_swin_tree_equals_jax_and_logits_match_hf():
    hf = _hf_swin()
    cfg = thi.swin_config_from_hf(hf.config, num_classes=10)
    tree = thi.import_hf_swin(hf.state_dict(), cfg)
    jcfg = jhi.swin_config_from_hf(hf.config, num_classes=10)
    jtree = jhi.import_hf_swin(hf.state_dict(), jcfg)
    _same_trees(tree, jtree)
    assert "bias" not in tree["params"]["downsample_0"]["reduction"]

    model = load_jax_params(SwinTransformer(cfg, device="cpu"), tree["params"])
    x = np.random.RandomState(1).randn(2, 3, 32, 32).astype(np.float32)
    jmodel = JSwin(jcfg)
    consts = jmodel.init(jax.random.key(0), jnp.asarray(x))["constants"]
    with torch.no_grad():
        ref = hf(torch.from_numpy(x)).logits.numpy()
        got = model(torch.from_numpy(x)).numpy()
    jgot = np.asarray(jmodel.apply({**jtree, "constants": consts}, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, **FP32)
    np.testing.assert_allclose(got, jgot, **FP32)


def test_configs_the_card_refuses_are_imported():
    """A Swin window of 14 and a ViT width of 1536 import as JAX imports
    them (on the card the window is refused with the kernels' own error and
    the width runs on the module path: tests/test_torch_kernels_cuda.py)."""
    hf = _hf_swin(image_size=56, patch_size=2, window_size=14, depths=[2], num_heads=[2],
                  embed_dim=64)
    cfg = thi.swin_config_from_hf(hf.config)
    assert cfg.window_size == 14
    tree = thi.import_hf_swin(hf.state_dict(), cfg)
    _same_trees(tree, jhi.import_hf_swin(hf.state_dict(), jhi.swin_config_from_hf(hf.config)))
    model = load_jax_params(SwinTransformer(cfg, device="cpu"), tree["params"])
    x = torch.randn(1, 3, 56, 56, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        np.testing.assert_allclose(model(x).numpy(), hf(x).logits.numpy(), **FP32)

    hf = _hf_vit(hidden_size=1536, num_attention_heads=24, intermediate_size=256,
                 num_hidden_layers=1)
    cfg = thi.vit_config_from_hf(hf.config)
    assert cfg.dim == 1536
    model = load_jax_params(ViT(cfg, device="cpu"), thi.import_hf_vit(hf.state_dict(), cfg)[
        "params"])
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        np.testing.assert_allclose(model(x).numpy(), hf(x).logits.numpy(), **FP32)


def _t2t_sd(variant: int, seed: int) -> dict:
    cfg = thi.t2t_config_from_variant(variant)
    return {k: v.numpy() for k, v in chip_smoke.t2t_state_dict(
        torch, cfg, torch.Generator().manual_seed(seed)).items()}


@pytest.fixture(scope="module")
def t2t7():
    """T2T-ViT-7's official state dict (numpy), both packages' imports, and
    JAX's logits on one 224x224 image."""
    sd = _t2t_sd(7, seed=5)
    cfg, variables = thi.import_t2t_torch(sd, 7)
    jcfg, jvars = jhi.import_t2t_torch(sd, 7)
    x = np.random.RandomState(4).randn(1, 3, 224, 224).astype(np.float32)
    jlogits = np.asarray(jax.jit(JT2T(jcfg).apply)(jvars, jnp.asarray(x)))
    return sd, cfg, variables, jcfg, jvars, x, jlogits


def test_import_t2t_torch_equals_jax(t2t7):
    sd, cfg, variables, jcfg, jvars, x, jlogits = t2t7
    assert cfg.to_json() == jcfg.to_json()
    assert (cfg.gelu_approx, cfg.qkv_bias, cfg.layernorm_eps) == (False, False, 1e-5)
    _same_trees(variables, jvars)
    model = load_jax_variables(T2TViT(cfg, device="cpu"), variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jlogits, rtol=2e-3, atol=2e-3)
    assert np.abs(jlogits).max() > 0


@pytest.mark.parametrize("wrapper", ["state_dict_ema", "state_dict", "model", None])
def test_load_t2t_checkpoint_takes_each_wrapper_key(tmp_path, t2t7, wrapper):
    sd, _, variables, *_ = t2t7
    payload = {k: torch.from_numpy(v) for k, v in sd.items()}
    if wrapper is not None:
        payload = {wrapper: payload, "epoch": 309}
    path = tmp_path / "71.7_T2T_ViT_7.pth.tar"
    torch.save(payload, path)
    cfg, loaded = thi.load_t2t_checkpoint(str(path), 7)
    assert cfg.depth == 7 and cfg.dim == 256
    _same_trees(loaded, variables)


def test_load_hf_model_params_from_a_saved_directory(tmp_path):
    for family, hf in (("vit", _hf_vit()), ("swin", _hf_swin())):
        hf.save_pretrained(tmp_path / family)
        cfg, variables = thi.load_hf_model_params(str(tmp_path / family), family, device="cpu")
        jcfg, jtree = jhi.load_hf_model_params(str(tmp_path / family), family)
        assert cfg.num_classes == jcfg.num_classes == 10
        got = {k: v.numpy() for k, v in flatten_tree(variables["params"]).items()}
        _same_trees(got, jtree["params"])
    with pytest.raises(ValueError):
        thi.load_hf_model_params(str(tmp_path / "vit"), "t2t", device="cpu")


def test_load_hf_model_params_defaults_to_the_card(tmp_path, monkeypatch):
    _hf_vit().save_pretrained(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thi.load_hf_model_params(str(tmp_path))


def test_chip_smoke_vit_state_dict_has_transformers_names_and_shapes():
    from transformers import ViTConfig, ViTForImageClassification

    for kw in (dict(num_hidden_layers=2, num_labels=1000), dict(num_hidden_layers=1,
                                                                 qkv_bias=False)):
        hf_cfg = ViTConfig(**kw)
        want = {k: tuple(v.shape) for k, v in ViTForImageClassification(hf_cfg).state_dict().items()}
        fake = chip_smoke.hf_vit_state_dict(torch, hf_cfg, torch.Generator().manual_seed(0))
        assert {k: tuple(v.shape) for k, v in fake.items()} == want
    ns = SimpleNamespace(**chip_smoke.HF_VIT_B16)
    defaults = ViTConfig()
    for k, v in chip_smoke.HF_VIT_B16.items():
        assert getattr(defaults, k) == v or k == "num_labels", k
    assert thi.vit_config_from_hf(ns).num_classes == 1000


def test_chip_smoke_swin_state_dict_has_transformers_names_and_shapes():
    from transformers import SwinConfig, SwinForImageClassification

    for hf_cfg in (SwinConfig(depths=[1, 1, 2, 1], num_labels=1000), SwinConfig(**SWIN_SMALL)):
        hf = SwinForImageClassification(hf_cfg)
        want = {k: (tuple(v.shape), v.dtype) for k, v in hf.state_dict().items()}
        fake = chip_smoke.hf_swin_state_dict(torch, hf_cfg, torch.Generator().manual_seed(0))
        assert {k: (tuple(v.shape), v.dtype) for k, v in fake.items()} == want
        for k, v in fake.items():
            if k.endswith("relative_position_index"):
                assert torch.equal(v, hf.state_dict()[k]), k
    defaults = SwinConfig()
    for k, v in chip_smoke.HF_SWIN_T.items():
        assert getattr(defaults, k) == v or k == "num_labels", k


def test_chip_smoke_t2t_state_dict_is_the_official_layout():
    sd = _t2t_sd(14, seed=6)
    cfg, variables = thi.import_t2t_torch(sd, 14)
    model = load_jax_variables(T2TViT(cfg, device="cpu"), variables)
    assert cfg.depth == 14 and cfg.dim == 384
    assert "blocks.0.attn.qkv.bias" not in sd and model.config.qkv_bias is False
    w = sd["tokens_to_token.attention1.w"]
    np.testing.assert_allclose(w @ w.T, 32 * np.eye(32), atol=1e-4)


def test_load_hf_model_params_names_transformers_when_it_is_missing(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_transformers(name, *a, **k):
        if name == "transformers" or name.startswith("transformers."):
            raise ModuleNotFoundError("No module named 'transformers'", name="transformers")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(ImportError, match="transformers"):
        thi.load_hf_model_params(str(tmp_path), "vit", device="cpu")
