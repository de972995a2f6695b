"""The PyTorch port imports no JAX, and its config mirrors the JAX one."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from edgevisiontransformer_tpu import config as jcfg
from edgevisiontransformer_tpu_torch import config as tcfg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT_MODULES = [
    "edgevisiontransformer_tpu_torch",
    "edgevisiontransformer_tpu_torch.config",
    "edgevisiontransformer_tpu_torch.ops.activations",
    "edgevisiontransformer_tpu_torch.ops.layers",
    "edgevisiontransformer_tpu_torch.ops.attention",
    "edgevisiontransformer_tpu_torch.ops.quant",
    "edgevisiontransformer_tpu_torch.ops.unfold",
    "edgevisiontransformer_tpu_torch.ops.cuda",
    "edgevisiontransformer_tpu_torch.ops.cuda.common",
    "edgevisiontransformer_tpu_torch.ops.cuda.mathlib",
    "edgevisiontransformer_tpu_torch.ops.cuda.build",
    "edgevisiontransformer_tpu_torch.ops.cuda.fused_encoder",
    "edgevisiontransformer_tpu_torch.ops.cuda.t2t_stage1",
    "edgevisiontransformer_tpu_torch.ops.cuda.swin_block",
    "edgevisiontransformer_tpu_torch.ops.cuda.swin_merge",
    "edgevisiontransformer_tpu_torch.ops.cuda.window_sdpa",
    "edgevisiontransformer_tpu_torch.ops.cuda.fused_attention",
    "edgevisiontransformer_tpu_torch.ops.cuda.fused_mlp",
    "edgevisiontransformer_tpu_torch.ops.cuda.layernorm",
    "edgevisiontransformer_tpu_torch.ops.cuda.fused_vit_full",
    "edgevisiontransformer_tpu_torch.ops.cuda.performer",
    "edgevisiontransformer_tpu_torch.models",
    "edgevisiontransformer_tpu_torch.models.vit",
    "edgevisiontransformer_tpu_torch.models.t2t_vit",
    "edgevisiontransformer_tpu_torch.models.swin",
    "edgevisiontransformer_tpu_torch.models.registry",
    "edgevisiontransformer_tpu_torch.models.cnn",
    "edgevisiontransformer_tpu_torch.models.cnn.common",
    "edgevisiontransformer_tpu_torch.models.cnn.inception",
    "edgevisiontransformer_tpu_torch.models.cnn.zoo",
    "edgevisiontransformer_tpu_torch.utils.jax_bridge",
    "edgevisiontransformer_tpu_torch.utils.checkpoint",
    "edgevisiontransformer_tpu_torch.utils.metrics",
    "edgevisiontransformer_tpu_torch.utils.finetune",
    "edgevisiontransformer_tpu_torch.utils.imagenet",
    "edgevisiontransformer_tpu_torch.utils.native_preprocess",
    "edgevisiontransformer_tpu_torch.utils.hf_import",
    "edgevisiontransformer_tpu_torch.utils.flops",
    "edgevisiontransformer_tpu_torch.utils.latency_model",
    "edgevisiontransformer_tpu_torch.utils.logscrape",
    "edgevisiontransformer_tpu_torch.utils.plots",
    "edgevisiontransformer_tpu_torch.parallel",
    "edgevisiontransformer_tpu_torch.parallel.train",
    "edgevisiontransformer_tpu_torch.parallel.mesh",
    "edgevisiontransformer_tpu_torch.parallel.pipeline",
    "edgevisiontransformer_tpu_torch.parallel.launch",
    "edgevisiontransformer_tpu_torch.parallel.dryrun",
    "edgevisiontransformer_tpu_torch.pruning",
    "edgevisiontransformer_tpu_torch.pruning.policy",
    "edgevisiontransformer_tpu_torch.pruning.magnitude_pruners",
    "edgevisiontransformer_tpu_torch.pruning.apply",
    "edgevisiontransformer_tpu_torch.pruning.head_importance",
    "edgevisiontransformer_tpu_torch.pruning.iterative",
    "edgevisiontransformer_tpu_torch.pruning.movement",
    "edgevisiontransformer_tpu_torch.pruning.sparse_train",
    "edgevisiontransformer_tpu_torch.pruning.transitions",
    "edgevisiontransformer_tpu_torch.pruning.sparse_driver",
    "edgevisiontransformer_tpu_torch.bench.harness",
    "edgevisiontransformer_tpu_torch.bench.analyse",
    "edgevisiontransformer_tpu_torch.bench.sdpa_ab",
    "edgevisiontransformer_tpu_torch.bench.mlp_ab",
    "edgevisiontransformer_tpu_torch.bench.linear_ab",
    "edgevisiontransformer_tpu_torch.bench.linear_i8_ab",
    "edgevisiontransformer_tpu_torch.bench.attention_ab",
    "edgevisiontransformer_tpu_torch.bench.window_sdpa_ab",
    "edgevisiontransformer_tpu_torch.bench.window_attention_ab",
    "edgevisiontransformer_tpu_torch.bench.vit_full_ab",
    "edgevisiontransformer_tpu_torch.bench.parent_bits",
    "edgevisiontransformer_tpu_torch.bench.performer_ab",
    "edgevisiontransformer_tpu_torch.bench.swin_merge_ab",
    "edgevisiontransformer_tpu_torch.bench.stage1_ab",
    "edgevisiontransformer_tpu_torch.bench.qat_oracle",
]


def test_port_modules_are_all_listed():
    pkg = REPO / "edgevisiontransformer_tpu_torch"
    found = {".".join(p.relative_to(REPO).with_suffix("").parts)
             for p in pkg.rglob("*.py") if p.name != "__init__.py"}
    listed = set(PORT_MODULES)
    assert found <= listed, f"modules missing from PORT_MODULES: {sorted(found - listed)}"


def test_port_imports_no_jax():
    """Every port module imports, in a fresh interpreter, without pulling in
    jax, jaxlib or flax at any depth."""
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("enc,depth,mlp", [
    ("all_head2_ffn0.7", 12, 768),
    ("all_head12_ffn1.0", 12, 3072),
    ("layerwise_h2-d1.0_h3-d0.5_h1-d0.3", 3, 1536),
])
def test_decode_prune_encoding_matches_jax(enc, depth, mlp):
    got = tcfg.decode_prune_encoding(enc, depth, mlp)
    assert got == jcfg.decode_prune_encoding(enc, depth, mlp)
    heads, mlps = got
    assert (tcfg.encode_prune_encoding(heads, mlps, mlp)
            == jcfg.encode_prune_encoding(heads, mlps, mlp))


def test_decode_prune_encoding_errors_match_jax():
    for enc, depth in (("layerwise_h2-d1.0", 2), ("bogus_h1", 1)):
        with pytest.raises(ValueError):
            jcfg.decode_prune_encoding(enc, depth, 768)
        with pytest.raises(ValueError):
            tcfg.decode_prune_encoding(enc, depth, 768)


@pytest.mark.parametrize("style", ["standard", "reference"])
def test_vit_config_json_matches_jax(style):
    import jax.numpy as jnp

    kw = jcfg.REFERENCE_STYLE if style == "reference" else jcfg.STANDARD_STYLE
    assert kw == (tcfg.REFERENCE_STYLE if style == "reference" else tcfg.STANDARD_STYLE)
    shared = dict(dim=192, heads=3, mlp_dim=768, heads_per_layer=(3,) * 12,
                  mlp_dim_per_layer=(768,) * 12, **kw)
    j = jcfg.ViTConfig(dtype=jnp.bfloat16, **shared)
    t = tcfg.ViTConfig(dtype=torch.bfloat16, **shared)
    assert t.to_json() == j.to_json()
    assert tcfg.ViTConfig.from_json(j.to_json()) == t
    assert jcfg.ViTConfig.from_json(t.to_json()) == j
    assert t.resolved_head_dim == j.resolved_head_dim == 64
    assert t.num_patches == j.num_patches == 196
