"""``utils/export.py`` (a ``torch.export`` program of the plain forward)
against the model it came from and against the JAX package's export sidecar,
on the CPU."""

import json

import jax
import jax.numpy as jnp
import pytest
import torch

from edgevisiontransformer_tpu.config import ViTConfig as JViTConfig
from edgevisiontransformer_tpu.models.vit import ViT as JViT
from edgevisiontransformer_tpu.utils.export import export_forward as jexport_forward
from edgevisiontransformer_tpu_torch.config import ViTConfig
from edgevisiontransformer_tpu_torch.models.vit import ViT, apply_params
from edgevisiontransformer_tpu_torch.utils.export import export_forward, load_exported

torch.set_num_threads(1)

SMALL = dict(image_size=32, patch_size=8, dim=32, depth=2, heads=2, mlp_dim=64,
             num_classes=10)


def _model(**kw):
    return ViT(ViTConfig(**{**SMALL, **kw}), device="cpu",
               generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("bake", [True, False])
def test_exported_program_is_the_plain_forward_bit_for_bit(tmp_path, bake):
    model = _model()
    apply = lambda p, x: apply_params(model, p, x)  # noqa: E731
    path = export_forward(apply, model.params(), (2, 3, 32, 32), str(tmp_path / "m.pt2"),
                          bake_params=bake, meta={"model": "small"})
    run = load_exported(path)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(x)
        got = run(x) if bake else run(model.params(), x)
    assert torch.equal(got, want)
    side = json.loads((tmp_path / "m.pt2.json").read_text())
    assert side == {"input_shape": [2, 3, 32, 32], "dtype": "float32", "baked_params": bake,
                    "model": "small"}


def test_export_sidecar_has_jaxs_keys(tmp_path):
    jmodel = JViT(JViTConfig(**SMALL))
    variables = jmodel.init(jax.random.key(0), jnp.ones((1, 3, 32, 32)))
    meta = {"model": "small", "style": "standard"}
    jexport_forward(jmodel.apply, variables, (1, 3, 32, 32), str(tmp_path / "j.bin"), meta=meta)
    model = _model()
    export_forward(lambda p, x: apply_params(model, p, x), model.params(), (1, 3, 32, 32),
                   str(tmp_path / "t.pt2"), meta=meta)
    want = json.loads((tmp_path / "j.bin.json").read_text())
    got = json.loads((tmp_path / "t.pt2.json").read_text())
    assert got == want


def test_bf16_program_records_its_dtype(tmp_path):
    model = _model(dtype=torch.bfloat16)
    path = export_forward(lambda p, x: apply_params(model, p, x), model.params(),
                          (1, 3, 32, 32), str(tmp_path / "b.pt2"), dtype=torch.bfloat16)
    assert json.loads((tmp_path / "b.pt2.json").read_text())["dtype"] == "bfloat16"
    x = torch.randn(1, 3, 32, 32).bfloat16()
    with torch.no_grad():
        assert torch.equal(load_exported(path)(x), model(x))


def test_cli_export_torch_export_is_the_seeded_forward(tmp_path, capsys):
    from edgevisiontransformer_tpu_torch import cli

    out = tmp_path / "deit_tiny.pt2"
    assert cli.main(["export", "--model", "deit_tiny", "--format", "torch_export",
                     "--output", str(out), "--device", "cpu"]) == 0
    assert f"saved torch_export -> {out}" in capsys.readouterr().out
    model, _ = cli._build_model("deit_tiny", device="cpu")
    x = torch.randn(1, 3, 224, 224, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.equal(load_exported(str(out))(x), model(x))
    side = json.loads((tmp_path / "deit_tiny.pt2.json").read_text())
    assert side["model"] == "deit_tiny" and side["input_shape"] == [1, 3, 224, 224]
