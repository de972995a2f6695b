"""The CUDA kernels against their plain twins, on the GPU.

Skipped without a CUDA device.  On the GPU machine (which has no JAX, so the
suite's conftest is left out):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_cuda.py -q

This file imports no JAX.
"""

import pytest
import torch

from edgevisiontransformer_tpu_torch.models.vit import ViT, deit_config, fused_vit_apply
from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as fe

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)

# Kernel and twin round the same fp32 values at the same points; fp32
# summation order and erff / exp2f / tanhf against torch's can move a value
# across a bf16 rounding boundary: at most ~2 bf16 spacings.
RTOL, ATOL = 2.0 ** -6, 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rnd(dev, *shape, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(*shape, generator=g, device=dev) * scale).to(torch.bfloat16)


def _close(got, ref):
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref.float(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rows,dim", [(1, 64), (197, 192), (1576, 768), (25216, 192)])
def test_ln_rows_kernel_matches_twin(dev, rows, dim):
    x = _rnd(dev, rows, dim, scale=3.0)
    g, b = _rnd(dev, dim, seed=1) + 1, _rnd(dev, dim, seed=2)
    _close(fe.ln_rows(x, g, b, 1e-6), fe.ln_rows_plain(x, g, b, 1e-6))


@pytest.mark.parametrize("m,k,n", [(1, 8, 8), (197, 192, 576), (197, 768, 3072),
                                   (1576, 3072, 768), (300, 200, 136)])
@pytest.mark.parametrize("epilogue,approx", [
    (fe.CAST_THEN_BIAS, False), (fe.CAST_THEN_BIAS_GELU, False),
    (fe.CAST_THEN_BIAS_GELU, True), (fe.BIAS_RESIDUAL, False)])
def test_linear_kernel_matches_twin(dev, m, k, n, epilogue, approx):
    x, w = _rnd(dev, m, k), _rnd(dev, k, n, scale=k ** -0.5, seed=1)
    b = _rnd(dev, n, scale=0.5, seed=2)
    res = _rnd(dev, m, n, seed=3) if epilogue == fe.BIAS_RESIDUAL else None
    kw = dict(epilogue=epilogue, res=res, approx_gelu=approx)
    _close(fe.linear(x, w, b, **kw), fe.linear_plain(x, w, b, **kw))


@pytest.mark.parametrize("batch,tokens,seq_len,heads,hd", [
    (2, 197, 197, 3, 64), (1, 5, 5, 2, 32), (3, 64, 64, 2, 128),
    (2, 200, 197, 2, 64), (1, 70, 0, 1, 64)])
def test_attention_rows_kernel_matches_twin(dev, batch, tokens, seq_len, heads, hd):
    qkv = _rnd(dev, batch * tokens, 3 * heads * hd)
    kw = dict(heads=heads, head_dim=hd, tokens=tokens, seq_len=seq_len)
    got = fe.attention_rows(qkv, **kw)
    _close(got, fe.attention_rows_plain(qkv, **kw))
    if seq_len == 0:
        assert not got.float().any()


def test_attention_rows_clamp60_rows_tie(dev):
    qkv = _rnd(dev, 64, 3 * 64)
    qkv[:8, :128] *= 8  # q and k large: log2-scaled scores far above 60
    kw = dict(heads=1, head_dim=64, tokens=64)
    _close(fe.attention_rows(qkv, **kw), fe.attention_rows_plain(qkv, **kw))


@pytest.mark.parametrize("reference_residual,approx", [(False, False), (True, True)])
def test_encoder_forward_kernels_match_twins_and_count(dev, reference_residual, approx):
    cfg = deit_config("tiny", depth=2, dtype=torch.bfloat16)
    model = ViT(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    from edgevisiontransformer_tpu_torch.models.vit import prepare_vit_fused

    stacked = prepare_vit_fused(model)
    x = _rnd(dev, 3, 197, 192)
    kw = dict(heads=3, head_dim=64, eps=1e-6, reference_residual=reference_residual,
              approx_gelu=approx)
    fe.reset_launches()
    got = fe.encoder_forward(x, stacked, **kw)
    assert fe.LAUNCHES == {"ln_rows": 4, "linear": 8, "attention_rows": 2}
    ref = fe.encoder_forward_plain(x, stacked, **kw)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max()
    assert err <= 0.03 * ref.float().abs().max()


def test_fused_vit_apply_on_kernels_matches_plain(dev):
    model = ViT(deit_config("tiny", depth=2, dtype=torch.bfloat16), device=dev,
                generator=torch.Generator().manual_seed(1))
    img = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(2)).to(dev)
    with torch.no_grad():
        got = fused_vit_apply(model, img)
        ref = fused_vit_apply(model, img, plain=True)
    torch.cuda.synchronize()
    assert got.shape == (2, 1000) and torch.isfinite(got.float()).all()
    assert (got.float() - ref.float()).abs().max() <= 0.05 * ref.float().abs().max()


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.randn(8, 16, device=dev)
    g, b = torch.ones(16, device=dev), torch.zeros(16, device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        fe.ln_rows(x, g, b, 1e-6)
    xb, gb, bb = x.bfloat16(), g.bfloat16(), b.bfloat16()
    with pytest.raises(ValueError, match="contiguous"):
        fe.ln_rows(xb.t().contiguous().t(), gb, bb, 1e-6)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        fe.ln_rows(xb, gb.cpu(), bb, 1e-6)
    with pytest.raises(ValueError, match="multiples of 8"):
        fe.linear(xb, torch.zeros(16, 12, device=dev, dtype=torch.bfloat16),
                  torch.zeros(12, device=dev, dtype=torch.bfloat16),
                  epilogue=fe.CAST_THEN_BIAS)
    with pytest.raises(ValueError, match="head_dim"):
        fe.attention_rows(torch.zeros(10, 3 * 48, device=dev, dtype=torch.bfloat16),
                          heads=1, head_dim=48, tokens=5)
