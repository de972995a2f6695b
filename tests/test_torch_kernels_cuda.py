"""The CUDA kernels against their plain twins, on the GPU.

Skipped without a CUDA device.  On the GPU machine (which has no JAX, so the
suite's conftest is left out):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_cuda.py -q

This file imports no JAX.
"""

import functools

import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu_torch.models import swin
from edgevisiontransformer_tpu_torch.models import t2t_vit as t2t
from edgevisiontransformer_tpu_torch.models import vit as tvit
from edgevisiontransformer_tpu_torch.models.registry import build_model
from edgevisiontransformer_tpu_torch.models.vit import (ViT, deit_config, fused_vit_apply,
                                                         fused_vit_apply_int8, prepare_vit_fused,
                                                         prepare_vit_int8,
                                                         prepare_vit_int8_static)
from edgevisiontransformer_tpu_torch.ops.cuda import fused_attention as fa
from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as fe
from edgevisiontransformer_tpu_torch.ops.cuda import fused_mlp as fm
from edgevisiontransformer_tpu_torch.ops.cuda import fused_vit_full as vf
from edgevisiontransformer_tpu_torch.ops.cuda import layernorm as ln
from edgevisiontransformer_tpu_torch.ops.cuda import performer as pf
from edgevisiontransformer_tpu_torch.ops.cuda import swin_block as sb
from edgevisiontransformer_tpu_torch.ops.cuda import swin_merge as sm
from edgevisiontransformer_tpu_torch.ops.cuda import t2t_stage1 as ts
from edgevisiontransformer_tpu_torch.ops.cuda import window_sdpa as ws
from edgevisiontransformer_tpu_torch.ops.quant import representative_batches

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)

# Kernel and twin round the same fp32 values at the same points; fp32
# summation order and erff / exp2f / tanhf against torch's can move a value
# across a bf16 rounding boundary: at most ~2 bf16 spacings.
RTOL, ATOL = 2.0 ** -6, 1e-2
# The element types every kernel has an instance for: each kernel's twin
# test runs at both (fp16 keeps the same bounds: its spacing is finer)
DTYPES = [torch.bfloat16, torch.float16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rnd(dev, *shape, scale=1.0, seed=0, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)


def _close(got, ref):
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref.float(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,dim", [(1, 64), (197, 192), (1576, 768), (25216, 192)])
def test_ln_rows_kernel_matches_twin(dev, rows, dim, dtype):
    x = _rnd(dev, rows, dim, scale=3.0, dtype=dtype)
    g, b = _rnd(dev, dim, seed=1, dtype=dtype) + 1, _rnd(dev, dim, seed=2, dtype=dtype)
    _close(fe.ln_rows(x, g, b, 1e-6), fe.ln_rows_plain(x, g, b, 1e-6))


# linear's epilogues as (epilogue, approx_gelu): csrc/linear.cu codes 0-3
LINEAR_EPILOGUES = [(fe.CAST_THEN_BIAS, False), (fe.CAST_THEN_BIAS_GELU, False),
                    (fe.CAST_THEN_BIAS_GELU, True), (fe.BIAS_RESIDUAL, False)]


def _linear_args(dev, m, k, n, epilogue, approx=False, seed=0, dtype=torch.bfloat16):
    x = _rnd(dev, m, k, seed=seed, dtype=dtype)
    w = _rnd(dev, k, n, scale=k ** -0.5, seed=seed + 1, dtype=dtype)
    b = _rnd(dev, n, scale=0.5, seed=seed + 2, dtype=dtype)
    res = _rnd(dev, m, n, seed=seed + 3, dtype=dtype) if epilogue == fe.BIAS_RESIDUAL else None
    return (x, w, b), dict(epilogue=epilogue, res=res, approx_gelu=approx)


# Swin's widths (N = 96 and 288 at stage 0, up to M = 100,352 at b32), a
# pruned width on both sides (K = N = 230), and N = 288 at K = 230.
@pytest.mark.parametrize("m,k,n", [(1, 8, 8), (197, 192, 576), (197, 768, 3072),
                                   (1576, 3072, 768), (300, 200, 136), (197, 192, 96),
                                   (197, 230, 230), (394, 230, 288), (100352, 96, 288)])
@pytest.mark.parametrize("epilogue,approx", LINEAR_EPILOGUES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_linear_kernel_matches_twin(dev, m, k, n, epilogue, approx, dtype):
    args, kw = _linear_args(dev, m, k, n, epilogue, approx, dtype=dtype)
    fe.reset_launches()
    got = fe.linear(*args, **kw)
    assert fe.LAUNCHES["linear"] == 1
    _close(got, fe.linear_plain(*args, **kw))


# Every block shape csrc/linear.cu is compiled for, on the 16-byte path
# (N = 576) and the element-wise one (K = N = 230), gives the default plan's
# bits: K is never split, so no plan changes an element's sum.
@pytest.mark.parametrize("m,k,n", [(197, 192, 576), (300, 230, 230), (25216, 768, 192)])
def test_linear_kernel_every_plan_gives_the_same_bits(dev, monkeypatch, m, k, n):
    outs = {}
    for epilogue, approx in LINEAR_EPILOGUES:
        args, kw = _linear_args(dev, m, k, n, epilogue, approx)
        want = fe.linear(*args, **kw)
        for rows in fe.LINEAR_ROWS:
            for cols in fe.LINEAR_COLS:
                monkeypatch.setattr(fe, "linear_plan", lambda *a, r=rows, c=cols, **_: (r, c))
                outs[(epilogue, approx, rows, cols)] = (fe.linear(*args, **kw), want)
                monkeypatch.undo()
    torch.cuda.synchronize()
    differ = [key for key, (got, want) in outs.items() if not torch.equal(got, want)]
    assert not differ


# A row's output is the same bits alone (b1, the plan's narrow tiles) and
# as one of 128 images (128-row tiles), at every epilogue.
@pytest.mark.parametrize("k,n", [(192, 576), (192, 192), (192, 768), (768, 192), (192, 230)])
@pytest.mark.parametrize("epilogue,approx", LINEAR_EPILOGUES)
def test_linear_rows_are_bit_identical_alone_and_in_a_batch(dev, k, n, epilogue, approx):
    (x, w, b), kw = _linear_args(dev, 128 * 197, k, n, epilogue, approx)
    sms = fe._sm_count(0)
    assert fe.linear_plan(197, n, k, sms) != fe.linear_plan(128 * 197, n, k, sms)
    batch = fe.linear(x, w, b, **kw)
    alone_kw = dict(kw, res=None if kw["res"] is None else kw["res"][:197])
    alone = fe.linear(x[:197], w, b, **alone_kw)
    torch.cuda.synchronize()
    assert torch.equal(alone, batch[:197])


@pytest.mark.parametrize("m,k,n", [(197, 192, 192), (197, 768, 192), (394, 230, 230)])
def test_linear_kernel_writes_over_its_own_residual(dev, m, k, n):
    """Y may be the residual (csrc/linear.cu reads each element's residual in
    the thread that writes it): epilogue 3 in place gives the bits of the
    call with a separate output, and epilogue 4 (ROW_BIAS, acc + res, which
    vit_full's tile uses) matches bf16(acc + f32(res))."""
    from edgevisiontransformer_tpu_torch.ops.cuda import build

    (x, w, b), kw = _linear_args(dev, m, k, n, fe.BIAS_RESIDUAL)
    want = fe.linear(x, w, b, **kw)
    lib, sms = build.load(), fe._sm_count(0)
    rows, cols = fe.linear_plan(m, n, k, sms)
    for epi, ref in ((3, want), (4, (x.float() @ w.float() + kw["res"].float()).bfloat16())):
        y = kw["res"].clone()
        build.check(lib.evt_linear(fe._ptr(x), fe._ptr(w), fe._ptr(b), fe._ptr(y), fe._ptr(y),
                                   m, n, k, epi, rows, cols, fe._stream(x)), "linear")
        if epi == 3:
            torch.cuda.synchronize()
            assert torch.equal(y, ref)
        else:
            _close(y, ref)


# The head dims of the kernels' instances at the multiples of 16 that no
# registry model uses (48, 80, 96, 112) and of their padded forms (24, ...,
# 120: ViT-g/14's 88 among them)
NEW_HEAD_DIMS = (24, 40, 48, 56, 72, 80, 88, 96, 104, 112, 120)

# deit_tiny, t2t_vit_14 (6 heads), the pruned model's one head, deit_base's
# 12, head_dim 16 (the layerwise pruned config: 5 tokens, 2 or 3 heads) to
# 128, padded and fully masked keys, deit_base at 384 (ten 64-key tiles),
# and every new head_dim at ViT-H/14's 257 tokens (five 64-key tiles, the
# last of one chunk) and with a padded, masked tail
ATTENTION_CASES = [
    (2, 197, 197, 3, 64), (1, 5, 5, 2, 32), (3, 64, 64, 2, 128),
    (2, 200, 197, 2, 64), (1, 70, 0, 1, 64), (1, 197, 197, 6, 64), (1, 197, 197, 1, 64),
    (128, 197, 197, 1, 64), (8, 197, 197, 12, 64), (1, 5, 5, 2, 16), (1, 5, 5, 3, 16),
    (4, 197, 197, 3, 16), (2, 200, 197, 4, 16), (1, 33, 0, 2, 16), (2, 577, 577, 12, 64),
    *((2, 257, 257, 2, hd) for hd in NEW_HEAD_DIMS),
    *((1, 200, 197, 2, hd) for hd in NEW_HEAD_DIMS)]


# fp16 at every case but the fully masked rows (seq_len 0): there the twin's
# float16 branch, as the reference's, averages every key (each at -1e30)
# where the kernel, which walks no key, writes zeros; no model masks every key
@pytest.mark.parametrize("dtype,batch,tokens,seq_len,heads,hd", [
    (dt, *case) for dt in DTYPES for case in ATTENTION_CASES
    if not (dt == torch.float16 and case[2] == 0)])
def test_attention_rows_kernel_matches_twin(dev, batch, tokens, seq_len, heads, hd, dtype):
    qkv = _rnd(dev, batch * tokens, 3 * heads * hd, dtype=dtype)
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


# A query row's output is the same bits alone (one image) and as image 0 of
# 128, and under every plan: each warp walks all of its keys alone.
@pytest.mark.parametrize("heads,hd", [(3, 64), (1, 64), (12, 64), (4, 16), (2, 128), (16, 80),
                                     (2, 88)])
def test_attention_rows_are_bit_identical_alone_and_in_a_batch(dev, monkeypatch, heads, hd):
    tokens = 197
    qkv = _rnd(dev, 128 * tokens, 3 * heads * hd)
    kw = dict(heads=heads, head_dim=hd, tokens=tokens)
    batch = fe.attention_rows(qkv, **kw)
    alone = fe.attention_rows(qkv[:tokens], **kw)
    forced = {}
    for warps in fe.ATTENTION_WARPS:
        monkeypatch.setattr(fe, "attention_plan", lambda *a, w=warps: w)
        forced[warps] = (fe.attention_rows(qkv, **kw), fe.attention_rows(qkv[:tokens], **kw))
        monkeypatch.undo()
    torch.cuda.synchronize()
    assert torch.equal(alone, batch[:tokens])
    for warps, (b, a) in forced.items():
        assert torch.equal(b, batch), warps
        assert torch.equal(a, alone), warps


@functools.lru_cache(maxsize=None)
def _tile_kernel():
    from edgevisiontransformer_tpu_torch.bench import attention_ab

    return attention_ab.build_libraries(source_variants=False)[1]


# The kernel against attn::tile (csrc/encoder_tiles.cuh, the WMMA tile that
# attention_rows and vit_full ran before their redesigns), built beside
# it: within the twin bound; -rP prints how many elements differ.
@pytest.mark.parametrize("batch,tokens,seq_len,heads,hd", [
    (128, 197, 197, 3, 64), (1, 197, 197, 3, 64), (1, 197, 197, 6, 64), (8, 197, 197, 12, 64),
    (128, 197, 197, 1, 64), (2, 200, 197, 2, 128), (4, 64, 64, 2, 32), (2, 577, 577, 12, 64)])
def test_attention_rows_agrees_with_the_wmma_tile(dev, batch, tokens, seq_len, heads, hd):
    from edgevisiontransformer_tpu_torch.bench import attention_ab

    qkv = _rnd(dev, batch * tokens, 3 * heads * hd, seed=4)
    kw = dict(heads=heads, head_dim=hd, tokens=tokens, seq_len=seq_len)
    got = fe.attention_rows(qkv, **kw)
    old = torch.empty_like(got)
    attention_ab.launch(_tile_kernel(), qkv, old, tokens, heads, hd, seq_len=seq_len)
    _close(got, old)
    diff = (got.float() - old.float()).abs()
    print(f"attention_rows vs the WMMA tile, b{batch} n{tokens} s{seq_len} h{heads} d{hd}: "
          f"{int((diff > 0).sum())} of {diff.numel()} elements differ, max {float(diff.max()):.3g}")


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
    assert fe.LAUNCHES == {"ln_rows": 4, "linear": 8, "attention_rows": 2, "quant_rows": 0,
                           "linear_i8": 0}
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
    with pytest.raises(ValueError, match="bad bias"):
        fe.linear(xb, torch.zeros(16, 12, device=dev, dtype=torch.bfloat16),
                  torch.zeros(8, device=dev, dtype=torch.bfloat16),
                  epilogue=fe.CAST_THEN_BIAS)
    with pytest.raises(ValueError, match="head_dim"):
        fe.attention_rows(torch.zeros(10, 3 * 136, device=dev, dtype=torch.bfloat16),
                          heads=1, head_dim=136, tokens=5)


def _float16_calls(dev, w16=torch.float16):
    """One call of every kernel wrapper on fp16 activations, their weights
    in ``w16``: ``{kernel: call}``."""
    h = torch.float16
    x = _rnd(dev, 197, 192, dtype=h)
    g, b = _rnd(dev, 192, dtype=w16) + 1, _rnd(dev, 192, dtype=w16)
    w, bias = _rnd(dev, 192, 64, scale=0.1, dtype=w16), _rnd(dev, 64, dtype=w16)
    g4, b4 = _rnd(dev, 384, dtype=w16) + 1, _rnd(dev, 384, dtype=w16)
    q, w_q = _int8(dev, 197, 192), _int8(dev, 192, 64, seed=1)
    w_s = _uniform(dev, 64, seed=2) * 1e-4
    qkv_w, bias16, mask = _sdpa_inputs(dev, 1, 14, 7, 2, 32, True, dtype=h)
    qkv_s, bias_f, mask_s = _window_inputs(dev, 1, 14, 7, 2, 32, True, dtype=h)
    w1, b1 = _rnd(dev, 192, 384, scale=0.1, dtype=w16), _rnd(dev, 384, dtype=w16)
    w2, b2 = _rnd(dev, 384, 192, scale=0.1, dtype=w16), _rnd(dev, 192, dtype=w16)
    sq, sk, sv = _qkv_views(dev, 1, 3, 197, 64, dtype=h)
    img, w9 = _images(dev, "normal", 1, h), _stage1_weights(dev, dtype=w16)
    xk, pp, pw = _performer_inputs(dev, 1, 784, dtype=h)
    ops = pf.performer_operands(pp, pw, w16)
    model, prep = _full_model(dev, dtype=w16)
    fimg = torch.randn(1, 3, 224, 224, device=dev).to(h)
    return {
        "ln_rows": lambda: fe.ln_rows(x, g, b, 1e-6),
        "linear": lambda: fe.linear(x, w, bias, epilogue=fe.CAST_THEN_BIAS),
        "attention_rows": lambda: fe.attention_rows(_rnd(dev, 197, 576, dtype=h), heads=3,
                                                    head_dim=64, tokens=197),
        "quant_rows": lambda: fe.quant_rows(x),
        "linear_i8": lambda: fe.linear_i8(q, None, w_q, w_s, bias, epilogue=fe.BIAS,
                                          out_dtype=h),
        "stage1_kqv": lambda: ts.stage1_kqv(img, *w9),
        "window_attention": lambda: sb.window_attention(qkv_s, bias_f, mask_s, res=14, window=7,
                                                        shift=3, heads=2, head_dim=32),
        "swin_merge": lambda: sm.swin_merge(x[:196, :96].contiguous(), g4, b4, res=14,
                                            eps=1e-5),
        "window_sdpa": lambda: ws.window_sdpa(qkv_w, bias16.to(w16), mask, heads=2, head_dim=32),
        "sdpa": lambda: fa.sdpa(sq, sk.to(w16), sv.to(w16)),
        "mlp": lambda: fm.mlp(x, w1, b1, w2, b2),
        "vit_full": lambda: tvit.fully_fused_vit_apply(model, fimg, prepared=prep),
        "performer_reduce": lambda: pf.performer_reduce(xk, pw, operands=ops),
        "performer_rows": lambda: pf.performer_rows(xk, pf.performer_reduce_plain(xk, pw), pp,
                                                    pw, eps_ln=1e-5, approx_gelu=True,
                                                    operands=ops),
    }


def test_float16_outputs_come_back_as_float16(dev):
    """Every kernel's fp16 instance writes fp16 (quant_rows int8 and fp32
    scales, performer_reduce its fp32 sums), one launch each."""
    want = {"quant_rows": torch.int8, "performer_reduce": torch.float32}
    for name, call in _float16_calls(dev).items():
        _reset_all()
        out = call()
        torch.cuda.synchronize()
        out = out[0] if isinstance(out, tuple) else out
        assert out.dtype == want.get(name, torch.float16), name
        assert torch.isfinite(out.float()).all(), name
        assert _all_counts()[name] == 1, name


def test_float16_activations_with_bfloat16_weights_raise(dev):
    """No wrapper casts: fp16 activations with bf16 weights (or a bf16
    operand among fp16 ones) raise TypeError, for every kernel that takes
    more than one 16-bit tensor."""
    for name, call in _float16_calls(dev, w16=torch.bfloat16).items():
        if name in ("quant_rows", "attention_rows", "window_attention"):
            continue  # one 16-bit tensor (window_attention's bias and mask are fp32)
        with pytest.raises(TypeError):
            call()


# ---------------------------------------------------------------------------
# int8: quant_rows and linear_i8
# ---------------------------------------------------------------------------


def _int8(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)


def _uniform(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(*shape, generator=g, device=dev) + 0.5


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("rows,k", [(1, 16), (197, 192), (197, 768), (1576, 3072),
                                    (25216, 192), (9, 48)])
def test_quant_rows_kernel_equals_twin(dev, rows, k, static, dtype):
    h = _rnd(dev, rows, k, scale=3.0, dtype=dtype)
    h[0] = 0  # absmax 0: s = 1
    act_inv = (30.0 * _uniform(dev, 3, 4, seed=1)).contiguous() if static else None
    q, s = fe.quant_rows(h, act_inv, 7)
    q_p, s_p = fe.quant_rows_plain(h, act_inv, 7)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and torch.equal(q, q_p)
    assert (s is None) == static and (static or torch.equal(s, s_p))


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("m,k,n", [(1, 16, 16), (197, 192, 576), (197, 768, 3072),
                                   (1576, 3072, 768), (300, 208, 144)])
@pytest.mark.parametrize("epilogue,approx", [
    (fe.BIAS, False), (fe.BIAS_GELU, False), (fe.BIAS_GELU, True), (fe.BIAS_RESIDUAL, False)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_linear_i8_kernel_matches_twin(dev, m, k, n, epilogue, approx, static, dtype):
    """Bit for bit, except the GELU epilogue (erff / tanhf against torch's);
    the output and the residual in each dtype (fp16 at odd m with an fp16
    bias)."""
    unit = 1.0 / (73.0 * 73.0 * k ** 0.5)
    q, w_q = _int8(dev, m, k), _int8(dev, k, n, seed=1)
    s_row = None if static else _uniform(dev, m, seed=2) * 0.05
    w_s = _uniform(dev, n, seed=3) * (unit if static else unit / 0.05)
    b = torch.randn(n, device=dev)
    if dtype == torch.float16 and m % 2:  # a bias in the compute dtype, as Swin's int8 stages
        b = b.to(dtype)
    res = _rnd(dev, m, n, seed=4, dtype=dtype) if epilogue == fe.BIAS_RESIDUAL else None
    kw = dict(epilogue=epilogue, out_dtype=dtype, res=res, approx_gelu=approx)
    got = fe.linear_i8(q, s_row, w_q, w_s, b, **kw)
    ref = fe.linear_i8_plain(q, s_row, w_q, w_s, b, **kw)
    if epilogue == fe.BIAS_GELU:
        _close(got, ref)
    else:
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (got.float() - ref.float()).abs().max()


# linear_i8's epilogues as (epilogue, approx_gelu): csrc/linear_i8.cu codes 0-3
LINEAR_I8_EPILOGUES = [(fe.BIAS, False), (fe.BIAS_GELU, True), (fe.BIAS_GELU, False),
                       (fe.BIAS_RESIDUAL, False)]


def _i8_args(dev, m, k, n, epilogue, approx, static, bias_dtype=torch.float32, seed=0):
    """Int8 operands and scales that give a dequantized sum of order 1."""
    unit = 1.0 / (73.0 * 73.0 * k ** 0.5)
    q, w_q = _int8(dev, m, k, seed=seed), _int8(dev, k, n, seed=seed + 1)
    s_row = None if static else _uniform(dev, m, seed=seed + 2) * 0.05
    w_s = _uniform(dev, n, seed=seed + 3) * (unit if static else unit / 0.05)
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    b = torch.randn(n, generator=g, device=dev).to(bias_dtype)
    res = _rnd(dev, m, n, seed=seed + 4) if epilogue == fe.BIAS_RESIDUAL else None
    return (q, s_row, w_q, w_s, b), dict(epilogue=epilogue, out_dtype=torch.bfloat16, res=res,
                                         approx_gelu=approx)


# Every block shape csrc/linear_i8.cu is compiled for, on the 16-byte path
# and the element-wise ones (K = 230, N = 537), gives the default plan's
# bits in every epilogue and both modes: K is never split and int32 sums
# are exact.
@pytest.mark.parametrize("m,k,n", [(197, 192, 576), (197, 230, 192), (394, 192, 537),
                                   (25216, 768, 192)])
def test_linear_i8_every_plan_gives_the_same_bits(dev, monkeypatch, m, k, n):
    outs = {}
    for static in (False, True):
        for epilogue, approx in LINEAR_I8_EPILOGUES:
            args, kw = _i8_args(dev, m, k, n, epilogue, approx, static)
            want = fe.linear_i8(*args, **kw)
            for rows in fe.LINEAR_I8_ROWS:
                for cols in fe.LINEAR_I8_COLS:
                    monkeypatch.setattr(fe, "linear_i8_plan",
                                        lambda *a, r=rows, c=cols, **_: (r, c, 1))
                    outs[(static, epilogue, approx, rows, cols)] = (fe.linear_i8(*args, **kw),
                                                                    want)
                    monkeypatch.undo()
    torch.cuda.synchronize()
    differ = [key for key, (got, want) in outs.items() if not torch.equal(got, want)]
    assert not differ


# Every split of K's steps over a cluster (1 to 8 blocks, some with no step
# where the steps are fewer) gives the unsplit bits: rank 0 adds exact int32
# partials.
@pytest.mark.parametrize("m,k,n", [(197, 768, 192), (197, 3072, 768), (49, 3072, 768),
                                   (197, 192, 576), (197, 230, 192), (394, 1152, 537)])
def test_linear_i8_every_split_gives_the_same_bits(dev, monkeypatch, m, k, n):
    sms = fe._sm_count(0)
    rows, cols, _ = fe.linear_i8_plan(m, n, k, sms)
    outs = {}
    for static in (False, True):
        for epilogue, approx in LINEAR_I8_EPILOGUES:
            args, kw = _i8_args(dev, m, k, n, epilogue, approx, static)
            monkeypatch.setattr(fe, "linear_i8_plan", lambda *a, **_: (rows, cols, 1))
            want = fe.linear_i8(*args, **kw)
            for split in range(2, 9):
                monkeypatch.setattr(fe, "linear_i8_plan", lambda *a, s=split, **_: (rows, cols, s))
                outs[(static, epilogue, approx, split)] = (fe.linear_i8(*args, **kw), want)
            monkeypatch.undo()
    torch.cuda.synchronize()
    differ = [key for key, (got, want) in outs.items() if not torch.equal(got, want)]
    assert not differ


# A row's output is the same bits alone (b1, the plan's narrow tiles) and
# as one of 128 images (128-row tiles), in every epilogue and both modes.
@pytest.mark.parametrize("k,n", [(192, 576), (192, 192), (192, 768), (768, 192), (192, 230),
                                 (3072, 768)])
@pytest.mark.parametrize("static", [False, True])
def test_linear_i8_rows_are_bit_identical_alone_and_in_a_batch(dev, k, n, static):
    sms = fe._sm_count(0)
    assert fe.linear_i8_plan(197, n, k, sms) != fe.linear_i8_plan(128 * 197, n, k, sms)
    for epilogue, approx in LINEAR_I8_EPILOGUES:
        (q, s_row, w_q, w_s, b), kw = _i8_args(dev, 128 * 197, k, n, epilogue, approx, static)
        batch = fe.linear_i8(q, s_row, w_q, w_s, b, **kw)
        alone_kw = dict(kw, res=None if kw["res"] is None else kw["res"][:197])
        alone = fe.linear_i8(q[:197], None if static else s_row[:197], w_q, w_s, b, **alone_kw)
        torch.cuda.synchronize()
        assert torch.equal(alone, batch[:197]), (epilogue, approx)


# The kernel against the WMMA kernel it replaced (its source in
# bench/linear_i8_ab.py): the same bits in every epilogue, both modes and
# both bias types, at deit_tiny b1 and b128, deit_base b1, Swin's int8
# stages (1-3 at b1, 1 at b32) and the pruned widths 230 and 537.
@pytest.mark.parametrize("m,k,n", [(197, 192, 576), (25216, 192, 768), (25216, 768, 192),
                                   (197, 768, 2304), (197, 3072, 768), (784, 192, 576),
                                   (196, 384, 1536), (49, 3072, 768), (25088, 192, 576),
                                   (197, 192, 230), (197, 230, 192), (394, 192, 537),
                                   (197, 537, 192), (5, 13, 7)])
def test_linear_i8_equals_the_wmma_kernel_bit_for_bit(dev, m, k, n):
    from edgevisiontransformer_tpu_torch.bench import linear_i8_ab

    parent = linear_i8_ab.wmma_kernel()
    differ = []
    for static in (False, True):
        for bias_dtype in (torch.float32, torch.bfloat16):
            for epilogue, approx in LINEAR_I8_EPILOGUES:
                (q, s_row, w_q, w_s, b), kw = _i8_args(dev, m, k, n, epilogue, approx, static,
                                                       bias_dtype)
                got = fe.linear_i8(q, s_row, w_q, w_s, b, **kw)
                old = torch.empty_like(got)
                linear_i8_ab.launch(parent, q, s_row, w_q, w_s, b, kw["res"], old,
                                    fe._I8_EPI_CODES[(epilogue, approx)])
                torch.cuda.synchronize()
                if not torch.equal(got, old):
                    differ.append((static, bias_dtype, epilogue, approx, int((got != old).sum())))
    assert not differ


def test_bf16_glue_matches_twin(dev):
    """A bf16 bias (stacks_from_quantized_tree of a bf16 model) and an fp32
    LayerNorm affine (the int8 stacks)."""
    q, w_q = _int8(dev, 197, 192), _int8(dev, 192, 576, seed=1)
    w_s = _uniform(dev, 576, seed=2) * 1e-5
    b = _rnd(dev, 576, seed=3)
    kw = dict(epilogue=fe.BIAS, out_dtype=torch.bfloat16)
    got = fe.linear_i8(q, None, w_q, w_s, b, **kw)
    assert torch.equal(got, fe.linear_i8_plain(q, None, w_q, w_s, b, **kw))
    x = _rnd(dev, 197, 192, scale=3.0)
    g, bb = torch.randn(192, device=dev) + 1, torch.randn(192, device=dev)
    _close(fe.ln_rows(x, g, bb, 1e-6), fe.ln_rows_plain(x, g, bb, 1e-6))


@pytest.mark.parametrize("static,reference_residual,approx", [
    (False, False, False), (True, False, False), (True, True, True)])
def test_encoder_forward_int8_kernels_match_twins_and_count(dev, static, reference_residual,
                                                            approx):
    cfg = deit_config("tiny", depth=2, dtype=torch.bfloat16)
    model = ViT(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    batches = [torch.randn(1, 3, 224, 224, generator=torch.Generator().manual_seed(i)).numpy()
               for i in range(2)]
    sq = (prepare_vit_int8_static(model, calib_batches=batches) if static
          else prepare_vit_int8(model))
    x = _rnd(dev, 3, 197, 192)
    kw = dict(heads=3, head_dim=64, eps=1e-6, reference_residual=reference_residual,
              approx_gelu=approx)
    fe.reset_launches()
    got = fe.encoder_forward_int8(x, sq, **kw)
    assert fe.LAUNCHES == {"ln_rows": 4, "linear": 0, "attention_rows": 2, "quant_rows": 8,
                           "linear_i8": 8}
    ref = fe.encoder_forward_int8_plain(x, sq, **kw)
    torch.cuda.synchronize()
    # a bf16 flip before a quantization moves a value into the next bucket
    assert (got.float() - ref.float()).abs().max() <= 0.05 * ref.float().abs().max()


@pytest.mark.parametrize("static", [False, True])
def test_fused_vit_apply_int8_on_kernels_matches_plain(dev, static):
    model = ViT(deit_config("tiny", depth=2, dtype=torch.bfloat16), device=dev,
                generator=torch.Generator().manual_seed(1))
    img = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(2)).to(dev)
    with torch.no_grad():
        sq = (prepare_vit_int8_static(model, calib_batches=[img[:1].cpu().numpy()]) if static
              else prepare_vit_int8(model))
        got = fused_vit_apply_int8(model, img, stacked_q=sq)
        ref = fused_vit_apply_int8(model, img, stacked_q=sq, plain=True)
    torch.cuda.synchronize()
    assert got.shape == (2, 1000) and torch.isfinite(got.float()).all()
    assert (got.float() - ref.float()).abs().max() <= 0.05 * ref.float().abs().max()


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(dev):
    h = _rnd(dev, 2, 8, 24)
    with pytest.raises(ValueError, match=r"\[M, K\]"):
        fe.quant_rows(h)
    with pytest.raises(TypeError, match="float32"):
        fe.quant_rows(_rnd(dev, 8, 32), torch.ones(2, 4, device=dev, dtype=torch.float64))
    q, w_q = _int8(dev, 8, 32), _int8(dev, 32, 24)
    ones = torch.ones(24, device=dev)
    with pytest.raises(ValueError, match="bad scale"):
        fe.linear_i8(q, None, w_q, ones[:16], ones, epilogue=fe.BIAS, out_dtype=torch.bfloat16)
    w_q = _int8(dev, 32, 32)
    ones = torch.ones(32, device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        fe.linear_i8(q, None, w_q, ones, ones, epilogue=fe.BIAS, out_dtype=torch.float32)
    with pytest.raises(TypeError, match="int8"):
        fe.linear_i8(q.float(), None, w_q, ones, ones, epilogue=fe.BIAS,
                     out_dtype=torch.bfloat16)


# ---------------------------------------------------------------------------
# T2T-ViT: stage1_kqv
# ---------------------------------------------------------------------------


def _stage1_weights(dev, d=192, seed=0, dtype=torch.bfloat16):
    """W9, M9, c1, c2 of a random performer1 (kqv kernel, bias, norm1 affine)."""
    rng = np.random.RandomState(seed)
    w = t2t.build_stage1_weights(rng.randn(147, d) * 147 ** -0.5, rng.randn(d) * 0.1,
                                 1.0 + 0.1 * rng.randn(147), 0.1 * rng.randn(147))
    return w[0].to(dev, dtype), w[1].to(dev), w[2].to(dev), w[3].to(dev)


def _images(dev, kind, batch, dtype=torch.bfloat16):
    if kind == "normal":
        return _rnd(dev, batch, 3, 224, 224, dtype=dtype)
    value = {"ones": 1.0, "zeros": 0.0}[kind]  # a constant image: var ~ 0 in the interior
    return torch.full((batch, 3, 224, 224), value, device=dev, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["normal", "ones", "zeros"])
@pytest.mark.parametrize("batch,d", [(1, 192), (4, 192), (2, 64), (2, 256)])
def test_stage1_kqv_kernel_matches_twin_and_counts(dev, batch, d, kind, dtype):
    img, w = _images(dev, kind, batch, dtype), _stage1_weights(dev, d, dtype=dtype)
    ts.reset_launches()
    got = ts.stage1_kqv(img, *w)
    assert ts.LAUNCHES["stage1_kqv"] == 1
    _close(got, ts.stage1_kqv_plain(img, *w))


def test_stage1_kqv_image_bits_alone_and_in_a_batch(dev):
    """Each block reads and writes one image: image 2 of b4 is image 2 alone."""
    img, w = _images(dev, "normal", 4), _stage1_weights(dev)
    both, alone = ts.stage1_kqv(img, *w), ts.stage1_kqv(img[2:3].contiguous(), *w)
    torch.cuda.synchronize()
    assert torch.equal(both[2:3], alone)


@pytest.mark.parametrize("batch,d", [(1, 192), (2, 64)])
def test_stage1_kqv_every_plan_gives_the_same_bits(dev, monkeypatch, batch, d):
    img, w = _images(dev, "normal", batch), _stage1_weights(dev, d)
    ref = ts.stage1_kqv(img, *w)
    for cols in ts.STAGE1_COLS:
        monkeypatch.setattr(ts, "stage1_plan", lambda *_, cols=cols: cols)
        got = ts.stage1_kqv(img, *w)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), cols


def test_stage1_kqv_graph_replays_equal_the_eager_call(dev):
    img, w = _images(dev, "normal", 2), _stage1_weights(dev)
    eager = ts.stage1_kqv(img, *w)
    _graph_replays_equal(lambda: ts.stage1_kqv(img, *w), eager)


@functools.lru_cache(maxsize=None)
def _parent_stage1():
    from edgevisiontransformer_tpu_torch.bench import stage1_ab

    return stage1_ab.build_libraries()[1]


@pytest.mark.parametrize("batch,d", [(1, 192), (4, 192), (2, 64)])
def test_stage1_kqv_agrees_with_the_parent_kernel(dev, batch, d):
    from edgevisiontransformer_tpu_torch.bench import stage1_ab

    img, w = _images(dev, "normal", batch), _stage1_weights(dev, d)
    got = ts.stage1_kqv(img, *w)
    run, old = stage1_ab.call(_parent_stage1(), img, w, cols=0)
    run()
    _close(got, old)
    diff = (got.float() - old.float()).abs()
    print(f"stage1_kqv vs the parent's WMMA kernel, b{batch} d{d}: {int((diff > 0).sum())} of "
          f"{diff.numel()} elements differ, max {float(diff.max()):.3g}")


def _graph_replays_equal(fn, eager):
    """Capture ``fn`` in a CUDA graph; two replays give the eager call's bits."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_stage1_kqv_empty_batch_launches_nothing(dev):
    ts.reset_launches()
    got = ts.stage1_kqv(_images(dev, "zeros", 0), *_stage1_weights(dev))
    assert got.shape == (0, 3136, 192) and ts.LAUNCHES["stage1_kqv"] == 0


@pytest.mark.parametrize("int8", [False, True])
def test_fused_t2t_apply_on_kernels_matches_plain_and_counts(dev, int8):
    model = t2t.T2TViT(t2t.t2t_vit_config(7, depth=2, dtype=torch.bfloat16), device=dev,
                       generator=torch.Generator().manual_seed(1))
    img = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(2)).to(dev)
    with torch.no_grad():
        if int8:
            sq = t2t.prepare_t2t_int8_static(model, calib_batches=[img[:1].cpu().numpy()])
            run = lambda **kw: t2t.fused_t2t_apply_int8(model, img, stacked_q=sq, **kw)  # noqa: E731
        else:
            run = lambda **kw: t2t.fused_t2t_apply(model, img, **kw)  # noqa: E731
        fe.reset_launches()
        ts.reset_launches()
        got = run()
        counts = {**fe.LAUNCHES, **ts.LAUNCHES}
        ref = run(plain=True)
    per_layer = ({"ln_rows": 2, "linear": 0, "attention_rows": 1, "quant_rows": 4, "linear_i8": 4}
                 if int8 else
                 {"ln_rows": 2, "linear": 4, "attention_rows": 1, "quant_rows": 0, "linear_i8": 0})
    assert counts == {**{k: 2 * v for k, v in per_layer.items()}, "stage1_kqv": 1}
    torch.cuda.synchronize()
    assert got.shape == (2, 1000) and torch.isfinite(got.float()).all()
    assert (got.float() - ref.float()).abs().max() <= 0.05 * ref.float().abs().max()


def test_stage1_kqv_refuses_what_the_kernel_does_not_take(dev):
    w = _stage1_weights(dev)
    img = _images(dev, "normal", 1)
    with pytest.raises(TypeError, match="bfloat16"):
        ts.stage1_kqv(img.float(), *w)
    with pytest.raises(TypeError, match="float32"):
        ts.stage1_kqv(img, w[0], w[1].bfloat16(), w[2], w[3])
    with pytest.raises(ValueError, match="224"):
        ts.stage1_kqv(_rnd(dev, 1, 3, 64, 64), *w)
    with pytest.raises(ValueError, match="432"):
        ts.stage1_kqv(img, w[0][:431].contiguous(), *w[1:])
    w24 = _stage1_weights(dev, 24)
    with pytest.raises(ValueError, match="multiple of 16"):
        ts.stage1_kqv(img, *w24)
    with pytest.raises(ValueError, match="multiple of 16"):
        ts.stage1_kqv(img, *_stage1_weights(dev, 272))


# ---------------------------------------------------------------------------
# Swin: window_attention and swin_merge
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634


def _window_inputs(dev, batch, res, w, heads, hd, shifted, seed=0, dtype=torch.bfloat16):
    """qkv, a log2(e)-scaled bias [heads, n, n] and, when shifted, the
    stage's log2(e)-scaled mask, as prepare_swin_fused builds them."""
    n = w * w
    qkv = _rnd(dev, batch * res * res, 3 * heads * hd, seed=seed, dtype=dtype)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    bias = torch.randn(heads, n, n, generator=g, device=dev) * (0.5 * LOG2E)
    mask = (torch.from_numpy(swin.shifted_window_mask(res, res, w, w // 2)).to(dev) * LOG2E
            if shifted else None)
    return qkv, bias, mask


@pytest.mark.parametrize("batch,res,w,heads,hd,shifted", [
    (1, 56, 7, 3, 32, False), (1, 56, 7, 3, 32, True), (2, 28, 7, 6, 32, True),
    (2, 14, 7, 12, 32, True), (2, 7, 7, 24, 32, False), (2, 8, 4, 2, 64, True),
    (1, 16, 8, 2, 64, True), (2, 18, 9, 2, 32, False), (2, 18, 9, 2, 32, True),
    (1, 96, 12, 4, 32, False), (1, 96, 12, 4, 32, True), (2, 24, 12, 2, 64, False),
    (2, 24, 12, 2, 64, True)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_window_attention_kernel_matches_twin_and_counts(dev, batch, res, w, heads, hd, shifted,
                                                         dtype):
    """swin_tiny's four stage shapes, head_dim 64, a full 64-token window,
    windows of 9 (n = 81: 9 chunks, 63 keys zero-filled) and of 12 (Swin-B
    at 384's first stage, and head_dim 64), shifted and not; fp16 on the
    float16 softmax (the row max)."""
    qkv, bias, mask = _window_inputs(dev, batch, res, w, heads, hd, shifted, dtype=dtype)
    kw = dict(res=res, window=w, shift=w // 2 if shifted else 0, heads=heads, head_dim=hd)
    sb.reset_launches()
    got = sb.window_attention(qkv, bias, mask, **kw)
    assert sb.LAUNCHES["window_attention"] == 1
    _close(got, sb.window_attention_plain(qkv, bias, mask, **kw))


def test_window_attention_clamp60_rows_tie(dev):
    qkv, bias, mask = _window_inputs(dev, 1, 14, 7, 1, 32, True)
    qkv[:20, :64] *= 8  # q and k large: log2-scaled scores far above 60
    kw = dict(res=14, window=7, shift=3, heads=1, head_dim=32)
    _close(sb.window_attention(qkv, bias, mask, **kw),
           sb.window_attention_plain(qkv, bias, mask, **kw))


def test_window_attention_refuses_what_the_kernel_does_not_take(dev):
    qkv, bias, mask = _window_inputs(dev, 1, 14, 7, 2, 32, True)
    kw = dict(res=14, window=7, shift=3, heads=2, head_dim=32)
    with pytest.raises(TypeError, match="bfloat16"):
        sb.window_attention(qkv.float(), bias, mask, **kw)
    with pytest.raises(TypeError, match="float32"):
        sb.window_attention(qkv, bias.bfloat16(), mask, **kw)
    with pytest.raises(ValueError, match="res % window"):
        sb.window_attention(qkv, bias, mask, **{**kw, "window": 5})
    with pytest.raises(ValueError, match="head_dim"):
        sb.window_attention(_rnd(dev, 196, 3 * 48), bias[:1], mask,
                            **{**kw, "heads": 1, "head_dim": 48})
    q13, b13, _ = _window_inputs(dev, 1, 26, 13, 1, 32, False)
    with pytest.raises(ValueError, match="at most 144"):
        sb.window_attention(q13, b13, None, res=26, window=13, shift=0, heads=1, head_dim=32)


# A window's output is the same bits alone (one image) and as image 0 of
# 32: each (window, head, image) runs the same instructions.
@pytest.mark.parametrize("res,heads,w,shifted", [(56, 3, 7, True), (28, 6, 7, True),
                                                 (14, 12, 7, False), (7, 24, 7, False),
                                                 (24, 2, 12, True), (24, 2, 12, False)])
def test_window_attention_is_bit_identical_alone_and_in_a_batch(dev, res, heads, w, shifted):
    qkv, bias, mask = _window_inputs(dev, 32, res, w, heads, 32, shifted)
    kw = dict(res=res, window=w, shift=w // 2 if shifted else 0, heads=heads, head_dim=32)
    batch = sb.window_attention(qkv, bias, mask, **kw)
    alone = sb.window_attention(qkv[:res * res], bias, mask, **kw)
    torch.cuda.synchronize()
    assert torch.equal(alone, batch[:res * res])


@functools.lru_cache(maxsize=None)
def _wmma_window_attention():
    from edgevisiontransformer_tpu_torch.bench import window_attention_ab

    return window_attention_ab.build_libraries(source_variants=False)[1]


# The kernel against the WMMA kernel it replaced (its source in
# bench/window_attention_ab.py, built beside it): within the twin bound;
# -rP prints how many elements differ.
@pytest.mark.parametrize("batch,res,heads,shifted", [
    (1, 56, 3, False), (1, 56, 3, True), (1, 28, 6, True), (1, 14, 12, True), (1, 7, 24, False),
    (32, 56, 3, True), (32, 14, 12, False)])
def test_window_attention_agrees_with_the_wmma_kernel(dev, batch, res, heads, shifted):
    from edgevisiontransformer_tpu_torch.bench import window_attention_ab

    qkv, bias, mask = _window_inputs(dev, batch, res, 7, heads, 32, shifted, seed=4)
    shift = 3 if shifted else 0
    got = sb.window_attention(qkv, bias, mask, res=res, window=7, shift=shift, heads=heads,
                              head_dim=32)
    old = torch.empty_like(got)
    window_attention_ab.launch(_wmma_window_attention(), qkv, bias, mask, old, res, 7, shift,
                               heads, 32)
    _close(got, old)
    diff = (got.float() - old.float()).abs()
    print(f"window_attention vs the WMMA kernel, b{batch} res{res} h{heads} "
          f"{'shifted' if shifted else 'unshifted'}: {int((diff > 0).sum())} of {diff.numel()} "
          f"elements differ, max {float(diff.max()):.3g}")


def _merge_args(dev, batch, res, c, affine="float32", seed=0, dtype=torch.bfloat16):
    """x (``dtype``) and the affine g, b (``affine``) of one merge."""
    x = _rnd(dev, batch * res * res, c, scale=3.0, seed=seed, dtype=dtype)
    dt = getattr(torch, affine)
    g = (_rnd(dev, 4 * c, seed=seed + 1, scale=0.5) + 1).to(dt)
    b = _rnd(dev, 4 * c, seed=seed + 2, scale=0.5).to(dt)
    return x, g, b


# swin_tiny's three merges at 224: (C, resolution)
SWIN_TINY_MERGES = [(96, 56), (192, 28), (384, 14)]


@pytest.mark.parametrize("dtype,affine", [(torch.bfloat16, "float32"),
                                          (torch.bfloat16, "bfloat16"),
                                          (torch.float16, "float32"), (torch.float16, "float16")])
@pytest.mark.parametrize("batch,res,c", [(1, 56, 96), (2, 28, 192), (2, 14, 384), (3, 8, 16)])
def test_swin_merge_kernel_matches_twin_and_counts(dev, batch, res, c, affine, dtype):
    x, g, b = _merge_args(dev, batch, res, c, affine, dtype=dtype)
    sm.reset_launches()
    got = sm.swin_merge(x, g, b, res=res, eps=1e-5)
    assert sm.LAUNCHES["swin_merge"] == 1 and got.shape == (batch * (res // 2) ** 2, 4 * c)
    _close(got, sm.swin_merge_plain(x, g, b, res=res, eps=1e-5))


@pytest.mark.parametrize("c,res", SWIN_TINY_MERGES)
def test_swin_merge_image_bits_alone_and_in_a_batch(dev, c, res):
    x, g, b = _merge_args(dev, 32, res, c, seed=7)
    both = sm.swin_merge(x, g, b, res=res, eps=1e-5)
    rows, out = res * res, (res // 2) ** 2
    alone = sm.swin_merge(x[5 * rows:6 * rows].contiguous(), g, b, res=res, eps=1e-5)
    torch.cuda.synchronize()
    assert torch.equal(both[5 * out:6 * out], alone)


@pytest.mark.parametrize("batch", [1, 32])
def test_swin_merge_graph_replays_equal_the_eager_call(dev, batch):
    x, g, b = _merge_args(dev, batch, 56, 96, seed=9)
    eager = sm.swin_merge(x, g, b, res=56, eps=1e-5)
    _graph_replays_equal(lambda: sm.swin_merge(x, g, b, res=56, eps=1e-5), eager)


def test_swin_merge_refuses_what_the_kernel_does_not_take(dev):
    g, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    with pytest.raises(ValueError, match="even"):
        sm.swin_merge(_rnd(dev, 49, 16), g, b, res=7, eps=1e-5)
    with pytest.raises(ValueError, match="multiple of 8"):
        sm.swin_merge(_rnd(dev, 16, 12), g[:48], b[:48], res=4, eps=1e-5)
    with pytest.raises(ValueError, match="one dtype"):
        sm.swin_merge(_rnd(dev, 16, 16), g, b.bfloat16(), res=4, eps=1e-5)
    with pytest.raises(TypeError, match="bfloat16"):
        sm.swin_merge(_rnd(dev, 16, 16).float(), g, b, res=4, eps=1e-5)


def _swin_model(dev, dtype=torch.bfloat16):
    """swin_tiny's widths (dim 96, head_dim 32) at image 112: three stages
    (res 28, 14, 7), two merges."""
    cfg = swin.swin_config("tiny", image_size=112, depths=(2, 2, 2), num_heads=(3, 6, 12),
                           dtype=dtype)
    return swin.SwinTransformer(cfg, device=dev, generator=torch.Generator().manual_seed(1))


def test_swin_stage_forward_kernels_match_twins_and_count(dev):
    model = _swin_model(dev)
    stage = swin.prepare_swin_fused(model)["stages"][0]
    x = _rnd(dev, 2 * 28 * 28, 96)
    kw = dict(res=28, window=7, heads=3, head_dim=32, eps=1e-5)
    fe.reset_launches()
    sb.reset_launches()
    got = sb.swin_stage_forward(x, stage, **kw)
    counts = {**fe.LAUNCHES, **sb.LAUNCHES}
    assert counts == {"ln_rows": 4, "linear": 8, "attention_rows": 0, "quant_rows": 0,
                      "linear_i8": 0, "window_attention": 2}
    ref = sb.swin_stage_forward_plain(x, stage, **kw)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max() <= 0.03 * ref.float().abs().max()


def test_fused_swin_apply_on_kernels_matches_plain_and_counts(dev):
    model = _swin_model(dev)
    img = torch.randn(2, 3, 112, 112, generator=torch.Generator().manual_seed(2)).to(dev)
    with torch.no_grad():
        prepared = swin.prepare_swin_fused(model)
        fe.reset_launches()
        sb.reset_launches()
        sm.reset_launches()
        got = swin.fused_swin_apply(model, img, prepared=prepared)
        counts = {**fe.LAUNCHES, **sb.LAUNCHES, **sm.LAUNCHES}
        ref = swin.fused_swin_apply(model, img, prepared=prepared, plain=True)
    # six blocks: ln_rows 2, linear 4, window_attention 1 each; two merges:
    # swin_merge 1, linear 1 each
    assert counts == {"ln_rows": 12, "linear": 26, "attention_rows": 0, "quant_rows": 0,
                      "linear_i8": 0, "window_attention": 6, "swin_merge": 2}
    torch.cuda.synchronize()
    assert got.shape == (2, 1000) and torch.isfinite(got.float()).all()
    assert (got.float() - ref.float()).abs().max() <= 0.05 * ref.float().abs().max()


def test_fused_swin_apply_fp32_on_the_card_raises(dev):
    model = _swin_model(dev, torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        swin.fused_swin_apply(model, torch.zeros(1, 3, 112, 112, device=dev))


# ---------------------------------------------------------------------------
# Swin: window_sdpa (K12), the int8 stage chain, the module's K12 path
# ---------------------------------------------------------------------------


def _sdpa_inputs(dev, batch, res, w, heads, hd, shifted, seed=0, dtype=torch.bfloat16):
    """Window-major qkv of ``batch`` images, a bias [heads, n, n] in its
    dtype and, when shifted, the stage's fp32 mask, as the module passes
    them."""
    n, nw = w * w, (res // w) ** 2
    qkv = _rnd(dev, batch * nw, n, 3 * heads * hd, seed=seed, dtype=dtype)
    bias = _rnd(dev, heads, n, n, scale=0.5, seed=seed + 1, dtype=dtype)
    mask = (torch.from_numpy(swin.shifted_window_mask(res, res, w, w // 2)).to(dev)
            if shifted else None)
    return qkv, bias, mask


@pytest.mark.parametrize("batch,res,w,heads,hd,shifted", [
    (1, 56, 7, 3, 32, False), (1, 56, 7, 3, 32, True), (1, 28, 7, 6, 32, True),
    (1, 14, 7, 12, 32, True), (1, 7, 7, 24, 32, False), (2, 28, 7, 6, 32, True),
    (3, 8, 4, 2, 64, True), (2, 16, 8, 2, 64, True),
    (32, 56, 7, 3, 32, False), (32, 56, 7, 3, 32, True), (32, 28, 7, 6, 32, False),
    (32, 28, 7, 6, 32, True), (32, 14, 7, 12, 32, False), (32, 14, 7, 12, 32, True),
    (32, 7, 7, 24, 32, False), (1, 96, 12, 4, 32, False), (1, 96, 12, 4, 32, True),
    (2, 24, 12, 2, 64, True), (1, 18, 9, 2, 32, True)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_window_sdpa_kernel_matches_twin_and_counts(dev, batch, res, w, heads, hd, shifted,
                                                    dtype):
    """swin_tiny's four stage shapes at b1 and b32 (where the plan walks
    several heads a block), the mask tiled over 2 and 3 images, head_dim 64,
    a full 64-token window, windows of 12 (Swin-B at 384's first stage, and
    head_dim 64) and 9 (n = 81)."""
    qkv, bias, mask = _sdpa_inputs(dev, batch, res, w, heads, hd, shifted, dtype=dtype)
    ws.reset_launches()
    got = ws.window_sdpa(qkv, bias, mask, heads=heads, head_dim=hd)
    assert ws.LAUNCHES["window_sdpa"] == 1
    _close(got, ws.window_sdpa_plain(qkv, bias, mask, heads=heads, head_dim=hd))


def test_window_sdpa_large_scores_subtract_the_row_max(dev):
    qkv, bias, mask = _sdpa_inputs(dev, 1, 14, 7, 2, 32, True)
    qkv[..., :128] *= 12  # q and k large: exp of the raw scores would overflow
    got = ws.window_sdpa(qkv, bias, mask, heads=2, head_dim=32)
    _close(got, ws.window_sdpa_plain(qkv, bias, mask, heads=2, head_dim=32))


def test_window_sdpa_refuses_what_the_kernel_does_not_take(dev):
    qkv, bias, mask = _sdpa_inputs(dev, 1, 14, 7, 2, 32, True)
    kw = dict(heads=2, head_dim=32)
    with pytest.raises(TypeError, match="bfloat16"):
        ws.window_sdpa(qkv.float(), bias, mask, **kw)
    with pytest.raises(TypeError, match="float32"):
        ws.window_sdpa(qkv, bias, mask.bfloat16(), **kw)
    with pytest.raises(ValueError, match="nW dividing"):
        ws.window_sdpa(qkv[:3], bias, mask, **kw)
    with pytest.raises(ValueError, match="head_dim"):
        ws.window_sdpa(_rnd(dev, 4, 49, 3 * 48), bias[:1], None, heads=1, head_dim=48)
    q13, b13, _ = _sdpa_inputs(dev, 1, 26, 13, 1, 32, False)
    with pytest.raises(ValueError, match="at most 144"):
        ws.window_sdpa(q13, b13, None, heads=1, head_dim=32)


# A window's output is the same bits alone (one image) and as image 0 of
# 32: each (window, head) runs the same instructions.
@pytest.mark.parametrize("res,heads,w,shifted", [(56, 3, 7, True), (28, 6, 7, True),
                                                 (14, 12, 7, False), (7, 24, 7, False),
                                                 (24, 2, 12, True)])
def test_window_sdpa_is_bit_identical_alone_and_in_a_batch(dev, res, heads, w, shifted):
    qkv, bias, mask = _sdpa_inputs(dev, 32, res, w, heads, 32, shifted)
    nwin = (res // w) ** 2
    kw = dict(heads=heads, head_dim=32)
    batch = ws.window_sdpa(qkv, bias, mask, **kw)
    alone = ws.window_sdpa(qkv[:nwin], bias, mask, **kw)
    torch.cuda.synchronize()
    assert torch.equal(alone, batch[:nwin])


@functools.lru_cache(maxsize=None)
def _wmma_window_sdpa():
    from edgevisiontransformer_tpu_torch.bench import window_sdpa_ab

    return window_sdpa_ab.build_libraries(source_variants=False)[1]


# The kernel against the WMMA kernel it replaced (its source in
# bench/window_sdpa_ab.py, built beside it): within the twin bound; -rP
# prints how many elements differ.
@pytest.mark.parametrize("batch,res,heads,shifted", [
    (1, 56, 3, False), (1, 56, 3, True), (1, 28, 6, True), (1, 14, 12, True), (1, 7, 24, False),
    (32, 56, 3, True), (32, 14, 12, False)])
def test_window_sdpa_agrees_with_the_wmma_kernel(dev, batch, res, heads, shifted):
    from edgevisiontransformer_tpu_torch.bench import window_sdpa_ab

    qkv, bias, mask = _sdpa_inputs(dev, batch, res, 7, heads, 32, shifted, seed=4)
    got = ws.window_sdpa(qkv, bias, mask, heads=heads, head_dim=32)
    old = torch.empty_like(got)
    window_sdpa_ab.launch(_wmma_window_sdpa(), qkv, bias, mask, old, heads, 32)
    _close(got, old)
    diff = (got.float() - old.float()).abs()
    print(f"window_sdpa vs the WMMA kernel, b{batch} res{res} h{heads} "
          f"{'shifted' if shifted else 'unshifted'}: {int((diff > 0).sum())} of {diff.numel()} "
          f"elements differ, max {float(diff.max()):.3g}")


@pytest.mark.parametrize("w", [7, 12])
def test_window_sdpa_subnormal_quotients_match_the_twin(dev, w):
    """The -100 mask with large |q . k|: many masked p = e / l are fp32
    subnormals, which the kernel's division rounds as __fdiv_rn does."""
    qkv, bias, mask = _sdpa_inputs(dev, 2, 4 * w, w, 2, 32, True, seed=5)
    qkv[..., :128] *= 3
    q, k = qkv[..., :32].float(), qkv[..., 64:96].float()  # head 0
    s = (q @ k.transpose(-1, -2)) * 32 ** -0.5 + bias[0].float()
    s = s + mask.repeat(2, 1, 1).bfloat16().float()
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    assert ((p > 0) & (p < 2.0 ** -126)).any()
    got = ws.window_sdpa(qkv, bias, mask, heads=2, head_dim=32)
    _close(got, ws.window_sdpa_plain(qkv, bias, mask, heads=2, head_dim=32))


def _int8_stacks(model, mode):
    if mode == "dynamic":
        return swin.prepare_swin_int8(model, min_dim=0)
    return swin.prepare_swin_int8_static(model, batches=representative_batches(
        n=2, shape=(3, 112, 112)), min_dim=0)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_swin_int8_stage_kernels_match_twins_and_count(dev, mode):
    model = _swin_model(dev)
    stage = swin.prepare_swin_fused(model)["stages"][1]
    q = _int8_stacks(model, mode)
    assert list(q) == [0, 1, 2] and ("act_inv" in q[1]) == (mode == "static")
    stack = {**q[1], "bias": stage["bias"], "mask": stage["mask"]}
    x = _rnd(dev, 2 * 14 * 14, 192)
    kw = dict(res=14, window=7, heads=6, head_dim=32, eps=1e-5)
    fe.reset_launches()
    sb.reset_launches()
    got = sb.swin_stage_forward_int8(x, stack, **kw)
    counts = {**fe.LAUNCHES, **sb.LAUNCHES}
    assert counts == {"ln_rows": 4, "linear": 0, "attention_rows": 0, "quant_rows": 8,
                      "linear_i8": 8, "window_attention": 2}
    ref = sb.swin_stage_forward_int8_plain(x, stack, **kw)
    torch.cuda.synchronize()
    # a one-spacing flip before a quantization moves a value into the next
    # int8 bucket, which the next matmuls spread
    assert (got.float() - ref.float()).abs().max() <= 0.05 * ref.float().abs().max()


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_fused_swin_apply_int8_on_kernels_matches_plain_and_counts(dev, mode):
    model = _swin_model(dev)
    img = torch.randn(2, 3, 112, 112, generator=torch.Generator().manual_seed(2)).to(dev)
    with torch.no_grad():
        prepared = swin.prepare_swin_fused(model)
        q = _int8_stacks(model, mode)
        fe.reset_launches()
        sb.reset_launches()
        sm.reset_launches()
        got = swin.fused_swin_apply(model, img, prepared=prepared, int8_prepared=q)
        counts = {**fe.LAUNCHES, **sb.LAUNCHES, **sm.LAUNCHES}
        ref = swin.fused_swin_apply(model, img, prepared=prepared, int8_prepared=q, plain=True)
    # six int8 blocks: ln_rows 2, quant_rows 4, linear_i8 4, window_attention 1
    # each; two merges: swin_merge 1, linear 1 each
    assert counts == {"ln_rows": 12, "linear": 2, "attention_rows": 0, "quant_rows": 24,
                      "linear_i8": 24, "window_attention": 6, "swin_merge": 2}
    torch.cuda.synchronize()
    assert got.shape == (2, 1000) and torch.isfinite(got.float()).all()
    assert (got.float() - ref.float()).abs().max() <= 0.05 * ref.float().abs().max()


def test_swin_module_pallas_kernel_mode_on_the_kernel_matches_the_twin(dev, monkeypatch):
    cfg = swin.swin_config("tiny", image_size=112, depths=(2, 2, 2), num_heads=(3, 6, 12),
                           dtype=torch.bfloat16, kernel_mode="pallas")
    model = swin.SwinTransformer(cfg, device=dev, generator=torch.Generator().manual_seed(1))
    img = torch.randn(2, 3, 112, 112, generator=torch.Generator().manual_seed(2)).to(dev)
    with torch.no_grad():
        ws.reset_launches()
        got = model(img)
        assert ws.LAUNCHES["window_sdpa"] == 6
        monkeypatch.setattr(ws, "window_sdpa", ws.window_sdpa_plain)
        ref = model(img)
    torch.cuda.synchronize()
    assert got.shape == (2, 1000) and torch.isfinite(got.float()).all()
    assert (got.float() - ref.float()).abs().max() <= 0.05 * ref.float().abs().max()


# ---------------------------------------------------------------------------
# Any hidden width: linear, quant_rows and linear_i8 at a pruned model's K / N
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(197, 192, 230), (197, 230, 192), (394, 192, 537),
                                   (197, 537, 192), (5, 13, 7)])
@pytest.mark.parametrize("epilogue,approx", [
    (fe.CAST_THEN_BIAS, False), (fe.CAST_THEN_BIAS_GELU, False), (fe.BIAS_RESIDUAL, False)])
def test_linear_kernel_any_width_matches_twin(dev, m, k, n, epilogue, approx):
    x, w = _rnd(dev, m, k), _rnd(dev, k, n, scale=k ** -0.5, seed=1)
    b = _rnd(dev, n, scale=0.5, seed=2)
    res = _rnd(dev, m, n, seed=3) if epilogue == fe.BIAS_RESIDUAL else None
    kw = dict(epilogue=epilogue, res=res, approx_gelu=approx)
    _close(fe.linear(x, w, b, **kw), fe.linear_plain(x, w, b, **kw))


def test_linear_kernel_unaligned_stack_slices_match_twin(dev):
    """Layer 1 of a [L, 1, 230] bias stack starts 460 bytes in: off its
    16-byte boundary, as the stacks of a pruned model are."""
    x = _rnd(dev, 197, 192)
    w = _rnd(dev, 3, 192, 230, scale=192 ** -0.5, seed=1)
    b = _rnd(dev, 3, 1, 230, scale=0.5, seed=2)
    assert b[1, 0].data_ptr() % 16
    kw = dict(epilogue=fe.CAST_THEN_BIAS_GELU)
    _close(fe.linear(x, w[1], b[1, 0], **kw), fe.linear_plain(x, w[1], b[1, 0], **kw))


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("rows,k", [(197, 230), (197, 537), (394, 460), (9, 13)])
def test_quant_rows_kernel_any_width_equals_twin(dev, rows, k, static):
    h = _rnd(dev, rows, k, scale=3.0)
    h[0] = 0  # absmax 0: s = 1
    act_inv = (30.0 * _uniform(dev, 3, 4, seed=1)).contiguous() if static else None
    q, s = fe.quant_rows(h, act_inv, 7)
    q_p, s_p = fe.quant_rows_plain(h, act_inv, 7)
    torch.cuda.synchronize()
    assert torch.equal(q, q_p) and (static or torch.equal(s, s_p))


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("m,k,n", [(197, 192, 230), (197, 230, 192), (197, 537, 192),
                                   (394, 192, 537), (5, 13, 7)])
@pytest.mark.parametrize("epilogue,approx", [
    (fe.BIAS, False), (fe.BIAS_GELU, False), (fe.BIAS_RESIDUAL, False)])
def test_linear_i8_kernel_any_width_matches_twin(dev, m, k, n, epilogue, approx, static):
    """Bit for bit, except the GELU epilogue."""
    unit = 1.0 / (73.0 * 73.0 * k ** 0.5)
    q, w_q = _int8(dev, m, k), _int8(dev, k, n, seed=1)
    s_row = None if static else _uniform(dev, m, seed=2) * 0.05
    w_s = _uniform(dev, n, seed=3) * (unit if static else unit / 0.05)
    b = torch.randn(n, device=dev)
    res = _rnd(dev, m, n, seed=4) if epilogue == fe.BIAS_RESIDUAL else None
    kw = dict(epilogue=epilogue, out_dtype=torch.bfloat16, res=res, approx_gelu=approx)
    got = fe.linear_i8(q, s_row, w_q, w_s, b, **kw)
    ref = fe.linear_i8_plain(q, s_row, w_q, w_s, b, **kw)
    if epilogue == fe.BIAS_GELU:
        _close(got, ref)
    else:
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (got.float() - ref.float()).abs().max()


# ---------------------------------------------------------------------------
# The ViT module's kernel_mode="pallas" path: sdpa (K13), mlp (K14),
# layer_norm (K15 on ln_rows)
# ---------------------------------------------------------------------------


def _qkv_views(dev, b, h, n, d, seed=0, dtype=torch.bfloat16):
    """q, k, v of [b, h, n, d] as views of a fused [b, n, 3 h d] activation."""
    qkv = _rnd(dev, b, n, 3 * h * d, seed=seed, dtype=dtype)
    parts = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
    return parts[0], parts[1], parts[2]


# csrc/sdpa.cu's resident form up to 256 keys (128 above d = 96),
# csrc/sdpa_long.cu beyond: n = 256 and 257 straddle the switch, 577 and 1000
# run off the 64-key tile, and d = 128 leaves sdpa.cu from 129 keys on; every
# new head_dim resident at 50 and 197 keys (sdpa_long.cu above 96) and on
# sdpa_long.cu at ViT-H/14's 257.
@pytest.mark.parametrize("b,h,n,d", [(1, 3, 197, 64), (128, 3, 197, 64), (1, 6, 197, 64),
                                     (2, 1, 197, 64), (2, 2, 50, 32), (1, 2, 577, 64),
                                     (2, 4, 65, 16), (1, 2, 100, 128), (1, 1, 1, 64),
                                     (1, 2, 256, 64), (2, 1, 257, 64), (1, 1, 1000, 64),
                                     (1, 2, 197, 128),
                                     *((b, h, n, d) for d in NEW_HEAD_DIMS
                                       for b, h, n in ((1, 2, 197), (2, 2, 257), (1, 1, 50)))])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sdpa_kernel_matches_twin_and_counts(dev, b, h, n, d, dtype):
    q, k, v = _qkv_views(dev, b, h, n, d, dtype=dtype)
    fa.reset_launches()
    got = fa.sdpa(q, k, v)
    assert fa.LAUNCHES["sdpa"] == 1 and got.is_contiguous()
    _close(got, fa.sdpa_plain(q, k, v))


def test_sdpa_large_scores_subtract_the_row_max(dev):
    q, k, v = _qkv_views(dev, 1, 2, 197, 64)
    q, k = q * 12, k * 12  # exp of the raw scores would overflow
    _close(fa.sdpa(q, k, v), fa.sdpa_plain(q, k, v))


# csrc/sdpa_long.cu: n on both sides of res_keys(d) (129 is resident up to d =
# 96) and on and off the 64-key tile, at the head dims of deit (64), ViT-H/14
# (80), ViT-g/14 (88, on 2 panels), ViT-G/14 (104) and 112 / 128 (resident
# only to 128 keys)
@pytest.mark.parametrize("n", [129, 257, 300, 577, 1000])
@pytest.mark.parametrize("d", [64, 80, 88, 104, 112, 128])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sdpa_long_matches_twin_and_counts(dev, n, d, dtype):
    q, k, v = _qkv_views(dev, 2, 3, n, d, seed=n + d, dtype=dtype)
    fa.reset_launches()
    got = fa.sdpa(q, k, v)
    assert fa.LAUNCHES["sdpa"] == 1 and got.is_contiguous()
    _close(got, fa.sdpa_plain(q, k, v))


@pytest.mark.parametrize("n,d", [(257, 80), (577, 64)])
def test_sdpa_long_large_scores_subtract_the_row_max(dev, n, d):
    q, k, v = _qkv_views(dev, 1, 2, n, d, seed=5)
    q, k = q * 12, k * 12  # exp of the raw scores would overflow
    assert n > fa.res_keys(d)
    _close(fa.sdpa(q, k, v), fa.sdpa_plain(q, k, v))


@pytest.mark.parametrize("b,h,n,d", [(8, 16, 257, 80), (8, 4, 577, 64), (8, 2, 300, 128)])
def test_sdpa_long_rows_alone_in_a_batch_and_twice_give_the_same_bits(dev, b, h, n, d):
    """An image alone and inside the batch (another plan: K and V resident
    against a ring of two tiles at ViT-H/14), and two calls, give the same
    bits."""
    sms = fe._sm_count(0)
    q, k, v = _qkv_views(dev, b, h, n, d, seed=7)
    batch, again = fa.sdpa(q, k, v), fa.sdpa(q, k, v)
    alone = [fa.sdpa(q[i:i + 1], k[i:i + 1], v[i:i + 1]) for i in (0, b - 1)]
    torch.cuda.synchronize()
    assert torch.equal(batch, again)
    assert torch.equal(alone[0], batch[:1]) and torch.equal(alone[1], batch[b - 1:])
    if (n, d) == (257, 80):
        alone_plan, batch_plan = fa.long_plan(1, h, n, d, sms), fa.long_plan(b, h, n, d, sms)
        assert alone_plan.resident != batch_plan.resident


def _forced(b, h, n, d, rows, stages):
    tiles = -(-n // fa.LONG_KEYS)
    return fa.LongPlan(rows, stages, stages >= 2 * tiles, tiles,
                       fa.long_smem_bytes(rows, d, stages), (b * h, -(-n // rows)))


# Every form of csrc/sdpa_long.cu's plan, forced: 64, 128 and 192 query rows,
# K and V resident or streamed through the ring, rings of 2 and 3 tiles (the
# least it takes), and the plan's own streamed ring at d = 128 (577 keys do
# not fit resident); 257 and 577 keys end in a one-chunk tail, 300 does not
@pytest.mark.parametrize("b,h,n,d,form", [
    *((2, 16, 257, 80, (rows, res)) for rows in (64, 128, 192) for res in (True, False)),
    *((1, 2, 577, 64, (rows, res)) for rows in (64, 128, 192) for res in (True, False)),
    (1, 2, 300, 88, ("ring", 2)), (1, 2, 300, 88, ("ring", 3)),
    (2, 2, 577, 128, None)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sdpa_long_every_plan_form_matches_twin(dev, monkeypatch, b, h, n, d, form, dtype):
    long_plan = fa.long_plan
    if form is not None and form[0] == "ring":
        monkeypatch.setattr(fa, "long_plan", lambda *a, **k: _forced(b, h, n, d, 64, form[1]))
    elif form is not None:
        monkeypatch.setattr(fa, "long_plan",
                            lambda *a, **k: long_plan(*a, **k, rows=form[0], resident=form[1]))
    else:
        assert not long_plan(b, h, n, d, fe._sm_count(0)).resident
    q, k, v = _qkv_views(dev, b, h, n, d, seed=3, dtype=dtype)
    fa.reset_launches()
    got = fa.sdpa(q, k, v)
    assert fa.LAUNCHES["sdpa"] == 1
    _close(got, fa.sdpa_plain(q, k, v))
    monkeypatch.undo()
    assert torch.equal(got, fa.sdpa(q, k, v))  # the plan moves no bits


def test_sdpa_long_refuses_a_plan_it_cannot_run(dev, monkeypatch):
    """A plan csrc/sdpa_long.cu refuses (rows not 64, 128 or 192, a ring of
    one tile, shared memory past the card's) raises, and counts no launch."""
    q, k, v = _qkv_views(dev, 1, 2, 300, 64)
    for rows, stages in ((32, 4), (256, 4), (64, 1), (64, 40)):
        monkeypatch.setattr(fa, "long_plan", lambda *a, r=rows, s=stages, **k: _forced(
            1, 2, 300, 64, r, s))
        fa.reset_launches()
        with pytest.raises(RuntimeError, match="sdpa launch failed"):
            fa.sdpa(q, k, v)
        assert fa.LAUNCHES["sdpa"] == 0


def test_attention_writes_the_merged_heads_in_place(dev):
    x = _rnd(dev, 2, 197, 192)
    w_qkv, b_qkv = _rnd(dev, 192, 576, scale=0.05, seed=1), _rnd(dev, 576, scale=0.05, seed=2)
    w_out, b_out = _rnd(dev, 192, 192, scale=0.05, seed=3), _rnd(dev, 192, scale=0.05, seed=4)
    fa.reset_launches()
    got = fa.attention(x, w_qkv, b_qkv, w_out, b_out, 3, 64)
    assert fa.LAUNCHES["sdpa"] == 1
    qkv = x @ w_qkv + b_qkv
    q, k, v = (t.contiguous() for t in qkv.view(2, 197, 3, 3, 64).permute(2, 0, 3, 1, 4))
    o = fa.sdpa_plain(q, k, v).permute(0, 2, 1, 3).reshape(2, 197, 192)
    _close(got, o @ w_out + b_out)


@pytest.mark.parametrize("rows,dim,hidden", [(197, 192, 768), (25216, 192, 768),
                                             (1576, 768, 3072), (197, 192, 230),
                                             (197, 192, 537), (394, 384, 460), (3, 64, 13),
                                             (1, 192, 768), (6304, 384, 1152), (197, 200, 768),
                                             (257, 1280, 5120), (2056, 1280, 5120),
                                             (257, 1536, 6144), (257, 2048, 8192),
                                             (100, 1408, 6144), (257, 1664, 8192),
                                             (257, 2056, 8192), (2056, 2304, 9216),
                                             (257, 1408, 6150)])
@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_kernel_matches_twin_and_counts(dev, rows, dim, hidden, approx, dtype):
    x = _rnd(dev, rows, dim, scale=2.0, dtype=dtype)
    w1 = _rnd(dev, dim, hidden, scale=dim ** -0.5, seed=1, dtype=dtype)
    b1 = _rnd(dev, hidden, seed=2, dtype=dtype)
    w2 = _rnd(dev, hidden, dim, scale=hidden ** -0.5, seed=3, dtype=dtype)
    b2 = _rnd(dev, dim, seed=4, dtype=dtype)
    fm.reset_launches()
    got = fm.mlp(x, w1, b1, w2, b2, approx_gelu=approx)
    assert fm.LAUNCHES["mlp"] == 1
    _close(got, fm.mlp_plain(x, w1, b1, w2, b2, approx_gelu=approx))


# Every form of csrc/mlp.cu's grid at shapes where the plan would not pick
# it: 128 and 64 rows, the cluster split (S = 2, 3, 8; at hidden 13 more
# splits than chunks), each column-tile width, chunks of 32 and 64 hidden
# units; dim 1,152 at 64 rows.  Above dim 1,152 csrc/mlp_wide.cu under
# forced splits of fc2's K (("wide", S)): S = 1, 2 and 8 at ViT-H/14 b1
# (the plan's is 5), a ragged hidden width, dim 1,160 at hidden 13.
@pytest.mark.parametrize("rows,dim,hidden,form", [
    (197, 192, 768, (128, 1, 192, 32)), (197, 192, 768, (128, 8, 192, 32)),
    (300, 192, 230, (64, 3, 128, 32)), (25216, 192, 768, (64, 1, 64, 32)),
    (25216, 192, 768, (128, 2, 256, 32)), (394, 384, 1152, (128, 1, 128, 32)),
    (1576, 768, 3072, (64, 8, 192, 32)), (3, 64, 13, (64, 2, 64, 32)),
    (200, 1152, 96, (64, 1, 256, 32)), (130, 512, 200, (128, 4, 256, 32)),
    (197, 192, 537, (128, 1, 192, 64)), (300, 256, 768, (128, 3, 256, 64)),
    (25216, 192, 768, (128, 1, 64, 64)), (70, 64, 13, (128, 1, 128, 64)),
    (257, 1280, 5120, ("wide", 1)), (257, 1280, 5120, ("wide", 2)),
    (257, 1280, 5120, ("wide", 8)), (300, 2048, 100, ("wide", 2)),
    (40, 1160, 13, ("wide", 4))])
def test_mlp_kernel_every_plan_form_matches_twin(dev, monkeypatch, rows, dim, hidden, form):
    x = _rnd(dev, rows, dim, scale=2.0)
    w1, b1 = _rnd(dev, dim, hidden, scale=dim ** -0.5, seed=1), _rnd(dev, hidden, seed=2)
    w2, b2 = _rnd(dev, hidden, dim, scale=hidden ** -0.5, seed=3), _rnd(dev, dim, seed=4)
    if form[0] == "wide":
        wide_plan = fm.wide_plan
        monkeypatch.setattr(fm, "wide_plan", lambda *a, **k: wide_plan(*a, **k, split=form[1]))
    else:
        r, split, nt, hc = form
        monkeypatch.setattr(fm, "plan", lambda *a, **k: fm.Plan(r, split, nt, hc, -(-dim // nt)))
    fm.reset_launches()
    got = fm.mlp(x, w1, b1, w2, b2)
    assert fm.LAUNCHES["mlp"] == 1
    _close(got, fm.mlp_plain(x, w1, b1, w2, b2))


@pytest.mark.parametrize("approx", [False, True])
def test_mlp_rows_alone_and_in_a_batch_agree_within_the_twin_bound(dev, approx):
    """The 197 rows of one image alone (the b1 plan: a cluster split of the
    hidden width, S = 8) and as rows 0-196 of a b128 call (S = 1) at
    deit_tiny's widths: the split sums the chunks in another order, so the
    rows may differ; they stay within the twin bound."""
    sms = fm._sm_count(0)
    assert fm.plan(197, 192, 768, sms).split > 1 and fm.plan(25216, 192, 768, sms).split == 1
    x = _rnd(dev, 25216, 192, scale=2.0)
    w1, b1 = _rnd(dev, 192, 768, scale=192 ** -0.5, seed=1), _rnd(dev, 768, seed=2)
    w2, b2 = _rnd(dev, 768, 192, scale=768 ** -0.5, seed=3), _rnd(dev, 192, seed=4)
    batch = fm.mlp(x, w1, b1, w2, b2, approx_gelu=approx)[:197]
    alone = fm.mlp(x[:197], w1, b1, w2, b2, approx_gelu=approx)
    torch.cuda.synchronize()
    diff = (alone.float() - batch.float()).abs()
    print(f"mlp {'tanh' if approx else 'erf'}: b1 against rows 0-196 of b128: max |diff| "
          f"{float(diff.max()):.6g}, {int((diff > 0).sum())} of {diff.numel()} values differ")
    _close(alone, batch)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,dim,hidden", [(257, 1280, 5120), (2056, 1280, 5120),
                                             (257, 1408, 6150)])
def test_mlp_wide_graph_replay_gives_the_eager_bits(dev, rows, dim, hidden, dtype):
    """csrc/mlp_wide.cu captured in a CUDA graph (its workspaces allocated in
    the graph's pool) and replayed twice gives the eager call's bits."""
    x = _rnd(dev, rows, dim, scale=2.0, dtype=dtype)
    w1 = _rnd(dev, dim, hidden, scale=dim ** -0.5, seed=1, dtype=dtype)
    b1 = _rnd(dev, hidden, seed=2, dtype=dtype)
    w2 = _rnd(dev, hidden, dim, scale=hidden ** -0.5, seed=3, dtype=dtype)
    b2 = _rnd(dev, dim, seed=4, dtype=dtype)
    eager = fm.mlp(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = fm.mlp(x, w1, b1, w2, b2)
    for _ in range(2):
        replayed.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager)


@pytest.mark.parametrize("rows", [197, 25216])
def test_mlp_kernel_is_deterministic(dev, rows):
    x = _rnd(dev, rows, 192, scale=2.0)
    w1, b1 = _rnd(dev, 192, 768, scale=192 ** -0.5, seed=1), _rnd(dev, 768, seed=2)
    w2, b2 = _rnd(dev, 768, 192, scale=768 ** -0.5, seed=3), _rnd(dev, 192, seed=4)
    first = fm.mlp(x, w1, b1, w2, b2)
    second = fm.mlp(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_layer_norm_is_one_ln_rows_launch(dev):
    x = _rnd(dev, 4, 197, 192, scale=3.0)
    g, b = _rnd(dev, 192, seed=1) + 1, _rnd(dev, 192, seed=2)
    fe.reset_launches()
    got = ln.layer_norm(x, g, b, 1e-6)
    assert fe.LAUNCHES["ln_rows"] == 1 and got.shape == x.shape
    _close(got, ln.layer_norm_plain(x, g, b, 1e-6))


def test_pallas_wrappers_raise_on_the_card_rather_than_fall_back(dev):
    q, k, v = _qkv_views(dev, 1, 2, 50, 32)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.sdpa(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="head_dim"):
        fa.sdpa(*_qkv_views(dev, 1, 2, 50, 136))
    odd = _rnd(dev, 1, 2, 50, 36)[..., :32]  # rows 36 values apart: not 16-byte vectors
    with pytest.raises(ValueError, match="strides"):
        fa.sdpa(odd, odd, odd)
    fa.reset_launches()  # the same refusals past res_keys (csrc/sdpa_long.cu's shapes)
    q, k, v = _qkv_views(dev, 1, 2, 300, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.sdpa(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="head_dim"):
        fa.sdpa(*_qkv_views(dev, 1, 2, 300, 136))
    odd = _rnd(dev, 1, 2, 300, 36)[..., :32]
    with pytest.raises(ValueError, match="strides"):
        fa.sdpa(odd, odd, odd)
    assert fa.LAUNCHES["sdpa"] == 0
    x, w1, w2 = _rnd(dev, 8, 64), _rnd(dev, 64, 96), _rnd(dev, 96, 64)
    b1, b2 = _rnd(dev, 96), _rnd(dev, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        fm.mlp(x.float(), w1.float(), b1.float(), w2.float(), b2.float())
    with pytest.raises(ValueError, match="multiple of 8"):
        fm.mlp(_rnd(dev, 8, 60), w1[:60], b1, _rnd(dev, 96, 60), b2[:60])
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        fm.mlp(x, w1.cpu(), b1, w2, b2)


def _module_counts():
    return {**fe.LAUNCHES, **fa.LAUNCHES, **fm.LAUNCHES}


def _reset_module_counts():
    for m in (fe, fa, fm):
        m.reset_launches()


@pytest.mark.parametrize("name,kw", [
    ("deit_tiny", dict(depth=2)), ("deit_tiny", dict(depth=2, style="reference")),
    ("pruned_deit_tiny@layerwise_h1-d0.3_h2-d0.5", dict(depth=2))])
def test_vit_module_pallas_kernel_mode_on_the_kernels_matches_the_twins(dev, monkeypatch,
                                                                       name, kw):
    model, shape = build_model(name, kernel_mode="pallas", dtype=torch.bfloat16, device=dev,
                               generator=torch.Generator().manual_seed(1), **kw)
    img = torch.randn(2, *shape, generator=torch.Generator().manual_seed(2)).to(dev)
    with torch.no_grad():
        _reset_module_counts()
        got = model(img)
        counts = _module_counts()
        monkeypatch.setattr(fa, "sdpa", fa.sdpa_plain)
        monkeypatch.setattr(fm, "mlp", fm.mlp_plain)
        ref = model(img)
    assert counts["sdpa"] == 2 and counts["mlp"] == 2
    assert sum(counts.values()) == 4  # LayerNorm and the projections stay torch ops
    torch.cuda.synchronize()
    assert got.shape == (2, 1000) and torch.isfinite(got.float()).all()
    assert (got.float() - ref.float()).abs().max() <= 0.05 * ref.float().abs().max()


@pytest.mark.parametrize("enc,pack", [("all_head1_ffn0.3", False),
                                      ("layerwise_h1-d0.3_h1-d0.3_h2-d0.5", False),
                                      ("layerwise_h1-d0.3_h1-d0.3_h2-d0.5", True)])
def test_pruned_fused_vit_apply_on_kernels_matches_plain_and_counts(dev, enc, pack):
    model, shape = build_model(f"pruned_deit_tiny@{enc}", depth=3, dtype=torch.bfloat16,
                               device=dev, generator=torch.Generator().manual_seed(1))
    img = torch.randn(2, *shape, generator=torch.Generator().manual_seed(2)).to(dev)
    with torch.no_grad():
        stacked = prepare_vit_fused(model, pack_layers=pack)
        fe.reset_launches()
        got = fused_vit_apply(model, img, stacked=stacked, pack_layers=pack)
        counts = dict(fe.LAUNCHES)
        ref = fused_vit_apply(model, img, stacked=stacked, pack_layers=pack, plain=True)
    assert counts == {"ln_rows": 6, "linear": 12, "attention_rows": 3, "quant_rows": 0,
                      "linear_i8": 0}
    torch.cuda.synchronize()
    assert got.shape == (2, 1000) and torch.isfinite(got.float()).all()
    assert (got.float() - ref.float()).abs().max() <= 0.05 * ref.float().abs().max()


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("enc", ["all_head1_ffn0.3", "layerwise_h1-d0.3_h1-d0.3_h2-d0.5"])
def test_pruned_fused_vit_apply_int8_on_kernels_matches_plain_and_counts(dev, enc, static):
    model, shape = build_model(f"pruned_deit_tiny@{enc}", depth=3, dtype=torch.bfloat16,
                               device=dev, generator=torch.Generator().manual_seed(1))
    img = torch.randn(2, *shape, generator=torch.Generator().manual_seed(2)).to(dev)
    with torch.no_grad():
        sq = (prepare_vit_int8_static(model, calib_batches=[img[:1].cpu().numpy()]) if static
              else prepare_vit_int8(model))
        assert ("segments" in sq) == enc.startswith("layerwise")
        fe.reset_launches()
        got = fused_vit_apply_int8(model, img, stacked_q=sq)
        counts = dict(fe.LAUNCHES)
        ref = fused_vit_apply_int8(model, img, stacked_q=sq, plain=True)
    assert counts == {"ln_rows": 6, "linear": 0, "attention_rows": 3, "quant_rows": 12,
                      "linear_i8": 12}
    torch.cuda.synchronize()
    assert got.shape == (2, 1000) and torch.isfinite(got.float()).all()
    assert (got.float() - ref.float()).abs().max() <= 0.05 * ref.float().abs().max()


# ---------------------------------------------------------------------------
# vit_full (K7a / K7b) and the performer kernels (K16)
# ---------------------------------------------------------------------------


def _full_model(dev, style="standard", size="tiny", dtype=torch.bfloat16, **kw):
    cfg = deit_config(size, style, depth=2, dtype=dtype, **kw)
    model = ViT(cfg, device=dev, generator=torch.Generator().manual_seed(3))
    return model, tvit.prepare_vit_full(model)


def _full_args(model):
    cfg = model.config
    return dict(heads=cfg.heads, head_dim=cfg.resolved_head_dim, eps=cfg.layernorm_eps,
                reference_residual=cfg.reference_residual, approx_gelu=cfg.gelu_approx,
                final_norm=cfg.final_norm)


# The whole forward against its twin under every plan form: b1 and b8 (16 x
# 32 tiles, 4-warp strips), b128 (128-row tiles, 8-warp strips), deit_base
# b8, both residual forms, no final norm, head_dim 16, 32 and 128 (the
# one-block-an-SM instance), and every new head_dim (two heads, dim 2 x
# head_dim) at b2 and b64 on that instance's 128-wide strip, zero-filled;
# chip_smoke.py's bound, 0.01 + 2^-6 max|twin|
@pytest.mark.parametrize("size,batch,kw", [
    ("tiny", 1, dict()), ("tiny", 8, dict()), ("tiny", 128, dict()), ("base", 8, dict()),
    ("tiny", 2, dict(reference_residual=True, gelu_approx=True)),
    ("tiny", 128, dict(reference_residual=True, gelu_approx=True)),
    ("tiny", 8, dict(final_norm=False)),
    ("tiny", 1, dict(dim=64, heads=4, mlp_dim=256)), ("tiny", 8, dict(dim=64, heads=4, mlp_dim=256)),
    ("tiny", 3, dict(dim=128, heads=4, mlp_dim=512)),
    ("tiny", 1, dict(dim=256, heads=2, mlp_dim=1024)),
    ("tiny", 16, dict(dim=256, heads=2, mlp_dim=1024)),
    *(("tiny", b, dict(dim=2 * hd, heads=2, mlp_dim=8 * hd)) for hd in NEW_HEAD_DIMS
      for b in (2, 64))])
@pytest.mark.parametrize("dtype", DTYPES)
def test_vit_full_kernel_matches_twin_under_every_plan_form(dev, size, batch, kw, dtype):
    model, prep = _full_model(dev, size=size, dtype=dtype, **kw)
    img = torch.randn(batch, 3, 224, 224, generator=torch.Generator().manual_seed(8)).to(dev)
    with torch.no_grad():
        vf.reset_launches()
        got = vf.vit_full_forward(img, prep, **_full_args(model))
        launches = vf.LAUNCHES["vit_full"]
        ref = vf.vit_full_forward_plain(img, prep, **_full_args(model))
    torch.cuda.synchronize()
    assert launches == 1 and got.shape == ref.shape and torch.isfinite(got.float()).all()
    assert got.dtype == dtype
    err = (got.float() - ref.float()).abs().max()
    assert err <= ATOL + RTOL * ref.float().abs().max(), err


# ViT-H/14's head_dim 80 and patch 14 at narrow width: the embedding's K =
# 3 x 14^2 = 588 ends inside a 64-deep K step; the twin at b1 and b8, and
# the same bits under every grid, tile height and instance the plan allows
@pytest.mark.parametrize("batch", [1, 8])
def test_vit_full_patch_14_head_dim_80_matches_twin_under_every_plan(dev, batch):
    model, prep = _full_model(dev, dim=160, heads=2, mlp_dim=640, patch_size=14)
    assert prep["patch_w"].shape == (588, 160)
    img = torch.randn(batch, 3, 224, 224, generator=torch.Generator().manual_seed(11)).to(dev)
    cfg, fn = model.config, vf.build.load().evt_vit_full
    args = (batch, 257, cfg.dim, cfg.heads, cfg.resolved_head_dim, cfg.mlp_dim, cfg.num_classes,
            torch.cuda.get_device_properties(0).multi_processor_count)
    plans = [vf.vit_full_plan(*args), vf.vit_full_plan(*args, grid=5),
             vf.vit_full_plan(*args, rows=128), vf.vit_full_plan(*args, rows=16)]
    with torch.no_grad():
        outs = [vf.launch(fn, img, prep, plan=p, **_full_args(model))[0] for p in plans]
        ref = vf.vit_full_forward_plain(img, prep, **_full_args(model))
    torch.cuda.synchronize()
    assert all(p.blocks == 1 for p in plans)
    err = (outs[0].float() - ref.float()).abs().max()
    assert err <= ATOL + RTOL * ref.float().abs().max(), err
    for logits in outs[1:]:
        torch.testing.assert_close(logits, outs[0], rtol=0, atol=0)


def test_vit_full_image_is_the_same_bits_alone_and_in_a_batch(dev):
    """b128 runs 128-row tiles and 8-warp strips, b1 16 x 32 tiles and 4-warp
    strips: K is never split and no strip splits the keys, so an image's
    logits do not move."""
    model, prep = _full_model(dev)
    img = torch.randn(128, 3, 224, 224, generator=torch.Generator().manual_seed(9)).to(dev)
    with torch.no_grad():
        batch = tvit.fully_fused_vit_apply(model, img, prepared=prep)
        alone = [tvit.fully_fused_vit_apply(model, img[i:i + 1], prepared=prep)
                 for i in (0, 77, 127)]
    torch.cuda.synchronize()
    for i, one in zip((0, 77, 127), alone):
        torch.testing.assert_close(one[0], batch[i], rtol=0, atol=0)


@pytest.mark.parametrize("batch", [1, 8])
def test_vit_full_gives_the_same_bits_under_every_grid_and_tile_height(dev, batch):
    """The plan's grid against caps of 7 and 1 blocks, 16 x 32 tiles against
    128-row tiles, and each on both kernel instances (one and two blocks an
    SM): the same logits bit for bit."""
    model, prep = _full_model(dev)
    img = torch.randn(batch, 3, 224, 224, generator=torch.Generator().manual_seed(10)).to(dev)
    cfg, fn = model.config, vf.build.load().evt_vit_full
    args = (batch, 197, cfg.dim, cfg.heads, cfg.resolved_head_dim, cfg.mlp_dim, cfg.num_classes,
            torch.cuda.get_device_properties(0).multi_processor_count)
    plans = [vf.vit_full_plan(*args), vf.vit_full_plan(*args, grid=7),
             vf.vit_full_plan(*args, grid=1), vf.vit_full_plan(*args, rows=128),
             vf.vit_full_plan(*args, blocks=2), vf.vit_full_plan(*args, rows=128, blocks=1)]
    with torch.no_grad():
        outs = [vf.launch(fn, img, prep, plan=p, **_full_args(model)) for p in plans]
    torch.cuda.synchronize()
    assert [grid for _, grid in outs][1:3] == [7, 1]
    for logits, _ in outs[1:]:
        torch.testing.assert_close(logits, outs[0][0], rtol=0, atol=0)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("kw", [dict(), dict(reference_residual=True, gelu_approx=True),
                                dict(final_norm=False), dict(num_classes=10)])
def test_vit_full_kernel_matches_twin_in_one_launch(dev, batch, kw):
    model, prep = _full_model(dev, **kw)
    img = torch.randn(batch, 3, 224, 224, generator=torch.Generator().manual_seed(4)).to(dev)
    with torch.no_grad():
        _reset_all()
        got = tvit.fully_fused_vit_apply(model, img, prepared=prep)
        counts = _all_counts()
        ref = tvit.fully_fused_vit_apply(model, img, prepared=prep, plain=True)
        chain = fused_vit_apply(model, img)
    assert counts == {**{k: 0 for k in counts}, "vit_full": 1}
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (batch, model.config.num_classes)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    scale = ref.float().abs().max()
    assert (got.float() - ref.float()).abs().max() <= 0.05 * scale
    assert (got.float() - chain.float()).abs().max() <= 0.05 * scale


def test_vit_full_bf16_image_reads_as_the_rounded_fp32_image(dev):
    model, prep = _full_model(dev)
    img = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(5)).to(dev)
    with torch.no_grad():
        a = tvit.fully_fused_vit_apply(model, img, prepared=prep)
        b = tvit.fully_fused_vit_apply(model, img.bfloat16(), prepared=prep)
    torch.cuda.synchronize()
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_vit_full_is_one_device_kernel_in_a_trace(dev):
    from edgevisiontransformer_tpu_torch.bench.harness import device_time_by_kernel

    model, prep = _full_model(dev)
    img = torch.randn(1, 3, 224, 224, generator=torch.Generator().manual_seed(6)).to(dev)
    img16 = img.bfloat16()
    with torch.no_grad():
        tvit.fully_fused_vit_apply(model, img16, prepared=prep)
        rows = device_time_by_kernel(lambda: tvit.fully_fused_vit_apply(model, img16,
                                                                        prepared=prep))
    assert len(rows) == 1 and rows[0][1] == 1 and "vit_full" in rows[0][0], rows


def test_vit_full_replays_in_a_cuda_graph(dev):
    model, prep = _full_model(dev)
    img = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(7)).to(dev)
    with torch.no_grad():
        eager = tvit.fully_fused_vit_apply(model, img, prepared=prep)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = tvit.fully_fused_vit_apply(model, img, prepared=prep)
        graph.replay()
        torch.cuda.synchronize()
        first = out.clone()
        graph.replay()
        torch.cuda.synchronize()
    torch.testing.assert_close(first, eager, rtol=0, atol=0)
    torch.testing.assert_close(out, eager, rtol=0, atol=0)


def test_vit_full_refuses_what_the_kernel_does_not_take(dev):
    model, prep = _full_model(dev)
    img = torch.randn(1, 3, 224, 224, device=dev)
    fp32 = {k: v.float() for k, v in prep.items()}
    with pytest.raises(TypeError, match="bfloat16"):
        vf.vit_full_forward(img, fp32, heads=3, head_dim=64, eps=1e-6,
                            reference_residual=False, approx_gelu=False, final_norm=True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tvit.fully_fused_vit_apply(model, img.half(), prepared=prep)
    with pytest.raises(ValueError, match="contiguous"):
        tvit.fully_fused_vit_apply(model, img.transpose(2, 3), prepared=prep)
    with pytest.raises(ValueError, match="head_dim"):
        vf.vit_full_forward(img, prep, heads=1, head_dim=192, eps=1e-6,
                            reference_residual=False, approx_gelu=False, final_norm=True)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        tvit.fully_fused_vit_apply(model, img.cpu(), prepared=prep)


def _performer_inputs(dev, batch, n, seed=0, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    p = {"attn_output": {"kernel": torch.randn(64, 64, generator=g) * 0.1,
                         "bias": torch.randn(64, generator=g) * 0.1},
         "norm2_scale": 1 + torch.randn(64, generator=g) * 0.1,
         "norm2_bias": torch.randn(64, generator=g) * 0.1,
         "mlp_fc1_kernel": torch.randn(64, 64, generator=g) * 0.1,
         "mlp_fc1_bias": torch.randn(64, generator=g) * 0.1,
         "mlp_fc2_kernel": torch.randn(64, 64, generator=g) * 0.1,
         "mlp_fc2_bias": torch.randn(64, generator=g) * 0.1}
    p = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict) else v.to(dev))
         for k, v in p.items()}
    w = (torch.randn(32, 64, generator=g) * 0.3).to(dev)
    x = (torch.randn(batch, n, 192, generator=g) * 0.5).to(dev, dtype)
    return x, p, w


# chip_smoke.py's PERFORMER_SHAPES (t2t_vit_14's two stages at b1, b4 and
# b32, ragged token counts), a few more ragged ones, and 50 tiles an image
# (8 groups of tiles: the group partials added in two batches)
@pytest.mark.parametrize("batch,n", [(1, 3136), (2, 784), (1, 50), (3, 100), (2, 300),
                                     (4, 3136), (1, 784), (4, 784), (32, 3136), (32, 784),
                                     (2, 3200)])
@pytest.mark.parametrize("approx", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_performer_kernels_match_twin_and_count(dev, batch, n, approx, dtype):
    x, p, w = _performer_inputs(dev, batch, n, dtype=dtype)
    pf.reset_launches()
    got = pf.performer_rest(x, p, w, eps_ln=1e-5, approx_gelu=approx)
    assert pf.LAUNCHES == {"performer_reduce": 1, "performer_rows": 1}
    _close(got, pf.performer_rest_plain(x, p, w, eps_ln=1e-5, approx_gelu=approx))
    _close(pf.performer_reduce(x, w), pf.performer_reduce_plain(x, w))


@pytest.mark.parametrize("batch,n", [(4, 3136), (32, 3136), (4, 784), (32, 784), (4, 300)])
def test_performer_is_bit_identical_alone_and_in_a_batch(dev, batch, n):
    """performer_reduce's partition is a constant, its sum over an image's
    tiles runs once in tile order, and a performer_rows warp carries its
    tokens alone: image 0's output is the same bits alone and in the batch
    (at b32 and alone)."""
    x, p, w = _performer_inputs(dev, batch, n, seed=3)
    kw = dict(eps_ln=1e-5, approx_gelu=True)
    together = pf.performer_rest(x, p, w, **kw)
    alone = pf.performer_rest(x[:1].contiguous(), p, w, **kw)
    torch.cuda.synchronize()
    assert torch.equal(alone[0], together[0])
    assert torch.equal(pf.performer_reduce(x[:1].contiguous(), w)[0], pf.performer_reduce(x, w)[0])


def test_performer_graph_replays_equal_the_eager_call(dev):
    """A CUDA graph of performer_rest replayed twice gives the eager call's
    bits: the arrival counters' zeroing is captured with the launch."""
    x, p, w = _performer_inputs(dev, 4, 784, seed=5)
    ops = pf.performer_operands(p, w)
    kw = dict(eps_ln=1e-5, approx_gelu=True, operands=ops)
    eager = pf.performer_rest(x, p, w, **kw)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        pf.performer_rest(x, p, w, **kw)  # warm up off the default stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pf.performer_rest(x, p, w, **kw)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_performer_on_two_streams_at_once_matches_the_twin(dev):
    """Calls on two streams at once share no arrival counters: each stream's
    results stay the twin's and the eager call's bits."""
    kw = dict(eps_ln=1e-5, approx_gelu=True)
    inputs = [_performer_inputs(dev, 4, 3136, seed=8), _performer_inputs(dev, 4, 3136, seed=9)]
    eager = [pf.performer_rest(x, p, w, **kw) for x, p, w in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = [[], []]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(8):  # interleaved launches, so the streams' kernels overlap
        for (x, p, w), s, o in zip(inputs, streams, outs):
            with torch.cuda.stream(s):
                o.append(pf.performer_rest(x, p, w, **kw))
    torch.cuda.synchronize()
    for (x, p, w), ref, o in zip(inputs, eager, outs):
        _close(o[0], pf.performer_rest_plain(x, p, w, **kw))
        assert all(torch.equal(got, ref) for got in o)


def test_performer_operands_give_the_bits_of_the_cast_per_call(dev):
    x, p, w = _performer_inputs(dev, 2, 784, seed=6)
    kw = dict(eps_ln=1e-5, approx_gelu=False)
    cast = pf.performer_rest(x, p, w, **kw)
    prepared = pf.performer_rest(x, p, w, operands=pf.performer_operands(p, w), **kw)
    torch.cuda.synchronize()
    assert torch.equal(cast, prepared)


@functools.lru_cache(maxsize=None)
def _old_performer():
    from edgevisiontransformer_tpu_torch.bench import performer_ab

    return performer_ab.build_libraries(source_variants=False)[1]


# The kernels against the kernels they replaced (their source in
# bench/performer_ab.py, built beside): within the twin bound; -rP prints
# how many elements differ.
@pytest.mark.parametrize("batch,n", [(1, 3136), (1, 784), (32, 3136), (32, 784), (2, 300)])
def test_performer_agrees_with_the_old_kernels(dev, batch, n):
    from edgevisiontransformer_tpu_torch.bench import performer_ab

    x, p, w = _performer_inputs(dev, batch, n, seed=7)
    got = pf.performer_rest(x, p, w, eps_ln=1e-5, approx_gelu=True)
    run_reduce, run_rows, old, _ = performer_ab.old_calls(_old_performer(), x, p, w, approx=True)
    run_reduce()
    run_rows()
    torch.cuda.synchronize()
    _close(got, old)
    diff = (got.float() - old.float()).abs()
    print(f"performer vs the old kernels, b{batch} n{n}: {int((diff > 0).sum())} of "
          f"{diff.numel()} elements differ, max {float(diff.max()):.3g}")


def test_performer_refuses_what_the_kernels_do_not_take(dev):
    x, p, w = _performer_inputs(dev, 1, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        pf.performer_rest(x.float(), p, w, eps_ln=1e-5, approx_gelu=True)
    with pytest.raises(ValueError, match="ts = 64"):
        pf.performer_rest(x, p, w[:16], eps_ln=1e-5, approx_gelu=True)
    with pytest.raises(ValueError, match="192"):
        pf.performer_rest(x[..., :96].contiguous(), p, w, eps_ln=1e-5, approx_gelu=True)


@pytest.mark.parametrize("batch", [1, 8])
def test_t2t_tokenize_runs_k16_and_the_int8_stem(dev, batch):
    model, shape = build_model("t2t_vit_7", dtype=torch.bfloat16, depth=1, device=dev,
                               generator=torch.Generator().manual_seed(1))
    img = torch.randn(batch, *shape, generator=torch.Generator().manual_seed(2)).to(dev)
    with torch.no_grad():
        stem = t2t.prepare_t2t_stem_int8_static(model, batches=[img[:1].cpu().numpy()])
        for stem_q in (None, stem):
            _reset_all()
            got = t2t.t2t_tokenize(model, img, stem_q=stem_q)
            counts = _all_counts()
            ref = t2t.t2t_tokenize(model, img, stem_q=stem_q, plain=True)
            want_i8 = 0 if stem_q is None else (2 if batch < 8 else 3)
            assert counts["performer_reduce"] == counts["performer_rows"] == 2
            assert counts["quant_rows"] == counts["linear_i8"] == want_i8
            assert counts["stage1_kqv"] == int(batch < 8)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max()
            assert err <= 0.05 * ref.float().abs().max()


def _all_counts():
    return {**fe.LAUNCHES, **ts.LAUNCHES, **sb.LAUNCHES, **sm.LAUNCHES, **ws.LAUNCHES,
            **fa.LAUNCHES, **fm.LAUNCHES, **vf.LAUNCHES, **pf.LAUNCHES}


def _reset_all():
    for m in (fe, ts, sb, sm, ws, fa, fm, vf, pf):
        m.reset_launches()


def test_kernel_backward_raises_on_the_card_and_the_forward_is_unchanged(dev):
    """No kernel has a backward: with grad on and an input that requires
    grad, a wrapper's output is the no-grad call's, bit for bit, and its
    backward raises instead of leaving the weights without a gradient; the
    ViT module path (``sdpa``, ``mlp``) and ``fused_vit_apply`` alike."""
    x = _rnd(dev, 197, 192)
    w = _rnd(dev, 192, 576, scale=192 ** -0.5, seed=1).requires_grad_()
    b = _rnd(dev, 576, seed=2)
    calls = {
        "linear": lambda: fe.linear(x, w, b, epilogue=fe.CAST_THEN_BIAS),
        "ln_rows": lambda: fe.ln_rows(x, w[:, 0].detach().clone().requires_grad_(), b[:192],
                                      1e-6),
        "attention_rows": lambda: fe.attention_rows(x @ w, heads=3, head_dim=64, tokens=197),
        "quant_rows": lambda: fe.quant_rows(x @ w[:, :192])[1],
        "mlp": lambda: fm.mlp(x[None], w[:, :192].contiguous(), b[:192],
                              w[:, :192].T.contiguous(), b[:192]),
    }
    for name, call in calls.items():
        got = call()
        with torch.no_grad():
            ref = call()
        torch.cuda.synchronize()
        assert got.requires_grad and torch.equal(got.detach(), ref), name
        with pytest.raises(RuntimeError, match=f"{name}: no backward kernel yet"):
            got.float().sum().backward()
    model = ViT(deit_config("tiny", depth=2, dtype=torch.bfloat16, kernel_mode="pallas"),
                device=dev, generator=torch.Generator().manual_seed(0))
    img = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(1)).to(dev)
    with pytest.raises(RuntimeError, match="no backward kernel yet"):
        model(img).float().sum().backward()
    bf = ViT(deit_config("tiny", depth=2, dtype=torch.bfloat16), device=dev)
    with pytest.raises(RuntimeError, match="no backward kernel yet"):
        fused_vit_apply(bf, img.requires_grad_()).float().sum().backward()


# ---------------------------------------------------------------------------
# The shapes a compiled sparse model reaches: hidden widths down to one unit
# (compile keeps at least one), one head of three
# ---------------------------------------------------------------------------

COMPILED_WIDTHS = (1, 7, 24)


@pytest.mark.parametrize("width", COMPILED_WIDTHS)
@pytest.mark.parametrize("m", [197, 32 * 197])
def test_linear_kernel_at_compiled_widths_matches_twin(dev, width, m):
    """fc1 (K = 192 -> N = width, GELU) and fc2 (K = width -> N = 192, the
    residual) of a deit_tiny layer pruned to ``width`` hidden units."""
    for k, n, epilogue in ((192, width, fe.CAST_THEN_BIAS_GELU), (width, 192, fe.BIAS_RESIDUAL)):
        args, kw = _linear_args(dev, m, k, n, epilogue)
        fe.reset_launches()
        got = fe.linear(*args, **kw)
        assert fe.LAUNCHES["linear"] == 1
        _close(got, fe.linear_plain(*args, **kw))


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("width", COMPILED_WIDTHS)
@pytest.mark.parametrize("m", [197, 32 * 197])
def test_int8_kernels_at_compiled_widths_match_twin(dev, width, m, static):
    """quant_rows of the hidden activation (K = width), and linear_i8's fc1
    (192 -> width, GELU) and fc2 (width -> 192, the residual): bit for bit
    but the GELU epilogue."""
    h = _rnd(dev, m, width, scale=3.0)
    act_inv = (30.0 * _uniform(dev, 3, 4, seed=1)).contiguous() if static else None
    q, s = fe.quant_rows(h, act_inv, 2)
    q_p, s_p = fe.quant_rows_plain(h, act_inv, 2)
    torch.cuda.synchronize()
    assert torch.equal(q, q_p) and (static or torch.equal(s, s_p))
    for k, n, epilogue in ((192, width, fe.BIAS_GELU), (width, 192, fe.BIAS_RESIDUAL)):
        unit = 1.0 / (73.0 * 73.0 * k ** 0.5)
        q, w_q = _int8(dev, m, k), _int8(dev, k, n, seed=1)
        s_row = None if static else _uniform(dev, m, seed=2) * 0.05
        w_s = _uniform(dev, n, seed=3) * (unit if static else unit / 0.05)
        b = torch.randn(n, device=dev)
        res = _rnd(dev, m, n, seed=4) if epilogue == fe.BIAS_RESIDUAL else None
        kw = dict(epilogue=epilogue, out_dtype=torch.bfloat16, res=res)
        got = fe.linear_i8(q, s_row, w_q, w_s, b, **kw)
        ref = fe.linear_i8_plain(q, s_row, w_q, w_s, b, **kw)
        if epilogue == fe.BIAS_GELU:
            _close(got, ref)
        else:
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (got.float() - ref.float()).abs().max()


@pytest.mark.parametrize("batch", [1, 32])
def test_attention_rows_one_head_of_three_matches_twin(dev, batch):
    """deit_tiny's attention pruned to one of its three heads (head_dim 64)."""
    qkv = _rnd(dev, batch * 197, 3 * 64)
    kw = dict(heads=1, head_dim=64, tokens=197)
    _close(fe.attention_rows(qkv, **kw), fe.attention_rows_plain(qkv, **kw))


# twelve layers, each its own (heads, hidden): every segment one layer
COMPILED_LAYERS = ((1, 1), (2, 7), (3, 24), (1, 64), (2, 230), (3, 537), (1, 768), (2, 1),
                   (3, 7), (1, 24), (2, 100), (3, 333))


@pytest.mark.parametrize("batch", [1, 32])
def test_twelve_layers_each_its_own_shape_on_the_kernels(dev, batch):
    """A deit_tiny whose every layer has its own heads and hidden width
    through ``fused_vit_apply`` (segmented and packed) and static
    ``fused_vit_apply_int8``: the logits against the twins within 5% of
    max|logit|, the launches of twelve layers."""
    heads, hidden = zip(*COMPILED_LAYERS)
    cfg = deit_config("tiny", heads_per_layer=heads, mlp_dim_per_layer=hidden, head_dim=64,
                      dtype=torch.bfloat16)
    model = ViT(cfg, device=dev, generator=torch.Generator().manual_seed(4))
    assert len(tvit.encoder_segments(cfg)) == 12
    img = torch.randn(batch, 3, 224, 224, generator=torch.Generator().manual_seed(5)).to(dev)
    with torch.no_grad():
        sq = prepare_vit_int8_static(model, calib_batches=[img[:1].cpu().numpy()])
        runs = {
            "segmented": (lambda plain: fused_vit_apply(model, img, plain=plain),
                          {"ln_rows": 24, "linear": 48, "attention_rows": 12}),
            "packed": (lambda plain: fused_vit_apply(model, img, pack_layers=True, plain=plain),
                       {"ln_rows": 24, "linear": 48, "attention_rows": 12}),
            "int8 static": (lambda plain: fused_vit_apply_int8(model, img, stacked_q=sq,
                                                               plain=plain),
                            {"ln_rows": 24, "attention_rows": 12, "quant_rows": 48,
                             "linear_i8": 48}),
        }
        for name, (run, want) in runs.items():
            fe.reset_launches()
            got = run(False)
            counts = {k: v for k, v in fe.LAUNCHES.items() if v}
            ref = run(True)
            torch.cuda.synchronize()
            assert counts == want, name
            assert got.shape == (batch, 1000) and torch.isfinite(got.float()).all(), name
            assert (got.float() - ref.float()).abs().max() <= 0.05 * ref.float().abs().max(), name


def _chip_smoke():
    """``chip_smoke.py``'s builders of published state dicts (the GPU
    machine has no transformers)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


# A checkpoint shape the importer takes, as the JAX one does, and the card
# path refuses: a Swin window of 14 (196 tokens, above the window kernels'
# 144).  The card path raises its own error; no twin answers in its place.
def test_imported_swin_window_14_is_refused_on_the_card(dev):
    from types import SimpleNamespace

    from edgevisiontransformer_tpu_torch.utils import hf_import as hi
    from edgevisiontransformer_tpu_torch.utils.jax_bridge import load_jax_params

    cs = _chip_smoke()
    hf = SimpleNamespace(**{**cs.HF_SWIN_T, "image_size": 112, "window_size": 14,
                            "depths": [2], "num_heads": [3]})
    cfg = hi.swin_config_from_hf(hf).replace(dtype=torch.bfloat16)
    tree = hi.import_hf_swin(cs.hf_swin_state_dict(torch, hf, torch.Generator().manual_seed(0)),
                             cfg)["params"]
    img = torch.randn(1, 3, 112, 112, generator=torch.Generator().manual_seed(1)).to(dev)
    model = load_jax_params(swin.SwinTransformer(cfg, device=dev), tree)
    sb.reset_launches()
    with torch.no_grad(), pytest.raises(ValueError, match="window 14 has 196 tokens"):
        swin.fused_swin_apply(model, img)
    module = load_jax_params(swin.SwinTransformer(cfg.replace(kernel_mode="pallas"), device=dev),
                             tree)
    ws.reset_launches()
    with torch.no_grad(), pytest.raises(ValueError, match="196 tokens per window"):
        module(img)
    assert sb.LAUNCHES["window_attention"] == 0 and ws.LAUNCHES["window_sdpa"] == 0


# An imported ViT of width 1536 (24 heads of 64, one layer, image 32) on the
# module path: mlp at dim 1,536 (csrc/mlp_wide.cu) and sdpa at head_dim 64, one
# launch of each a layer; the logits against the twins.
def test_imported_vit_dim_1536_runs_on_the_module_path(dev, monkeypatch):
    from types import SimpleNamespace

    from edgevisiontransformer_tpu_torch.utils import hf_import as hi
    from edgevisiontransformer_tpu_torch.utils.jax_bridge import load_jax_params

    cs = _chip_smoke()
    hf = SimpleNamespace(**{**cs.HF_VIT_B16, "hidden_size": 1536, "num_attention_heads": 24,
                            "num_hidden_layers": 1, "image_size": 32})
    cfg = hi.vit_config_from_hf(hf).replace(dtype=torch.bfloat16, kernel_mode="pallas")
    tree = hi.import_hf_vit(cs.hf_vit_state_dict(torch, hf, torch.Generator().manual_seed(2)),
                            cfg)["params"]
    model = load_jax_params(ViT(cfg, device=dev), tree)
    img = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(3)).to(dev)
    _reset_module_counts()
    with torch.no_grad():
        got = model(img)
        counts = _module_counts()
        monkeypatch.setattr(fa, "sdpa", fa.sdpa_plain)
        monkeypatch.setattr(fm, "mlp", fm.mlp_plain)
        ref = model(img)
    torch.cuda.synchronize()
    assert counts["mlp"] == counts["sdpa"] == 1 and sum(counts.values()) == 2
    assert got.shape == (2, 1000) and torch.isfinite(got.float()).all()
    assert (got.float() - ref.float()).abs().max() <= 0.05 * ref.float().abs().max()


# Past the widened limits: head_dim 136 (above 128) and 20 (not a multiple
# of 8) raise a ValueError that names the limit, and nothing launches.
# sdpa's rows of 20 values are not 16-byte vectors: its stride check refuses
# them first.  The MLP has no width limit above 1,152 (csrc/mlp_wide.cu):
# dim 2,056 runs, once, and matches the twin.
def test_head_dim_136_is_refused_without_a_launch_and_mlp_dim_2056_runs(dev):
    _reset_all()
    for hd in (136, 20):
        with pytest.raises(ValueError, match="multiple of 8 from 16 to 128"):
            fe.attention_rows(_rnd(dev, 2 * 50, 3 * 2 * hd), heads=2, head_dim=hd, tokens=50)
    with pytest.raises(ValueError, match="multiple of 8 from 16 to 128"):
        fa.sdpa(*_qkv_views(dev, 1, 2, 50, 136))
    with pytest.raises(ValueError, match="strides"):
        fa.sdpa(*_qkv_views(dev, 1, 2, 50, 20))
    model, prep = _full_model(dev, dim=272, heads=2, mlp_dim=544)  # head_dim 136
    img = torch.randn(1, 3, 224, 224, device=dev)
    with torch.no_grad(), pytest.raises(ValueError, match="multiple of 8 from 16 to 128"):
        tvit.fully_fused_vit_apply(model, img, prepared=prep)
    assert not any(_all_counts().values())
    x = _rnd(dev, 8, 2056)
    w1, b1 = _rnd(dev, 2056, 64, scale=0.02), _rnd(dev, 64)
    w2, b2 = _rnd(dev, 64, 2056, scale=0.02), _rnd(dev, 2056)
    got = fm.mlp(x, w1, b1, w2, b2)
    assert _all_counts() == {**{k: 0 for k in _all_counts()}, "mlp": 1}
    _close(got, fm.mlp_plain(x, w1, b1, w2, b2))


def test_cnn_on_the_card_matches_its_cpu_forward(dev):
    """mobilenet_v3_large (depthwise and grouped convs, SE, hard-swish) in
    fp32 on cuDNN, TF32 off, against the same module on the CPU, within
    chip_smoke.py's bound; and a bf16 cast stays finite."""
    import copy

    from edgevisiontransformer_tpu_torch.models.cnn.zoo import get_cnn

    cs = _chip_smoke()
    cpu = get_cnn("mobilenet_v3_large", device="cpu", generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(dev)
    x = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = cpu(x)
        got = card(x.to(dev)).cpu()
        half = copy.deepcopy(card).to(torch.bfloat16)(x.to(dev))
    assert got.shape == (2, 1000) and torch.isfinite(got).all() and ref.abs().max() > 0
    assert (got - ref).abs().max() <= cs.CNN_REL * ref.abs().max()
    assert half.dtype == torch.bfloat16 and torch.isfinite(half.float()).all()


def _ln_rank(rank, world, x, g, b):
    """A rank's ``ln_rows`` launch on the card, from the parent's library."""
    from edgevisiontransformer_tpu_torch.ops.cuda import build

    assert not build._build_allowed  # a rank opens the parent's library, never builds
    fe.reset_launches()
    y = fe.ln_rows(x.cuda(), g.cuda(), b.cuda(), 1e-6)
    t = y.float().sum().reshape(1)
    torch.distributed.all_reduce(t)
    torch.cuda.synchronize()
    return y, fe.LAUNCHES["ln_rows"], float(t)


def test_ranks_sharing_the_card_open_the_parents_library(dev):
    """Two gloo ranks on the card (parallel/launch.spawn) launch a kernel from
    the library the parent built, with the parent's bits, and reduce a CUDA
    tensor over gloo; the library is linked under a temporary name and moved
    into place, so no rank sees a half-written file."""
    from edgevisiontransformer_tpu_torch.ops.cuda import build
    from edgevisiontransformer_tpu_torch.parallel.launch import spawn

    build.load()
    assert build.library_path().exists()
    x = _rnd(dev, 197, 192, scale=3.0)
    g, b = _rnd(dev, 192, seed=1) + 1, _rnd(dev, 192, seed=2)
    want = fe.ln_rows(x, g, b, 1e-6).cpu()
    got = spawn(_ln_rank, 2, backend="gloo", device="cuda", deadline_s=240,
                args=(x.cpu(), g.cpu(), b.cpu()))
    for y, launches, total in got:
        assert torch.equal(y, want) and launches == 1
        assert total == pytest.approx(2 * float(want.float().sum()), rel=1e-6)
    stray = [p for p in build.library_path().parent.iterdir() if p.suffix != ".so"]
    assert not stray, stray


# The CLI's benchmark on the card: each --kernel-mode launches exactly its
# kernels (deit_tiny b1), as chip_smoke.py phase 12 checks at full size.
CLI_MODE_KERNELS = {
    "xla": set(),
    "pallas": {"sdpa", "mlp"},
    "fused": {"ln_rows", "linear", "attention_rows"},
    "int8": {"ln_rows", "attention_rows", "quant_rows", "linear_i8"},
    "int8_static": {"ln_rows", "attention_rows", "quant_rows", "linear_i8"},
}


@pytest.mark.parametrize("mode", sorted(CLI_MODE_KERNELS))
def test_cli_benchmark_launches_the_modes_kernels(dev, mode, capsys):
    import json

    from edgevisiontransformer_tpu_torch import cli

    mods = (fe, fa, fm, vf, pf, sb, sm, ts, ws)
    for m in mods:
        m.reset_launches()
    assert cli.main(["benchmark", "--kernel-mode", mode, "--iters", "3", "--repeats", "2",
                     "--device-time"]) == 0
    r = json.loads(capsys.readouterr().out.splitlines()[-1])
    ran = {k for m in mods for k, v in m.LAUNCHES.items() if v}
    assert ran == CLI_MODE_KERNELS[mode]
    assert r["p50_ms"] > 0 and r["device_p50_ms"] > 0 and r["batch"] == 1


def test_profile_trace_on_the_card_names_linear(dev):
    from edgevisiontransformer_tpu_torch.bench.profile import profile_trace

    model = build_model("deit_tiny", dtype=torch.bfloat16, device=dev,
                        generator=torch.Generator().manual_seed(0))[0]
    stacked = prepare_vit_fused(model)
    img = torch.ones(1, 3, 224, 224, dtype=torch.bfloat16, device=dev)

    def run_once():
        fused_vit_apply(model, img, stacked=stacked)
        torch.cuda.synchronize()

    with torch.no_grad():
        rows, total = profile_trace(run_once, iters=3, warmup=1)
    linear = [r for r in rows if "linear_kernel" in r["name"]]
    assert linear and all(r["node_type"] == "FULLY_CONNECTED" for r in linear)
    assert any(r["node_type"] == "LAYER_NORM" for r in rows)
    assert total > 0 and abs(sum(r["percent"] for r in rows) - 100.0) < 1e-6


def test_looptimer_agrees_with_the_event_timer(dev):
    """Both time a deit_tiny b128 fused_vit_apply call with the host in it;
    they run in turn, three times each, and their medians are compared, as
    the host's speed drifts from one measurement to the next."""
    import statistics

    from edgevisiontransformer_tpu_torch.bench import harness, looptimer

    model = build_model("deit_tiny", dtype=torch.bfloat16, device=dev,
                        generator=torch.Generator().manual_seed(0))[0]
    stacked = prepare_vit_fused(model)
    img = torch.ones(128, 3, 224, 224, dtype=torch.bfloat16, device=dev)
    fn = functools.partial(fused_vit_apply, model, stacked=stacked)
    loops, events = [], []
    with torch.no_grad():
        for _ in range(3):
            loops.append(looptimer.measure_op_time(fn, (img,), iters=20, repeats=3)["p50_ms"])
            events.append(harness.measure_call_time(fn, (img,), iters=20, repeats=5)["p50_ms"])
    loop, event = statistics.median(loops), statistics.median(events)
    assert abs(loop - event) <= 0.15 * event, (loops, events)


def test_harness_memory_on_the_card(dev):
    from edgevisiontransformer_tpu_torch.bench import harness

    x = torch.ones(1024, 1024, device=dev)
    x @ x  # cuBLAS's workspace, allocated at a handle's first product, is not the call's
    peak, live = harness.device_mem_mb()
    assert peak >= live >= 4.0
    # one call's own allocation: the 4 MiB product, above what was live
    assert harness.compiled_mem_mb(lambda a: a @ a, (x,)) == pytest.approx(4.0, abs=0.5)
    res = harness.benchmark_fn(lambda a: a @ a, (x,), name="mm", num_runs=3, iters=10,
                               batch_size=1)
    assert res.p50_ms > 0 and res.peak_hbm_mb is not None and res.throughput_per_s > 0
