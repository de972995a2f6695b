"""The arithmetic of ``csrc/window_sdpa.cu`` (K12, the Swin module's window
attention on the card), emulated in a few lines of PyTorch on the CPU and
held against JAX's K12 ``window_sdpa``
(``edgevisiontransformer_tpu/ops/pallas/window_attention.py``, in interpret
mode, as ``tests/test_torch_swin.py`` runs it) and against the port's twin
``window_sdpa_plain``.

The emulation follows the kernel: the keys in 16-key chunks (4 up to 64
tokens, 9 up to 144), zero-filled past ``n``; the fp32 score scaled by one
multiply, then the bias (in the compute dtype) and the mask (cast to the
compute dtype) added in that order; keys past ``n`` left out of the row max
and sum; ``exp(s - max)``, the fp32 row sum over the unrounded ``exp``, the
quotient ``e / l`` (the kernel's ``divide_exact`` gives the correctly
rounded quotient, which the division test below checks in exact rational
arithmetic over the fp32 range), then ``bf16(p)`` into PV with fp32
accumulation, chunk by chunk.  The anchors of ``bench/window_sdpa_ab.py``
are checked too; ``tests/test_torch_kernels_cuda.py`` holds the kernel
itself to the twin on the card.

Inputs come from a numpy seed.
"""

import random
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from edgevisiontransformer_tpu.models import swin as jswin
from edgevisiontransformer_tpu.ops.pallas.window_attention import window_sdpa
from edgevisiontransformer_tpu_torch.bench import window_sdpa_ab
from edgevisiontransformer_tpu_torch.ops.cuda import build
from edgevisiontransformer_tpu_torch.ops.cuda import window_sdpa as tws
from test_torch_sdpa_tiles import _rn32

torch.set_num_threads(1)

CHUNK = 16  # keys per chunk (csrc/window_sdpa.cu: 4 or 9 chunks)
# The bounds tests/test_torch_swin.py holds K12 to: fp32, the same math in
# another summation order; bf16, a value at most ~2 bf16 spacings off (p
# rounds to bf16 after normalising)
SDPA_FP32 = dict(rtol=1e-5, atol=1e-6)
SDPA_BF16 = dict(rtol=2.0 ** -6, atol=1e-2)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def kernel_tiles(qkv, bias, mask, *, heads, head_dim):
    """``window_sdpa`` as csrc/window_sdpa.cu computes it, chunk by chunk."""
    dt = qkv.dtype
    bw, n = qkv.shape[:2]
    nc = 4 if n <= 64 else 9
    q, k, v = qkv.float().reshape(bw, n, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
    k, v = (F.pad(x, (0, 0, 0, CHUNK * nc - n)) for x in (k, v))
    edge = F.pad(bias.float(), (0, CHUNK * nc - n))[None]  # [1, heads, n, 16 nc]
    if mask is not None:
        nw = mask.shape[0]
        m16 = F.pad(mask.to(dt).float(), (0, CHUNK * nc - n))
    s = torch.cat([q @ k[..., c * CHUNK:(c + 1) * CHUNK, :].transpose(-1, -2)
                   for c in range(nc)], dim=-1)
    s = s * torch.tensor(head_dim ** -0.5, dtype=torch.float32) + edge  # scale, then bias
    if mask is not None:  # then the mask
        s = (s.reshape(bw // nw, nw, heads, n, -1) + m16[None, :, None]).reshape(s.shape)
    s = s.masked_fill(torch.arange(CHUNK * nc) >= n, -torch.inf)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(dt).float()
    o = sum(p[..., c * CHUNK:(c + 1) * CHUNK] @ v[..., c * CHUNK:(c + 1) * CHUNK, :]
            for c in range(nc))
    return o.permute(0, 2, 1, 3).reshape(bw, n, heads * head_dim).to(dt)


def _inputs(images, w, heads, hd, dtype, shifted, seed=0, qk_scale=1.0):
    """Window-major qkv of ``images`` images of 2 x 2 windows, a bias in
    the compute dtype and, when ``shifted``, the fp32 shifted-window mask;
    the JAX and the torch sides hold the same values."""
    rng = np.random.default_rng(seed)
    n, res = w * w, 2 * w
    qkv = rng.standard_normal((images * 4, n, 3 * heads * hd)).astype(np.float32)
    qkv[..., :2 * heads * hd] *= qk_scale
    bias = (0.5 * rng.standard_normal((heads, n, n))).astype(np.float32)
    mask = jswin.shifted_window_mask(res, res, w, w // 2) if shifted else None
    jd, td = DTYPES[dtype]
    jq, jb = jnp.asarray(qkv).astype(jd), jnp.asarray(bias).astype(jd)
    tq, tb = torch.from_numpy(_np(jq)).to(td), torch.from_numpy(_np(jb)).to(td)
    tm = None if mask is None else torch.from_numpy(np.asarray(mask))
    return (jq, jb, None if mask is None else jnp.asarray(mask)), (tq, tb, tm)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _check(images, w, dtype, shifted, heads=2, hd=32, **kw):
    (jq, jb, jm), (tq, tb, tm) = _inputs(images, w, heads, hd, dtype, shifted, **kw)
    got = kernel_tiles(tq, tb, tm, heads=heads, head_dim=hd)
    assert got.shape == (images * 4, w * w, heads * hd) and got.dtype == tq.dtype
    assert torch.isfinite(got.float()).all()
    tol = SDPA_FP32 if dtype == "float32" else SDPA_BF16
    np.testing.assert_allclose(_np(got), _np(window_sdpa(jq, jb, jm, heads, hd)), **tol)
    np.testing.assert_allclose(
        _np(got), _np(tws.window_sdpa_plain(tq, tb, tm, heads=heads, head_dim=hd)), **tol)
    return tq, tb, tm


# window 7 (n = 49, 4 chunks: swin_tiny) over 2 images and window 12 (n =
# 144, 9 chunks: Swin at 384) over 1, shifted and not
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("images,w", [(2, 7), (1, 12)])
def test_kernel_tiles_match_jax_k12_and_the_twin(images, w, dtype, shifted):
    _check(images, w, dtype, shifted)


@pytest.mark.parametrize("w", [7, 12])
def test_kernel_tiles_with_subnormal_quotients_match(w):
    """Large |q . k| with the -100 mask: the masked keys' p = e / l fall
    into the fp32 subnormals (and to 0), which the kernel's division must
    round as __fdiv_rn does."""
    heads, hd = 2, 32
    tq, tb, tm = _check(1, w, "bfloat16", True, heads=heads, hd=hd, seed=3, qk_scale=3.0)
    q, k = tq.float()[..., :hd], tq.float()[..., heads * hd:heads * hd + hd]  # head 0
    s = (q @ k.transpose(-1, -2)) * hd ** -0.5 + tb.float()[0] + tm.to(tq.dtype).float()
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    assert ((p > 0) & (p < 2.0 ** -126)).any()


def _divide_exact(e: float, l: float, tie_fix: bool = True) -> float:
    """csrc/window_sdpa.cu ``divide_exact(e, l, __frcp_rn(l))``, each fp32
    operation rounded once from its exact value; ``tie_fix`` False leaves
    out the remainder's say on a tie (a broken copy, for the test's
    teeth)."""
    def fma(a, b, c):
        return _rn32(Fraction(a) * Fraction(b) + Fraction(c))

    y = _rn32(1 / Fraction(l))
    es = e * 2.0 ** 64  # exact
    q = _rn32(Fraction(es) * Fraction(y))
    q = fma(fma(-l, q, es), y, q)
    q = fma(fma(-l, q, es), y, q)
    r = fma(-l, q, es)
    if q >= 2.0 ** -62:
        return q * 2.0 ** -64  # exact
    t = q * 2.0 ** 85  # exact, below 2^23
    i = float(round(t))  # ties to even, as rintf
    if tie_fix:
        d = t - i
        i += (d == 0.5 and r > 0) - (d == -0.5 and r < 0)
    return i * 2.0 ** -149


def _bf16(xs) -> list:
    return torch.tensor(xs, dtype=torch.float32).bfloat16().float().tolist()


def _f32(x: float) -> float:
    return float(np.float32(x))


def _tie_pairs(rng, count):
    """(l, e) whose rounded scaled quotient q lands exactly on a half-way
    point of the fp32 subnormal grid while e / l does not: the cases the
    remainder decides.  Half-way points next to bf16 rounding midpoints
    (odd multiples of 2^15 units of 2^-149) come first."""
    pairs = []
    while len(pairs) < count:
        l = _f32(rng.uniform(1, 144))
        if len(pairs) < count // 2:  # k or k + 1 a bf16 midpoint, odd * 2^15 < 2^23
            k = ((2 * rng.randrange(1 << 7) + 1) << 15) - rng.randrange(2)
        else:
            k = rng.randrange(1, 1 << 23)
        x = (Fraction(k) + Fraction(1, 2)) * Fraction(2) ** -149
        e = _rn32(Fraction(l) * x)
        if e > 1 or e == 0:
            continue
        q = _rn32(Fraction(e) * Fraction(2) ** 64 / Fraction(l))
        if Fraction(q) == x * Fraction(2) ** 64 and Fraction(e) != Fraction(l) * x:
            pairs.append((l, e))
    return pairs


def test_divide_exact_is_the_correctly_rounded_quotient():
    """Every e the kernel meets (exp(s - m) in [0, 1], subnormals included:
    each binade from 2^-149 to 1) against softmax sums l in [1, 144] (random,
    integer, and just below powers of two, where RN(1/l) errs most), and
    the subnormal ties: fp32(route) == fp32(e / l correctly rounded), hence
    the same bf16(p) as bf16(__fdiv_rn(e, l)).  The copy without the tie
    rule must fail somewhere, in fp32 and in bf16."""
    rng = random.Random(0)
    ls = [_f32(rng.uniform(1, 144)) for _ in range(8)] + [1.0, 3.0, 49.0, 144.0]
    ls += [float(Fraction(2) ** k - Fraction(2) ** (k - 24)) for k in range(1, 8)]
    es = [0.0, 1.0, 2.0 ** -149, 2.0 ** -126, _f32(2.0 ** -126 * (1 - 2 ** -23))]
    for b in range(-149, 0):  # a random value in each binade
        es.append(_f32(2.0 ** b * (1 + rng.random())) if b >= -126
                  else rng.randrange(1 << (b + 149), 1 << (b + 150)) * 2.0 ** -149)
    pairs = [(l, e) for l in ls for e in rng.sample(es, 40)] + [(l, e) for l in ls[:3] for e in es]
    ties = _tie_pairs(rng, 120)
    got, want, naive = [], [], []
    for l, e in pairs + ties:
        assert e == _f32(e) and 0 <= e <= 1 and l == _f32(l) and 1 <= l <= 144
        got.append(_divide_exact(e, l))
        want.append(_rn32(Fraction(e) / Fraction(l)))
        naive.append(_divide_exact(e, l, tie_fix=False))
    assert got == want
    assert _bf16(got) == _bf16(want)
    assert any(0 < w < 2.0 ** -126 for w in want)
    assert naive != want and _bf16(naive) != _bf16(want)


def test_window_sdpa_ab_finds_every_anchor_in_the_committed_source():
    src = (build.CSRC / "window_sdpa.cu").read_text()
    found = window_sdpa_ab.variants(src)
    assert list(found) == [window_sdpa_ab.COMMITTED, "__fdiv_rn per score", "reciprocal product",
                           "no division"]
    assert found[window_sdpa_ab.COMMITTED] == src
    others = [code for name, code in found.items() if name != window_sdpa_ab.COMMITTED]
    assert all(code != src for code in others) and len(set(others)) == len(others)
    assert "evt_window_sdpa_wmma(" in window_sdpa_ab.WMMA_SOURCE
    assert "wmma::mma_sync" in window_sdpa_ab.WMMA_SOURCE and "wmma::" not in src
