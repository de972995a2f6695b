"""The arithmetic of ``csrc/attention_rows.cu`` (K1's attention on the card),
emulated in a few lines of PyTorch on the CPU and held against JAX's
``_attention_rows`` (``ops/pallas/fused_encoder.py:101-171``, run inside an
interpret-mode ``pallas_call`` by ``tests/test_torch_kernels_plain.py``'s
helper) and against the port's twin ``attention_rows_plain``.

The emulation follows the kernel: the keys in 16-key chunks, only the chunks
that hold a key below ``seq_len`` (rows past ``tokens`` zero-filled), the
scores scaled by one fp32 multiply, ``p = exp2(min(s, 60))`` with the keys
at or past ``seq_len`` 0, the fp32 row sums over the unrounded ``p``,
``bf16(p)`` into PV with fp32 accumulation, then the reciprocal of
``max(r, 1e-30)`` and one multiply.  The plan that picks the kernel's grid
(``fused_encoder.attention_plan``) and the anchors of
``bench/attention_ab.py`` are checked too; ``tests/test_torch_kernels_cuda.py``
holds the kernel itself to the twin on the card.

Inputs come from a numpy seed.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from edgevisiontransformer_tpu_torch.bench import attention_ab
from edgevisiontransformer_tpu_torch.ops.cuda import build
from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as tfe
from test_torch_kernels_plain import _jax_attention_rows

torch.set_num_threads(1)

CHUNK = 16  # keys per chunk (csrc/attention_rows.cu: 16-key chunks, four to a tile)
# fp32: the bound of the JAX package's kernel tests (sums of up to 208 terms
# in another order); bf16: the kernel tolerance of PERF.md section 2 (an
# fp32-order difference can move a p before PV, or the output, across a
# bf16 rounding boundary)
FP32 = dict(rtol=1e-5, atol=1e-5)
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 1e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
H100_SMS = 132
# (heads, tokens) of models whose encoders run attention_rows
PLAN_SHAPES = {"deit_tiny": (3, 197), "t2t_vit_14": (6, 197), "pruned h1": (1, 197)}


def kernel_tiles(qkv, *, heads, head_dim, tokens, seq_len):
    """``attention_rows`` as csrc/attention_rows.cu computes it, chunk by
    chunk."""
    dt, b = qkv.dtype, qkv.shape[0] // tokens
    q, k, v = qkv.float().reshape(b, tokens, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
    chunks = -(-seq_len // CHUNK)  # the chunks that hold a key below seq_len
    k, v = (F.pad(x, (0, 0, 0, max(0, CHUNK * chunks - tokens)))[..., :CHUNK * chunks, :]
            for x in (k, v))
    scale2 = torch.tensor(head_dim ** -0.5 * tfe._LOG2E, dtype=torch.float32)
    o = torch.zeros(b, heads, tokens, head_dim)
    r = torch.zeros(b, heads, tokens, 1)
    for c in range(chunks):
        keys = slice(c * CHUNK, (c + 1) * CHUNK)
        s = (q @ k[..., keys, :].transpose(-1, -2)) * scale2
        p = torch.exp2(torch.clamp(s, max=60.0))
        p = p.masked_fill(torch.arange(c * CHUNK, (c + 1) * CHUNK) >= seq_len, 0.0)
        r = r + p.sum(-1, keepdim=True)  # fp32, over the unrounded p
        o = o + p.to(dt).float() @ v[..., keys, :]
    out = o * (1.0 / torch.clamp(r, min=1e-30))
    return out.permute(0, 2, 1, 3).reshape(b * tokens, heads * head_dim).to(dt)


def _inputs(b, n, heads, hd, dtype, seed=0, scale_rows=0):
    """qkv [b * n, 3 * heads * hd] for JAX and for torch, the same values;
    the q and k columns of the first ``scale_rows`` tokens times 6."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, 3 * heads * hd)).astype(np.float32)
    x[:, :scale_rows, : 2 * heads * hd] *= 6.0
    flat = x.reshape(b * n, -1)
    jx = jnp.asarray(flat).astype(DTYPES[dtype][0])
    return jx, torch.from_numpy(_np(jx)).to(DTYPES[dtype][1])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close(got, ref, dtype):
    got, ref = _np(got), _np(ref)
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, **FP32)
    else:
        err = np.abs(got - ref)
        assert (err <= BF16_ATOL + BF16_RTOL * np.abs(ref)).all(), err.max()


def _check(b, n, seq_len, heads, hd, dtype, **kw):
    jx, tx = _inputs(b, n, heads, hd, dtype, **kw)
    args = dict(heads=heads, head_dim=hd, tokens=n, seq_len=seq_len)
    got = kernel_tiles(tx, **args)
    assert got.shape == (b * n, heads * hd) and got.dtype == tx.dtype
    ref = _jax_attention_rows(jx, bm=b, n_pad=n, heads=heads, head_dim=hd, seq_len=seq_len,
                              dtype=DTYPES[dtype][0])
    _close(got, ref, dtype)
    _close(got, tfe.attention_rows_plain(tx, **args), dtype)
    return got


# n = 1 and 5 (one chunk; the layerwise pruned config has 5 tokens), 65 (a
# second tile of one chunk), 197 (13 chunks, every registry ViT at 224^2),
# 200 tokens with seq_len 197 (the TPU's padding: keys 197-199 loaded and
# masked)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("n,seq_len", [(1, 1), (5, 5), (65, 65), (197, 197), (200, 197)])
def test_kernel_tiles_match_jax_k1_and_the_twin(n, seq_len, hd, dtype):
    _check(2, n, seq_len, 2, hd, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [24, 197])
def test_kernel_tiles_clamp60_rows_tie(n, dtype):
    """Rows whose log2-scaled scores pass 60 clamp there and tie, where an
    eager softmax would not; rows past them are ordinary."""
    _, tx = _inputs(1, n, 2, 32, dtype, seed=3, scale_rows=4)
    q, k = tx.float()[:4, :32], tx.float()[:, 64:96]
    assert ((q @ k.T) * 32 ** -0.5 * tfe._LOG2E).max() > 60
    _check(1, n, n, 2, 32, dtype, seed=3, scale_rows=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [5, 70])
def test_kernel_tiles_with_every_key_masked_give_zeros(n, dtype):
    got = _check(1, n, 0, 2, 16, dtype)
    assert not got.float().any()


@pytest.mark.parametrize("batch", [1, 8, 128])
@pytest.mark.parametrize("model", list(PLAN_SHAPES))
def test_attention_plan_covers_every_row_once(model, batch):
    """The kernel's grid (block = strip + strips * (image * heads + head),
    warp w of a block owning rows 16 (strip * warps + w) .. + 15) covers
    each query row of each (image, head) once, in blocks of 8 warps where
    those still number 1.5 an SM (the rule bench/attention_ab.py set), else
    of 4."""
    heads, tokens = PLAN_SHAPES[model]
    warps = tfe.attention_plan(batch, heads, tokens, H100_SMS)
    assert warps in tfe.ATTENTION_WARPS
    strips = -(-tokens // (16 * warps))
    covered = Counter()
    for block in range(strips * batch * heads):
        strip, bh = block % strips, block // strips
        for w in range(warps):
            row0 = (strip * warps + w) * 16
            covered.update((bh, row) for row in range(row0, min(row0 + 16, tokens)))
    assert len(covered) == batch * heads * tokens and set(covered.values()) == {1}
    wide = -(-tokens // 128) * batch * heads
    assert (warps == 8) == (wide >= 1.5 * H100_SMS)


def test_attention_plan_at_deit_tiny_and_deit_base():
    # b1: 4 strips of 4 warps x 3 heads = 12 blocks; b128: 2 x 384 = 768 of 8
    assert tfe.attention_plan(1, 3, 197, H100_SMS) == 4
    assert tfe.attention_plan(128, 3, 197, H100_SMS) == 8
    # deit_base b8: 192 blocks of 8 warps, 1.45 an SM, lose to 384 of 4
    assert tfe.attention_plan(8, 12, 197, H100_SMS) == 4


def test_attention_ab_finds_every_anchor_in_the_committed_source():
    src = {name: (build.CSRC / name).read_text()
           for name in (attention_ab.STRIP, attention_ab.ENTRY)}
    found = attention_ab.variants(src[attention_ab.STRIP], src[attention_ab.ENTRY])
    assert list(found) == ["committed", "3 stages", "4 stages (resident)", "no softmax",
                           attention_ab.NARROW]
    assert found["committed"] == src
    others = [tuple(files.items()) for name, files in found.items() if name != "committed"]
    assert all(dict(files) != src for files in others) and len(set(others)) == len(others)
    assert "attn::tile<HD>" in attention_ab.TILE_SOURCE
    assert "namespace attn {" in (build.CSRC / "encoder_tiles.cuh").read_text()
