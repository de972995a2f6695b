"""The plan of ``csrc/vit_full.cu`` (``fused_vit_full.vit_full_plan``: each
GEMM phase's tile, the attention strip's warps and the grid of the one-launch
DeiT forward, K7a / K7b on the card), checked on the CPU: the kernel's loops
over its warp groups cover every output once under the plan, the plan names
only shapes the committed kernel is compiled for, its shared memory fits two
blocks an SM, its grid two blocks an SM, and a b1 GEMM phase spreads over
the card.  The GEMM phases' arithmetic, ``linear``'s k16-ordered tile
(``tests/test_torch_linear_tiles.py:kernel_tiles``), walked tile by tile in
the plan's order, is held against JAX's K7 lines
(``ops/pallas/fused_vit_full.py:55-105``) at a tiny shape, and gives the
same bits under every plan.

Inputs come from a numpy seed.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.ops.pallas import mathlib as jmath
from edgevisiontransformer_tpu_torch.ops.cuda import build
from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as tfe
from edgevisiontransformer_tpu_torch.ops.cuda import fused_vit_full as tvf
from test_torch_linear_tiles import BF16_ATOL, BF16_RTOL, kernel_tiles

torch.set_num_threads(1)

H100_SMS = 132
TOKENS = 197
# (dim, mlp, classes) of the two DeiT widths the whole-model path serves
MODELS = {"deit_tiny": (192, 768, 1000), "deit_base": (768, 3072, 1000)}
BATCHES = (1, 8, 128)
HEAD_DIMS = (16, 32, 64, 128)


def _plan(model, batch, head_dim, sms=H100_SMS, **kw):
    dim, mlp, classes = MODELS[model]
    heads = max(1, dim // head_dim)
    return (tvf.vit_full_plan(batch, TOKENS, dim, heads, head_dim, mlp, classes, sms, **kw),
            (batch, TOKENS, dim, heads, head_dim, mlp, classes))


def _slots(grid, groups, units):
    """The units each (block, group) slot of the kernel's loop takes: group g
    of block b runs units b * groups + g, + grid * groups, ..."""
    return {(b, g): list(range(b * groups + g, units, grid * groups))
            for b in range(grid) for g in range(groups)}


def _tiles(m, n, rows, cols):
    """Tile t of a GEMM phase: rows (t // tn) * rows.., columns (t % tn) * cols..
    (csrc/vit_full.cu gemm_groups), masked at M and N."""
    tn = -(-n // cols)
    return [(range((t // tn) * rows, min((t // tn + 1) * rows, m)),
             range((t % tn) * cols, min((t % tn + 1) * cols, n)))
            for t in range(-(-m // rows) * tn)]


def _covers_once(spans, size):
    counts = np.zeros(size, dtype=np.int64)
    for r in spans:
        counts[r.start:r.stop] += 1
    return bool((counts == 1).all())


@pytest.mark.parametrize("reference_residual", [False, True])
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("model", sorted(MODELS))
def test_plan_covers_each_phase_once_within_the_kernel(model, batch, head_dim,
                                                       reference_residual):
    """Under the plan's grid every GEMM tile, attention strip, LayerNorm row
    and head tile is run by exactly one (block, group), and the tiles of a
    GEMM phase cover its [M, N] output exactly once.  The residual form picks
    what an epilogue reads, never the plan."""
    plan, (b, n_tok, dim, heads, hd, mlp, classes) = _plan(model, batch, head_dim)
    assert plan == _plan(model, batch, head_dim)[0]  # the plan reads no residual form
    for (m, n), code in zip(tvf.gemm_shapes(b, n_tok, dim, heads, hd, mlp), plan.tiles):
        rows, cols, groups = tvf.VIT_FULL_TILES[code]
        tiles = _tiles(m, n, rows, cols)
        taken = sorted(t for ts in _slots(plan.grid, groups, len(tiles)).values() for t in ts)
        assert taken == list(range(len(tiles)))
        col_spans = [cs for rs, cs in tiles if rs.start == 0]
        row_spans = [rs for rs, cs in tiles if cs.start == 0]
        assert _covers_once(col_spans, n) and _covers_once(row_spans, m)
        assert len(tiles) == len(col_spans) * len(row_spans)
    warps = plan.attn_warps
    strips = -(-n_tok // (16 * warps))
    units = strips * heads * b
    per_block = tvf.VIT_FULL_THREADS // (32 * warps)
    taken = sorted(u for us in _slots(plan.grid, per_block, units).values() for u in us)
    assert taken == list(range(units))
    rows_of = [range(s * warps * 16, min((s + 1) * warps * 16, n_tok)) for s in range(strips)]
    assert _covers_once(rows_of, n_tok)
    ln_rows = sorted(r for us in _slots(plan.grid, 8, b * n_tok).values() for r in us)
    assert ln_rows == list(range(b * n_tok))


def _compiled():
    """The tile shapes, strip warps and head dims csrc/vit_full.cu compiles,
    read from the committed source."""
    src = (build.CSRC / "vit_full.cu").read_text()
    shapes = re.findall(r"if \(tile == (0)\) gemm_groups<(\d+), (\d+), (\d+)>", src)
    shapes += re.findall(r"else (gemm)_groups<(\d+), (\d+), (\d+)>", src)
    tiles = []
    for i, (_, wm, tm, tn) in enumerate(shapes):
        code = i
        wm, tm, tn = int(wm), int(tm), int(tn)
        tiles.append((int(code), (wm * tm, 2 * tn, tvf.VIT_FULL_THREADS // (wm * 2 * 32))))
    warps = sorted({int(w) for w in re.findall(r"attention_groups<HD, (\d+)>", src)})
    instances = {(int(h), int(b)) for h, b in re.findall(
        r"case (\d+) \* 4 \+ (\d):(?: return launch_full|\n)", src)}
    return src, tiles, warps, instances


def test_the_kernel_is_compiled_for_every_shape_of_the_plan():
    src, tiles, warps, instances = _compiled()
    assert tiles == list(enumerate(tvf.VIT_FULL_TILES))
    assert warps == sorted(tfe.ATTENTION_WARPS)
    # every (head_dim, blocks an SM) a plan may name, and at head_dim 128 one block only
    plans = {(hd, _plan(m, b, hd)[0].blocks) for m in MODELS for b in BATCHES for hd in HEAD_DIMS}
    assert plans <= instances
    assert instances == {(hd, b) for hd in (16, 32, 64) for b in (1, 2)} | {(128, 1)}
    assert f"constexpr int TILE_CODES = {len(tvf.VIT_FULL_TILES)};" in src
    assert f"constexpr int THREADS = {tvf.VIT_FULL_THREADS};" in src
    for rows, cols, groups in tvf.VIT_FULL_TILES:  # each group a whole number of warp rows
        assert rows % 16 == 0 and cols % 32 == 0 and groups in (1, 2, 4, 8)


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("model", sorted(MODELS))
def test_plan_takes_compiled_shapes_fits_shared_memory_and_two_blocks_an_sm(model, batch,
                                                                            head_dim):
    plan, (b, n_tok, dim, heads, hd, mlp, classes) = _plan(model, batch, head_dim)
    assert all(0 <= c < len(tvf.VIT_FULL_TILES) for c in plan.tiles)
    assert len(plan.tiles) == len(tvf.GEMM_PHASES)
    assert plan.attn_warps == tfe.attention_plan(b, heads, n_tok, H100_SMS)
    smem = tvf.vit_full_smem_bytes(plan, hd, dim)
    per_sm = plan.blocks
    # two blocks an SM where a phase takes 128-row tiles at head_dim <= 64
    assert per_sm == (2 if hd <= 64 and 0 in plan.tiles else 1)
    assert per_sm * (smem + tvf.BLOCK_RESERVE_BYTES) <= tvf.SM_SHARED_BYTES
    need = tvf.phase_blocks(plan, b, n_tok, dim, heads, hd, mlp, classes)
    assert 1 <= plan.grid == min(per_sm * H100_SMS, max(need.values())) <= 2 * H100_SMS


def test_smem_mirror_matches_the_kernel_layout_by_hand():
    """csrc/vit_full.cu smem_of, worked by hand: deit_tiny b1 (16 x 32 tiles,
    four 22,272-byte rings; two 4-warp strips of 64 Q rows and two stages of
    64-key K and V at 72 elements a row) and b128 (the 128 x 96 ring)."""
    b1, _ = _plan("deit_tiny", 1, 64)
    assert tfe._linear_smem_bytes(16, 32) == 3 * (16 * 72 + 64 * 40) * 2 == 22272
    assert tvf.vit_full_smem_bytes(b1, 64, 192) == 2 * (64 + 2 * 2 * 64) * 72 * 2 == 92160
    b128, _ = _plan("deit_tiny", 128, 64)
    assert tvf.vit_full_smem_bytes(b128, 64, 192) == 3 * (128 * 72 + 64 * 104) * 2 == 95232
    assert (b1.blocks, b128.blocks) == (1, 2)
    assert 2 * (95232 + tvf.BLOCK_RESERVE_BYTES) <= tvf.SM_SHARED_BYTES


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("model", sorted(MODELS))
def test_b1_gemm_phases_take_at_least_a_slot_an_sm(model, head_dim):
    """At b1 every GEMM phase runs 16 x 32 tiles on four warp groups a
    block: at least one tile an SM where M * N holds that many 16 x 32
    tiles, where 128-row tiles gave 2-24."""
    plan, (b, n_tok, dim, heads, hd, mlp, classes) = _plan(model, 1, head_dim)
    for (m, n), code in zip(tvf.gemm_shapes(b, n_tok, dim, heads, hd, mlp), plan.tiles):
        rows, cols, groups = tvf.VIT_FULL_TILES[code]
        assert (rows, cols) == (16, 32)
        tiles = -(-m // rows) * -(-n // cols)
        assert tiles >= min(H100_SMS, m * n // (rows * cols))
        assert min(tiles, plan.grid * groups) >= min(H100_SMS, tiles)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_serving_batches_take_128_by_96_tiles(model):
    """At b128 every GEMM phase takes 128 x 96 tiles, one 8-warp group a
    block (every DeiT width is a whole number of them), and the grid is two
    blocks an SM."""
    plan, (b, n_tok, dim, heads, hd, mlp, classes) = _plan(model, 128, 64)
    for (m, n), code in zip(tvf.gemm_shapes(b, n_tok, dim, heads, hd, mlp), plan.tiles):
        assert tvf.VIT_FULL_TILES[code] == (128, 96, 1) and n % 96 == 0
    assert plan.grid == 2 * H100_SMS


def test_plan_overrides_force_rows_blocks_and_cap_the_grid():
    plan, _ = _plan("deit_tiny", 1, 64, rows=128)
    assert {tvf.VIT_FULL_TILES[c][0] for c in plan.tiles} == {128} and plan.blocks == 2
    assert _plan("deit_tiny", 1, 64)[0].blocks == 1  # b1: one block an SM
    assert _plan("deit_tiny", 128, 64, blocks=1)[0].grid == H100_SMS
    assert _plan("deit_base", 1, 64, blocks=2)[0].grid == 2 * H100_SMS
    assert _plan("deit_tiny", 1, 64, grid=7)[0].grid == 7
    assert _plan("deit_tiny", 128, 64, grid=100)[0].grid == 100
    assert tvf.barriers(12) == 85


# ---------------------------------------------------------------------------
# The GEMM phases' arithmetic in the plan's tile order against K7's lines
# ---------------------------------------------------------------------------

# a tiny whole-model shape: 2 images of 5 tokens (32 x 32, patch 16), dim 64,
# 2 heads of 32, mlp 128
TINY = dict(batch=2, tokens=5, dim=64, heads=2, head_dim=32, mlp=128, classes=10, k_patch=768)


def _tiny_inputs(phase, m, n, k, dt, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if phase == "embed":
        x[::TINY["tokens"]] = 0.0  # each image's cls row has zero patches
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    b = (rng.standard_normal(n) * 0.5).astype(np.float32)
    res_rows = TINY["tokens"] if phase == "embed" else m
    r = rng.standard_normal((res_rows, n)).astype(np.float32)
    jx, jw, jb, jr = (jnp.asarray(a).astype(dt) for a in (x, w, b, r))
    tx, tw, tb, tr = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                      for a in (jx, jw, jb, jr))
    return (jx, jw, jb, jr), (tx, tw, tb, tr)


def _k7(phase, x, w, b, r, approx):
    """K7's lines for the phase, verbatim (ops/pallas/fused_vit_full.py)."""
    dt = x.dtype
    acc = jax.lax.dot(x, w, preferred_element_type=jnp.float32)
    if phase == "embed":  # :59-67, embed_b tiled over the images
        eb = jnp.tile(r.astype(jnp.float32), (x.shape[0] // r.shape[0], 1))
        return (acc + eb).astype(dt)
    if phase in ("out", "fc2"):  # :82-86, :96-100
        return (acc + b.astype(jnp.float32) + r.astype(jnp.float32)).astype(dt)
    y = acc.astype(dt) + b  # :72-76, :89-93
    return jmath.gelu_kernel(y, approx).astype(dt) if phase == "fc1" else y


def _walk(plan_tiles, phase_idx, x, w, b, r, code):
    """The phase through kernel_tiles, one tile at a time, in the order the
    kernel's slots take them; ROW_BIAS (the embedding) reads residual row
    gm % tokens."""
    m, n = x.shape[0], w.shape[1]
    rows, cols, _ = tvf.VIT_FULL_TILES[plan_tiles[phase_idx]]
    out = torch.full((m, n), float("nan"), dtype=torch.bfloat16)
    for rs, cs in _tiles(m, n, rows, cols):
        xs, bs = x[rs.start:rs.stop], b[cs.start:cs.stop]
        if code == 4:
            rr = r[[i % r.shape[0] for i in rs]][:, cs.start:cs.stop]
            acc = kernel_tiles(xs, w[:, cs.start:cs.stop], torch.zeros_like(bs), rr, 3)
        else:
            rr = r[rs.start:rs.stop, cs.start:cs.stop]
            acc = kernel_tiles(xs, w[:, cs.start:cs.stop], bs, rr, code)
        out[rs.start:rs.stop, cs.start:cs.stop] = acc
    return out


@pytest.mark.parametrize("approx", [False, True])
def test_gemm_phases_in_plan_order_match_k7_and_every_plan_gives_the_same_bits(approx):
    t = TINY
    m = t["batch"] * t["tokens"]
    inner = t["heads"] * t["head_dim"]
    phases = {"embed": (t["dim"], t["k_patch"], 4), "qkv": (3 * inner, t["dim"], 0),
              "out": (t["dim"], inner, 3), "fc1": (t["mlp"], t["dim"], 1 if approx else 2),
              "fc2": (t["dim"], t["mlp"], 3)}
    args = (t["batch"], t["tokens"], t["dim"], t["heads"], t["head_dim"], t["mlp"], t["classes"])
    plans = [tvf.vit_full_plan(*args, sms) for sms in (1, H100_SMS)]
    assert {tvf.VIT_FULL_TILES[plans[0].tiles[0]][0],
            tvf.VIT_FULL_TILES[plans[1].tiles[0]][0]} == {128, 16}
    for i, (phase, (n, k, code)) in enumerate(phases.items()):
        (jx, jw, jb, jr), (x, w, b, r) = _tiny_inputs(phase, m, n, k, jnp.bfloat16, 30 + i)
        outs = [_walk(p.tiles, i, x, w, b, r, code) for p in plans]
        assert torch.equal(outs[0], outs[1]), phase  # K never split: the plan changes no bit
        ref = np.asarray(_k7(phase, jx, jw, jb, jr, approx).astype(jnp.float32))
        got = outs[0].float().numpy()
        assert np.isfinite(got).all()
        err = np.abs(got - ref)
        assert (err <= BF16_ATOL + BF16_RTOL * np.abs(ref)).all(), (phase, err.max())


def test_vit_full_ab_finds_its_anchors_in_the_committed_source():
    from edgevisiontransformer_tpu_torch.bench import vit_full_ab

    src = (build.CSRC / vit_full_ab.SOURCE).read_text()
    found = vit_full_ab.variants(src)
    assert list(found) == [vit_full_ab.COMMITTED, vit_full_ab.WIDE, vit_full_ab.STRIP4]
    assert found[vit_full_ab.COMMITTED] == src
    others = [code for name, code in found.items() if name != vit_full_ab.COMMITTED]
    assert all(code != src for code in others) and len(set(others)) == len(others)
    assert "if (tile == 2) gemm_groups<4, 32, 64>" in found[vit_full_ab.WIDE]
    plan, (b, n_tok, dim, heads, hd, mlp, classes) = _plan("deit_tiny", 128, 64)
    wide = vit_full_ab.wide_plan(plan, tvf.gemm_shapes(b, n_tok, dim, heads, hd, mlp), H100_SMS)
    assert wide.tiles == (0, vit_full_ab.WIDE_CODE, 0, vit_full_ab.WIDE_CODE, 0)
