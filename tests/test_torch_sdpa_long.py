"""The host side of ``csrc/sdpa_long.cu`` (K13 past ``csrc/sdpa.cu``'s
resident form), on the CPU: which kernel a shape goes to (``res_keys``),
the plan (``long_plan``), its shared-memory mirror (``long_smem_bytes``,
held against the kernel's own ``smem_bytes``) and the geometry of the 4-D
tensor maps the host encodes (``long_tensor_map``): extents, byte strides,
the box, and which boxes fall past ``n`` or ``d`` (those load zeros rather
than the next head's columns or the next image's rows).

The kernel itself runs only on the card (``tests/test_torch_kernels_cuda.py``);
``tests/test_torch_sdpa_tiles.py`` holds its arithmetic against JAX's K13.
"""

import re

import pytest
import torch

from edgevisiontransformer_tpu_torch.ops.cuda import build
from edgevisiontransformer_tpu_torch.ops.cuda import fused_attention as tfa
from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as tfe

H100_SMS = 132
HEAD_DIMS = range(16, 129, 8)  # every head_dim the wrapper takes
SRC = (build.CSRC / "sdpa_long.cu").read_text()


def test_res_keys_sends_each_shape_to_one_kernel():
    for d in HEAD_DIMS:
        want = 128 if tfe.head_dim_instance(d) > 96 else 256
        assert tfa.res_keys(d) == want
    assert tfa.res_keys(80) == 256 < 257  # ViT-H/14 and ViT-g/14: one key past it
    assert tfa.res_keys(104) == 128 < 197  # ViT-G/14 at 224^2
    assert tfa.res_keys(64) < 577  # every ViT at 384^2


def test_constants_and_smem_mirror_the_kernel():
    """fused_attention's LONG_* constants are sdpa_long.cu's, and
    long_smem_bytes evaluates the kernel's own ``smem_bytes`` expression."""
    consts = {name: eval(v) for name, v in re.findall(r"constexpr int (\w+) = ([\d *]+);", SRC)}
    assert consts["WIDEST_HEAD_DIM"] == tfa.LONG_WIDEST_HEAD_DIM
    assert consts["ROWS"] == tfa.LONG_ROWS and consts["KEYS"] == tfa.LONG_KEYS
    assert consts["PANEL"] == tfa.LONG_PANEL and consts["MAX_SMEM"] == tfa.LONG_MAX_SMEM
    assert consts["BOX"] == 64 * 128
    body = re.search(r"constexpr int smem_bytes\(int wg, int panels, int stages\) \{\s*"
                     r"return ([^;]+);", SRC)[1]
    for rows in (64, 128):
        for d in HEAD_DIMS:
            for stages in (1, 2, 7, 20):
                env = {"wg": rows // 64, "panels": tfa.long_panels(d), "stages": stages,
                       "BOX": consts["BOX"]}
                assert tfa.long_smem_bytes(rows, d, stages) == eval(body, {}, env)
    assert [tfa.long_panels(d) for d in (16, 64, 72, 80, 128)] == [1, 1, 2, 2, 2]


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_every_plan_fits_the_card_from_129_to_1000_keys(d):
    for n in range(129, 1001):
        for b, h in ((1, 16), (8, 16)):
            plan = tfa.long_plan(b, h, n, d, H100_SMS)
            tiles = -(-n // 64)
            assert plan.tiles == tiles and plan.rows in (64, 128, 192)
            assert plan.rows < 192 or d <= tfa.LONG_WIDEST_HEAD_DIM
            assert plan.smem == tfa.long_smem_bytes(plan.rows, d, plan.stages) <= 232448
            assert plan.grid == (b * h, -(-n // plan.rows))
            if plan.resident:
                assert plan.stages == 2 * tiles
            else:
                assert plan.stages == tfa.LONG_RING < 2 * tiles
                assert tfa.long_smem_bytes(plan.rows, d, 2 * tiles) > 232448 or (
                    tfa.long_blocks_per_sm(plan.rows, d, plan.stages)
                    > tfa.long_blocks_per_sm(plan.rows, d, 2 * tiles))


def test_blocks_per_sm_mirror_shared_memory_and_registers():
    # ViT-H/14's 80: one resident block (181,416 bytes) an SM; streamed, two
    # (83,016 bytes each; 160 threads of LONG_REGS[5] registers)
    assert tfa.long_blocks_per_sm(64, 80, 10) == 1
    assert tfa.long_blocks_per_sm(64, 80, 4) == 233472 // (83016 + 1024) == 2
    # at d <= 64 three one-warpgroup blocks (the cap of three warpgroups)
    assert tfa.long_blocks_per_sm(64, 64, 4) == 3
    # two or three warpgroups: one block an SM
    assert tfa.long_blocks_per_sm(128, 64, 4) == tfa.long_blocks_per_sm(192, 64, 4) == 1
    assert set(tfa.LONG_REGS) == set(range(1, 9)) and set(tfa.LONG_WAVE_COST) == {1, 2, 3}


def test_long_plan_at_the_shapes_that_reach_it():
    # ViT-H/14 b1: 16 heads x 5 query tiles of 64 rows, one wave of one
    # warpgroup an SM; K and V resident (5 + 5 tiles of 2 panels)
    p = tfa.long_plan(1, 16, 257, 80, H100_SMS)
    assert (p.rows, p.stages, p.resident, p.tiles, p.grid) == (64, 10, True, 5, (16, 5))
    assert p.smem == 1024 + 11 * 2 * 64 * 128 + 21 * 8
    # ViT-H/14 b8: 640 blocks of 64 rows on a ring of two tiles, three an SM
    # (two waves; 192-row blocks tie, 128-row ones take three waves)
    p = tfa.long_plan(8, 16, 257, 80, H100_SMS)
    assert (p.rows, p.stages, p.resident, p.grid) == (64, 2, False, (128, 5))
    assert tfa.long_blocks_per_sm(64, 80, 2) == 3
    # head_dim 88 (152 registers: two one-warpgroup blocks an SM) at b8:
    # 192-row blocks, two waves
    p = tfa.long_plan(8, 16, 257, 88, H100_SMS)
    assert (p.rows, p.stages, p.resident, p.grid) == (192, 10, True, (128, 2))
    # ... and at b2, 64 rows on a ring of two: 160 blocks in one wave
    p = tfa.long_plan(2, 16, 257, 88, H100_SMS)
    assert (p.rows, p.resident, p.grid) == (64, False, (32, 5))
    # d = 128 at 577 keys: 20 tiles of 2 panels do not fit; a ring
    p = tfa.long_plan(8, 12, 577, 128, H100_SMS)
    assert not p.resident and p.stages == tfa.LONG_RING
    # ViT-G/14 (104) at 257 keys, b1: resident
    assert tfa.long_plan(1, 16, 257, 104, H100_SMS).resident


def test_long_plan_forces_a_form_or_refuses_it():
    assert tfa.long_plan(1, 16, 257, 80, H100_SMS, rows=128).rows == 128
    p = tfa.long_plan(8, 16, 257, 80, H100_SMS, rows=64, resident=False)
    assert (p.rows, p.resident, p.stages) == (64, False, tfa.LONG_RING)
    assert tfa.long_plan(1, 2, 577, 64, H100_SMS, rows=192, resident=True).stages == 20
    with pytest.raises(ValueError, match="one of"):
        tfa.long_plan(1, 16, 257, 80, H100_SMS, rows=32)
    # no 192-row block past head_dim 112 (its kernel would spill)
    assert tfa.long_plan(1, 2, 577, 112, H100_SMS, rows=192).rows == 192
    with pytest.raises(ValueError, match=r"\(64, 128\)"):
        tfa.long_plan(1, 2, 577, 120, H100_SMS, rows=192)
    with pytest.raises(ValueError, match="do not fit"):
        tfa.long_plan(1, 2, 577, 128, H100_SMS, resident=True)


def _views(b, n, h, d, dtype):
    """q, k, v as views of a fused [b, n, 3 h d] (what attention() passes)."""
    return torch.zeros(b, n, 3 * h * d, dtype=dtype).view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)


@pytest.mark.parametrize("b,h,n,d", [(8, 16, 257, 80), (2, 12, 577, 64), (1, 3, 300, 88),
                                     (2, 4, 197, 112)])
def test_tensor_maps_cover_one_head_and_zero_past_n_and_d(b, h, n, d):
    q = _views(b, n, h, d, torch.bfloat16)[0]
    out = torch.empty(b, n, h * d, dtype=torch.bfloat16).view(b, n, h, d).transpose(1, 2)
    for t, row in ((q, 3 * h * d), (out, h * d)):
        dims, strides, box = tfa.long_tensor_map(t)
        assert dims == (d, n, h, b) and box == (64, 64, 1, 1)
        assert strides == (row * 2, d * 2, n * row * 2)
        assert all(s % 16 == 0 for s in strides) and box[0] * 2 <= 128  # TMA's rules
    # k over a qkv whose every element is a code of its index: each box of one
    # (image, head) reads that head's own elements where it lies inside (d, n),
    # and lies past them (TMA's zero fill) only in the last tile or panel
    k = _views(b, n, h, d, torch.float64)[1]
    flat = k.untyped_storage()
    flat = torch.arange(len(flat) // 8, dtype=torch.float64)
    k = flat.as_strided(k.shape, k.stride(), k.storage_offset())
    _, strides, _ = tfa.long_tensor_map(k)
    sn, sh, sb = (s // k.element_size() for s in strides)
    for img in (0, b - 1):
        for head in (0, h - 1):
            for t in range(-(-n // 64)):
                for c in range(tfa.long_panels(d)):
                    col = torch.arange(64 * c, 64 * c + 64)[None, :]
                    tok = torch.arange(64 * t, 64 * t + 64)[:, None]
                    inside = (col < d) & (tok < n)
                    at = k.storage_offset() + col + tok * sn + head * sh + img * sb
                    got = torch.where(inside, flat[torch.where(inside, at, 0)], -1.0)
                    want = torch.where(inside, k[img, head, tok.clamp(max=n - 1),
                                                 col.clamp(max=d - 1)], -1.0)
                    assert torch.equal(got, want)
                    assert bool(inside.all()) == (64 * (t + 1) <= n and 64 * (c + 1) <= d)
