"""Each kernel's bf16 instance against another checkout's, bit for bit.

    python -m edgevisiontransformer_tpu_torch.bench.parent_bits --against DIR

``DIR`` is the root of another checkout of this repository (for example the
parent commit, unpacked by ``git archive`` into a git-ignored directory).
Its ``edgevisiontransformer_tpu_torch/csrc`` is built as it is (its bf16
entry points only) into ``build/parent_bits/``, beside this checkout's
library.  Every kernel wrapper then runs on fixed inputs (seeded, on the
card) at the main path's shapes, once with each library loaded, and the
outputs must be equal bit for bit: a change that gives the kernels an fp16
instance must leave the bf16 one as it was.  A case that a kernel new in
this checkout takes (``TARGETED``: sdpa past ``res_keys``, which
csrc/sdpa_long.cu runs) is held only to itself on two runs, since the
other checkout's kernel computes it another way.  Prints one line a case and
exits non-zero if any differs.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

LOG2E = 1.4426950408889634

def cases(dev) -> list:
    """``[(name, fn, targeted)]``: each fn runs one kernel wrapper on fixed
    bf16 inputs and returns its outputs; ``targeted`` where a kernel new in
    this checkout runs it (:func:`targeted`)."""
    import numpy as np

    from edgevisiontransformer_tpu_torch.models.swin import shifted_window_mask
    from edgevisiontransformer_tpu_torch.models.t2t_vit import build_stage1_weights
    from edgevisiontransformer_tpu_torch.models.vit import ViT, deit_config, prepare_vit_full
    from edgevisiontransformer_tpu_torch.ops.cuda import fused_attention as fa
    from edgevisiontransformer_tpu_torch.ops.cuda import fused_encoder as fe
    from edgevisiontransformer_tpu_torch.ops.cuda import fused_mlp as fm
    from edgevisiontransformer_tpu_torch.ops.cuda import fused_vit_full as vf
    from edgevisiontransformer_tpu_torch.ops.cuda import performer as pf
    from edgevisiontransformer_tpu_torch.ops.cuda import swin_block as sb
    from edgevisiontransformer_tpu_torch.ops.cuda import swin_merge as sm
    from edgevisiontransformer_tpu_torch.ops.cuda import t2t_stage1 as ts
    from edgevisiontransformer_tpu_torch.ops.cuda import window_sdpa as ws

    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    out = []
    for m in (197, 32 * 197):
        x = rnd(m, 192, scale=2.0)
        g, b = rnd(192, scale=0.5) + 1, rnd(192, scale=0.5)
        g32, b32 = g.float(), b.float()
        out.append((f"ln_rows m{m}", lambda x=x, g=g, b=b: fe.ln_rows(x, g, b, 1e-6)))
        out.append((f"ln_rows fp32 affine m{m}",
                    lambda x=x, g=g32, b=b32: fe.ln_rows(x, g, b, 1e-6)))
        for k, n, epi, approx in ((192, 576, fe.CAST_THEN_BIAS, False),
                                  (192, 192, fe.BIAS_RESIDUAL, False),
                                  (192, 768, fe.CAST_THEN_BIAS_GELU, False),
                                  (192, 768, fe.CAST_THEN_BIAS_GELU, True),
                                  (768, 192, fe.BIAS_RESIDUAL, False),
                                  (230, 230, fe.BIAS_RESIDUAL, False)):
            a, w, bias = rnd(m, k), rnd(k, n, scale=k ** -0.5), rnd(n, scale=0.5)
            res = rnd(m, n) if epi == fe.BIAS_RESIDUAL else None
            out.append((f"linear {k}x{n} {epi}{' tanh' if approx else ''} m{m}",
                        lambda a=a, w=w, bias=bias, kw=dict(epilogue=epi, res=res,
                                                            approx_gelu=approx):
                        fe.linear(a, w, bias, **kw)))
        act_inv = torch.rand(12, 4, generator=gen, device=dev) + 0.5
        h = rnd(m, 230, scale=2.0)
        out.append((f"quant_rows dynamic m{m}", lambda h=h: fe.quant_rows(h)))
        out.append((f"quant_rows static m{m}", lambda h=h, ai=act_inv: fe.quant_rows(h, ai, 5)))
        for k, n, epi, approx in ((192, 576, fe.BIAS, False), (192, 768, fe.BIAS_GELU, False),
                                  (768, 192, fe.BIAS_RESIDUAL, False),
                                  (230, 192, fe.BIAS_GELU, True)):
            q, wq = int8(m, k), int8(k, n)
            ws_ = torch.rand(n, generator=gen, device=dev) * 1e-4
            for bias in (rnd(n, scale=0.5, dtype=torch.float32), rnd(n, scale=0.5)):
                res = rnd(m, n) if epi == fe.BIAS_RESIDUAL else None
                s_row = torch.rand(m, generator=gen, device=dev) * 0.05
                for sr in (None, s_row):
                    out.append((f"linear_i8 {k}x{n} {epi} {str(bias.dtype)[6:]} "
                                f"{'dynamic' if sr is not None else 'static'} m{m}",
                                lambda q=q, sr=sr, wq=wq, w_s=ws_, bias=bias,
                                kw=dict(epilogue=epi, out_dtype=bf, res=res, approx_gelu=approx):
                                fe.linear_i8(q, sr, wq, w_s, bias, **kw)))
    for batch, tokens, seq, heads, hd in ((2, 197, 197, 3, 64), (1, 5, 5, 2, 16),
                                          (3, 64, 64, 2, 128), (2, 200, 197, 2, 64),
                                          (64, 197, 197, 3, 64), (1, 577, 577, 12, 64)):
        qkv = rnd(batch * tokens, 3 * heads * hd)
        out.append((f"attention_rows b{batch} n{tokens}/{seq} h{heads} d{hd}",
                    lambda qkv=qkv, kw=dict(heads=heads, head_dim=hd, tokens=tokens,
                                            seq_len=seq): fe.attention_rows(qkv, **kw)))
    rng = np.random.RandomState(3)
    w9 = build_stage1_weights(rng.randn(147, 192) * 147 ** -0.5, rng.randn(192) * 0.1,
                              1.0 + 0.1 * rng.randn(147), 0.1 * rng.randn(147))
    w9 = (w9[0].to(dev, bf), w9[1].to(dev), w9[2].to(dev), w9[3].to(dev))
    for batch in (1, 4):
        img = rnd(batch, 3, 224, 224)
        out.append((f"stage1_kqv b{batch}", lambda img=img: ts.stage1_kqv(img, *w9)))
    for res, dim, heads, w, batch in ((56, 96, 3, 7, 2), (14, 384, 12, 7, 2), (7, 768, 24, 7, 1),
                                      (96, 128, 4, 12, 1)):
        n, nwin = w * w, (res // w) ** 2
        qkv = rnd(batch * res * res, 3 * dim)
        bias = rnd(heads, n, n, scale=0.7, dtype=torch.float32)
        mask = (torch.from_numpy(shifted_window_mask(res, res, w, w // 2)).to(dev)
                if nwin > 1 else None)
        qkv_w = rnd(batch * nwin, n, 3 * dim)
        bias16 = rnd(heads, n, n, scale=0.5)
        for mk in ((None, mask) if mask is not None else (None,)):
            kw = dict(res=res, window=w, shift=0 if mk is None else w // 2, heads=heads,
                      head_dim=dim // heads)
            tag = f"res{res} w{w} {'shifted' if mk is not None else 'unshifted'} b{batch}"
            mk2 = None if mk is None else mk * LOG2E  # window_attention's mask, log2-scaled
            out.append((f"window_attention {tag}",
                        lambda qkv=qkv, bias=bias, mk=mk2, kw=kw:
                        sb.window_attention(qkv, bias, mk, **kw)))
            out.append((f"window_sdpa {tag}",
                        lambda qkv=qkv_w, bias=bias16, mk=mk,
                        kw=dict(heads=heads, head_dim=dim // heads):
                        ws.window_sdpa(qkv, bias, mk, **kw)))
        if res % 2 == 0 and w == 7:
            x = rnd(batch * res * res, dim, scale=2.0)
            g4, b4 = rnd(4 * dim, dtype=torch.float32) + 1, rnd(4 * dim, dtype=torch.float32)
            out.append((f"swin_merge res{res} c{dim} b{batch}",
                        lambda x=x, g=g4, b=b4, r=res: sm.swin_merge(x, g, b, res=r, eps=1e-5)))
    for b, h, n, d in ((2, 3, 197, 64), (1, 6, 197, 64), (2, 4, 50, 32), (2, 12, 577, 64),
                       (1, 2, 70, 128), (2, 2, 256, 96), (2, 2, 128, 128)):
        qkv = rnd(b, n, 3 * h * d)
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        out.append((f"sdpa b{b} h{h} n{n} d{d}", lambda q=q, k=k, v=v: fa.sdpa(q, k, v)))
    for m, dim, hid in ((197, 192, 768), (8 * 197, 192, 768), (197, 384, 1152), (197, 192, 230),
                        (257, 1280, 5120), (100, 1408, 6150)):
        x = rnd(m, dim, scale=2.0)
        w1, b1 = rnd(dim, hid, scale=dim ** -0.5), rnd(hid)
        w2, b2 = rnd(hid, dim, scale=hid ** -0.5), rnd(dim)
        for approx in (False, True):
            out.append((f"mlp m{m} {dim}x{hid}{' tanh' if approx else ''}",
                        lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2, a=approx:
                        fm.mlp(x, w1, b1, w2, b2, approx_gelu=a)))
    for batch, kw in ((1, {}), (8, dict(reference_residual=True, gelu_approx=True)),
                      (2, dict(dim=256, heads=2, mlp_dim=1024))):
        cfg = deit_config("tiny", depth=2, dtype=bf, **kw)
        model = ViT(cfg, device=dev, generator=torch.Generator().manual_seed(21))
        prep = prepare_vit_full(model)
        img = torch.randn(batch, 3, 224, 224, generator=torch.Generator().manual_seed(22)).to(dev)
        args = dict(heads=cfg.heads, head_dim=cfg.resolved_head_dim, eps=cfg.layernorm_eps,
                    reference_residual=cfg.reference_residual, approx_gelu=cfg.gelu_approx,
                    final_norm=cfg.final_norm)
        out.append((f"vit_full d2 b{batch} {kw}",
                    lambda img=img, prep=prep, args=args: vf.vit_full_forward(img, prep, **args)))
    pgen = torch.Generator(device=dev).manual_seed(17)

    def r(*shape, scale=0.1, base=0.0):
        return torch.randn(*shape, generator=pgen, device=dev) * scale + base

    p = {"attn_output": {"kernel": r(64, 64), "bias": r(64)}, "norm2_scale": r(64, base=1.0),
         "norm2_bias": r(64), "mlp_fc1_kernel": r(64, 64), "mlp_fc1_bias": r(64),
         "mlp_fc2_kernel": r(64, 64), "mlp_fc2_bias": r(64)}
    wr = r(32, 64, scale=0.3)
    ops = pf.performer_operands(p, wr)
    for batch, n in ((1, 3136), (1, 784), (4, 3136), (2, 300)):
        x = rnd(batch, n, 192, scale=0.5)
        out.append((f"performer_reduce b{batch} n{n}",
                    lambda x=x: pf.performer_reduce(x, wr, operands=ops)))
        out.append((f"performer_rest b{batch} n{n}",
                    lambda x=x: pf.performer_rest(x, p, wr, eps_ln=1e-5, approx_gelu=True,
                                                  operands=ops)))
    return [(name, fn, targeted(name)) for name, fn in out]


def targeted(name: str) -> bool:
    """Whether csrc/sdpa_long.cu, which the other checkout may lack, runs the
    case: an sdpa case with more keys than sdpa.cu's resident form holds."""
    from edgevisiontransformer_tpu_torch.ops.cuda import fused_attention as fa

    if not name.startswith("sdpa "):
        return False
    n, d = (int(w[1:]) for w in name.split()[3:5])
    return n > fa.res_keys(d)


def run(fns, skip_targeted: bool = False) -> list:
    with torch.no_grad():
        outs = []
        for _, fn, tgt in fns:
            if tgt and skip_targeted:
                outs.append(None)
                continue
            got = fn()
            got = got if isinstance(got, tuple) else (got,)
            outs.append(tuple(None if t is None else t.clone() for t in got))
        torch.cuda.synchronize()
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True, type=Path,
                    help="root of the other checkout whose bf16 kernels are the reference")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("parent_bits: no CUDA device", file=sys.stderr)
        return 1
    from edgevisiontransformer_tpu_torch.ops.cuda import build

    dev = torch.device("cuda")
    mine = build.load()
    other_path = build.BUILD_DIR.parent / "parent_bits" / "libevt_kernels_other.so"
    t0 = time.perf_counter()
    build.compile_library(other_path, csrc=args.against / "edgevisiontransformer_tpu_torch" /
                          "csrc", f16=False)
    other = build.open_library(other_path)
    print(f"the other checkout's kernels built in {time.perf_counter() - t0:.2f} s")
    fns = cases(dev)
    results = {}
    for name, lib in (("other", other), ("this", mine), ("this again", mine), ("other again",
                                                                                other)):
        build._lib = lib
        results[name] = run(fns, skip_targeted=name.startswith("other"))
    build._lib = mine
    bad = 0
    for i, (case, _, tgt) in enumerate(fns):
        pairs = ((("this", "this again"),) if tgt else
                 (("other", "this"), ("this", "this again"), ("other", "other again")))
        same = all(
            all((a is None and b is None) or (a is not None and b is not None
                                              and torch.equal(a, b))
                for a, b in zip(results[x][i], results[y][i]))
            for x, y in pairs)
        bad += not same
        print(f"  {'same bits' if same else 'DIFFER   '}  {case}"
              f"{'  (targeted: this checkout twice)' if tgt else ''}")
    print(f"parent_bits: {len(fns) - bad} of {len(fns)} cases the same bits in both checkouts")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
