"""How close the static-aware QAT forward comes to the static-int8
deployment it trains for, and how close the unquantized forward comes.

    python -m edgevisiontransformer_tpu_torch.bench.qat_oracle [--device cpu]

deit_tiny standard at full width and depth, fp32 (TF32 off), random weights
from seed 0, activation scales from ``calibrate_vit`` on 8 representative
batches.  For four batches of 32 images (seeds 11-14), against the fp32
static-int8 oracle (``ops/quant.int8_vit_apply_static``) on the same
weights and scales: max |err| / max|logit| of the QAT forward
(``fake_quant_vit_apply_static``) and of the unquantized forward
(``models/vit.apply_params``), at depth 12 and on the first 1, 2, 4 and 8
blocks (the same embedding and head); then :func:`matmul_deviation` on the
first batch.  No kernel runs: every forward is eager PyTorch.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from ..models.registry import build_model
from ..models.vit import ViT, apply_params
from ..ops import quant


def matmul_deviation(cfg, params: dict, qparams: dict, scales, img: torch.Tensor) -> dict:
    """Every encoder matmul of the static-int8 oracle's forward on ``img``,
    its input also through the QAT forward's product ``fq(x) @ fq(w)`` and
    the unquantized ``x @ w``: for each of the two, the largest deviation
    from the oracle's product over the matmuls as a share of that product's
    max|.| (``*_max``), and the largest share of a product's elements that
    it misses by more than 1e-4 of that max (``*_share``)."""
    s = torch.as_tensor(scales, dtype=torch.float32, device=img.device)
    order = iter(range(4 * cfg.depth))
    out = dict.fromkeys(("qat_max", "plain_max", "qat_share", "plain_share"), 0.0)

    def mm(x, leaf):
        i, j = divmod(next(order), 4)
        sub, key = quant._VIT_MATMUL_KEYS[j]
        w = params[f"block_{i}"][sub][key]
        ref = quant._mm_int8_static(x, leaf)
        top = ref.abs().max()
        for tag, got in (("qat", quant.fake_quant_act(x, s[i, j]) @ quant.fake_quant_ste(w)),
                         ("plain", x @ w)):
            err = (got - ref).abs()
            out[f"{tag}_max"] = max(out[f"{tag}_max"], float(err.max() / top))
            out[f"{tag}_share"] = max(out[f"{tag}_share"],
                                      float((err > 1e-4 * top).float().mean()))
        return ref

    with torch.no_grad():
        quant._int8_encoder_blocks(cfg, qparams, quant._embed_vit(cfg, qparams, img), mm)
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _logits(model, params: dict, scales, img: torch.Tensor) -> tuple:
    """(QAT, unquantized) forward against the oracle, max |err| / max|logit|."""
    with torch.no_grad():
        oracle = quant.int8_vit_apply_static(
            model, quant.quantize_vit_params_int8_static(params, scales), img)
        return (_rel(quant.fake_quant_vit_apply_static(model, params, scales, img), oracle),
                _rel(apply_params(model, params, img), oracle))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, shape = build_model("deit_tiny", style="standard", device=args.device,
                               generator=torch.Generator().manual_seed(0))
    cfg, params = model.config, model.params()
    if args.device != "cpu":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    with torch.no_grad():
        scales = quant.calibrate_vit(model, params,
                                     batches=quant.representative_batches(n=8, shape=shape))
    imgs = [torch.randn(32, *shape, generator=torch.Generator().manual_seed(seed)).to(
        args.device) for seed in (11, 12, 13, 14)]
    print("max |err| / max|logit| against the fp32 static-int8 oracle, b32: QAT forward, "
          "unquantized forward")
    for depth in (cfg.depth,) + tuple(d for d in (1, 2, 4, 8) if d < cfg.depth):
        m = model if depth == cfg.depth else ViT(cfg.replace(depth=depth), device=args.device)
        p = {k: v for k, v in params.items()
             if not (k.startswith("block_") and int(k.split("_")[1]) >= depth)}
        rows = [_logits(m, p, scales[:depth], x) for x in imgs]
        print(f"  depth {depth:2d}: " + "; ".join(f"{q:.5f}, {u:.5f}" for q, u in rows))
    with torch.no_grad():
        qparams = quant.quantize_vit_params_int8_static(params, scales)
    dev = matmul_deviation(cfg, params, qparams, scales, imgs[0])
    print(f"each of the {4 * cfg.depth} matmuls on the oracle's input (seed 11): max |err| / "
          f"max|product| QAT {dev['qat_max']:.4g}, unquantized {dev['plain_max']:.4g}; the "
          f"largest share of a product's elements off by > 1e-4 of its max: QAT "
          f"{dev['qat_share']:.4g}, unquantized {dev['plain_share']:.4g}")


if __name__ == "__main__":
    main()
