"""Multi-rank dryrun of the parallel layer (port of
``__graft_entry__.py:dryrun_multichip``):

    python -m edgevisiontransformer_tpu_torch.parallel.dryrun N [--device cpu|cuda]

starts N gloo ranks (on the card unless ``--device cpu``; the ranks share
it) and runs, on tiny DeiT shapes: the dp x tp train step with
``grad_accum=2`` (tp = 2 where N is even and at least 4), the GPipe forward
at pp = 2, the GPipe train step at pp = 4 and depth 8 (N >= 4), the
sequence-parallel forward and its distance from the pipeline's,
``evaluate_sharded`` over a BMP folder with an odd total, and the
head-importance all-reduce against one process's.  It asserts what the
JAX dryrun asserts and prints its tail line, field for field.
"""

from __future__ import annotations

import argparse
import math
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

DEADLINE_S = 600.0


def dryrun_config():
    from ..models.vit import deit_config

    return deit_config("tiny").replace(image_size=32, patch_size=16, dim=64, depth=2, heads=2,
                                       mlp_dim=128, num_classes=16)


def mesh_dims(n: int) -> tuple:
    tp = 2 if n % 2 == 0 and n >= 4 else 1
    return n // tp, tp


def write_folder(root: Path, batch: int) -> None:
    """Two classes of random 36 x 36 BMPs, ``batch + 1`` in all (an odd
    total: the last batch is padded, and its one image is dp rank 0's)."""
    from ..utils.imagenet import write_bmp

    rng = np.random.RandomState(0)
    for cls, count in (("class_a", batch // 2 + 1), ("class_b", batch - batch // 2)):
        (root / cls).mkdir(parents=True)
        for k in range(count):
            write_bmp(root / cls / f"{k}.bmp", rng.randint(0, 255, (36, 36, 3)).astype(np.uint8))


def dryrun_rank(rank: int, n: int, device: str, folder: str) -> str:
    """One rank's share of the dryrun; returns the tail line (every rank
    alike)."""
    from ..models.vit import ViT, apply_params
    from ..ops.cuda.fused_encoder import stack_vit_layer_params
    from ..pruning.head_importance import calculate_head_importance
    from ..utils.imagenet import evaluate_sharded
    from ..utils.jax_bridge import tree_map
    from .mesh import Mesh, make_mesh, shard_params
    from .pipeline import (make_pipeline_train_step, pipeline_encoder_apply,
                           sequence_sharded_encoder_apply)
    from .train import Optimizer, jit_sharded_train_step, make_train_step

    dev = torch.device(device)
    dp, tp = mesh_dims(n)
    mesh = make_mesh(dp=dp, tp=tp)
    cfg = dryrun_config()
    model = ViT(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    params = model.params()
    clone = lambda tree: tree_map(lambda t: t.detach().clone(), tree)  # noqa: E731
    batch = dp * 2
    x = torch.ones(batch, 3, 32, 32, device=dev)
    labels = torch.zeros(batch, dtype=torch.int64, device=dev)

    opt = Optimizer(torch.optim.SGD, {"lr": 1e-3})
    train_step = make_train_step(lambda p, xx: apply_params(model, p, xx), opt, grad_accum=2)
    sharded = shard_params(clone(params), mesh)
    step = jit_sharded_train_step(train_step, mesh, params, config=cfg)
    _, _, metrics = step(sharded, opt.init(sharded), x, labels)
    loss = float(metrics["loss"])
    assert math.isfinite(loss), f"bad loss {loss}"

    # pp + sp forwards on the encoder stack
    kw = dict(heads=cfg.heads, eps=cfg.layernorm_eps, approx_gelu=cfg.gelu_approx,
              reference_residual=cfg.reference_residual)
    stacked = stack_vit_layer_params(params, cfg.depth, cfg.qkv_bias)
    h = torch.ones(4, 8, cfg.dim, device=dev)
    pp = 2 if cfg.depth % 2 == 0 and n >= 2 else 1
    pp_mesh = Mesh(np.arange(pp), ("pp",))
    with torch.no_grad():
        y_pp = (pipeline_encoder_apply(stacked, h, pp_mesh, microbatches=2, **kw)
                if rank in pp_mesh else None)

    # the pp train step: gradients through the GPipe schedule, pp = 4, depth 8
    pl_loss = float("nan")
    if n >= 4:
        cfg8 = cfg.replace(depth=8)
        m8 = ViT(cfg8, device=dev, generator=torch.Generator().manual_seed(1))
        stk8 = stack_vit_layer_params(m8.params(), 8, cfg8.qkv_bias)
        mesh4 = Mesh(np.arange(4), ("pp",))
        if rank in mesh4:
            head_w = torch.zeros(cfg8.dim, cfg8.num_classes, device=dev)
            head_w[0, 0] = 1.0
            # not ones: LN of a constant vector is zero, which zeroes qkv grads
            h8 = torch.randn(4, 8, cfg8.dim, generator=torch.Generator().manual_seed(2)).to(dev)
            pstep = make_pipeline_train_step(mesh4, microbatches=4, **kw)
            stk8n, _, pl = pstep(stk8, head_w, h8, torch.zeros(4, dtype=torch.int64,
                                                               device=dev))
            pl_loss = float(pl)
            assert math.isfinite(pl_loss), pl_loss
            moved = float((stk8n["qkv_w"] - stk8["qkv_w"]).abs().max())
            assert moved > 0, "pp train step produced zero grads"
    with torch.no_grad():
        y_sp = sequence_sharded_encoder_apply(stacked, h, mesh, **kw)
    err = float((y_pp - y_sp).abs().max()) if y_pp is not None else 0.0
    assert err < 1e-4, f"pp/sp disagree: {err}"

    # the distributed-eval count reduce and the head-importance all-reduce
    with torch.no_grad():
        acc = evaluate_sharded(lambda xx: apply_params(model, params, xx), folder, mesh,
                               batch_size=batch, crop=32, resize=36, device=dev)
    assert 0.0 <= acc <= 1.0, f"bad sharded eval accuracy {acc}"
    imgs = torch.randn(batch, 3, 32, 32, generator=torch.Generator().manual_seed(3)).numpy()
    imp_mesh = calculate_head_importance(cfg, params, [imgs], mesh=mesh)
    imp_ref = calculate_head_importance(cfg, params, [imgs])
    imp_err = float(np.abs(imp_mesh - imp_ref).max())
    assert imp_err < 1e-4, f"sharded head importance diverges: {imp_err}"
    # the pp-train loss is rank 0's (a member of the pp = 4 ring)
    return (f"dryrun_multichip ok: mesh={dict(mesh.shape)}, loss={loss:.4f}, "
            f"pp={pp} sp=tp{mesh.shape['tp']} max|pp-sp|={err:.2e} "
            f"pp4-train-loss={pl_loss:.4f} "
            f"eval-count={acc:.2f} importance-psum-err={imp_err:.1e}")


def run(n: int, device: str = "cuda", deadline_s: float = DEADLINE_S) -> str:
    """The dryrun on ``n`` gloo ranks; returns rank 0's tail line."""
    from ..models.vit import model_device
    from ..utils import native_preprocess
    from .launch import spawn

    model_device(device)  # no card, no run: never a silent CPU run
    native_preprocess.available()  # built once here; the ranks load it
    with tempfile.TemporaryDirectory() as tmp:
        write_folder(Path(tmp), mesh_dims(n)[0] * 2)
        lines = spawn(dryrun_rank, n, backend="gloo", device=device, deadline_s=deadline_s,
                      args=(device, tmp))
    return lines[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = ap.parse_args(argv)
    print(run(args.n, args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
