"""Command-line interface (port of ``edgevisiontransformer_tpu/cli.py``).

The JAX package's 21 commands, with its names, arguments, defaults and
printed lines, on the port's modules:

  benchmark        latency of a forward (the loop-delta timer; ``--device-time``
                   adds the device p50 of a CUDA-graph replay of the same call)
  benchmark_train  finetune and sparse (movement-pruning) step latency
  profile          per-op CSV profiling (stage micro-benchmarks, or a
                   ``torch.profiler`` trace)
  analyse_op / analyse_attn_ffn / analyse_gelu_ln / fetch_all_op_latency
  convert          float16 | bfloat16 | dynamic-int8 | static-int8 artifacts
  quant_accuracy   bf16 / dynamic / static logit drift and argmax table
  export           a checkpoint, or a ``torch.export`` program of the forward
  eval             image-folder top-1 (``--impl`` xla / fused / int8 ...)
  prune_heads, prune, finetune, sparse_train
  latency_model    collect / fit / predict the latency predictor
  logscrape, experiments, flops, plot, models

Run: ``python -m edgevisiontransformer_tpu_torch.cli <command> ...``

Where the port differs from the JAX CLI:

* ``--device`` (default ``cuda``) on every command that builds a model or
  tensors; without a card a command raises, as the models do (pass
  ``--device cpu``, where every kernel wrapper takes its plain twin).
* Weights are the port's seeded init (``torch.Generator`` seed 0), or
  ``--checkpoint`` / ``--from-hf`` / ``--quantized-checkpoint`` in the port's
  checkpoint format (``utils/checkpoint.py``: ``{"params": tree}`` and, for a
  model with buffers, ``"constants"``), not orbax directories.
* ``--kernel-mode pallas`` builds the model with ``kernel_mode="pallas"``:
  the ViT / T2T module on the ``sdpa`` and ``mlp`` kernels, the Swin module
  on ``window_sdpa`` (the JAX CLI drops the mode and runs ``model.apply``).
* ``export --format torch_export`` (the JAX CLI's ``stablehlo``) saves the
  plain forward, which ``torch.export`` can trace.
* The kernels compute in bf16 or fp16, so ``eval``'s kernel impls and the
  quantized artifacts default to ``--dtype bfloat16``.
* The Swin int8 refusal (no stage qualifies) lives here, as in the JAX CLI;
  ``latency_model predict --batch`` on a fit made without the batch feature
  is refused rather than ignored; ``--stem-int8`` is refused outside
  ``--kernel-mode int8_static`` on a T2T model.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

_TRANSFORMERS = ("deit", "pruned_deit", "t2t_vit", "swin")


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise SystemExit(f"unknown dtype {name!r}")
    return dt


def _build_model(name: str, style: str = "standard", dtype: str = "float32",
                 device: str = "cuda", kernel_mode: str = "xla"):
    """``(model, input shape without the batch)`` from the registry, its
    weights the port's seeded init."""
    from .models.registry import build_model

    kw = {"device": device, "generator": torch.Generator().manual_seed(0)}
    if name.startswith("deit") or name.startswith("pruned_deit"):
        kw["style"] = style
    kw["dtype"] = _dtype(dtype)
    if kernel_mode != "xla":
        if not name.startswith(_TRANSFORMERS):
            raise SystemExit(f"--kernel-mode {kernel_mode} applies to the ViT, T2T and Swin "
                             f"families, not {name}")
        kw["kernel_mode"] = kernel_mode
    return build_model(name, **kw)


def _variables(model) -> dict:
    """The weights as the CLI's checkpoints hold them."""
    from .models.vit import nested_tree

    out = {"params": nested_tree(model.named_parameters())}
    buffers = nested_tree(model.named_buffers())
    if buffers:
        out["constants"] = buffers
    return out


def _copy_into(named: dict, tree: dict, what: str) -> None:
    from .utils.jax_bridge import flatten_tree

    flat = flatten_tree(tree)
    if set(flat) != set(named):
        raise SystemExit(f"checkpoint {what}: missing {sorted(set(named) - set(flat))}, "
                         f"unexpected {sorted(set(flat) - set(named))}")
    with torch.no_grad():
        for k, t in named.items():
            t.copy_(flat[k])


def _load_weights(model, tree: dict) -> None:
    """Copy a ``{"params": ..., "constants": ...}`` tree (or a bare params
    tree) into ``model``, casting to its dtypes and device."""
    if "params" not in tree:
        tree = {"params": tree}
    _copy_into(dict(model.named_parameters()), tree["params"], "params")
    if "constants" in tree:
        _copy_into(dict(model.named_buffers()), tree["constants"], "constants")


def _checkpoint_weights(model, path: str) -> None:
    from .utils.checkpoint import load_checkpoint

    _load_weights(model, load_checkpoint(path))


def _apply(model):
    """``(params, x) -> model(x)`` on a params tree (``torch.func.functional_call``),
    for the train steps and the export."""
    from .utils.jax_bridge import flatten_tree

    return lambda p, x: torch.func.functional_call(model, flatten_tree(p.get("params", p)),
                                                   (x,))


def _device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="where the model and tensors live: cuda (the kernels) or cpu (their "
                        "plain twins)")


def cmd_models(argv):
    from .models.registry import available_models

    print("\n".join(available_models() + ["pruned_deit_{size}@{encoding}"]))


def _load_quantized_artifact(path: str, dtype: str, device: str = "cuda"):
    """Load a ``convert --quantization dynamic|int8`` artifact and return
    ``(model, in_shape, fn)`` where ``fn(x)`` runs the int8 kernels on it
    (``fn(x, plain=True)`` their plain twins): the consume half of the
    reference's convert -> run loop.  ViT / DeiT and
    T2T rebuild their int8 stacks from the saved quantized tree
    (``stacks_from_quantized_tree``), Swin takes its saved stage stacks; the
    float weights (embedding, norms, head, tokenizer) go into the model."""
    from .models.swin import SwinTransformer, fused_swin_apply, prepare_swin_fused
    from .models.t2t_vit import T2TViT, fused_t2t_apply_int8, prepare_t2t_fused
    from .models.vit import fused_vit_apply_int8, stacks_from_quantized_tree
    from .utils.checkpoint import load_checkpoint, load_meta
    from .utils.jax_bridge import flatten_tree, tree_map

    meta = load_meta(path)
    if not meta or meta.get("quantization") not in ("dynamic", "int8"):
        raise SystemExit(
            f"{path}: not a quantized convert artifact (need meta.json with "
            "quantization dynamic|int8; float16/bfloat16 casts load via "
            "--checkpoint)")
    if "config" in meta:
        # built from a sparse_train-compiled checkpoint: the exact pruned shapes
        from .config import ViTConfig
        from .models.vit import ViT

        cfg = ViTConfig.from_json(json.dumps(meta["config"])).replace(dtype=_dtype(dtype))
        model = ViT(cfg, device=device, generator=torch.Generator().manual_seed(0))
        in_shape = (3, cfg.image_size, cfg.image_size)
    else:
        model, in_shape = _build_model(meta["model"], meta.get("style", "standard"), dtype,
                                       device)
    dev = torch.device(device)
    tree = tree_map(lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t,
                    load_checkpoint(path))
    dt = model.config.dtype

    if isinstance(model, SwinTransformer):
        if "variables" not in tree:
            raise SystemExit(f"{path}: swin artifact without the bundled float variables")
        _load_weights(model, tree["variables"])
        # convert saves fp32; the float glue follows the compute dtype, as in
        # the prepare-time stacks; int8 weights and fp32 scales keep theirs
        q = {int(k.split("_")[1]): {
                 kk: (s if kk.endswith("_s") or kk == "act_inv" or not s.is_floating_point()
                      else s.to(dt))
                 for kk, s in stacked.items()}
             for k, stacked in tree.items() if k.startswith("stage_")}
        prep = prepare_swin_fused(model)
        return model, in_shape, lambda x, plain=False: fused_swin_apply(
            model, x, prepared=prep, int8_prepared=q, plain=plain)
    # the float leaves that are the model's own (the quantized kernels are
    # dicts of q / scale / act_scale and are not)
    named = dict(model.named_parameters())
    with torch.no_grad():
        for k, v in flatten_tree(tree.get("params", tree)).items():
            if k in named:
                named[k].copy_(v)
        if "constants" in tree:
            _copy_into(dict(model.named_buffers()), tree["constants"], "constants")
    stacks = stacks_from_quantized_tree(model.config, tree)
    if isinstance(model, T2TViT):
        prep = prepare_t2t_fused(model)
        return model, in_shape, lambda x, plain=False: fused_t2t_apply_int8(
            model, x, stacked_q=stacks, prepared=prep, plain=plain)
    return model, in_shape, lambda x, plain=False: fused_vit_apply_int8(
        model, x, stacked_q=stacks, plain=plain)


def _benchmark_call(args):
    """``(fn, x)`` of ``benchmark``: the forward its ``--kernel-mode`` names
    on a batch of ones, every constant prepared once."""
    from .models.swin import (SwinTransformer, fused_swin_apply, prepare_swin_fused,
                              prepare_swin_int8, prepare_swin_int8_static)
    from .models.t2t_vit import T2TViT
    from .models.vit import ViT

    dt = _dtype(args.dtype)
    if args.quantized_checkpoint:
        _, in_shape, fn = _load_quantized_artifact(args.quantized_checkpoint, args.dtype,
                                                   args.device)
        return fn, torch.ones((args.batch,) + tuple(in_shape), dtype=dt, device=args.device)
    model, in_shape = _build_model(args.model, args.style, args.dtype, args.device,
                                   "pallas" if args.kernel_mode == "pallas" else "xla")
    x = torch.ones((args.batch,) + tuple(in_shape), dtype=dt, device=args.device)
    if args.stem_int8 and not (args.kernel_mode == "int8_static" and isinstance(model, T2TViT)):
        raise SystemExit("--stem-int8 needs --kernel-mode int8_static on a T2T model")
    if args.kernel_mode in ("int8", "int8_static"):
        static = args.kernel_mode == "int8_static"
        if isinstance(model, SwinTransformer):
            prep = prepare_swin_fused(model)
            q = prepare_swin_int8_static(model) if static else prepare_swin_int8(model)
            if not q:
                raise SystemExit(
                    f"{args.model}: no stage qualifies for the int8 "
                    "whole-stage kernel — the result would silently be the "
                    "bf16 fused path; use --kernel-mode fused instead")
            n_stages = len(model.config.depths)
            print(f"int8 stages: {sorted(q)} of {list(range(n_stages))} "
                  f"(others run bf16 fused — mixed-precision result)")
            return (lambda x_: fused_swin_apply(model, x_, prepared=prep, int8_prepared=q)), x
        if isinstance(model, T2TViT):
            from .models.t2t_vit import (fused_t2t_apply_int8, prepare_t2t_fused,
                                         prepare_t2t_int8, prepare_t2t_int8_static,
                                         prepare_t2t_stem_int8_static)

            sq = prepare_t2t_int8_static(model) if static else prepare_t2t_int8(model)
            prep = prepare_t2t_fused(model)
            stq = prepare_t2t_stem_int8_static(model) if args.stem_int8 else None
            return (lambda x_: fused_t2t_apply_int8(model, x_, stacked_q=sq, prepared=prep,
                                                    stem_q=stq)), x
        if isinstance(model, ViT):
            from .models.vit import (fused_vit_apply_int8, prepare_vit_int8,
                                     prepare_vit_int8_static)

            sq = prepare_vit_int8_static(model) if static else prepare_vit_int8(model)
            return (lambda x_: fused_vit_apply_int8(model, x_, stacked_q=sq)), x
        raise SystemExit(
            f"--kernel-mode int8 supports ViT/DeiT, Swin and T2T "
            f"models, not {type(model).__name__} ({args.model})")
    if args.kernel_mode == "fused":
        return _fused_forward(model, args.model), x
    return model, x  # xla: the plain module; pallas: the module on the sdpa / mlp kernels


def _fused_forward(model, name: str):
    """The bf16 / fp16 kernel forward of a Swin, T2T or ViT model."""
    from .models.swin import SwinTransformer, fused_swin_apply, prepare_swin_fused
    from .models.t2t_vit import T2TViT, fused_t2t_apply, prepare_t2t_fused
    from .models.vit import ViT, fused_vit_apply, prepare_vit_fused

    if isinstance(model, SwinTransformer):
        prep = prepare_swin_fused(model)
        return lambda x: fused_swin_apply(model, x, prepared=prep)
    if isinstance(model, T2TViT):
        prep, stacked = prepare_t2t_fused(model), prepare_vit_fused(model)
        return lambda x: fused_t2t_apply(model, x, prepared=prep, stacked=stacked)
    if isinstance(model, ViT):
        stacked = prepare_vit_fused(model)
        return lambda x: fused_vit_apply(model, x, stacked=stacked)
    raise SystemExit(f"the fused kernels run ViT/DeiT, T2T and Swin models, not {name}")


def cmd_benchmark(argv):
    p = argparse.ArgumentParser(prog="benchmark")
    p.add_argument("--model", default="deit_tiny")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--style", default="standard")
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--kernel-mode", default="xla",
                   choices=["xla", "pallas", "fused", "int8", "int8_static"])
    p.add_argument("--quantized-checkpoint", default=None,
                   help="benchmark a convert-saved dynamic/int8 artifact "
                        "through the deployment kernels (overrides --model/"
                        "--kernel-mode)")
    p.add_argument("--stem-int8", action="store_true",
                   help="T2T int8_static only: also run the tokenizer "
                        "stem's three big matmuls static-int8 "
                        "(prepare_t2t_stem_int8_static)")
    p.add_argument("--device-time", action="store_true",
                   help="also time a CUDA-graph replay of the same call "
                        "(harness.measure_graph_time): device_p50_ms, the host taken out")
    _device_arg(p)
    args = p.parse_args(argv)

    from .bench import harness
    from .bench.looptimer import measure_op_time

    with torch.no_grad():
        fn, x = _benchmark_call(args)
        r = measure_op_time(fn, (x,), iters=args.iters, repeats=args.repeats, chain_arg=-1)
        if args.device_time:
            if x.device.type != "cuda":
                raise SystemExit("--device-time needs --device cuda")
            r["device_p50_ms"] = harness.measure_graph_time(lambda: fn(x))["p50_ms"]
    r["model"] = args.quantized_checkpoint or args.model
    r["batch"] = args.batch
    r["throughput_per_s"] = args.batch / (r["p50_ms"] / 1e3) if r["p50_ms"] else None
    # the reference's print contract (tools.py:550)
    print(f"Avg latency {r['avg_ms']:.4f} ms, Std {r['std_ms']:.4f} ms")
    print(json.dumps(r))
    return r


def cmd_benchmark_train(argv):
    """Training-step benchmark: finetune and sparse (movement-pruning) step
    latency and img/s, with the marginal cost of the every-step topK
    binarization over the mask scores."""
    p = argparse.ArgumentParser(prog="benchmark_train")
    p.add_argument("--model", default="deit_tiny")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--style", default="standard")
    p.add_argument("--mode", default="both",
                   choices=["finetune", "sparse", "both"])
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--remat", action="store_true",
                   help="per-block gradient rematerialization (memory for "
                        "recompute; ViT-family models)")
    p.add_argument("--qat", action="store_true",
                   help="sparse mode: fake-quant the encoder matmul kernels "
                        "in the training forward (STE; measures the QAT "
                        "marginal step cost)")
    p.add_argument("--report-memory", action="store_true",
                   help="also report one step's device memory in MB "
                        "(harness.compiled_mem_mb)")
    _device_arg(p)
    args = p.parse_args(argv)
    if args.qat and args.mode != "sparse":
        raise SystemExit("--qat requires --mode sparse")

    from .bench.harness import compiled_mem_mb
    from .bench.looptimer import measure_op_time
    from .models.vit import ViT
    from .parallel.train import Optimizer, cross_entropy, make_train_step

    model, in_shape = _build_model(args.model, args.style, args.dtype, args.device)
    if args.remat:
        if not isinstance(model, ViT):
            raise SystemExit("--remat currently applies to ViT-family models")
        model = ViT(model.config.replace(remat=True), device=args.device,
                    generator=torch.Generator().manual_seed(0))
    cfg = model.config
    dev = torch.device(args.device)
    x = torch.from_numpy(np.random.RandomState(0).randn(args.batch, *in_shape)).to(
        dev, _dtype(args.dtype))
    labels = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.num_classes, (args.batch,))).to(dev)
    apply = _apply(model)
    params = _variables(model)["params"]
    results = {}

    if args.mode in ("sparse", "both") and not isinstance(model, ViT):
        raise SystemExit(
            f"benchmark_train --mode sparse needs a ViT-family model "
            f"(mask scores address the ViT param tree); got "
            f"{type(model).__name__} for --model {args.model}")

    if args.mode in ("finetune", "both"):
        opt = Optimizer(torch.optim.SGD, {"lr": 1e-3, "momentum": 0.9})
        step = make_train_step(apply, opt, cross_entropy)
        fargs = (params, opt.init(params), x, labels)
        r = measure_op_time(step, fargs, iters=args.iters, repeats=args.repeats, chain_arg=2)
        if args.report_memory:
            r["hbm_mb"] = compiled_mem_mb(step, fargs)
        results["finetune"] = r

    if args.mode in ("sparse", "both"):
        from .pruning.movement import SparseConfig, init_mask_scores, schedule_thresholds
        from .pruning.sparse_driver import ADAMW_WEIGHT_DECAY
        from .pruning.sparse_train import make_sparse_train_step

        sparse = SparseConfig(qat=args.qat)
        from .utils.jax_bridge import flatten_tree

        scores = init_mask_scores(cfg, sparse, torch.Generator().manual_seed(2), device=dev)
        n_scores = sum(int(s.numel()) for s in flatten_tree(scores).values())
        opt_p = Optimizer(torch.optim.AdamW, {"lr": 1e-4, "weight_decay": ADAMW_WEIGHT_DECAY})
        opt_s = Optimizer(torch.optim.AdamW, {"lr": 1e-2, "weight_decay": ADAMW_WEIGHT_DECAY})
        step = make_sparse_train_step(apply, cfg, sparse, opt_p, opt_s)
        thr_list, regu_mul = schedule_thresholds(500, 1000, cfg, sparse)
        fargs = (params, scores, opt_p.init(params), opt_s.init(scores), x, labels,
                 torch.tensor(thr_list, dtype=torch.float32, device=dev),
                 torch.tensor(regu_mul, dtype=torch.float32, device=dev))
        r = measure_op_time(step, fargs, iters=args.iters, repeats=args.repeats, chain_arg=4)
        r["mask_scores"] = n_scores
        if args.report_memory:
            r["hbm_mb"] = compiled_mem_mb(step, fargs)
        results["sparse"] = r

    for mode, r in results.items():
        ips = args.batch / (r["p50_ms"] / 1e3) if r["p50_ms"] else None
        extra = f" scores={r['mask_scores']}" if "mask_scores" in r else ""
        print(f"{mode}: step {r['p50_ms']:.4f} ms (std {r['std_ms']:.4f}), "
              f"{ips:.1f} img/s{extra}")
    if "finetune" in results and "sparse" in results:
        marg = results["sparse"]["p50_ms"] - results["finetune"]["p50_ms"]
        print(f"sparse marginal (masking+topK+regu+2nd opt): {marg:.4f} ms/step")
    out = {m: dict(r) for m, r in results.items()}
    out.update(model=args.model, batch=args.batch)
    if args.qat:
        out["qat"] = True
    print(json.dumps(out))


def cmd_profile(argv):
    p = argparse.ArgumentParser(prog="profile")
    p.add_argument("--model", default="deit_tiny")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--output", default="profile.csv")
    p.add_argument("--mode", default="micro", choices=["micro", "trace"],
                   help="micro = loop-delta stage decomposition; trace = "
                        "a torch.profiler trace (one row per CUDA kernel launch on "
                        "the card, per CPU operator on the CPU)")
    p.add_argument("--kernel-mode", default="xla", choices=["xla", "fused"],
                   help="trace mode: which forward to trace")
    p.add_argument("--iters", type=int, default=10)
    _device_arg(p)
    args = p.parse_args(argv)

    from .bench.looptimer import measure_op_time
    from .bench.profile import profile_trace, profile_vit, write_profile_csv
    from .models.vit import ViT

    model, in_shape = _build_model(args.model, dtype=args.dtype, device=args.device)
    x = torch.ones((args.batch,) + tuple(in_shape), dtype=_dtype(args.dtype),
                   device=args.device)
    with torch.no_grad():
        if args.mode == "trace":
            fn = _fused_forward(model, args.model) if args.kernel_mode == "fused" else model
            fn(x)

            def run_once():
                fn(x)
                if x.is_cuda:
                    torch.cuda.synchronize()

            rows, total = profile_trace(run_once, iters=args.iters, device=args.device)
            # the sanity oracle: per-op sums must reconcile with the
            # end-to-end loop-delta latency
            e2e = measure_op_time(fn, (x,), iters=100, repeats=3, chain_arg=0)["p50_ms"]
            ratio = total / e2e if e2e else float("nan")
            print(f"trace per-op sum {total:.4f} ms vs end-to-end {e2e:.4f} ms "
                  f"(ratio {ratio:.2f})")
        else:
            if not isinstance(model, ViT):
                raise SystemExit(f"profile --mode micro decomposes a ViT forward, not "
                                 f"{type(model).__name__} ({args.model})")
            rows, total = profile_vit(model, model.params(), x)
    write_profile_csv(args.output, rows, total)
    print(f"total {total:.4f} ms -> {args.output}")


def _analyse(which, argv):
    p = argparse.ArgumentParser(prog=which)
    p.add_argument("--file", required=True)
    p.add_argument("--type", default="deit")
    args = p.parse_args(argv)
    from .bench import analyse as an

    if which == "analyse_op":
        table = an.analyse_op(args.file, args.type)
        for k, v in table.items():
            print(f"{k} {v['latency']: .2f} {v['percent']: .2f}")
    elif which == "analyse_attn_ffn":
        print(json.dumps(an.analyse_attn_ffn(args.file, args.type)))
    elif which == "analyse_gelu_ln":
        print(json.dumps(an.analyse_gelu_ln(args.file, args.type)))
    elif which == "fetch_all_op_latency":
        for name, ms in an.fetch_all_op_latency(args.file):
            print(f"{name},{ms}")


def _float_model(args, dtype: str = "float32"):
    """``(model, in_shape, ck_meta)``: the model of ``--model`` or of the
    compiled config a ``--checkpoint``'s meta carries, with its weights."""
    from .utils.checkpoint import load_meta

    ck_meta = load_meta(args.checkpoint) if getattr(args, "checkpoint", None) else None
    if ck_meta and "config" in ck_meta:
        # a sparse_train-compiled (shrunken) checkpoint: the exact pruned config
        from .config import ViTConfig
        from .models.vit import ViT

        cfg = ViTConfig.from_json(json.dumps(ck_meta["config"])).replace(dtype=_dtype(dtype))
        model = ViT(cfg, device=args.device, generator=torch.Generator().manual_seed(0))
        in_shape = (3, cfg.image_size, cfg.image_size)
    else:
        model, in_shape = _build_model(args.model, args.style, dtype, args.device)
    if getattr(args, "checkpoint", None):
        _checkpoint_weights(model, args.checkpoint)
    return model, in_shape, ck_meta


def cmd_convert(argv):
    p = argparse.ArgumentParser(prog="convert")
    p.add_argument("--model", default="deit_tiny")
    p.add_argument("--quantization", default="float16",
                   choices=["float16", "bfloat16", "dynamic", "int8"])
    p.add_argument("--checkpoint", default=None, help="input checkpoint dir")
    p.add_argument("--output", required=True)
    p.add_argument("--style", default="standard")
    p.add_argument("--calib-batches", type=int, default=100,
                   help="int8: representative random-normal batches "
                        "(reference utils.py:265-269 uses 100)")
    p.add_argument("--calib-percentile", type=float, default=None,
                   help="int8: abs-percentile calibration instead of absmax")
    p.add_argument("--calib-method", default="absmax",
                   choices=["absmax", "mse"],
                   help="int8: activation-clip calibration — absmax "
                        "(reference min/max semantics) or mse (offline "
                        "MSE-optimal clip search)")
    p.add_argument("--smooth-alpha", type=float, default=None,
                   help="int8 (ViT/T2T/Swin): SmoothQuant-style offline "
                        "scale migration before calibration, with this "
                        "strength (exact float re-parameterization)")
    _device_arg(p)
    args = p.parse_args(argv)
    if args.smooth_alpha is not None and args.quantization != "int8":
        raise SystemExit("--smooth-alpha applies to --quantization int8 only")

    from .models.swin import SwinTransformer
    from .ops.quant import cast_params, quantize_vit_params_int8
    from .utils.checkpoint import save_checkpoint

    meta = {
        "model": args.model, "quantization": args.quantization,
        "style": args.style,
    }
    model, in_shape, ck_meta = _float_model(args)
    if ck_meta and "config" in ck_meta:
        meta["config"] = ck_meta["config"]
        cfg = model.config
        print(f"checkpoint carries a compiled config: heads "
              f"{cfg.heads_per_layer} mlp {cfg.mlp_dim_per_layer}")
    params = _variables(model)
    with torch.no_grad():
        if args.quantization in ("float16", "bfloat16"):
            out = cast_params(params, _dtype(args.quantization))
        elif isinstance(model, SwinTransformer):
            # Swin int8 lives in per-stage stacks, not per-param trees: save
            # what the whole-stage kernels consume
            from .models.swin import prepare_swin_int8, prepare_swin_int8_static

            if args.quantization == "dynamic":
                out = prepare_swin_int8(model)
            else:
                if args.calib_percentile is not None:
                    raise SystemExit("swin calibration records absmax only "
                                     "(--calib-percentile is ViT/T2T-only)")
                if args.smooth_alpha is not None:
                    from .models.swin import smooth_swin

                    _load_weights(model, smooth_swin(model, n=args.calib_batches,
                                                     alpha=args.smooth_alpha))
                    params = _variables(model)
                    meta["smooth_alpha"] = args.smooth_alpha
                    print(f"smoothed swin params (alpha={args.smooth_alpha})")
                out = prepare_swin_int8_static(model, n=args.calib_batches,
                                               method=args.calib_method)
                meta["calib_batches"] = args.calib_batches
                meta["calib_method"] = args.calib_method
            if not out:
                raise SystemExit(f"{args.model}: no stage qualifies for the "
                                 "int8 whole-stage kernel")
            out = {f"stage_{si}": stacked for si, stacked in out.items()}
            meta["int8_stages"] = sorted(int(k.split("_")[1]) for k in out)
            # the float variables make the artifact standalone-runnable
            out["variables"] = params
            print(f"int8 stages: {meta['int8_stages']}")
        elif args.quantization == "dynamic":
            out = quantize_vit_params_int8(params)
            if not any(k.startswith("block_") for k in out["params"]):
                raise SystemExit(
                    f"{args.model}: no encoder blocks to quantize — dynamic "
                    "int8 targets transformer encoders (ViT/DeiT/T2T)")
        else:  # int8 = full-integer static: calibrate on representative data
            from .models.t2t_vit import T2TViT
            from .models.vit import ViT
            from .ops.quant import calibrate_t2t, calibrate_vit, quantize_vit_params_int8_static

            if not isinstance(model, (ViT, T2TViT)):
                raise SystemExit(
                    f"{args.model}: static-int8 calibration targets the "
                    "ViT/DeiT and T2T families (the calibrators walk those "
                    "forwards); CNNs support --quantization float16/bfloat16")
            is_t2t = isinstance(model, T2TViT)
            if args.smooth_alpha is not None:
                from .ops.quant import smooth_t2t, smooth_vit

                params = {**params, "params": (smooth_t2t if is_t2t else smooth_vit)(
                    model, n=args.calib_batches, alpha=args.smooth_alpha)}
                meta["smooth_alpha"] = args.smooth_alpha
                print(f"smoothed encoder params (alpha={args.smooth_alpha})")
            calibrate = calibrate_t2t if is_t2t else calibrate_vit
            scales = calibrate(model, params["params"], n=args.calib_batches,
                               percentile=args.calib_percentile, method=args.calib_method)
            out = quantize_vit_params_int8_static(params, scales)
            meta["act_scales"] = np.asarray(scales).tolist()
            meta["calib_batches"] = args.calib_batches
            meta["calib_method"] = args.calib_method
            print(f"calibrated {scales.shape[0]} layers x {scales.shape[1]} "
                  f"activation scales on {args.calib_batches} batches "
                  f"({args.calib_method})")
    save_checkpoint(args.output, out, meta=meta)
    print(f"saved {args.quantization} checkpoint -> {args.output}")


def cmd_quant_accuracy(argv):
    """Quantization accuracy-delta table: fp32 vs bf16 / dynamic-int8 /
    static-int8 logit drift and argmax agreement (the reference's
    quant-op-test methodology, applied to the whole model)."""
    p = argparse.ArgumentParser(prog="quant_accuracy")
    p.add_argument("--model", default="deit_tiny")
    p.add_argument("--style", default="standard")
    p.add_argument("--from-hf", default=None,
                   help="optional HF checkpoint for real weights")
    p.add_argument("--checkpoint", default=None,
                   help="float checkpoint dir (e.g. a sparse_train output; "
                        "its meta config overrides --model when present)")
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--calib-batches", type=int, default=32)
    p.add_argument("--with-mse", action="store_true",
                   help="add a static_int8_mse row (MSE-optimal clip "
                        "calibration)")
    p.add_argument("--with-smooth", action="store_true",
                   help="add a static_int8_smooth row (SmoothQuant-style "
                        "offline scale migration before calibration; with "
                        "--with-mse also a static_int8_smooth_mse row)")
    p.add_argument("--smooth-alpha", type=float, default=0.5,
                   help="migration strength for --with-smooth (0..1)")
    _device_arg(p)
    args = p.parse_args(argv)

    from .models.swin import SwinTransformer
    from .models.t2t_vit import T2TViT
    from .models.vit import ViT
    from .ops.quant import (calibrate_t2t, calibrate_vit, int8_t2t_apply,
                            int8_t2t_apply_static, int8_vit_apply, int8_vit_apply_static,
                            quantize_vit_params_int8, quantize_vit_params_int8_static,
                            representative_batches)

    model, in_shape, ck_meta = _float_model(args)
    if ck_meta and "config" in ck_meta:
        print(f"checkpoint config: heads {model.config.heads_per_layer} "
              f"mlp {model.config.mlp_dim_per_layer}")
    if not isinstance(model, (ViT, T2TViT, SwinTransformer)):
        raise SystemExit(
            f"{args.model}: quant_accuracy supports the ViT/DeiT, T2T and "
            "Swin families")
    if args.from_hf:
        from .utils.hf_import import load_hf_model_params

        family = "swin" if isinstance(model, SwinTransformer) else "vit"
        _load_weights(model, load_hf_model_params(args.from_hf, family, device=args.device)[1])

    def bf16_twin(variables=None):
        """The same model in bf16 with ``variables`` (default: the fp32 model's)."""
        m = type(model)(model.config.replace(dtype=torch.bfloat16), device=args.device)
        _load_weights(m, variables if variables is not None else _variables(model))
        return m

    bf = torch.bfloat16
    with torch.no_grad():
        if isinstance(model, SwinTransformer):
            # Swin int8 is the whole-stage kernel path: the table compares
            # the deployment kernels directly; only qualifying stages run int8
            from .models.swin import (fused_swin_apply, prepare_swin_fused, prepare_swin_int8,
                                      prepare_swin_int8_static, smooth_swin)

            model_bf = bf16_twin()
            prep = prepare_swin_fused(model_bf)
            q = prepare_swin_int8(model_bf)
            qs = prepare_swin_int8_static(model_bf, n=args.calib_batches)
            if not q:
                raise SystemExit(f"{args.model}: no stage qualifies for the "
                                 "int8 whole-stage kernel")
            n_stages = len(model.config.depths)
            print(f"int8 stages: {sorted(q)} of {list(range(n_stages))} "
                  f"(others run bf16 fused — mixed-precision rows)")

            def swin_mode(m, pr, qq):
                return lambda x: fused_swin_apply(m, x.to(bf), prepared=pr, int8_prepared=qq)

            modes = {"bf16": lambda x: model_bf(x.to(bf)),
                     "dynamic_int8": swin_mode(model_bf, prep, q),
                     "static_int8": swin_mode(model_bf, prep, qs)}
            if args.with_mse:
                modes["static_int8_mse"] = swin_mode(model_bf, prep, prepare_swin_int8_static(
                    model_bf, n=args.calib_batches, method="mse"))
            if args.with_smooth:
                model_sm = bf16_twin({"params": smooth_swin(model_bf, n=args.calib_batches,
                                                            alpha=args.smooth_alpha)})
                prep_sm = prepare_swin_fused(model_sm)
                modes["static_int8_smooth"] = swin_mode(model_sm, prep_sm, prepare_swin_int8_static(
                    model_sm, n=args.calib_batches))
                if args.with_mse:
                    modes["static_int8_smooth_mse"] = swin_mode(
                        model_sm, prep_sm, prepare_swin_int8_static(
                            model_sm, n=args.calib_batches, method="mse"))
        else:
            is_t2t = isinstance(model, T2TViT)
            calibrate = calibrate_t2t if is_t2t else calibrate_vit
            variables = _variables(model)
            scales = calibrate(model, n=args.calib_batches)
            qdyn = quantize_vit_params_int8(variables)
            qstat = quantize_vit_params_int8_static(variables, scales)
            apply_dyn = int8_t2t_apply if is_t2t else int8_vit_apply
            apply_stat = int8_t2t_apply_static if is_t2t else int8_vit_apply_static
            model_bf = bf16_twin()
            modes = {
                "bf16": lambda x: model_bf(x.to(bf)),
                "dynamic_int8": lambda x: apply_dyn(model, qdyn, x),
                "static_int8": lambda x: apply_stat(model, qstat, x),
            }
            if args.with_mse:
                qmse = quantize_vit_params_int8_static(
                    variables, calibrate(model, n=args.calib_batches, method="mse"))
                modes["static_int8_mse"] = lambda x: apply_stat(model, qmse, x)
            if args.with_smooth:
                from .ops.quant import smooth_t2t, smooth_vit

                psm = {**variables, "params": (smooth_t2t if is_t2t else smooth_vit)(
                    model, n=args.calib_batches, alpha=args.smooth_alpha)}
                qsm = quantize_vit_params_int8_static(
                    psm, calibrate(model, psm["params"], n=args.calib_batches))
                modes["static_int8_smooth"] = lambda x: apply_stat(model, qsm, x)
                if args.with_mse:
                    qsm2 = quantize_vit_params_int8_static(
                        psm, calibrate(model, psm["params"], n=args.calib_batches,
                                       method="mse"))
                    modes["static_int8_smooth_mse"] = lambda x: apply_stat(model, qsm2, x)

        # the fp32 oracle: the plain module on the same device
        stats = {m: {"max_abs": 0.0, "max_rel": 0.0, "agree": 0, "n": 0} for m in modes}
        for batch in representative_batches(args.batches, args.batch, in_shape, seed=1234):
            xb = torch.as_tensor(batch, device=args.device)
            ref = model(xb).float().cpu().numpy()
            denom = np.abs(ref).max() + 1e-9
            for m, fn in modes.items():
                got = fn(xb).float().cpu().numpy()
                st = stats[m]
                st["max_abs"] = max(st["max_abs"], float(np.abs(got - ref).max()))
                st["max_rel"] = max(st["max_rel"], float(np.abs(got - ref).max() / denom))
                st["agree"] += int((got.argmax(-1) == ref.argmax(-1)).sum())
                st["n"] += ref.shape[0]
    print(f"{'mode':<14} {'max|dlogit|':>12} {'max rel':>9} {'argmax agree':>13}")
    for m, st in stats.items():
        print(f"{m:<14} {st['max_abs']:>12.4f} {st['max_rel']:>9.4f} "
              f"{st['agree']}/{st['n']:>8}")
    print(json.dumps({m: dict(st) for m, st in stats.items()}))


def cmd_export(argv):
    p = argparse.ArgumentParser(prog="export")
    p.add_argument("--model", default="deit_tiny")
    p.add_argument("--style", default="standard")
    p.add_argument("--from-hf", default=None, help="HF checkpoint name/path")
    p.add_argument("--format", default="checkpoint",
                   choices=["checkpoint", "torch_export"])
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--output", required=True)
    _device_arg(p)
    args = p.parse_args(argv)

    from .utils.checkpoint import save_checkpoint

    if args.format == "torch_export":
        from .utils.export import export_forward

        model, in_shape = _build_model(args.model, args.style, device=args.device)
        path = export_forward(
            _apply(model), _variables(model)["params"], (args.batch,) + tuple(in_shape),
            args.output, meta={"model": args.model, "style": args.style},
        )
        print(f"saved torch_export -> {path}")
        return

    if args.from_hf:
        if "t2t" in args.model:
            # official *.pth.tar checkpoint (reference tools.py:360-365)
            from .utils.hf_import import load_t2t_checkpoint
            from .utils.jax_bridge import tree_to_torch

            variant = int(args.model.rsplit("_", 1)[-1])
            _, params = load_t2t_checkpoint(args.from_hf, variant)
            params = tree_to_torch(params)
        else:
            from .utils.hf_import import load_hf_model_params

            family = "swin" if "swin" in args.model else "vit"
            _, params = load_hf_model_params(args.from_hf, family, device=args.device)
        meta = {"model": args.model, "hf": args.from_hf}
    else:
        model, _ = _build_model(args.model, args.style, device=args.device)
        params = _variables(model)
        meta = {"model": args.model, "style": args.style}
    save_checkpoint(args.output, params, meta=meta)
    print(f"saved -> {args.output}")


def cmd_eval(argv):
    p = argparse.ArgumentParser(prog="eval")
    p.add_argument("--model", default="deit_tiny")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--style", default="standard")
    p.add_argument("--marker-dir", default=None)
    # cross-implementation consistency: plain vs fused kernels vs int8
    p.add_argument("--impl", default="xla",
                   choices=["xla", "fused", "int8", "int8_fused",
                            "int8_static", "int8_static_fused"])
    p.add_argument("--calib-method", default="absmax",
                   choices=["absmax", "mse"],
                   help="int8_static impls: activation-clip calibration "
                        "(ViT/T2T families; swin records absmax)")
    p.add_argument("--quantized-checkpoint", default=None,
                   help="evaluate a convert-saved dynamic/int8 artifact "
                        "through the deployment kernels (overrides --model/"
                        "--impl)")
    p.add_argument("--dtype", default=None,
                   help="compute dtype: float32 for --impl xla, int8 and int8_static; "
                        "bfloat16 for the kernel impls and --quantized-checkpoint (the "
                        "kernels compute in bf16 or fp16)")
    _device_arg(p)
    args = p.parse_args(argv)

    from .utils.imagenet import evaluate, write_accuracy_marker

    kernels = args.quantized_checkpoint or args.impl in ("fused", "int8_fused",
                                                         "int8_static_fused")
    dtype = args.dtype or ("bfloat16" if kernels else "float32")
    kw = dict(batch_size=args.batch, limit=args.limit, progress=True, device=args.device)
    if args.quantized_checkpoint:
        _, _, qfn = _load_quantized_artifact(args.quantized_checkpoint, dtype, args.device)
        acc = evaluate(qfn, args.data_dir, **kw)
        print(f"top1 {acc:.4f}")
        if args.marker_dir:
            write_accuracy_marker(args.marker_dir, acc)
        return

    from .models.swin import SwinTransformer
    from .models.t2t_vit import T2TViT

    model, _ = _build_model(args.model, args.style, dtype, args.device)
    if args.checkpoint:
        _checkpoint_weights(model, args.checkpoint)
    is_t2t = isinstance(model, T2TViT)
    if isinstance(model, SwinTransformer) and args.impl != "xla":
        # Swin's cross-impl eval rides the whole-stage kernels
        from .models.swin import (fused_swin_apply, prepare_swin_fused, prepare_swin_int8,
                                  prepare_swin_int8_static)

        prep = prepare_swin_fused(model)
        if args.impl in ("int8", "int8_fused"):
            q = prepare_swin_int8(model)
        elif args.impl in ("int8_static", "int8_static_fused"):
            q = prepare_swin_int8_static(model, method=args.calib_method)
        else:
            q = None
        if q is not None and not q:
            raise SystemExit(f"{args.model}: no stage qualifies for the "
                             "int8 whole-stage kernel; use --impl fused")
        apply_fn = lambda x: fused_swin_apply(model, x, prepared=prep,  # noqa: E731
                                              int8_prepared=q)
    elif args.impl == "fused":
        apply_fn = _fused_forward(model, args.model)
    elif args.impl in ("int8", "int8_static"):
        from .ops.quant import (calibrate_t2t, calibrate_vit, int8_t2t_apply,
                                int8_t2t_apply_static, int8_vit_apply, int8_vit_apply_static,
                                quantize_vit_params_int8, quantize_vit_params_int8_static)

        variables = _variables(model)
        if args.impl == "int8":
            qp = quantize_vit_params_int8(variables)
            apply = int8_t2t_apply if is_t2t else int8_vit_apply
        else:
            calibrate = calibrate_t2t if is_t2t else calibrate_vit
            qp = quantize_vit_params_int8_static(
                variables, calibrate(model, method=args.calib_method))
            apply = int8_t2t_apply_static if is_t2t else int8_vit_apply_static
        apply_fn = lambda x: apply(model, qp, x)  # noqa: E731
    elif args.impl in ("int8_fused", "int8_static_fused"):
        static = args.impl == "int8_static_fused"
        if is_t2t:
            from .models.t2t_vit import (fused_t2t_apply_int8, prepare_t2t_fused,
                                         prepare_t2t_int8, prepare_t2t_int8_static)

            sq = (prepare_t2t_int8_static(model, method=args.calib_method) if static
                  else prepare_t2t_int8(model))
            prep = prepare_t2t_fused(model)
            apply_fn = lambda x: fused_t2t_apply_int8(model, x, stacked_q=sq,  # noqa: E731
                                                      prepared=prep)
        else:
            from .models.vit import (fused_vit_apply_int8, prepare_vit_int8,
                                     prepare_vit_int8_static)

            sq = (prepare_vit_int8_static(model, method=args.calib_method) if static
                  else prepare_vit_int8(model))
            apply_fn = lambda x: fused_vit_apply_int8(model, x, stacked_q=sq)  # noqa: E731
    else:
        apply_fn = model
    acc = evaluate(apply_fn, args.data_dir, **kw)
    print(f"top1 {acc:.4f}")
    if args.marker_dir:
        write_accuracy_marker(args.marker_dir, acc)


def _make_batches(args, in_shape):
    """() -> iterable of (images, labels) from --data-dir or --synthetic N
    (numpy arrays; the training loops move them to the params' device)."""
    if getattr(args, "data_dir", None):
        from .utils.imagenet import iterate_batches, list_image_folder

        samples, _ = list_image_folder(args.data_dir)
        if getattr(args, "limit", None):
            samples = samples[: args.limit]
        crop = in_shape[-1]
        resize = max(crop, round(crop * 256 / 224))
        return lambda: iterate_batches(samples, args.batch, resize=resize, crop=crop)

    n = getattr(args, "synthetic", 0)
    if not n:
        raise SystemExit("need --data-dir or --synthetic N")
    rng = np.random.RandomState(0)
    data = [
        (rng.randn(args.batch, *in_shape).astype(np.float32),
         rng.randint(0, 1000, size=args.batch).astype(np.int32))
        for _ in range(n)
    ]
    return lambda: list(data)


def cmd_prune_heads(argv):
    p = argparse.ArgumentParser(prog="prune_heads")
    p.add_argument("--model", default="deit_tiny")
    p.add_argument("--importance-file", default=None)
    p.add_argument("--data-dir", default=None,
                   help="compute real Taylor importance from these images")
    p.add_argument("--importance-batches", type=int, default=8)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--random-importance", action="store_true",
                   help="explicit opt-in to random scores (debug only)")
    p.add_argument("--prune-percent", type=float, nargs="+", default=[10.0])
    p.add_argument("--at-least-x-heads-per-layer", type=int, default=1)
    p.add_argument("--eval", action="store_true",
                   help="top-1 eval of the pruned model on --data-dir")
    p.add_argument("--retrain-steps", type=int, default=0,
                   help="SGD retrain steps on --data-dir after pruning")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--output", default=None)
    p.add_argument("--style", default="standard")
    _device_arg(p)
    args = p.parse_args(argv)

    from .pruning import (calculate_head_importance, determine_pruning_sequence,
                          load_head_importance_txt, prune_heads_params, to_pruning_descriptor,
                          what_to_prune)
    from .utils.checkpoint import save_checkpoint

    model, in_shape, _ = _float_model(args)
    cfg = model.config
    params = _variables(model)

    if args.importance_file:
        imp = load_head_importance_txt(args.importance_file)
    elif args.data_dir:
        # real Taylor importance (reference classifier_eval.py:111-225)
        import itertools

        batches = _make_batches(args, in_shape)
        images_only = itertools.islice(
            (x for x, _ in batches()), args.importance_batches)
        imp = calculate_head_importance(cfg, params, images_only)
        print("computed head importance from data:")
        print(np.array2string(np.asarray(imp), precision=4))
    elif args.random_importance:
        print("using uniform random importance (--random-importance)")
        imp = np.random.RandomState(0).rand(cfg.depth, cfg.heads)
    else:
        raise SystemExit(
            "need an importance source: --importance-file, --data-dir, "
            "or --random-importance")

    seq = determine_pruning_sequence(
        None, args.prune_percent, cfg.heads, cfg.depth,
        args.at_least_x_heads_per_layer,
    )
    to_prune = {}
    for step, n in enumerate(seq):
        to_prune = what_to_prune(
            imp, n, to_prune, args.at_least_x_heads_per_layer
        )
        print(f"step {step}: prune {n} -> {to_pruning_descriptor(to_prune)}")
    new_cfg, new_params = prune_heads_params(cfg, params, to_prune)
    print(f"heads_per_layer: {new_cfg.heads_per_layer}")

    if (args.retrain_steps and args.data_dir) or (args.eval and args.data_dir):
        from .models.vit import ViT

        new_model = ViT(new_cfg, device=args.device)
        _load_weights(new_model, new_params)
        new_params = _variables(new_model)
    if args.retrain_steps and args.data_dir:
        from .utils.finetune import FinetuneConfig, finetune

        new_params = finetune(
            _apply(new_model), new_params, _make_batches(args, in_shape),
            FinetuneConfig(optimizer="sgd", epochs=10**6,
                           max_steps=args.retrain_steps),
        )
    if args.eval and args.data_dir:
        from .utils.imagenet import evaluate

        fwd = _apply(new_model)
        acc = evaluate(lambda x: fwd(new_params, x), args.data_dir,
                       batch_size=args.batch, limit=args.limit, device=args.device)
        print(f"pruned top1 {acc:.4f}")

    if args.output:
        save_checkpoint(args.output, new_params, meta={
            "model": args.model,
            "heads_per_layer": list(new_cfg.heads_per_layer),
            "pruned": to_pruning_descriptor(to_prune),
        })
        print(f"saved -> {args.output}")


def cmd_prune(argv):
    """Standalone magnitude pruner (reference deit_pruning/src/pytorch_prune/
    pruner.py:85-103): hybrid = block on attention + ln_smart on denses."""
    p = argparse.ArgumentParser(prog="prune")
    p.add_argument("--model", default="deit_tiny")
    p.add_argument("--style", default="standard")
    p.add_argument("--func", default="hybrid",
                   choices=["hybrid", "block", "ln_smart_structured",
                            "ln_structured", "l1_unstructured",
                            "random_unstructured"])
    p.add_argument("--amount", type=float, default=0.5)
    p.add_argument("--block-row", type=int, default=None)
    p.add_argument("--block-col", type=int, default=None)
    p.add_argument("--dim", type=int, default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--output", default=None)
    _device_arg(p)
    args = p.parse_args(argv)

    from .pruning import magnitude_pruners as mp
    from .pruning.movement import sparsity_report
    from .utils.checkpoint import save_checkpoint

    model, _, _ = _float_model(args)
    cfg = model.config
    params = _variables(model)

    if args.func == "hybrid":
        params = mp.hybrid_prune_params(
            cfg, params, args.amount, args.block_row, args.block_col)
    else:
        mask_fn = {
            "block": lambda w: mp.block_prune_mask(
                w, args.amount,
                args.block_row or cfg.resolved_head_dim,
                args.block_col or w.shape[1]),
            "ln_smart_structured": lambda w: mp.ln_smart_structured_mask(
                w, args.amount),
            "ln_structured": lambda w: mp.ln_structured_mask(
                w, args.amount, dim=args.dim if args.dim is not None else 0),
            "l1_unstructured": lambda w: mp.l1_unstructured_mask(w, args.amount),
            "random_unstructured": lambda w: mp.random_unstructured_mask(
                w, args.amount),
        }[args.func]

        def prune_tree(tree, path=""):
            # encoder weight matrices only (the reference prunes encoder
            # Linears; embeddings and heads stay dense)
            if isinstance(tree, dict):
                return {k: prune_tree(v, f"{path}/{k}") for k, v in tree.items()}
            if tree.dim() == 2 and "block_" in path and "kernel" in path:
                w = tree.float().cpu().numpy().T  # torch [out, in] orientation
                return torch.from_numpy((w * mask_fn(w)).T.copy()).to(tree.device, tree.dtype)
            return tree

        params = prune_tree(params)

    rep = sparsity_report(params)
    print(json.dumps({"func": args.func, "amount": args.amount,
                      "overall_sparsity": rep["__overall__"]}))
    if args.output:
        save_checkpoint(args.output, params, meta={
            "model": args.model, "func": args.func, "amount": args.amount,
        })
        print(f"saved -> {args.output}")


def cmd_finetune(argv):
    """Retrain / finetune command (reference classifier_training.py:18-184,
    finetune.py)."""
    p = argparse.ArgumentParser(prog="finetune")
    p.add_argument("--model", default="deit_tiny")
    p.add_argument("--style", default="standard")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N random batches (smoke/test mode)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "adamw"])
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--lr-scale-batch", type=int, default=None,
                   help="if set, lr *= n_dev*batch/512 (train_main.py:225-227)")
    p.add_argument("--resume-dir", default=None,
                   help="mid-training checkpoint dir (resume if present)")
    p.add_argument("--remat", action="store_true",
                   help="per-block gradient rematerialization (ViT family): "
                        "memory-for-recompute at larger batch")
    p.add_argument("--output", default=None)
    _device_arg(p)
    args = p.parse_args(argv)

    from .models.vit import ViT
    from .utils.checkpoint import save_checkpoint
    from .utils.finetune import FinetuneConfig, finetune

    model, in_shape = _build_model(args.model, args.style, device=args.device)
    if args.remat:
        if not isinstance(model, ViT):
            raise SystemExit("--remat currently applies to ViT-family models")
        model = ViT(model.config.replace(remat=True), device=args.device)
    if args.checkpoint:
        _checkpoint_weights(model, args.checkpoint)
    params = _variables(model)
    batches = _make_batches(args, in_shape)
    fcfg = FinetuneConfig(
        lr=args.lr, optimizer=args.optimizer, epochs=args.epochs,
        max_steps=args.max_steps, grad_accum=args.grad_accum,
        lr_scale_batch=args.lr_scale_batch, checkpoint_dir=args.resume_dir,
        donate=True,
    )
    params = finetune(_apply(model), params, batches, fcfg)
    if args.output:
        save_checkpoint(args.output, params, meta={
            "model": args.model, "finetuned": True, "optimizer": args.optimizer,
        })
        print(f"saved -> {args.output}")
    print("finetune done")


def cmd_sparse_train(argv):
    """Movement-pruning sparse finetune (reference train_main.py:104-437)."""
    p = argparse.ArgumentParser(prog="sparse_train")
    p.add_argument("--model", default="deit_tiny")
    p.add_argument("--style", default="standard")
    p.add_argument("--preset", default="topk-hybrid-struct-layerwise-tiny",
                   help="preset name in configs/ or a JSON path")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--teacher-checkpoint", default=None,
                   help="distillation teacher params (same arch)")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--warmup-steps", type=int, default=None)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--mask-lr", type=float, default=1e-2)
    p.add_argument("--layerwise-thresholds", default=None,
                   help='"h_0.5_d_0.3-..." DSL (README.md:78-82)')
    p.add_argument("--final-finetune-steps", type=int, default=0)
    p.add_argument("--no-compile", action="store_true",
                   help="skip compile-to-static-shapes at the end")
    p.add_argument("--output", default=None)
    _device_arg(p)
    args = p.parse_args(argv)

    from .pruning.sparse_driver import run_sparse_finetune, sparse_config_from_preset
    from .utils.checkpoint import save_checkpoint

    model, in_shape = _build_model(args.model, args.style, device=args.device)
    cfg = model.config
    if args.checkpoint:
        _checkpoint_weights(model, args.checkpoint)
    params = _variables(model)
    apply = _apply(model)
    teacher_apply = teacher_params = None
    if args.teacher_checkpoint:
        # the teacher's weights ride as the step's argument, on the same forward
        teacher, _ = _build_model(args.model, args.style, device=args.device)
        _checkpoint_weights(teacher, args.teacher_checkpoint)
        teacher_params = _variables(teacher)
        teacher_apply = apply

    warmup = args.warmup_steps if args.warmup_steps is not None else max(
        1, args.steps // 10)
    sparse = sparse_config_from_preset(
        args.preset, warmup_steps=warmup,
        layerwise_thresholds=args.layerwise_thresholds,
    )
    batches = _make_batches(args, in_shape)
    res = run_sparse_finetune(
        apply, cfg, params, sparse, batches, total_steps=args.steps,
        lr=args.lr, mask_lr=args.mask_lr, teacher_apply=teacher_apply,
        teacher_params=teacher_params,
        do_compile=not args.no_compile,
        final_finetune_steps=args.final_finetune_steps,
    )
    summary = {"steps": args.steps, "preset": args.preset}
    if res.compiled_cfg is not None:
        summary["heads_per_layer"] = list(res.compiled_cfg.heads_per_layer or [])
        summary["mlp_dim_per_layer"] = list(res.compiled_cfg.mlp_dim_per_layer or [])
        summary["sparsity"] = res.sparsity
    print(json.dumps(summary, default=float))
    if args.output:
        out_params = (res.compiled_params
                      if res.compiled_params is not None else res.params)
        meta = {"model": args.model, "preset": args.preset}
        if res.compiled_cfg is not None:
            # the full config is the source of truth for reloading: a
            # transitions-compiled checkpoint fed to a default-config model
            # would re-normalize the affine-folded LN params
            meta["config"] = json.loads(res.compiled_cfg.to_json())
            meta["heads_per_layer"] = list(res.compiled_cfg.heads_per_layer or [])
            meta["mlp_dim_per_layer"] = list(res.compiled_cfg.mlp_dim_per_layer or [])
            meta["norm_mode"] = res.compiled_cfg.norm_mode
            meta["act"] = res.compiled_cfg.act
        save_checkpoint(args.output, out_params, meta=meta)
        print(f"saved -> {args.output}")


def cmd_latency_model(argv):
    """Latency predictor: collect / fit / predict
    (reference latency_model.py:27-92 + get_latency.py:34-152)."""
    p = argparse.ArgumentParser(prog="latency_model")
    p.add_argument("action", choices=["collect", "fit", "predict"])
    p.add_argument("--size", default="tiny")
    p.add_argument("--n", type=int, default=20, help="configs to sample")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data", default=None, help="csv of encoding,ms")
    p.add_argument("--predictor", default=None, help="pickled model path")
    p.add_argument("--encoding", default=None, help='"h_4_d_0.4-..." to predict')
    p.add_argument("--impl", default="fused",
                   choices=["fused", "xla", "int8_static"],
                   help="collect: which inference path to measure — "
                        "int8_static is the deployed static-int8 path, so its "
                        "dataset fits a 'deployed latency' predictor")
    p.add_argument("--cv", type=int, default=5,
                   help="fit: also report k-fold cross-validated metrics "
                        "(0 disables)")
    p.add_argument("--max-noise", type=float, default=None,
                   help="fit: drop rows whose measured std_ms/ms exceeds "
                        "this fraction (needs the collect noise columns)")
    p.add_argument("--features", default="physical",
                   choices=["raw", "physical"],
                   help="fit: featurization — 'raw' is the reference-parity "
                        "per-layer (h, d) vector; 'physical' derives "
                        "MACs/weight-bytes/segment features from --size")
    p.add_argument("--output", default=None)
    _device_arg(p)
    args = p.parse_args(argv)

    import csv

    from .utils.latency_model import (LatencyPredictor, measure_pruned_deit,
                                      sample_random_configs)

    if args.action == "collect":
        depth = 12
        max_heads = {"tiny": 3, "small": 6, "base": 12}[args.size]
        encs = sample_random_configs(args.n, depth, max_heads, seed=args.seed)
        suffix = "" if args.impl == "fused" else f"_{args.impl}"
        bsuffix = "" if args.batch == 1 else f"_b{args.batch}"
        out = args.output or f"latency_{args.size}{suffix}{bsuffix}.csv"
        measure = measure_pruned_deit(args.size, batch=args.batch, impl=args.impl,
                                      detailed=True, device=args.device)
        # incremental writes: a killed collect keeps its rows; the std /
        # iters columns record each row's own noise floor; the batch column
        # lets fit pool batches behind the batch feature
        with open(out, "w", newline="", buffering=1) as f:
            w = csv.writer(f)
            w.writerow(["encoding", "ms", "std_ms", "iters", "batch"])
            for i, enc in enumerate(encs):
                r = measure(enc)
                w.writerow([enc, r["p50_ms"], r["std_ms"], r["iters"], args.batch])
                print(f"[{i + 1}/{len(encs)}] {enc} {r['p50_ms']:.4f} ms "
                      f"(std {r['std_ms']:.4f}, iters {r['iters']})",
                      flush=True)
        print(f"saved {len(encs)} rows -> {out}")
    elif args.action == "fit":
        if not args.data:
            raise SystemExit("fit needs --data csv")
        with open(args.data) as f:
            rows = list(csv.DictReader(f))
        bad = [r for r in rows if float(r["ms"]) <= 0]
        if bad:
            print(f"dropping {len(bad)} non-positive latency rows "
                  f"(measurement failures)")
            rows = [r for r in rows if float(r["ms"]) > 0]
        if args.max_noise is not None:
            if rows and "std_ms" not in rows[0]:
                raise SystemExit("--max-noise needs a csv with the collect "
                                 "noise columns (encoding,ms,std_ms,iters)")

            def _quiet(r):
                # rows without a std value cannot show they are below the gate
                try:
                    return float(r["std_ms"]) / float(r["ms"]) <= args.max_noise
                except (KeyError, TypeError, ValueError):
                    return False

            kept = [r for r in rows if _quiet(r)]
            if len(kept) != len(rows):
                print(f"dropping {len(rows) - len(kept)} rows with std/p50 > "
                      f"{args.max_noise:g} or missing std "
                      "(own-noise-floor gate)")
                rows = kept
        encs = [r["encoding"] for r in rows]
        ys = [float(r["ms"]) for r in rows]
        # a batch column with several batches turns on the batch feature
        batches = [int(r.get("batch") or 1) for r in rows]
        use_batch = len(set(batches)) > 1
        if use_batch and args.features != "physical":
            raise SystemExit("multi-batch data needs --features physical "
                             "(raw is the reference-parity b1 vector)")
        pred = LatencyPredictor(features=args.features, size=args.size,
                                batch_feature=use_batch)
        if args.features == "physical":
            # catch a forgotten --size: no config has more heads than its size
            from .utils.latency_model import parse_features as _pf

            native = {"tiny": 3, "small": 6, "base": 12}[args.size]
            seen = max(int(h) for e in encs for h in _pf(e)[0::2])
            if seen > native:
                raise SystemExit(
                    f"--features physical with --size {args.size} "
                    f"(max {native} heads) but the data has configs with "
                    f"{seen} heads — pass the right --size")
        metrics = pred.fit(encs, ys, batches=batches)
        out = args.output or "latency_model.pkl"
        pred.save(out)
        if metrics:
            rmse, rmspe, rel, a5, a10, a15 = metrics
            rec = {
                "features": args.features,
                "batch_feature": use_batch,
                "rmse": rmse, "rmspe_pct": rmspe, "rel_rmse": rel,
                "acc_5pct": a5, "acc_10pct": a10, "acc_15pct": a15,
            }
            if args.cv and len(rows) >= args.cv:
                c_rmse, c_rmspe, c_rel, c5, c10, c15 = pred.cv_metrics(
                    encs, ys, k=args.cv, batches=batches)
                rec.update({
                    "cv_folds": args.cv, "cv_rmse": c_rmse,
                    "cv_rmspe_pct": c_rmspe, "cv_rel_rmse": c_rel,
                    "cv_acc_5pct": c5, "cv_acc_10pct": c10,
                    "cv_acc_15pct": c15,
                })
            print(json.dumps(rec))
        print(f"saved predictor -> {out}")
    else:  # predict
        if not (args.predictor and args.encoding):
            raise SystemExit("predict needs --predictor and --encoding")
        pred = LatencyPredictor.load(args.predictor)
        if args.batch != 1 and not pred.batch_feature:
            raise SystemExit(
                f"--batch {args.batch}: {args.predictor} was fitted without the batch "
                "feature (single-batch data) and predicts one batch only; fit on a "
                "dataset with several batches to predict others")
        print(f"{pred.predict(args.encoding, batch=args.batch):.4f} ms")


def cmd_logscrape(argv):
    """Result-collection scrapers (reference fetch_latency_std tools.py
    subcommand, utils.py:409-461 + fetch_results.py:6-40): latency / std,
    memory and accuracy series from benchmark logs, or accuracy markers
    under a model dir tree (the "Avg latency X ms, Std Y ms" contract)."""
    p = argparse.ArgumentParser(prog="logscrape")
    p.add_argument("what", choices=["latency_std", "mem", "accuracy",
                                    "markers"])
    p.add_argument("--file", default=None, help="log file to scrape")
    p.add_argument("--dir", default=None,
                   help="markers: root dir to walk for accuracy*.txt")
    args = p.parse_args(argv)

    from .utils import logscrape as ls

    if args.what == "markers":
        if not args.dir:
            raise SystemExit("markers needs --dir")
        for name, acc in sorted(ls.fetch_results_from_markers(args.dir).items()):
            print(f"{name} {acc:.4f}")
        return
    if not args.file:
        raise SystemExit(f"{args.what} needs --file")
    if args.what == "latency_std":
        for avg, std in ls.fetch_latency_std(args.file):
            print(f"{avg:.4f} {std:.4f}")
    elif args.what == "mem":
        for v in ls.fetch_mem_footprints(args.file):
            print(f"{v:.2f}")
    else:
        for v in ls.fetch_accuracies_from_log(args.file):
            print(f"{v:.4f}")


def cmd_experiments(argv):
    """Fusion / quant / prune experiment generators (reference experiments.py)."""
    p = argparse.ArgumentParser(prog="experiments")
    p.add_argument("which",
                   choices=["fusion_ab", "quant_sweep", "prune_grid", "micro"])
    p.add_argument("--size", default="tiny")
    p.add_argument("--dim", type=int, default=192)
    p.add_argument("--heads", type=int, default=3)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--sizes", type=int, nargs="+", default=[256, 512, 1024, 2048])
    _device_arg(p)
    args = p.parse_args(argv)

    from .bench import experiments as ex

    if args.which == "prune_grid":
        print("\n".join(ex.prune_benchmark_grid(args.size)))
        return
    if args.which == "fusion_ab":
        out = ex.fusion_ab(dim=args.dim, mlp=args.dim * 4,
                           iters=args.iters, repeats=args.repeats, device=args.device)
    elif args.which == "quant_sweep":
        out = ex.quant_op_sweep(sizes=args.sizes, iters=args.iters,
                                repeats=args.repeats, device=args.device)
    else:  # micro
        out = ex.bench_micro_models(dim=args.dim, heads=args.heads,
                                    batch=args.batch, iters=args.iters,
                                    repeats=args.repeats, device=args.device)
    print(json.dumps(out))


def cmd_flops(argv):
    from .utils.flops import MODEL_FLOPS, pruned_deit_grids

    print(json.dumps({
        "model_flops": MODEL_FLOPS,
        "pruned_deit_grids_mmacs": pruned_deit_grids(),
    }, indent=2))


def cmd_plot(argv):
    """Figures (reference draw.py): accuracy-vs-MACs anchor curves and a
    measured latency-vs-MACs scatter from a sweep jsonl."""
    p = argparse.ArgumentParser(prog="plot")
    p.add_argument("which", choices=["macs_accuracy", "latency_macs"])
    p.add_argument("--sweep", default=None, nargs="+",
                   help="latency_macs: bench sweep jsonl(s) of measured "
                        "rows (several files merge; best ms per row wins)")
    p.add_argument("--batch", type=int, default=1,
                   help="latency_macs: which batch's rows to plot")
    p.add_argument("--output", default=None)
    args = p.parse_args(argv)

    from .utils.plots import draw_latency_vs_macs, draw_macs_accuracy_curve

    if args.which == "macs_accuracy":
        out = draw_macs_accuracy_curve(args.output or "macs_accuracy.png")
    else:
        if not args.sweep:
            raise SystemExit("latency_macs needs --sweep <jsonl>")
        from .utils.flops import bench_row_flops

        best = {}
        for path in args.sweep:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    d = json.loads(line)
                    if "ms" not in d or d.get("batch") != args.batch:
                        continue
                    fl = bench_row_flops(d["name"])
                    if not fl:
                        continue
                    if d["name"] not in best or d["ms"] < best[d["name"]][1]:
                        best[d["name"]] = (fl / 2e9, d["ms"])  # GMACs, ms
        if not best:
            raise SystemExit(f"no plottable b{args.batch} rows in "
                             f"{', '.join(args.sweep)}")
        out = draw_latency_vs_macs(
            best, args.output or "latency_macs.png",
            title=f"latency vs MACs (batch {args.batch})")
    print(f"wrote {out}")


COMMANDS = {
    "models": cmd_models,
    "benchmark": cmd_benchmark,
    "benchmark_train": cmd_benchmark_train,
    "profile": cmd_profile,
    "analyse_op": lambda a: _analyse("analyse_op", a),
    "analyse_attn_ffn": lambda a: _analyse("analyse_attn_ffn", a),
    "analyse_gelu_ln": lambda a: _analyse("analyse_gelu_ln", a),
    "fetch_all_op_latency": lambda a: _analyse("fetch_all_op_latency", a),
    "convert": cmd_convert,
    "quant_accuracy": cmd_quant_accuracy,
    "export": cmd_export,
    "eval": cmd_eval,
    "prune_heads": cmd_prune_heads,
    "prune": cmd_prune,
    "finetune": cmd_finetune,
    "sparse_train": cmd_sparse_train,
    "latency_model": cmd_latency_model,
    "logscrape": cmd_logscrape,
    "experiments": cmd_experiments,
    "flops": cmd_flops,
    "plot": cmd_plot,
}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        print("usage: python -m edgevisiontransformer_tpu_torch.cli <command> [...]")
        print("commands:", ", ".join(COMMANDS))
        return 1 if argv and argv[0] not in ("-h", "--help") else 0
    ret = COMMANDS[argv[0]](argv[1:])
    # commands may return their result dict for programmatic callers; only
    # ints are exit codes, and a bool (an int subclass) is not one
    return ret if isinstance(ret, int) and not isinstance(ret, bool) else 0


if __name__ == "__main__":
    sys.exit(main())
