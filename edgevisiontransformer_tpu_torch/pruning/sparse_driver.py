"""Sparse finetuning end to end, the deit_pruning/train_main.py analogue (port of
``edgevisiontransformer_tpu/pruning/sparse_driver.py``).

Wires presets -> SparseConfig -> the sparse train step -> compile -> final
finetune, following deit_pruning/src/train_main.py:104-437: JSON preset
resolution (:209-215), sparse training with scheduled thresholds,
``compile_model`` at the end (:388-389), ``unzero_parameters`` + final
finetune (:375-377), and the sparsity report (:392-421).

Preset JSONs use the reference's key names (config/*.json); the port keeps
its own copies in ``edgevisiontransformer_tpu_torch/configs/``, the same
bytes as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Iterable, Optional

import torch

from ..config import ViTConfig
from ..parallel.train import Optimizer
from ..utils.jax_bridge import flatten_tree
from .movement import (
    SparseConfig,
    compile_sparse_model,
    init_mask_scores,
    schedule_thresholds,
    sparsity_report,
    unzero_params,
)
from .sparse_train import make_sparse_train_step, make_sparse_train_step_transitions
from .transitions import (
    compile_transitions,
    init_ln_accumulators,
    transition_delta,
    transition_mix,
)

PRESET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")

# optax.adamw's default weight decay, which the JAX run_sparse_finetune's optimizer takes
# (torch.optim.AdamW's default is 1e-2)
ADAMW_WEIGHT_DECAY = 1e-4


def sparse_config_from_preset(
    name_or_path: str,
    warmup_steps: int = 120,
    layerwise_thresholds: Optional[str] = None,
    **overrides,
) -> SparseConfig:
    """Load a reference-format preset JSON into a SparseConfig.

    Accepts a preset name (resolved in ``PRESET_DIR``, as train_main.py:52-57
    resolves ./config/<name>.json) or a path."""
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(PRESET_DIR, name_or_path)
        if not path.endswith(".json"):
            path += ".json"
    with open(path) as f:
        d = json.load(f)

    method = d.get("attention_pruning_method", "topK").lower()
    dense_method = d.get("dense_pruning_method", "topK:1d_alt")
    dense_pruning = dense_method.split(":")[1] if ":" in dense_method else "blocks"

    kw = dict(
        method=method,
        attn_block_rows=d.get("attention_block_rows", -1),
        attn_block_cols=d.get("attention_block_cols", -1),
        dense_pruning=dense_pruning,
        initial_threshold=d.get("initial_threshold", 1.0),
        final_threshold=d.get("final_threshold", 0.5),
        initial_warmup=d.get("initial_warmup", 1),
        final_warmup=d.get("final_warmup", 2),
        warmup_steps=warmup_steps,
        regularization=d.get("regularization"),
        regu_lambda_attention=d.get("regularization_final_lambda", 0.0),
        regu_lambda_dense=d.get("regularization_final_lambda", 0.0)
        * d.get("dense_lambda", 1.0),
        dense_block_rows=d.get("dense_block_rows", 1),
        dense_block_cols=d.get("dense_block_cols", 1),
        layerwise_thresholds=layerwise_thresholds,
        # transition + QAT knobs (SparseTrainingArguments names preserved)
        layer_norm_patch=bool(d.get("layer_norm_patch", False)),
        layer_norm_patch_steps=d.get("layer_norm_patch_steps", 50000),
        layer_norm_patch_start_delta=d.get("layer_norm_patch_start_delta", 0.99),
        gelu_patch=bool(d.get("gelu_patch", False)),
        gelu_patch_steps=d.get("gelu_patch_steps", 50000),
        qat=bool(d.get("qat", False)),
    )
    kw.update(overrides)
    return SparseConfig(**kw)


@dataclasses.dataclass
class SparseRunResult:
    params: dict
    mask_scores: dict
    compiled_cfg: Optional[ViTConfig] = None
    compiled_params: Optional[dict] = None
    report: Optional[dict] = None
    sparsity: Optional[dict] = None
    ln_acc: Optional[dict] = None  # Layer2NoNorm accumulators (if patched)


def sparse_optimizers(lr: float = 5e-5, mask_lr: float = 1e-2) -> tuple:
    """``run_sparse_finetune``'s two optimizers: AdamW on the params (optax.adamw(lr)'s
    weight decay) and Adam on the mask scores (the mask-lr group,
    patch_coordinator.py:669-704)."""
    return (Optimizer(torch.optim.AdamW, {"lr": lr, "weight_decay": ADAMW_WEIGHT_DECAY}),
            Optimizer(torch.optim.Adam, {"lr": mask_lr}))


def run_sparse_finetune(
    model_apply: Callable,
    cfg: ViTConfig,
    params: dict,
    sparse: SparseConfig,
    batches: Callable[[], Iterable],
    total_steps: int,
    lr: float = 5e-5,
    mask_lr: float = 1e-2,
    teacher_apply: Optional[Callable] = None,
    teacher_params=None,
    do_compile: bool = True,
    final_finetune_steps: int = 0,
    seed: int = 0,
    log: Callable[[str], None] = print,
) -> SparseRunResult:
    """Full sparse run: train masks + weights, then compile to static shapes.

    ``model_apply(params, images) -> logits``; ``batches()`` yields (images,
    labels) as numpy arrays or tensors, moved to the params' device, which
    every tensor of the run shares; the scores start from
    ``init_mask_scores`` drawn from ``seed``.  With ``teacher_params``,
    teacher_apply is (teacher_params, images) -> logits.  The params tree is updated in place, as ``parallel/train`` steps do."""
    dev = next(iter(flatten_tree(params).values())).device
    scores = init_mask_scores(cfg, sparse, torch.Generator().manual_seed(seed), device=dev)
    opt_p, opt_s = sparse_optimizers(lr, mask_lr)

    transitions = sparse.layer_norm_patch or sparse.gelu_patch
    ln_acc = None
    with_tp = teacher_params is not None
    if transitions:
        ln_acc = init_ln_accumulators(cfg, device=dev)
        step_fn = make_sparse_train_step_transitions(cfg, sparse, opt_p, opt_s, teacher_apply,
                                                     with_teacher_params=with_tp)
    else:
        step_fn = make_sparse_train_step(model_apply, cfg, sparse, opt_p, opt_s, teacher_apply,
                                         with_teacher_params=with_tp)

    st_p = opt_p.init(params)
    st_s = opt_s.init(scores)
    step = 0
    while step < total_steps:
        for images, labels in batches():
            thr, regu_mul = schedule_thresholds(step, total_steps, cfg, sparse)
            x = torch.as_tensor(images, device=dev)
            y = torch.as_tensor(labels, device=dev)
            thr_t = torch.as_tensor(thr, dtype=torch.float32, device=dev)
            mul = torch.as_tensor(regu_mul, dtype=torch.float32, device=dev)
            if transitions:
                tmix = [transition_mix(step, sparse.layer_norm_patch_steps),
                        transition_delta(step, sparse.layer_norm_patch_steps,
                                         sparse.layer_norm_patch_start_delta),
                        transition_mix(step, sparse.gelu_patch_steps)]
                params, scores, ln_acc, st_p, st_s, metrics = step_fn(
                    params, scores, ln_acc, st_p, st_s, x, y, thr_t, mul, tmix, teacher_params)
            else:
                params, scores, st_p, st_s, metrics = step_fn(
                    params, scores, st_p, st_s, x, y, thr_t, mul, teacher_params)
            step += 1
            if step % 10 == 0:
                log(f"step {step}/{total_steps} loss {float(metrics['loss']):.4f} "
                    f"thr_a {thr[0][0]:.3f} thr_d {thr[0][1]:.3f}")
            if step >= total_steps:
                break

    result = SparseRunResult(params=params, mask_scores=scores, ln_acc=ln_acc)
    compile_cfg, compile_params = cfg, params
    if transitions and do_compile:
        # Bake transitions to their endpoints BEFORE the structural shrink:
        # LN params absorb the running stats (NoNorm), act becomes ReLU.
        compile_cfg, compile_params = compile_transitions(
            cfg, params, ln_acc, ln_patch=sparse.layer_norm_patch, gelu_patch=sparse.gelu_patch)
    if do_compile:
        new_cfg, new_params, report = compile_sparse_model(compile_cfg, compile_params, scores,
                                                           sparse)
        result.compiled_cfg = new_cfg
        result.compiled_params = new_params
        result.report = report
        result.sparsity = sparsity_report(new_params)
        log(f"compiled: heads_per_layer={new_cfg.heads_per_layer} "
            f"mlp_dim_per_layer={new_cfg.mlp_dim_per_layer}")

        if final_finetune_steps > 0:
            # reference final_finetune: re-seed zeros then a short finetune
            from ..models.vit import ViT, apply_params
            from ..utils.finetune import FinetuneConfig, finetune

            new_params = unzero_params(new_params, torch.Generator().manual_seed(seed + 1))
            model = ViT(new_cfg, device=dev)
            new_params = finetune(
                lambda p, x: apply_params(model, p, x), new_params, batches,
                FinetuneConfig(lr=lr, optimizer="adamw", max_steps=final_finetune_steps,
                               epochs=10**6),
                log=log,
            )
            result.compiled_params = new_params
    return result
