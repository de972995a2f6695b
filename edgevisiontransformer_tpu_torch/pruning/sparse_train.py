"""Sparse (movement-pruning) training steps (port of
``edgevisiontransformer_tpu/pruning/sparse_train.py``).

Replaces the reference's SparseTrainer/HF-Trainer stack
(deit_pruning/vendor/.../sparse_trainer.py:85-128,
deit_pruning/src/trainer.py:48-121) with one step:

  loss = task_ce (+ distillation) + regu_mul * regularization
  gradients flow to weights AND mask scores (STE through the binarizers);
  mask scores get their own optimizer / lr (the reference's mask-lr param
  group, patch_coordinator.py:669-704).

Per-step thresholds come from ``schedule_thresholds()`` on the host and are
fed as a [depth, 2] fp32 tensor.  The forward and backward are plain
autograd (no kernel: a kernel wrapper has no backward), as the JAX package
trains through XLA.  The optimizers are ``parallel/train.Optimizer``s
(AdamW on the params and Adam on the scores in ``run_sparse_finetune``);
as in ``parallel/train.make_train_step`` the update is in place: a step
returns the trees it was given, their tensors updated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..config import ViTConfig
from ..ops.quant import fake_quant_vit_encoder
from ..parallel.train import Optimizer, _unflatten, cross_entropy
from ..utils.jax_bridge import flatten_tree, tree_map
from .movement import SparseConfig, apply_masks, distillation_loss, regularization_loss


@dataclasses.dataclass
class SparseTrainState:
    params: Any
    mask_scores: Any
    opt_state_p: Any
    opt_state_s: Any
    step: int = 0


def init_sparse_state(params, mask_scores, opt_params: Optimizer,
                      opt_scores: Optimizer) -> SparseTrainState:
    return SparseTrainState(
        params=params,
        mask_scores=mask_scores,
        opt_state_p=opt_params.init(params),
        opt_state_s=opt_scores.init(mask_scores),
        step=0,
    )


def _live(tree) -> tuple:
    """(leaves by dotted name, detached and requiring grad where floating;
    the same leaves as a tree)."""
    leaves = {k: v.detach().requires_grad_(v.is_floating_point())
              for k, v in flatten_tree(tree).items()}
    return leaves, _unflatten(leaves)


def _masked(cfg, sparse, params, scores, thresholds):
    masked = apply_masks(cfg, params, scores, thresholds, sparse)
    return fake_quant_vit_encoder(masked) if sparse.qat else masked


def _objective(sparse, logits, labels, images, teacher_apply, with_teacher_params,
               tparams, scores, regu_mul):
    ce = cross_entropy(logits, labels)
    loss = ce
    if teacher_apply is not None:
        with torch.no_grad():
            t_logits = teacher_apply(tparams, images) if with_teacher_params \
                else teacher_apply(images)
        loss = distillation_loss(logits, t_logits, ce, sparse.distil_alpha,
                                 sparse.distil_temperature)
    regu = regularization_loss(scores, sparse, regu_mul)
    return loss + regu, {"ce": ce, "loss": loss, "regu": regu}


def _update(total, leaves_p, leaves_s, opt_params, opt_scores, state_p, state_s, metrics):
    names = list(leaves_p) + list(leaves_s)
    tensors = list(leaves_p.values()) + list(leaves_s.values())
    grads = torch.autograd.grad(total, tensors, allow_unused=True)
    grads = {n: torch.zeros_like(t) if g is None else g
             for n, t, g in zip(names, tensors, grads)}
    with torch.no_grad():
        opt_params.apply(leaves_p, {k: grads[k] for k in leaves_p}, state_p)
        opt_scores.apply(leaves_s, {k: grads[k] for k in leaves_s}, state_s)
    return {k: torch.as_tensor(v).detach() for k, v in metrics.items()}


def _thresholds(thresholds, device) -> torch.Tensor:
    return torch.as_tensor(thresholds, dtype=torch.float32, device=device)


def make_sparse_train_step(
    apply_fn: Callable,
    cfg: ViTConfig,
    sparse: SparseConfig,
    opt_params: Optimizer,
    opt_scores: Optimizer,
    teacher_apply: Optional[Callable] = None,
    with_teacher_params: bool = False,
):
    """Returns step(params, scores, opt_p, opt_s, images, labels,
    thresholds[depth,2], regu_mul[, teacher_params]) ->
    (params, scores, opt_p, opt_s, metrics).

    ``apply_fn(params, images) -> logits`` on a params tree (e.g.
    ``lambda p, x: models.vit.apply_params(model, p, x)``).
    ``with_teacher_params``: teacher_apply takes (teacher_params, images)
    and the step a trailing teacher_params argument; otherwise
    teacher_apply(images).  The teacher runs under ``no_grad``."""

    def step(params, scores, opt_p, opt_s, images, labels, thresholds, regu_mul,
             teacher_params=None):
        leaves_p, tree_p = _live(params)
        leaves_s, tree_s = _live(scores)
        thr = _thresholds(thresholds, images.device)
        logits = apply_fn(_masked(cfg, sparse, tree_p, tree_s, thr), images)
        total, metrics = _objective(sparse, logits, labels, images, teacher_apply,
                                    with_teacher_params, teacher_params, tree_s, regu_mul)
        metrics = _update(total, leaves_p, leaves_s, opt_params, opt_scores, opt_p, opt_s,
                          metrics)
        return params, scores, opt_p, opt_s, metrics

    return step


def make_sparse_train_step_transitions(
    cfg: ViTConfig,
    sparse: SparseConfig,
    opt_params: Optimizer,
    opt_scores: Optimizer,
    teacher_apply: Optional[Callable] = None,
    with_teacher_params: bool = False,
):
    """Sparse step with LayerNorm->NoNorm / GeLU->ReLU transitions active
    (preset layer_norm_patch / gelu_patch; pruning/transitions.py).

    step(params, scores, ln_acc, opt_p, opt_s, images, labels,
         thresholds[depth,2], regu_mul, tmix[3]=(mix_ln, delta, mix_gelu))
    -> (params, scores, ln_acc, opt_p, opt_s, metrics).

    The forward is the transition-aware functional ViT (not apply_fn), and
    the accumulators it returns are detached (JAX's stop_gradient): a new
    tree each step, not updated in place."""
    from .transitions import vit_forward_transitions

    def step(params, scores, ln_acc, opt_p, opt_s, images, labels, thresholds, regu_mul,
             tmix, teacher_params=None):
        leaves_p, tree_p = _live(params)
        leaves_s, tree_s = _live(scores)
        thr = _thresholds(thresholds, images.device)
        tmix = torch.as_tensor(tmix, dtype=torch.float32, device=images.device)
        logits, new_acc = vit_forward_transitions(
            cfg, _masked(cfg, sparse, tree_p, tree_s, thr), images, ln_acc,
            tmix[0], tmix[1], tmix[2], ln_patch=sparse.layer_norm_patch,
            gelu_patch=sparse.gelu_patch, train=True)
        total, metrics = _objective(sparse, logits, labels, images, teacher_apply,
                                    with_teacher_params, teacher_params, tree_s, regu_mul)
        metrics = _update(total, leaves_p, leaves_s, opt_params, opt_scores, opt_p, opt_s,
                          metrics)
        new_acc = tree_map(torch.Tensor.detach, new_acc)
        return params, scores, new_acc, opt_p, opt_s, metrics

    return step
