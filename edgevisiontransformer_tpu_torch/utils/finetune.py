"""Finetune / retrain loop (port of ``edgevisiontransformer_tpu/utils/finetune.py``).

Epoch- or step-bounded training (the ``max_steps`` islice), gradient
accumulation, periodic logging and eval, the linear LR scaling rule, and
resume from a mid-training checkpoint with the optimizer state, on
``parallel/train.make_train_step``.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Callable, Iterable, Optional

import torch

from ..parallel.train import Optimizer, cross_entropy, make_train_step, scaled_lr
from ..utils.jax_bridge import flatten_tree
from .checkpoint import load_checkpoint, load_meta, save_checkpoint


@dataclasses.dataclass
class FinetuneConfig:
    lr: float = 5e-5
    optimizer: str = "sgd"  # sgd | adamw (the reference uses SGD for retrain)
    momentum: float = 0.9
    weight_decay: float = 0.0
    epochs: int = 1
    max_steps: Optional[int] = None      # islice bound
    grad_accum: int = 1
    lr_scale_batch: Optional[int] = None  # if set: lr *= n_dev * mbs / 512
    n_devices: int = 1
    log_every: int = 10
    checkpoint_dir: Optional[str] = None  # mid-training resume
    checkpoint_every: int = 100
    # Kept for the JAX config's shape and has no effect here: a step updates
    # the parameters and the optimizer state in place (torch.optim's way),
    # which is what buffer donation buys the jitted JAX step.
    donate: bool = False


def build_optimizer(cfg: FinetuneConfig) -> Optimizer:
    """``sgd``: ``torch.optim.SGD`` with momentum (optax's ``sgd`` trace);
    ``adamw``: ``torch.optim.AdamW`` with ``cfg.weight_decay`` passed
    explicitly (torch's default is 0.01, optax's 1e-4)."""
    lr = cfg.lr
    if cfg.lr_scale_batch:
        lr = scaled_lr(cfg.lr, cfg.n_devices, cfg.lr_scale_batch)
    if cfg.optimizer == "sgd":
        return Optimizer(torch.optim.SGD, {"lr": lr, "momentum": cfg.momentum})
    if cfg.optimizer == "adamw":
        return Optimizer(torch.optim.AdamW, {"lr": lr, "weight_decay": cfg.weight_decay})
    raise ValueError(cfg.optimizer)


def finetune(
    apply_fn: Callable,
    params,
    batches: Callable[[], Iterable],  # () -> iterable of (images, labels)
    cfg: FinetuneConfig,
    eval_fn: Optional[Callable] = None,
    log: Callable[[str], None] = print,
):
    """Train and return the params.

    ``batches()`` is called once per epoch and may yield numpy arrays or
    tensors; they go to the device of ``params``' first leaf.  The update is
    in place (``parallel/train.py``); after a resume the returned tree holds
    the checkpoint's tensors."""
    optimizer = build_optimizer(cfg)
    step_fn = make_train_step(apply_fn, optimizer, cross_entropy, cfg.grad_accum)
    opt_state = optimizer.init(params)
    device = next(iter(flatten_tree(params).values())).device

    step = 0
    if cfg.checkpoint_dir:
        latest = os.path.join(cfg.checkpoint_dir, "latest")
        meta = load_meta(latest)
        if meta is not None:
            state = load_checkpoint(latest, {"params": params, "opt_state": opt_state})
            params, opt_state = state["params"], state["opt_state"]
            step = int(meta.get("step", 0))
            log(f"resumed from {latest} at step {step}")
    t0 = time.time()
    for epoch in range(cfg.epochs):
        it = batches()
        if cfg.max_steps is not None:
            it = itertools.islice(it, cfg.max_steps - step)
        for images, labels in it:
            params, opt_state, metrics = step_fn(
                params, opt_state, torch.as_tensor(images, device=device),
                torch.as_tensor(labels, device=device))
            step += 1
            if step % cfg.log_every == 0:
                log(f"epoch {epoch} step {step} loss {float(metrics['loss']):.4f} "
                    f"({step / (time.time() - t0):.2f} it/s)")
            if cfg.checkpoint_dir and step % cfg.checkpoint_every == 0:
                save_checkpoint(os.path.join(cfg.checkpoint_dir, "latest"),
                                {"params": params, "opt_state": opt_state},
                                meta={"step": step})
            if cfg.max_steps is not None and step >= cfg.max_steps:
                break
        if eval_fn is not None:
            log(f"epoch {epoch} eval: {eval_fn(params):.4f}")
        if cfg.max_steps is not None and step >= cfg.max_steps:
            break
    return params
