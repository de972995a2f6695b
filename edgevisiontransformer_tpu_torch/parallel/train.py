"""Train and eval steps (port of ``edgevisiontransformer_tpu/parallel/train.py``,
without the mesh sharding of ``jit_sharded_train_step``).

A step takes a parameter tree (nested dicts of tensors keyed as
``ViT.params()``, bare or under ``"params"``) and ``apply_fn(params,
images) -> logits``, which keeps its JAX meaning: ``models/vit.apply_params``
for the plain model, or a QAT forward such as
``ops/quant.fake_quant_vit_apply_static``.  Gradients come from autograd on
the tree's leaves.  The optimizer is a ``torch.optim`` class with its
hyper-parameters (:class:`Optimizer`), and its state a tree keyed by the
parameters' dotted names, so a checkpoint holds it as it holds the
parameters.  The update is in place: a step returns the tree it was given,
its tensors updated, and with them any module parameters they alias (the
tensors of ``ViT.params()`` share the model's storage).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from ..utils.jax_bridge import flatten_tree


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under ``logits``, in fp32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def scaled_lr(base_lr: float, n_devices: int, micro_batch: int, denom: int = 512) -> float:
    """Linear LR scaling rule (lr * gpus * mbs / 512)."""
    return base_lr * n_devices * micro_batch / denom


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


# The per-parameter state each optimizer class starts from: zeros, so the
# state tree has its final structure from the first step on (optax's init).
_STATE = {
    torch.optim.SGD: lambda p: {"momentum_buffer": torch.zeros_like(p)},
    torch.optim.AdamW: lambda p: {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                                  "exp_avg_sq": torch.zeros_like(p)},
    torch.optim.Adam: lambda p: {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                                 "exp_avg_sq": torch.zeros_like(p)},
}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A ``torch.optim`` class and its hyper-parameters, in optax's two
    parts: :meth:`init` builds the state tree, :meth:`apply` updates the
    parameters from their gradients.  SGD with momentum, Adam (the mask
    scores' optimizer of ``pruning/sparse_train``) and AdamW, in their
    default (for-each) form: the state table is theirs (``_STATE``), and a
    fused or capturable AdamW keeps its ``step`` on the device instead.

    Each step binds a new ``torch.optim`` object (:meth:`bind`) to the
    leaves it is given, which are new tensors every step, and to the state
    tree, whose tensors it updates in place."""

    cls: type
    hyper: dict

    def __post_init__(self):
        if self.cls not in _STATE:
            raise ValueError(f"no optimizer state for {self.cls.__name__}; one of "
                             f"{[c.__name__ for c in _STATE]}")
        if self.hyper.get("fused") or self.hyper.get("capturable"):
            raise ValueError("fused and capturable optimizers keep another state layout")

    def init(self, params: dict) -> dict:
        """``{dotted name: {state: tensor}}``, zeros, beside each leaf."""
        return {k: _STATE[self.cls](v) for k, v in flatten_tree(params).items()}

    def bind(self, leaves: dict, state: dict) -> torch.optim.Optimizer:
        """A ``torch.optim`` object over ``leaves`` (dotted name -> leaf
        tensor) whose per-parameter state is ``state``'s tensors, keyed
        alike (not copies)."""
        opt = self.cls(list(leaves.values()), **self.hyper)
        for name, p in leaves.items():
            opt.state[p] = state[name]
        return opt

    def apply(self, leaves: dict, grads: dict, state: dict) -> None:
        """One ``torch.optim`` step over ``leaves``, ``grads`` and ``state``
        keyed alike; ``leaves`` and ``state`` are updated in place."""
        opt = self.bind(leaves, state)
        for name, p in leaves.items():
            p.grad = grads[name]
        opt.step()
        for p in leaves.values():
            p.grad = None


def make_train_step(apply_fn: Callable, optimizer: Optimizer,
                    loss_fn: Callable = cross_entropy, grad_accum: int = 1):
    """``train_step(params, opt_state, images, labels) -> (params, opt_state,
    {"loss": tensor})``.  With ``grad_accum > 1`` the batch is split into
    that many contiguous micro-batches, and their gradients and losses are
    averaged.  The loss stays on the device: reading it is the caller's
    choice, so a step does not wait for the device."""

    def loss_and_grads(tree, leaves, images, labels):
        loss = loss_fn(apply_fn(tree, images), labels)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves.values(), grads)]

    def train_step(params, opt_state, images, labels):
        flat = flatten_tree(params)
        leaves = {k: v.detach().requires_grad_(v.is_floating_point())
                  for k, v in flat.items()}
        tree = _unflatten(leaves)
        if grad_accum == 1:
            loss, grads = loss_and_grads(tree, leaves, images, labels)
        else:
            mb_images = images.reshape((grad_accum, -1) + tuple(images.shape[1:]))
            mb_labels = labels.reshape(grad_accum, -1)
            loss, grads = loss_and_grads(tree, leaves, mb_images[0], mb_labels[0])
            for i in range(1, grad_accum):
                l_i, g_i = loss_and_grads(tree, leaves, mb_images[i], mb_labels[i])
                loss = loss + l_i
                grads = [a + b for a, b in zip(grads, g_i)]
            grads = [g / grad_accum for g in grads]
            loss = loss / grad_accum
        with torch.no_grad():
            optimizer.apply(leaves, dict(zip(leaves, grads)), opt_state)
        return params, opt_state, {"loss": loss}

    return train_step


def make_eval_step(apply_fn: Callable):
    """``eval_step(params, images, labels) -> (n_correct, n_total)``: the
    argmax of the logits against the labels, under ``inference_mode``;
    ``n_correct`` is a tensor on the logits' device."""

    def eval_step(params, images, labels):
        with torch.inference_mode():
            pred = apply_fn(params, images).argmax(dim=-1)
            return (pred == labels.to(pred.device)).sum(), int(labels.shape[0])

    return eval_step
