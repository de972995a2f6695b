"""Train and eval steps (port of ``edgevisiontransformer_tpu/parallel/train.py``).

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

:func:`jit_sharded_train_step` runs a step over a ("dp", "tp") mesh of
ranks (``parallel/mesh.py``): the batch split over dp, the gradients
averaged over dp, and at tp > 1 the ViT forward written with Megatron's
column- and row-parallel products (:func:`vit_apply_tp`), one all-reduce
after ``out`` and one after ``fc2``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.activations import get_act, get_gelu
from ..ops.attention import merge_heads, qkv_split, sdpa
from ..ops.layers import layer_norm, patch_embed
from ..utils.jax_bridge import flatten_tree
from .mesh import Mesh, enter_tp, reduce_tp


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


def _loss_and_grads(apply_fn, loss_fn, grad_accum, params, images, labels):
    """The loss and the gradient of every leaf of ``params`` (dotted name
    -> tensor, zeros where unused), the batch split into ``grad_accum``
    contiguous micro-batches whose losses and gradients are averaged; the
    leaves to update come with them."""
    flat = flatten_tree(params)
    leaves = {k: v.detach().requires_grad_(v.is_floating_point()) for k, v in flat.items()}
    tree = _unflatten(leaves)

    def one(x, y):
        loss = loss_fn(apply_fn(tree, x), y)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves.values(), grads)]

    if grad_accum == 1:
        loss, grads = one(images, labels)
    else:
        mb_images = images.reshape((grad_accum, -1) + tuple(images.shape[1:]))
        mb_labels = labels.reshape(grad_accum, -1)
        loss, grads = one(mb_images[0], mb_labels[0])
        for i in range(1, grad_accum):
            l_i, g_i = one(mb_images[i], mb_labels[i])
            loss = loss + l_i
            grads = [a + b for a, b in zip(grads, g_i)]
        grads = [g / grad_accum for g in grads]
        loss = loss / grad_accum
    return loss, leaves, dict(zip(leaves, grads))


def make_train_step(apply_fn: Callable, optimizer: Optimizer,
                    loss_fn: Callable = cross_entropy, grad_accum: int = 1):
    """``train_step(params, opt_state, images, labels) -> (params, opt_state,
    {"loss": tensor})``.  With ``grad_accum > 1`` the batch is split into
    that many contiguous micro-batches, and their gradients and losses are
    averaged.  The loss stays on the device: reading it is the caller's
    choice, so a step does not wait for the device.  The step keeps its
    parts (``.parts``: apply_fn, optimizer, loss_fn, grad_accum) for
    :func:`jit_sharded_train_step`."""

    def train_step(params, opt_state, images, labels):
        loss, leaves, grads = _loss_and_grads(apply_fn, loss_fn, grad_accum, params, images,
                                              labels)
        with torch.no_grad():
            optimizer.apply(leaves, grads, opt_state)
        return params, opt_state, {"loss": loss}

    train_step.parts = (apply_fn, optimizer, loss_fn, grad_accum)
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


def _tp_layer_norm(cfg, ln: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_mode == "nonorm":
        return x * ln["scale"] + ln["bias"]
    return layer_norm(x, ln["scale"], ln["bias"], cfg.layernorm_eps)


def vit_apply_tp(cfg, params: dict, img: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``models/vit.ViT`` 's forward (``train=False``) on this rank's
    :func:`~.mesh.shard_params` tree, tensor-parallel over the mesh's tp
    group (Megatron): each rank runs its ``heads / tp`` whole heads (its
    ``[q_r | k_r | v_r]`` columns) and its ``mlp / tp`` hidden units; the
    out and fc2 products are summed over tp (one all-reduce each) before
    their bias; everything else is replicated.  The logits are every tp
    rank's, the same."""
    group = mesh.group("tp")
    tp = mesh.shape["tp"]
    p = params.get("params", params)
    dt = cfg.dtype
    act = get_act(cfg)
    hd = cfg.resolved_head_dim
    x = patch_embed(img.to(dt), p["patch_kernel"].to(dt), p["patch_bias"].to(dt),
                    cfg.patch_size)
    cls = p["cls_token"].to(dt).expand(x.shape[0], 1, cfg.dim)
    x = torch.cat([cls, x], dim=1) + p["pos_embedding"].to(dt)
    for i in range(cfg.depth):
        blk = p[f"block_{i}"]
        heads = cfg.layer_heads(i)
        if heads % tp:
            raise ValueError(f"layer {i}: {heads} heads do not split over tp={tp}")
        attn, ffn = blk["attn"], blk["ffn"]

        def attention(h):
            qkv = enter_tp(h, group) @ attn["qkv_kernel"].to(dt)
            if cfg.qkv_bias:
                qkv = qkv + attn["qkv_bias"].to(dt)
            q, k, v = qkv_split(qkv, heads // tp, hd)
            o = merge_heads(sdpa(q, k, v, scale=hd ** -0.5)) @ attn["out_kernel"].to(dt)
            return reduce_tp(o, group) + attn["out_bias"].to(dt)

        def mlp(h):
            u = act(enter_tp(h, group) @ ffn["fc1_kernel"].to(dt) + ffn["fc1_bias"].to(dt))
            return reduce_tp(u @ ffn["fc2_kernel"].to(dt), group) + ffn["fc2_bias"].to(dt)

        if cfg.reference_residual:
            h = _tp_layer_norm(cfg, blk["ln1"], x)
            x = attention(h) + h
            h = _tp_layer_norm(cfg, blk["ln2"], x)
            x = mlp(h) + h
        else:
            x = x + attention(_tp_layer_norm(cfg, blk["ln1"], x))
            x = x + mlp(_tp_layer_norm(cfg, blk["ln2"], x))
    if cfg.final_norm:
        x = _tp_layer_norm(cfg, p["final_norm"], x)
    x = x[:, 0]
    if cfg.mlp_head:
        h = get_gelu(cfg.gelu_approx)(x @ p["head_fc1"]["kernel"].to(dt)
                                      + p["head_fc1"]["bias"].to(dt))
        return h @ p["head_fc2"]["kernel"].to(dt) + p["head_fc2"]["bias"].to(dt)
    return x @ p["head"]["kernel"].to(dt) + p["head"]["bias"].to(dt)


def _all_reduce_mean(tensors: list, group, n: int) -> list:
    """Every tensor summed over ``group`` and divided by ``n``, as one
    flat buffer (one all-reduce)."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= n
    return [c.view_as(t).to(t.dtype)
            for c, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def jit_sharded_train_step(train_step: Callable, mesh: Mesh, params_example=None, *,
                           config=None):
    """``train_step`` (:func:`make_train_step`'s) over ``mesh``:
    ``step(params, opt_state, images, labels) -> (params, opt_state,
    {"loss"})``, run by every rank of the mesh on the same global batch,
    with ``params`` this rank's :func:`~.mesh.shard_params` tree and
    ``opt_state`` its optimizer's ``init`` of that tree (so the tp-sharded
    leaves stay sharded in both).  Each dp rank takes its rows of every
    micro-batch (the batch is split into ``grad_accum`` micro-batches
    first, as the single-process step splits it); the loss and gradients
    are averaged over dp (one all-reduce); the update is the optimizer's,
    on the local leaves.  The result equals the single-process step on the
    whole batch.

    At tp = 1 the forward is the step's own ``apply_fn``.  At tp > 1 it is
    :func:`vit_apply_tp` of ``config`` (the ``ViTConfig`` of the ViT the
    step trains; required): the plain ViT forward, which stands in for
    ``apply_fn``.  ``params_example`` is accepted for the JAX signature; the
    shardings are the trees' own."""
    apply_fn, optimizer, loss_fn, grad_accum = train_step.parts
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    r = mesh.index("dp")
    if tp > 1:
        if config is None:
            raise ValueError("jit_sharded_train_step at tp > 1 needs config= (the ViTConfig): "
                             "the tensor-parallel forward is vit_apply_tp")
        apply_fn = lambda p, x: vit_apply_tp(config, p, x, mesh)  # noqa: E731

    def step(params, opt_state, images, labels):
        b = images.shape[0]
        if b % (grad_accum * dp):
            raise ValueError(f"batch {b} does not split into {grad_accum} micro-batches "
                             f"over dp={dp}")
        m = b // (grad_accum * dp)
        mine = lambda t: t.reshape((grad_accum, dp, m) + tuple(t.shape[1:]))[:, r].reshape(
            (grad_accum * m,) + tuple(t.shape[1:]))  # noqa: E731
        loss, leaves, grads = _loss_and_grads(apply_fn, loss_fn, grad_accum, params,
                                              mine(images), mine(labels))
        if dp > 1:
            names = list(grads)
            *avg, loss = _all_reduce_mean([grads[k] for k in names] + [loss.reshape(1)],
                                          mesh.group("dp"), dp)
            grads, loss = dict(zip(names, avg)), loss[0]
        with torch.no_grad():
            optimizer.apply(leaves, grads, opt_state)
        return params, opt_state, {"loss": loss}

    return step
