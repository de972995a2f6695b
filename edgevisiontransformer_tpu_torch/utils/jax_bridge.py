"""Move Flax parameter trees into the port, as numpy arrays.

The JAX package's ``variables["params"]`` tree, converted leaf by leaf to
numpy (``jax.tree.map(np.asarray, params)``), maps one to one onto the
port's ``named_parameters()``.  Every copy is exact; the JAX layout
(``x @ W`` with ``W [in, out]``) is kept, so tests compare like with like.
This module needs numpy and torch only.
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch(arr) -> torch.Tensor:
    """Exact numpy -> torch copy, bfloat16 (ml_dtypes) included."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """``{"a": {"b": x}}`` -> ``{"a.b": x}``."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, name + "."))
        else:
            out[name] = v
    return out


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a nested dict, the same nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_to_torch(tree_np: dict) -> dict:
    """A nested dict of numpy leaves (a JAX params tree, a movement-pruning
    mask-score tree, LayerNorm transition accumulators) as the same tree of
    exact torch copies on the CPU."""
    return tree_map(to_torch, tree_np)


def _matched(tree_np: dict, named: dict, what: str) -> list:
    """``[(port tensor, exact torch copy of the flax leaf)]`` for a numpy
    tree against ``{dotted name: tensor}``; raise ``KeyError`` on a missing
    or extra leaf and ``ValueError`` on a shape or dtype mismatch."""
    flat = {k: np.asarray(v) for k, v in flatten_tree(tree_np).items()}
    missing = sorted(set(named) - set(flat))
    extra = sorted(set(flat) - set(named))
    if missing or extra:
        raise KeyError(f"{what} trees differ: missing {missing}, unexpected {extra}")
    pairs = []
    for name, dst in named.items():
        src = to_torch(flat[name])
        if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
            raise ValueError(f"{name}: flax {tuple(src.shape)} {src.dtype} vs port "
                             f"{tuple(dst.shape)} {dst.dtype}")
        pairs.append((dst, src))
    return pairs


def _copy(pairs: list) -> None:
    with torch.no_grad():
        for dst, src in pairs:
            dst.copy_(src)


def load_jax_params(model: torch.nn.Module, params_np: dict) -> torch.nn.Module:
    """Copy a Flax params tree (numpy leaves) into ``model`` in place.

    Raises ``KeyError`` when either side has a leaf the other lacks and
    ``ValueError`` on a shape or dtype mismatch: nothing is cast or left at
    its initial value."""
    _copy(_matched(params_np, dict(model.named_parameters()), "param"))
    return model


def load_jax_variables(model: torch.nn.Module, variables_np: dict) -> torch.nn.Module:
    """Copy Flax variables (numpy leaves) into ``model`` in place: the
    ``params`` collection onto its parameters and the ``constants``
    collection (for T2T-ViT the performers' ``w`` and ``pos_embedding``)
    onto its buffers, under :func:`load_jax_params`'s rule; both are checked
    before either is copied.  A model without buffers takes variables
    without constants."""
    extra = sorted(set(variables_np) - {"params", "constants"})
    if extra:
        raise KeyError(f"unexpected variable collections {extra}")
    pairs = _matched(variables_np["params"], dict(model.named_parameters()), "param")
    pairs += _matched(variables_np.get("constants", {}), dict(model.named_buffers()),
                      "constant")
    _copy(pairs)
    return model


def load_flax_cnn(model: torch.nn.Module, variables_np: dict) -> torch.nn.Module:
    """Copy a Flax CNN zoo model's variables (numpy leaves: ``params`` and
    ``batch_stats``) into the port's module of the same name
    (``models/cnn/zoo.get_cnn``) in place: a conv kernel ``[kh, kw, in /
    groups, out]`` becomes ``[out, in / groups, kh, kw]`` and a Dense kernel
    ``[in, out]`` is transposed; the statistics go to the BatchNorms'
    ``mean`` / ``var`` buffers.  Raises as :func:`load_jax_params` on a
    missing or extra leaf; both collections are checked before either is
    copied."""
    extra = sorted(set(variables_np) - {"params", "batch_stats"})
    if extra:
        raise KeyError(f"unexpected variable collections {extra}")

    def torch_layout(name, leaf):
        a = np.asarray(leaf)
        if name.endswith("kernel") and a.ndim == 4:
            return a.transpose(3, 2, 0, 1)
        if name.endswith("kernel") and a.ndim == 2:
            return a.T
        return a

    params = {k: torch_layout(k, v) for k, v in flatten_tree(variables_np["params"]).items()}
    pairs = _matched(params, dict(model.named_parameters()), "param")
    pairs += _matched(variables_np.get("batch_stats", {}), dict(model.named_buffers()),
                      "batch_stats")
    _copy(pairs)
    return model


def stacked_from_params(params_np: dict, depth: int, qkv_bias: bool,
                        start: int = 0) -> dict:
    """The ``[L, ...]`` stack of JAX ``stack_vit_layer_params``, as torch
    tensors, from a numpy params tree."""
    from ..ops.cuda.fused_encoder import stack_vit_layer_params

    def convert(tree):
        return {k: convert(v) if isinstance(v, dict) else to_torch(v)
                for k, v in tree.items()}

    return stack_vit_layer_params(convert(params_np), depth, qkv_bias, start=start)


def quantized_stack_from_jax(stacked_q_np: dict) -> dict:
    """The port's int8 stack from a JAX one (``quantize_stacked_int8[_static]``
    or ``prepare_vit_int8[_static]`` output, leaves as numpy): int8 weights,
    fp32 scales and ``act_inv``, float glue, all copied exactly.  A
    ``{"segments": [...]}`` stack keeps that form."""
    if "segments" in stacked_q_np:
        return {"segments": [quantized_stack_from_jax(s) for s in stacked_q_np["segments"]]}
    return {k: to_torch(v) for k, v in stacked_q_np.items()}


def swin_int8_from_jax(int8_prepared_np: dict) -> dict:
    """The port's ``models/swin.prepare_swin_int8[_static]`` result from a
    JAX one (``{si: stack}``, leaves as numpy), copied exactly: the JAX
    stacks keep LN affines and biases as ``[L, 1, d]``, the port's as
    ``[L, d]``; int8 weights, ``*_s [L, 1, out]`` scales and ``act_inv``
    keep their shapes."""
    def convert(key, v):
        t = to_torch(v)
        return t[:, 0].contiguous() if key.endswith(("_g", "_b")) else t

    return {int(si): {k: convert(k, v) for k, v in stack.items()}
            for si, stack in int8_prepared_np.items()}


def sharded_from_jax(params_np: dict, mesh) -> dict:
    """This rank's ``parallel/mesh.shard_params`` tree of a Flax params tree
    (numpy leaves, bare or under ``"params"``), exact CPU copies: the same
    numbers as the JAX side, placed by the port's rules."""
    from ..parallel.mesh import shard_params

    return shard_params(tree_to_torch(params_np), mesh)
