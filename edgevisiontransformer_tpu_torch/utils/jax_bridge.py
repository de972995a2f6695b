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


def load_jax_params(model: torch.nn.Module, params_np: dict) -> torch.nn.Module:
    """Copy a Flax params tree (numpy leaves) into ``model`` in place.

    Raises ``KeyError`` when either side has a leaf the other lacks and
    ``ValueError`` on a shape or dtype mismatch: nothing is cast or left at
    its initial value."""
    flat = {k: np.asarray(v) for k, v in flatten_tree(params_np).items()}
    named = dict(model.named_parameters())
    missing = sorted(set(named) - set(flat))
    extra = sorted(set(flat) - set(named))
    if missing or extra:
        raise KeyError(f"param trees differ: missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for name, prm in named.items():
            src = to_torch(flat[name])
            if tuple(src.shape) != tuple(prm.shape) or src.dtype != prm.dtype:
                raise ValueError(
                    f"{name}: flax {tuple(src.shape)} {src.dtype} vs port "
                    f"{tuple(prm.shape)} {prm.dtype}")
            prm.copy_(src)
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
