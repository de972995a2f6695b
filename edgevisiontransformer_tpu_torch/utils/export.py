"""Serialized model export (port of ``edgevisiontransformer_tpu/utils/export.py``),
the ONNX-export analogue.

The reference exports models to ONNX / TFLite flatbuffers as the
deployment interchange format; the JAX package serializes its jitted
forward to StableHLO.  The PyTorch counterpart is ``torch.export``: the
forward ``apply_fn(params, x)`` traced to an ``ExportedProgram`` (the
weights baked in, or as inputs) and saved with ``torch.export.save``, which
any PyTorch runtime reloads and runs without the model code.

The port's kernel wrappers launch through ctypes, which ``torch.export``
cannot trace, so what is exported is the plain forward (the model's own
``forward``, ``kernel_mode="xla"``), as the JAX CLI exports ``model.apply``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

import torch

from .jax_bridge import flatten_tree


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


class _Baked(torch.nn.Module):
    """``apply_fn`` over ``params`` held as the module's buffers, so that the
    exported program carries them."""

    def __init__(self, apply_fn, params: dict):
        super().__init__()
        self.apply_fn = apply_fn
        self.names = list(flatten_tree(params))
        for i, t in enumerate(flatten_tree(params).values()):
            self.register_buffer(f"p{i}", t.detach())

    def forward(self, x):
        flat = {n: getattr(self, f"p{i}") for i, n in enumerate(self.names)}
        return self.apply_fn(_unflatten(flat), x)


class _Args(torch.nn.Module):
    def __init__(self, apply_fn):
        super().__init__()
        self.apply_fn = apply_fn

    def forward(self, params, x):
        return self.apply_fn(params, x)


def export_forward(
    apply_fn,
    params,
    input_shape: Sequence[int],
    out_path: str,
    dtype: torch.dtype = torch.float32,
    bake_params: bool = True,
    meta: Optional[dict] = None,
) -> str:
    """Serialize ``apply_fn(params, x)`` to a ``torch.export`` program (+ a
    meta sidecar ``<out_path>.json``: ``input_shape``, ``dtype``,
    ``baked_params`` and ``meta``'s keys, the JAX package's).

    ``bake_params=True`` holds the weights in the program (a single-file
    deployable model, like an ONNX export); False exports ``fn(params, x)``.
    The example input is zeros of ``input_shape`` and ``dtype`` on the
    device of ``params``' first tensor."""
    leaf = next(iter(flatten_tree(params).values()))
    x = torch.zeros(tuple(input_shape), dtype=dtype, device=leaf.device)
    with torch.no_grad():
        if bake_params:
            program = torch.export.export(_Baked(apply_fn, params), (x,))
        else:
            program = torch.export.export(_Args(apply_fn), (params, x))
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, str(out))
    out.with_suffix(out.suffix + ".json").write_text(json.dumps({
        "input_shape": list(input_shape),
        "dtype": str(dtype).removeprefix("torch."),
        "baked_params": bake_params,
        **(meta or {}),
    }, indent=2))
    return str(out)


def load_exported(path: str):
    """Load a saved program and return a callable running it
    (``x -> logits``, or ``(params, x) -> logits`` when not baked)."""
    return torch.export.load(str(path)).module()
