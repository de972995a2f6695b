"""Checkpoint save and restore (port of ``edgevisiontransformer_tpu/utils/checkpoint.py``).

A checkpoint is a directory: the tree (``{"params": ..., "opt_state": ...}``
or any nested dict of tensors and numbers) in ``state.pt`` by
``torch.save`` where the JAX package writes orbax files, and the same
``meta.json`` sidecar (the step, the config, the prune topology), so a
run can resume where it stopped.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

import torch

_FILE = "state.pt"


def save_checkpoint(path: str, tree: Any, meta: Optional[dict] = None) -> None:
    """Write ``tree`` (and ``meta`` as ``meta.json``) into the directory
    ``path``, replacing what a checkpoint there held."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (_FILE + ".tmp")
    torch.save(tree, tmp)
    tmp.replace(path / _FILE)
    if meta is not None:
        (path / "meta.json").write_text(json.dumps(meta, indent=2))


def _fill(target: Any, saved: Any, where: str) -> Any:
    if isinstance(target, dict):
        if not isinstance(saved, dict) or set(target) != set(saved):
            got = sorted(saved) if isinstance(saved, dict) else type(saved).__name__
            raise KeyError(f"checkpoint {where or 'tree'}: keys {got}, the target's "
                           f"{sorted(target)}")
        return {k: _fill(v, saved[k], f"{where}.{k}" if where else k) for k, v in target.items()}
    if isinstance(target, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != target.shape:
            raise ValueError(f"checkpoint {where}: {getattr(saved, 'shape', type(saved))} "
                             f"where the target has {tuple(target.shape)}")
        return saved.to(device=target.device, dtype=target.dtype)
    return saved


def load_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    """The tree saved in ``path``; with ``target``, a new tree of the
    target's structure whose tensors have the target's dtypes and devices
    (raising when a key or a shape differs)."""
    saved = torch.load(Path(path).absolute() / _FILE, map_location="cpu", weights_only=True)
    return saved if target is None else _fill(target, saved, "")


def load_meta(path: str) -> Optional[dict]:
    meta = Path(path).absolute() / "meta.json"
    if meta.exists():
        return json.loads(meta.read_text())
    return None
