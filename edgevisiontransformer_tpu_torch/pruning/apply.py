"""Structural pruning: weight slicing to static shapes (port of
``edgevisiontransformer_tpu/pruning/apply.py``).

The reference prunes with HF ``model.vit.prune_heads`` (in-place Linear
surgery, run_classifier.py:247-250) or soft masks.  Here a NEW parameter
tree is sliced to the remaining heads / FFN units, with a config whose
per-layer static shapes (``heads_per_layer`` / ``mlp_dim_per_layer``) the
ViT module and the fused encoders read, so every layer runs at its own
width.  Trees are nested dicts of tensors keyed as ``ViT.params()``, bare
or under ``"params"``; the result keeps the input's form and device.
"""

from __future__ import annotations

from typing import Dict, Sequence, Set

import torch

from ..config import ViTConfig


def _remaining(heads: int, pruned: Set[int]) -> list:
    return [h for h in range(heads) if h not in pruned]


def _index(keep, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(list(keep), dtype=torch.long, device=like.device)


def prune_heads_params(cfg: ViTConfig, params: dict, to_prune: Dict[int, Set[int]]):
    """Slice fused-qkv / out-proj weights to the remaining heads.

    Returns (new_cfg, new_params).  qkv kernels are [dim, 3*H*hd] with fused
    axis ordered (qkv, head, hd), reshaped to [dim, 3, H, hd] for the head
    gather; out kernels are [H*hd, dim] -> [H, hd, dim]."""
    p = params["params"] if "params" in params else params
    hd = cfg.resolved_head_dim
    new_heads = []
    new_params = dict(p)
    for i in range(cfg.depth):
        heads_i = cfg.layer_heads(i)
        keep = _remaining(heads_i, to_prune.get(i, set()))
        new_heads.append(len(keep))
        if len(keep) == heads_i:
            continue
        blk = dict(p[f"block_{i}"])
        attn = dict(blk["attn"])
        dim = attn["qkv_kernel"].shape[0]
        idx = _index(keep, attn["qkv_kernel"])

        w = attn["qkv_kernel"].reshape(dim, 3, heads_i, hd)
        attn["qkv_kernel"] = w[:, :, idx, :].reshape(dim, 3 * len(keep) * hd)
        if "qkv_bias" in attn:
            bqkv = attn["qkv_bias"].reshape(3, heads_i, hd)
            attn["qkv_bias"] = bqkv[:, idx, :].reshape(3 * len(keep) * hd)
        wo = attn["out_kernel"].reshape(heads_i, hd, -1)
        attn["out_kernel"] = wo[idx].reshape(len(keep) * hd, -1)
        blk["attn"] = attn
        new_params[f"block_{i}"] = blk

    new_cfg = cfg.replace(heads_per_layer=tuple(new_heads), head_dim=hd)
    out = {"params": new_params} if "params" in params else new_params
    return new_cfg, out


def prune_ffn_params(cfg: ViTConfig, params: dict, keep_units: Dict[int, Sequence[int]]):
    """Physically slice FFN hidden units per layer (reference optimize_model
    semantics, inference_model_patcher.py:266-317: zero rows of fc1 and zero
    cols of fc2 are removed)."""
    p = params["params"] if "params" in params else params
    new_mlp = []
    new_params = dict(p)
    for i in range(cfg.depth):
        full = cfg.layer_mlp_dim(i)
        keep = list(keep_units.get(i, range(full)))
        new_mlp.append(len(keep))
        if len(keep) == full:
            continue
        blk = dict(p[f"block_{i}"])
        ffn = dict(blk["ffn"])
        idx = _index(keep, ffn["fc1_kernel"])
        ffn["fc1_kernel"] = ffn["fc1_kernel"][:, idx]
        ffn["fc1_bias"] = ffn["fc1_bias"][idx]
        ffn["fc2_kernel"] = ffn["fc2_kernel"][idx, :]
        blk["ffn"] = ffn
        new_params[f"block_{i}"] = blk
    new_cfg = cfg.replace(mlp_dim_per_layer=tuple(new_mlp))
    out = {"params": new_params} if "params" in params else new_params
    return new_cfg, out


def mask_heads_params(cfg: ViTConfig, params: dict, to_prune: Dict[int, Set[int]]):
    """Soft masking (reference ``mask_heads`` path, run_classifier.py:250):
    zero the out-projection rows of masked heads so outputs are exactly as if
    pruned, without shape changes.  Useful for eval-before-commit."""
    p = params["params"] if "params" in params else params
    hd = cfg.resolved_head_dim
    new_params = dict(p)
    for i, pruned in to_prune.items():
        if not pruned:
            continue
        heads_i = cfg.layer_heads(i)
        blk = dict(p[f"block_{i}"])
        attn = dict(blk["attn"])
        wo = attn["out_kernel"].detach().clone().reshape(heads_i, hd, -1)
        wo[_index(sorted(pruned), wo)] = 0.0
        attn["out_kernel"] = wo.reshape(heads_i * hd, -1)
        blk["attn"] = attn
        new_params[f"block_{i}"] = blk
    return {"params": new_params} if "params" in params else new_params
