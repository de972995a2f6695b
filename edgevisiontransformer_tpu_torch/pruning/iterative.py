"""Iterative head-pruning loop, the are16heads run_classifier analogue
(port of ``edgevisiontransformer_tpu/pruning/iterative.py``).

The reference loop (are_16_heads/run_classifier.py:49-317): for each step of
the pruning sequence -> (load cached | compute) head importance ->
what_to_prune -> structurally prune (or soft-mask) -> optional retrain ->
eval -> save per-level checkpoint directory
``{out}/deit_{size}_are16heads_prune{N}/final`` with the accuracy-marker
idempotence convention (evaluate_iterative_pruned_deit.py:44-74).

Pruning is weight slicing to static shapes (``apply.prune_heads_params``):
there is no stateful module to rebuild (run_classifier.py:41-47's
prune_heads_plus_ddp has no analogue); the caller builds ``ViT(cfg)`` on a
level's config and loads its params.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Iterable, Optional, Sequence, Set

import numpy as np

from ..config import ViTConfig
from ..utils.jax_bridge import tree_map
from .apply import mask_heads_params, prune_heads_params
from .head_importance import calculate_head_importance
from .policy import (
    determine_pruning_sequence,
    load_head_importance_txt,
    to_pruning_descriptor,
    what_to_prune,
)


@dataclasses.dataclass
class IterativePruneConfig:
    prune_percents: Sequence[float] = (10, 20, 30, 40, 50)
    prune_numbers: Optional[Sequence[int]] = None
    at_least_x_heads_per_layer: int = 1
    actually_prune: bool = True        # structural slice vs soft mask
    normalize_by_layer: bool = True
    exact_importance_each_step: bool = True  # recompute after each level
    output_dir: str = "pruned_models"
    model_tag: str = "deit_tiny"


@dataclasses.dataclass
class PruneStepResult:
    level: int
    n_pruned_total: int
    descriptor: str
    cfg: ViTConfig
    params: dict
    accuracy: Optional[float] = None
    save_dir: Optional[str] = None
    # the level's importance, re-expanded to the original heads (pruned
    # heads +inf); None where it was read from a file
    importance: Optional[np.ndarray] = None


def iterative_head_prune(
    cfg: ViTConfig,
    params: dict,
    prune_cfg: IterativePruneConfig,
    importance_batches: Optional[Callable[[], Iterable]] = None,
    importance_file: Optional[str] = None,
    eval_fn: Optional[Callable[[ViTConfig, dict], float]] = None,
    retrain_fn: Optional[Callable[[ViTConfig, dict], dict]] = None,
    save: bool = False,
):
    """Run the full iterative loop; yields a PruneStepResult per level."""
    sequence = determine_pruning_sequence(
        prune_cfg.prune_numbers,
        prune_cfg.prune_percents,
        cfg.heads,
        cfg.depth,
        prune_cfg.at_least_x_heads_per_layer,
    )

    # Track pruned heads in ORIGINAL indices (the reference's index-remap
    # problem, classifier_eval.py:194-204, vanishes if importance rows are
    # re-expanded to original positions below).
    to_prune: Dict[int, Set[int]] = {}
    cur_cfg, cur_params = cfg, params
    total = 0

    for level, n in enumerate(sequence):
        # --- importance ---
        computed = None
        if importance_file and level == 0 and not prune_cfg.exact_importance_each_step:
            importance = load_head_importance_txt(importance_file)
        elif importance_batches is not None:
            imp_small = calculate_head_importance(
                cur_cfg, cur_params, importance_batches(),
                normalize_scores_by_layer=prune_cfg.normalize_by_layer,
            )
            # re-expand to original head indices (pruned heads get +inf so
            # they are never re-chosen)
            importance = np.full((cfg.depth, cfg.heads), np.inf)
            for layer in range(cfg.depth):
                remaining = [h for h in range(cfg.heads)
                             if h not in to_prune.get(layer, set())]
                for j, h in enumerate(remaining):
                    importance[layer, h] = imp_small[layer, j]
            computed = importance
        elif importance_file:
            importance = load_head_importance_txt(importance_file)
        else:
            raise ValueError("need importance_batches or importance_file")

        # never re-prune: mark already-pruned with +inf importance, they are
        # skipped by what_to_prune's to_prune bookkeeping anyway
        to_prune = what_to_prune(
            np.where(np.isinf(importance),
                     np.nanmax(importance[~np.isinf(importance)]) + 1, importance),
            n,
            to_prune,
            prune_cfg.at_least_x_heads_per_layer,
        )
        total += n
        descriptor = to_pruning_descriptor(to_prune)

        # --- apply ---
        if prune_cfg.actually_prune:
            cur_cfg, cur_params = prune_heads_params(cfg, params, to_prune)
        else:
            cur_cfg, cur_params = cfg, mask_heads_params(cfg, params, to_prune)

        # --- retrain ---
        # on a copy: the level's tree shares its unpruned leaves with
        # ``params``, which every level slices from, and the port's train
        # steps update their tree in place
        if retrain_fn is not None:
            cur_params = retrain_fn(cur_cfg, tree_map(lambda t: t.detach().clone(), cur_params))

        # --- eval + save ---
        result = PruneStepResult(
            level=level, n_pruned_total=total, descriptor=descriptor,
            cfg=cur_cfg, params=cur_params, importance=computed,
        )
        if save:
            from ..utils.checkpoint import save_checkpoint

            d = os.path.join(
                prune_cfg.output_dir,
                f"{prune_cfg.model_tag}_are16heads_prune{total}", "final",
            )
            save_checkpoint(os.path.abspath(d), cur_params, meta={
                "descriptor": descriptor,
                "heads_per_layer": list(cur_cfg.heads_per_layer or []),
            })
            result.save_dir = d
        if eval_fn is not None:
            from ..utils.imagenet import has_accuracy_marker, write_accuracy_marker

            marker_dir = result.save_dir or os.path.join(
                prune_cfg.output_dir,
                f"{prune_cfg.model_tag}_are16heads_prune{total}",
            )
            cached = has_accuracy_marker(marker_dir)
            if cached is not None:
                result.accuracy = cached
            else:
                result.accuracy = float(eval_fn(cur_cfg, cur_params))
                write_accuracy_marker(marker_dir, result.accuracy)
        yield result
