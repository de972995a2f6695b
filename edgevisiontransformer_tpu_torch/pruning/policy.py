"""Head-pruning policy: which heads to remove, in what order (port of
``edgevisiontransformer_tpu/pruning/policy.py``, a copy of its numpy code so
the two give the same outputs).

The reference policy (are_16_heads/pruning.py:5-125):

* descriptor DSL "layer:head1,head2" is 1-indexed on both axes;
* ``determine_pruning_sequence`` converts percent targets into incremental
  per-step counts with an at-least-x-heads-per-layer guard;
* ``what_to_prune`` sorts all (layer, head) pairs by importance globally,
  protects the top head(s) per layer, skips already-pruned heads, and takes
  the lowest-scoring n.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Set

import numpy as np


def parse_head_pruning_descriptors(
    descriptors: Sequence[str],
    reverse_descriptors: bool = False,
    n_heads: Optional[int] = None,
) -> Dict[int, Set[int]]:
    """"layer:head1,head2" (1-indexed) -> {layer0: {head0, ...}}."""
    to_prune: Dict[int, Set[int]] = {}
    for descriptor in descriptors:
        layer_s, heads_s = descriptor.split(":")
        layer = int(layer_s) - 1
        heads = {int(h) - 1 for h in heads_s.split(",")}
        to_prune.setdefault(layer, set()).update(heads)
    if reverse_descriptors:
        if n_heads is None:
            raise ValueError("need n_heads to reverse descriptors")
        for layer, heads in to_prune.items():
            to_prune[layer] = {h for h in range(n_heads) if h not in heads}
    return to_prune


def to_pruning_descriptor(to_prune: Dict[int, Set[int]]) -> str:
    return " ".join(
        f"{layer + 1}:{','.join(str(h + 1) for h in sorted(heads))}"
        for layer, heads in sorted(to_prune.items())
    )


def determine_pruning_sequence(
    prune_numbers: Optional[Sequence[int]],
    prune_percents: Optional[Sequence[float]],
    n_heads: int,
    n_layers: int,
    at_least_x_heads_per_layer: int = 0,
) -> List[int]:
    """Cumulative targets -> incremental per-step prune counts."""
    all_n = list(prune_numbers) if prune_numbers is not None else None
    if all_n is None:
        all_n = []
        total = n_heads * n_layers
        for pct in prune_percents:
            n = int(total * pct / 100)
            if at_least_x_heads_per_layer > 0:
                cap = total - at_least_x_heads_per_layer * n_layers
                if n > cap:
                    all_n.append(cap)
                    break
            all_n.append(n)
    all_n = sorted(all_n)
    seq = all_n[:]
    for i in range(1, len(all_n)):
        seq[i] = all_n[i] - all_n[i - 1]
    assert not all_n or all_n[-1] == sum(seq)
    return seq


def what_to_prune(
    head_importance: np.ndarray,
    n_to_prune: int,
    to_prune: Optional[Dict[int, Set[int]]] = None,
    at_least_x_heads_per_layer: int = 0,
    rescale_by_number: bool = False,
) -> Dict[int, Set[int]]:
    """Pick the globally lowest-importance heads, respecting protections."""
    imp = np.array(head_importance, dtype=np.float64, copy=True)
    n_layers, n_heads = imp.shape
    to_prune = {k: set(v) for k, v in (to_prune or {}).items()}
    if rescale_by_number:
        for layer in to_prune:
            imp[layer] *= math.sqrt(len(to_prune[layer]) / n_layers)

    pairs = [((l, h), imp[l, h]) for l in range(n_layers) for h in range(n_heads)]
    pairs.sort(key=lambda x: x[1])
    sorted_heads = [p[0] for p in pairs]

    if at_least_x_heads_per_layer:
        # walk from highest importance down, reserving the top-x per layer
        to_protect = {l: 0 for l in range(n_layers)}
        filtered: List = []
        for layer, head in reversed(sorted_heads):
            if layer in to_protect:
                if to_protect[layer] < at_least_x_heads_per_layer:
                    to_protect[layer] += 1
                    continue
                else:
                    to_protect.pop(layer)
            filtered.insert(0, (layer, head))
        sorted_heads = filtered

    sorted_heads = [
        (l, h) for (l, h) in sorted_heads
        if l not in to_prune or h not in to_prune[l]
    ]
    for layer, head in sorted_heads[:n_to_prune]:
        to_prune.setdefault(layer, set()).add(head)
    return to_prune


def load_head_importance_txt(path: str) -> np.ndarray:
    """Read the reference's head-importance asset format
    (are_16_heads/deit_*_head_importance.txt: one row per layer)."""
    return np.loadtxt(path, dtype=np.float64)


def save_head_importance_txt(path: str, imp: np.ndarray) -> None:
    np.savetxt(path, np.asarray(imp))
