"""Benchmark/accuracy log scrapers (port of
``edgevisiontransformer_tpu/utils/logscrape.py``, pure Python).

The reference's result-collection utilities: ``fetch_latency_std``
(the reference's ``utils.py:409-461``) pulls latency/std/memory series out
of benchmark logs; ``fetch_results.py:6-40`` pulls accuracies from pruning
logs and from the accuracy-marker filenames.  The logs print the same
"Avg latency X ms, Std Y ms" contract, so these scrapers work on both the
package's logs and the reference's.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple


_LAT_RE = re.compile(r"Avg latency\s+([0-9.]+)\s*ms,\s*Std\s+([0-9.]+)\s*ms")
_MEM_RE = re.compile(r"Mem footprint\(MB\):\s*([0-9.]+)")
_ACC_RE = re.compile(r"(?:top1|accuracy|acc)[\s=:]+([0-9.]+)", re.IGNORECASE)


def fetch_latency_std(log_path: str) -> List[Tuple[float, float]]:
    """All (avg_ms, std_ms) pairs in a benchmark log."""
    out = []
    with open(log_path) as f:
        for line in f:
            m = _LAT_RE.search(line)
            if m:
                out.append((float(m.group(1)), float(m.group(2))))
    return out


def fetch_mem_footprints(log_path: str) -> List[float]:
    with open(log_path) as f:
        return [float(m.group(1)) for line in f for m in [_MEM_RE.search(line)] if m]


def fetch_accuracies_from_log(log_path: str) -> List[float]:
    out = []
    with open(log_path) as f:
        for line in f:
            m = _ACC_RE.search(line)
            if m:
                try:
                    v = float(m.group(1))
                except ValueError:
                    continue
                if 0.0 <= v <= 100.0:
                    out.append(v)
    return out


def fetch_results_from_markers(root: str) -> Dict[str, float]:
    """Walk model dirs for accuracy{int(acc*10000)}.txt markers
    (fetch_results.py:6-40 + evaluate_iterative_pruned_deit.py:44-46)."""
    results: Dict[str, float] = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            m = re.fullmatch(r"accuracy(\d+)\.txt", f)
            if m:
                results[os.path.relpath(dirpath, root)] = int(m.group(1)) / 10000.0
    return results
