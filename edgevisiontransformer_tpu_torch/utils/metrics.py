"""Metrics logging (port of ``edgevisiontransformer_tpu/utils/metrics.py``).

A JSONL stream, one object per event, and a rank-0 gate for data-parallel
runs: the rank is ``torch.distributed``'s where a process group is
initialised, and 0 otherwise.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch.distributed as dist


def is_rank_zero() -> bool:
    """True on the process that should log (dist_print analogue)."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def dist_print(*args, **kw) -> None:
    if is_rank_zero():
        print(*args, **kw)


class MetricsLogger:
    """Append-only JSONL metrics stream with wall-clock stamps."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._t0 = time.time()
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, event: str, **fields: Any) -> Dict[str, Any]:
        rec = {"event": event, "t": round(time.time() - self._t0, 3), **fields}
        if self._f is not None and is_rank_zero():
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self.echo and is_rank_zero():
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            print(f"[{rec['t']:.1f}s] {event} {kv}")
        return rec

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


def read_metrics(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
