"""ImageNet evaluation helpers (port of part of
``edgevisiontransformer_tpu/utils/imagenet.py``): the accuracy marker files.

The marker is an empty file ``accuracy{int(acc*10000)}.txt`` in the model
directory, so a sweep skips a model it has already evaluated.  ``evaluate``
and the image-folder loader need PIL and the native preprocessing that the
card's machine lacks; they come with the port of ``utils/native_preprocess.py``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional


def write_accuracy_marker(model_dir: str, acc: float) -> str:
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, f"accuracy{int(acc * 10000)}.txt")
    Path(path).touch()
    return path


def has_accuracy_marker(model_dir: str) -> Optional[float]:
    """The accuracy a marker in ``model_dir`` records, or None."""
    if not os.path.isdir(model_dir):
        return None
    for f in os.listdir(model_dir):
        if f.startswith("accuracy") and f.endswith(".txt"):
            try:
                return int(f[len("accuracy"):-len(".txt")]) / 10000.0
            except ValueError:
                continue
    return None
