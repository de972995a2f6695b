"""Model registry: name -> (module, example NCHW input shape sans batch).

Port of ``edgevisiontransformer_tpu/models/registry.py`` for the models
ported so far: ``deit_tiny``, ``deit_small`` and ``deit_base``.
"""

from __future__ import annotations

from typing import Tuple

from torch import nn

from .vit import get_deit_base, get_deit_small, get_deit_tiny

_REGISTRY = {
    "deit_tiny": get_deit_tiny,
    "deit_small": get_deit_small,
    "deit_base": get_deit_base,
}


def available_models():
    return sorted(_REGISTRY)


def build_model(name: str, **kw) -> Tuple[nn.Module, Tuple[int, ...]]:
    """Build a model by name; ``kw`` goes to the factory (``style``,
    ``device``, ``generator`` and any ``ViTConfig`` field)."""
    if name not in _REGISTRY:
        raise KeyError(f"model {name!r} is not ported yet; ported: {available_models()}")
    model = _REGISTRY[name](**kw)
    img = model.config.image_size
    return model, (model.config.in_channels, img, img)
