"""Model registry: name -> (module, example NCHW input shape sans batch).

Port of ``edgevisiontransformer_tpu/models/registry.py`` for the models
ported so far: ``deit_tiny``, ``deit_small``, ``deit_base``,
``pruned_deit_<size>@<encoding>`` (the encoding defaults to
``all_head12_ffn1.0``), ``t2t_vit_{7,10,12,14}`` and
``swin_{tiny,small,base}``.
"""

from __future__ import annotations

import functools
from typing import Tuple

from torch import nn

from .swin import get_swin
from .t2t_vit import get_t2t_vit
from .vit import get_deit_base, get_deit_small, get_deit_tiny, get_pruned_vit

_REGISTRY = {
    "deit_tiny": get_deit_tiny,
    "deit_small": get_deit_small,
    "deit_base": get_deit_base,
}
for _v in (7, 10, 12, 14):
    _REGISTRY[f"t2t_vit_{_v}"] = functools.partial(get_t2t_vit, _v)
for _size in ("tiny", "small", "base"):
    _REGISTRY[f"swin_{_size}"] = functools.partial(get_swin, _size)


def available_models():
    return sorted(_REGISTRY)


def build_model(name: str, **kw) -> Tuple[nn.Module, Tuple[int, ...]]:
    """Build a model by name; ``kw`` goes to the factory (``device``, the
    card by default, ``generator``, ``style`` for the ViT family and any
    field of its config).  ``pruned_deit_<size>@<encoding>``, e.g.
    ``pruned_deit_tiny@all_head1_ffn0.3``, builds :func:`get_pruned_vit`."""
    if name.startswith("pruned_deit_"):
        size, _, enc = name[len("pruned_deit_"):].partition("@")
        model = get_pruned_vit(size=size, prune_encoding=enc or "all_head12_ffn1.0", **kw)
    elif name not in _REGISTRY:
        raise KeyError(f"model {name!r} is not ported yet; ported: {available_models()}")
    else:
        model = _REGISTRY[name](**kw)
    img = model.config.image_size
    return model, (model.config.in_channels, img, img)
