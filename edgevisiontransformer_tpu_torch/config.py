"""Model configuration (port of ``edgevisiontransformer_tpu/config.py``).

Same fields, defaults and JSON form as the JAX ``ViTConfig``; the two dtype
fields hold ``torch.dtype``s and serialise under the same names
(``"float32"``, ``"bfloat16"``, ``"float16"``), so a config written by
either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch


def dtype_name(dt: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (the numpy / jnp name)."""
    return str(dt).removeprefix("torch.")


def dtype_from_name(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclass(frozen=True)
class ViTConfig:
    """Configuration for ViT/DeiT-family encoders.

    ``REFERENCE_STYLE`` reproduces the TF reference semantics (pre-norm
    blocks whose skip path also passes through LayerNorm, a 2-layer GELU
    classifier head, tanh GELU, no qkv bias, eps 1e-5, no final LayerNorm);
    ``STANDARD_STYLE`` is the real DeiT form (``x + fn(LN(x))``, one linear
    head, final LayerNorm, qkv bias, exact GELU, eps 1e-6).
    """

    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    dim: int = 768
    depth: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    head_dim: Optional[int] = None  # default: dim // heads
    in_channels: int = 3

    # Per-layer pruned shapes (static). None => uniform (heads, mlp_dim).
    heads_per_layer: Optional[Tuple[int, ...]] = None
    mlp_dim_per_layer: Optional[Tuple[int, ...]] = None

    # Fidelity switches.
    reference_residual: bool = False  # True => fn(LN(x)) + LN(x) quirk
    mlp_head: bool = False            # True => Dense(mlp_dim, gelu) + Dense(C)
    final_norm: bool = True
    qkv_bias: bool = True
    gelu_approx: bool = False         # True => tanh approximation
    layernorm_eps: float = 1e-6

    # Compute / parameter dtypes.
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    dropout_rate: float = 0.0
    kernel_mode: str = "xla"
    remat: bool = False

    # Compiled-transition modes: "nonorm" turns every LayerNorm into the
    # affine ``x * g + b``; "relu" replaces GELU.
    norm_mode: str = "layernorm"  # "layernorm" | "nonorm"
    act: str = "gelu"             # "gelu" | "relu"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.dim // self.heads

    def layer_heads(self, i: int) -> int:
        return self.heads_per_layer[i] if self.heads_per_layer is not None else self.heads

    def layer_mlp_dim(self, i: int) -> int:
        return (
            self.mlp_dim_per_layer[i]
            if self.mlp_dim_per_layer is not None
            else self.mlp_dim
        )

    def replace(self, **kw) -> "ViTConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["dtype"] = dtype_name(self.dtype)
        d["param_dtype"] = dtype_name(self.param_dtype)
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "ViTConfig":
        d = json.loads(s)
        d["dtype"] = dtype_from_name(d["dtype"])
        d["param_dtype"] = dtype_from_name(d["param_dtype"])
        for k in ("heads_per_layer", "mlp_dim_per_layer"):
            if d.get(k) is not None:
                d[k] = tuple(d[k])
        return ViTConfig(**d)


REFERENCE_STYLE = dict(
    reference_residual=True,
    mlp_head=True,
    final_norm=False,
    qkv_bias=False,
    gelu_approx=True,
    layernorm_eps=1e-5,
)

STANDARD_STYLE = dict(
    reference_residual=False,
    mlp_head=False,
    final_norm=True,
    qkv_bias=True,
    gelu_approx=False,
    layernorm_eps=1e-6,
)


def decode_prune_encoding(prune_encoding: str, depth: int, mlp_dim: int):
    """Parse the prune-encoding DSL.

    ``"all_headH_ffnF"`` => every layer keeps H heads and int(F*mlp_dim) FFN
    units; ``"layerwise_h2-d1.0_h3-d0.5_..."`` => per-layer settings.
    """
    tokens = prune_encoding.split("_")
    setting = tokens[0]
    if setting == "all":
        num_heads = int(tokens[1].replace("head", ""))
        ffn_threshold = float(tokens[2].replace("ffn", ""))
        heads_per_layer = tuple(num_heads for _ in range(depth))
        mlp_per_layer = tuple(int(ffn_threshold * mlp_dim) for _ in range(depth))
    elif setting == "layerwise":
        heads, ffns = [], []
        for token in tokens[1:]:
            hx, dx = token.split("-")
            heads.append(int(hx.replace("h", "")))
            ffns.append(float(dx.replace("d", "")))
        if len(heads) != depth:
            raise ValueError(
                f"layerwise encoding has {len(heads)} entries, expected depth={depth}"
            )
        heads_per_layer = tuple(heads)
        mlp_per_layer = tuple(int(f * mlp_dim) for f in ffns)
    else:
        raise ValueError(f"unknown prune setting {setting!r}")
    return heads_per_layer, mlp_per_layer


def encode_prune_encoding(
    heads_per_layer: Sequence[int], mlp_dims: Sequence[int], mlp_dim: int
) -> str:
    """Inverse of :func:`decode_prune_encoding` (layerwise form)."""
    parts = [
        f"h{h}-d{m / mlp_dim:g}" for h, m in zip(heads_per_layer, mlp_dims)
    ]
    return "layerwise_" + "_".join(parts)
