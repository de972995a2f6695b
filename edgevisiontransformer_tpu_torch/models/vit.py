"""ViT / DeiT as PyTorch modules (port of ``edgevisiontransformer_tpu/models/vit.py``).

Parameters keep the Flax names and layouts (a dense kernel is ``[in, out]``,
applied as ``x @ w``), so ``named_parameters()`` matches the Flax
``variables["params"]`` tree leaf for leaf: ``block_0.attn.qkv_kernel`` is
``params["block_0"]["attn"]["qkv_kernel"]``.  :meth:`ViT.params` returns that
tree.  ``ViT.forward`` has ``model.apply``'s eager semantics;
:func:`fused_vit_apply` runs the encoder on the hand-written kernels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import REFERENCE_STYLE, STANDARD_STYLE, ViTConfig
from ..ops.activations import get_act, get_gelu
from ..ops.attention import attention_xla
from ..ops.layers import layer_norm, mlp_block, patch_embed


def _param(shape, cfg: ViTConfig) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype))


def _check_kernel_mode(cfg: ViTConfig) -> None:
    if cfg.kernel_mode != "xla":
        raise NotImplementedError(
            f"kernel_mode={cfg.kernel_mode!r}: the per-op attention and MLP "
            "kernels are not ported yet; use kernel_mode='xla' or fused_vit_apply")


class Dense(nn.Module):
    """``x @ kernel + bias`` in the compute dtype (flax ``nn.Dense``)."""

    def __init__(self, cfg: ViTConfig, din: int, dout: int):
        super().__init__()
        self.config = cfg
        self.kernel = _param((din, dout), cfg)
        self.bias = _param((dout,), cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.config.dtype
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


class Attention(nn.Module):
    """Fused-QKV multi-head self-attention."""

    def __init__(self, cfg: ViTConfig, layer_idx: int = 0):
        super().__init__()
        self.config = cfg
        self.heads = cfg.layer_heads(layer_idx)
        self.head_dim = cfg.resolved_head_dim
        inner = 3 * self.heads * self.head_dim
        self.qkv_kernel = _param((cfg.dim, inner), cfg)
        self.qkv_bias = _param((inner,), cfg) if cfg.qkv_bias else None
        self.out_kernel = _param((self.heads * self.head_dim, cfg.dim), cfg)
        self.out_bias = _param((cfg.dim,), cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        _check_kernel_mode(cfg)
        dt = cfg.dtype
        b_qkv = self.qkv_bias.to(dt) if self.qkv_bias is not None else None
        return attention_xla(x.to(dt), self.qkv_kernel.to(dt), b_qkv,
                             self.out_kernel.to(dt), self.out_bias.to(dt),
                             self.heads, self.head_dim)


class FeedForward(nn.Module):
    """Dense(hidden, gelu) -> Dense(dim)."""

    def __init__(self, cfg: ViTConfig, layer_idx: int = 0):
        super().__init__()
        self.config = cfg
        hidden = cfg.layer_mlp_dim(layer_idx)
        self.fc1_kernel = _param((cfg.dim, hidden), cfg)
        self.fc1_bias = _param((hidden,), cfg)
        self.fc2_kernel = _param((hidden, cfg.dim), cfg)
        self.fc2_bias = _param((cfg.dim,), cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        _check_kernel_mode(cfg)
        dt = cfg.dtype
        return mlp_block(x.to(dt), self.fc1_kernel.to(dt), self.fc1_bias.to(dt),
                         self.fc2_kernel.to(dt), self.fc2_bias.to(dt), get_act(cfg))


class LayerNormP(nn.Module):
    """LayerNorm over the last axis; with ``norm_mode == "nonorm"`` the same
    params act as the plain affine ``x * scale + bias``."""

    def __init__(self, cfg: ViTConfig, dim: int):
        super().__init__()
        self.config = cfg
        self.scale = _param((dim,), cfg)
        self.bias = _param((dim,), cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if cfg.norm_mode == "nonorm":
            return x * self.scale + self.bias
        return layer_norm(x, self.scale, self.bias, cfg.layernorm_eps)


class EncoderBlock(nn.Module):
    """One pre-norm block: ``x + fn(LN(x))``, or with ``reference_residual``
    the reference quirk ``fn(LN(x)) + LN(x)``."""

    def __init__(self, cfg: ViTConfig, layer_idx: int = 0):
        super().__init__()
        self.config = cfg
        self.attn = Attention(cfg, layer_idx)
        self.ffn = FeedForward(cfg, layer_idx)
        self.ln1 = LayerNormP(cfg, cfg.dim)
        self.ln2 = LayerNormP(cfg, cfg.dim)

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        p = self.config.dropout_rate
        return F.dropout(x, p, training=True) if self.training and p > 0 else x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.config.reference_residual:
            h = self.ln1(x)
            x = self._drop(self.attn(h)) + h
            h = self.ln2(x)
            return self._drop(self.ffn(h)) + h
        x = x + self._drop(self.attn(self.ln1(x)))
        return x + self._drop(self.ffn(self.ln2(x)))


class ViT(nn.Module):
    """Vision Transformer encoder + classifier.

    Parameters are created on the CPU, initialised from ``generator`` (the
    Flax initialisers: xavier-uniform kernels, lecun-normal head kernels,
    normal(0.02) cls / position embeddings, zero biases, unit LN scales),
    then moved to ``device``.
    """

    def __init__(self, cfg: ViTConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = cfg
        p, c, dim = cfg.patch_size, cfg.in_channels, cfg.dim
        self.patch_kernel = _param((p * p * c, dim), cfg)
        self.patch_bias = _param((dim,), cfg)
        self.cls_token = _param((1, 1, dim), cfg)
        self.pos_embedding = _param((cfg.num_patches + 1, dim), cfg)
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", EncoderBlock(cfg, i))
        if cfg.final_norm:
            self.final_norm = LayerNormP(cfg, dim)
        if cfg.mlp_head:
            self.head_fc1 = Dense(cfg, dim, cfg.mlp_dim)
            self.head_fc2 = Dense(cfg, cfg.mlp_dim, cfg.num_classes)
        else:
            self.head = Dense(cfg, dim, cfg.num_classes)
        self._init_params(generator)
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def _init_params(self, gen: torch.Generator | None) -> None:
        for name, prm in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name in ("cls_token", "pos_embedding"):
                prm.normal_(0.0, 0.02, generator=gen)
            elif leaf == "scale":
                prm.fill_(1.0)
            elif name.startswith("head") and leaf == "kernel":
                std = math.sqrt(1.0 / prm.shape[0]) / 0.87962566103423978
                nn.init.trunc_normal_(prm, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=gen)
            elif prm.dim() == 2:
                limit = math.sqrt(6.0 / (prm.shape[0] + prm.shape[1]))
                prm.uniform_(-limit, limit, generator=gen)
            else:
                prm.zero_()

    def blocks(self) -> list:
        return [getattr(self, f"block_{i}") for i in range(self.config.depth)]

    def params(self) -> dict:
        """The parameters as a nested dict keyed as the Flax tree."""
        tree: dict = {}
        for name, prm in self.named_parameters():
            *path, leaf = name.split(".")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = prm.detach()
        return tree

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dt = cfg.dtype
        x = patch_embed(img.to(dt), self.patch_kernel.to(dt),
                        self.patch_bias.to(dt), cfg.patch_size)
        cls = self.cls_token.to(dt).expand(x.shape[0], 1, cfg.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(dt)
        for blk in self.blocks():
            x = blk(x)
        if cfg.final_norm:
            x = self.final_norm(x)
        x = x[:, 0]
        if cfg.mlp_head:
            return self.head_fc2(get_gelu(cfg.gelu_approx)(self.head_fc1(x)))
        return self.head(x)


# ---------------------------------------------------------------------------
# Factories
# ---------------------------------------------------------------------------

_DEIT_SHAPES = {
    "tiny": dict(dim=192, depth=12, heads=3, mlp_dim=768),
    "small": dict(dim=384, depth=12, heads=6, mlp_dim=1536),
    "base": dict(dim=768, depth=12, heads=12, mlp_dim=3072),
}


def deit_config(size: str = "tiny", style: str = "standard", **overrides) -> ViTConfig:
    """Build a DeiT config. style in {"standard", "reference"}."""
    shape = _DEIT_SHAPES[size]
    style_kw = REFERENCE_STYLE if style == "reference" else STANDARD_STYLE
    return ViTConfig(**{**shape, **style_kw, **overrides})


def get_deit_tiny(style: str = "standard", *, device=None, generator=None, **kw) -> ViT:
    return ViT(deit_config("tiny", style, **kw), device=device, generator=generator)


def get_deit_small(style: str = "standard", *, device=None, generator=None, **kw) -> ViT:
    return ViT(deit_config("small", style, **kw), device=device, generator=generator)


def get_deit_base(style: str = "standard", *, device=None, generator=None, **kw) -> ViT:
    return ViT(deit_config("base", style, **kw), device=device, generator=generator)


def encoder_segments(cfg: ViTConfig) -> list:
    """Runs of consecutive layers with identical (heads, mlp) shapes, as
    ``[(start, depth, heads, mlp_dim)]``."""
    shapes = [(cfg.layer_heads(i), cfg.layer_mlp_dim(i)) for i in range(cfg.depth)]
    segments = []
    for i, sh in enumerate(shapes):
        if segments and segments[-1][2:] == sh:
            start, d, h_, m_ = segments[-1]
            segments[-1] = (start, d + 1, h_, m_)
        else:
            segments.append((i, 1, sh[0], sh[1]))
    return segments


def prepare_vit_fused(model: ViT) -> dict:
    """The encoder params stacked ``[L, ...]`` in the compute dtype, as
    :func:`fused_vit_apply` consumes them.  Build once and pass as
    ``stacked=`` to keep the stack and cast out of every forward."""
    from ..ops.cuda.fused_encoder import stack_vit_layer_params

    cfg = model.config
    stacked = stack_vit_layer_params(model.params(), cfg.depth, cfg.qkv_bias)
    return {k: v.to(cfg.dtype).contiguous() for k, v in stacked.items()}


def fused_vit_apply(model: ViT, img: torch.Tensor, *, stacked: dict | None = None,
                    plain: bool = False) -> torch.Tensor:
    """Forward pass with the encoder on the hand-written kernels
    (``ops/cuda/fused_encoder.encoder_forward``); the same params and
    result as ``model(img)``.

    Patch embedding, the cls / position add, the final LayerNorm and the
    head stay plain tensor ops, as they stay outside the kernel in the
    reference.  ``stacked`` is :func:`prepare_vit_fused`'s output (built
    here when omitted).  ``plain=True`` runs the kernels' plain twins on any
    device: the reference the kernel path is checked against on the GPU.
    """
    from ..ops.cuda.fused_encoder import encoder_forward, encoder_forward_plain

    cfg = model.config
    if cfg.norm_mode != "layernorm" or cfg.act != "gelu":
        # transitions-compiled (NoNorm / ReLU) models: the kernels compute
        # real LayerNorm + GELU
        raise ValueError(
            "fused encoder supports norm_mode='layernorm' + act='gelu' only; "
            f"got norm_mode={cfg.norm_mode!r}, act={cfg.act!r} (use model(img))"
        )
    segments = encoder_segments(cfg)
    if len(segments) != 1:
        raise NotImplementedError(
            f"{len(segments)} encoder segments: layerwise-pruned models are not "
            "ported to the fused path yet (use model(img))")
    p = model.params()
    dt = cfg.dtype
    x = patch_embed(img.to(dt), p["patch_kernel"].to(dt), p["patch_bias"].to(dt),
                    cfg.patch_size)
    cls = p["cls_token"].to(dt).expand(x.shape[0], 1, cfg.dim)
    x = torch.cat([cls, x], dim=1) + p["pos_embedding"].to(dt)

    if stacked is None:
        stacked = prepare_vit_fused(model)
    encoder = encoder_forward_plain if plain else encoder_forward
    x = encoder(x, stacked, heads=segments[0][2], head_dim=cfg.resolved_head_dim,
                eps=cfg.layernorm_eps, reference_residual=cfg.reference_residual,
                approx_gelu=cfg.gelu_approx)

    if cfg.final_norm:
        x = layer_norm(x, p["final_norm"]["scale"], p["final_norm"]["bias"],
                       cfg.layernorm_eps)
    x = x[:, 0]
    if cfg.mlp_head:
        h = x @ p["head_fc1"]["kernel"].to(dt) + p["head_fc1"]["bias"].to(dt)
        h = get_gelu(cfg.gelu_approx)(h)
        return h @ p["head_fc2"]["kernel"].to(dt) + p["head_fc2"]["bias"].to(dt)
    return x @ p["head"]["kernel"].to(dt) + p["head"]["bias"].to(dt)
