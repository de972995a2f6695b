"""ViT / DeiT as PyTorch modules (port of ``edgevisiontransformer_tpu/models/vit.py``).

Parameters keep the Flax names and layouts (a dense kernel is ``[in, out]``,
applied as ``x @ w``), so ``named_parameters()`` matches the Flax
``variables["params"]`` tree leaf for leaf: ``block_0.attn.qkv_kernel`` is
``params["block_0"]["attn"]["qkv_kernel"]``.  :meth:`ViT.params` returns that
tree, :func:`load_params` copies one into a model and :func:`apply_params`
runs the model on one (``model.apply(params, img)``, differentiable in the
tree).  ``ViT.forward`` has ``model.apply``'s eager semantics; with
``kernel_mode="pallas"`` its attention core runs on the ``sdpa`` kernel and
its MLP on the ``mlp`` kernel.  :func:`fused_vit_apply` runs the encoder on
the hand-written kernels, one chain per uniform run of layers for
layerwise-pruned models (:func:`pruned_vit_config`),
:func:`fused_vit_apply_int8` runs it in int8 (dynamic or static scales), and
:func:`fully_fused_vit_apply` runs the whole forward as one kernel launch.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..config import REFERENCE_STYLE, STANDARD_STYLE, ViTConfig, decode_prune_encoding
from ..ops.activations import get_act, get_gelu
from ..ops.attention import attention_xla
from ..ops.cuda import fused_attention, fused_mlp
from ..ops.layers import layer_norm, mlp_block, patch_embed


def _param(shape, cfg: ViTConfig) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype))


def lecun_normal_(prm: torch.Tensor, gen: torch.Generator | None) -> None:
    """Flax's default Dense init: truncated normal of variance 1 / fan_in."""
    std = math.sqrt(1.0 / prm.shape[0]) / 0.87962566103423978
    nn.init.trunc_normal_(prm, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def xavier_uniform_(prm: torch.Tensor, gen: torch.Generator | None) -> None:
    limit = math.sqrt(6.0 / (prm.shape[0] + prm.shape[1]))
    prm.uniform_(-limit, limit, generator=gen)


def nested_tree(named) -> dict:
    """``(dotted name, tensor)`` pairs as a nested dict of detached tensors:
    ``named_parameters()`` becomes the Flax ``params`` tree."""
    tree: dict = {}
    for name, t in named:
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t.detach()
    return tree


def _flat_params(model: nn.Module, params: dict) -> dict:
    """``params`` (a bare tree or ``{"params": tree}``) by dotted name;
    raises ``KeyError`` unless the names are ``model``'s parameters'."""
    from ..utils.jax_bridge import flatten_tree

    flat = flatten_tree(params.get("params", params))
    names = {n for n, _ in model.named_parameters()}
    if set(flat) != names:
        raise KeyError(f"param tree and model differ: missing {sorted(names - set(flat))}, "
                       f"unexpected {sorted(set(flat) - names)}")
    return flat


def load_params(model: nn.Module, params: dict) -> nn.Module:
    """Copy a parameter tree keyed as :func:`nested_tree`'s (a bare tree or
    ``{"params": tree}``) into ``model``'s parameters in place.  Raises
    ``KeyError`` when either side has a leaf the other lacks and
    ``ValueError`` on a shape or dtype mismatch: nothing is cast."""
    flat = _flat_params(model, params)
    named = dict(model.named_parameters())
    for name, dst in named.items():
        src = flat[name]
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"{name}: tree {tuple(src.shape)} {src.dtype} vs model "
                             f"{tuple(dst.shape)} {dst.dtype}")
    with torch.no_grad():
        for name, dst in named.items():
            dst.copy_(flat[name])
    return model


def apply_params(model: nn.Module, params: dict, img: torch.Tensor, *,
                 train: bool = False) -> torch.Tensor:
    """``model.apply(params, img, train)``: ``model``'s forward on the
    parameter tree ``params`` (a bare tree or ``{"params": tree}``, keyed as
    ``model.params()``, every parameter and nothing else) in place of its
    own parameters (``torch.func.functional_call``); gradients flow to the
    tree's leaves."""
    return torch.func.functional_call(model, _flat_params(model, params), (img,),
                                      {"train": train})


def model_device(device) -> torch.device:
    """The device a model is built on: the card unless the caller names
    another.  Raises when the card is asked for and there is none, rather
    than leaving the model, and every kernel wrapper after it, on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but no CUDA device is available: the port's models are "
            "built on the card unless asked otherwise; pass device='cpu' to build on the CPU")
    return dev


class Dense(nn.Module):
    """``x @ kernel (+ bias)`` in the compute dtype (flax ``nn.Dense``)."""

    def __init__(self, cfg: ViTConfig, din: int, dout: int, use_bias: bool = True):
        super().__init__()
        self.config = cfg
        self.kernel = _param((din, dout), cfg)
        self.bias = _param((dout,), cfg) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.config.dtype
        y = x.to(dt) @ self.kernel.to(dt)
        return y + self.bias.to(dt) if self.bias is not None else y


class Attention(nn.Module):
    """Fused-QKV multi-head self-attention; with ``kernel_mode="pallas"`` the
    softmax chain runs on the ``sdpa`` kernel (K13)."""

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
        dt = cfg.dtype
        b_qkv = self.qkv_bias.to(dt) if self.qkv_bias is not None else None
        fn = fused_attention.attention if cfg.kernel_mode == "pallas" else attention_xla
        return fn(x.to(dt), self.qkv_kernel.to(dt), b_qkv, self.out_kernel.to(dt),
                  self.out_bias.to(dt), self.heads, self.head_dim)


class FeedForward(nn.Module):
    """Dense(hidden, gelu) -> Dense(dim); with ``kernel_mode="pallas"`` (and
    any ``act`` but ``"relu"``, as in the reference) both run in the ``mlp``
    kernel (K14)."""

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
        dt = cfg.dtype
        weights = (self.fc1_kernel.to(dt), self.fc1_bias.to(dt), self.fc2_kernel.to(dt),
                   self.fc2_bias.to(dt))
        if cfg.kernel_mode == "pallas" and cfg.act != "relu":
            return fused_mlp.mlp(x.to(dt), *weights, approx_gelu=cfg.gelu_approx)
        return mlp_block(x.to(dt), *weights, get_act(cfg))


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

    def _drop(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        p = self.config.dropout_rate
        return F.dropout(x, p, training=True) if train and p > 0 else x

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Dropout applies with ``train=True`` only, as in the Flax block."""
        if self.config.reference_residual:
            h = self.ln1(x)
            x = self._drop(self.attn(h), train) + h
            h = self.ln2(x)
            return self._drop(self.ffn(h), train) + h
        x = x + self._drop(self.attn(self.ln1(x)), train)
        return x + self._drop(self.ffn(self.ln2(x)), train)


def _remat_block(blk: EncoderBlock, x: torch.Tensor, train: bool) -> torch.Tensor:
    """``blk(x, train)`` under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward, one block at a time (``cfg.remat``, Flax's
    ``nn.remat``).  The block's parameters enter the checkpoint as inputs, so
    the recompute sees the tensors the forward saw, under
    :func:`apply_params` (``functional_call``) too."""
    names, tensors = zip(*blk.named_parameters())

    def run(x_, *ts):
        return torch.func.functional_call(blk, dict(zip(names, ts)), (x_, train))

    return torch.utils.checkpoint.checkpoint(run, x, *tensors, use_reentrant=False)


class ViT(nn.Module):
    """Vision Transformer encoder + classifier.

    Parameters are created on the CPU, initialised from ``generator`` (the
    Flax initialisers: xavier-uniform kernels, lecun-normal head kernels,
    normal(0.02) cls / position embeddings, zero biases, unit LN scales),
    then moved to ``device``: the card unless the caller names another
    (:func:`model_device`).
    """

    def __init__(self, cfg: ViTConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        device = model_device(device)
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
                lecun_normal_(prm, gen)
            elif prm.dim() == 2:
                xavier_uniform_(prm, gen)
            else:
                prm.zero_()

    def blocks(self) -> list:
        return [getattr(self, f"block_{i}") for i in range(self.config.depth)]

    def params(self) -> dict:
        """The parameters as a nested dict keyed as the Flax tree."""
        return nested_tree(self.named_parameters())

    def forward(self, img: torch.Tensor, train: bool = False) -> torch.Tensor:
        """``model.apply(variables, img, train)``: dropout only with
        ``train=True``; with ``cfg.remat`` and grad mode on, each block is
        recomputed in the backward (:func:`_remat_block`)."""
        cfg = self.config
        dt = cfg.dtype
        x = patch_embed(img.to(dt), self.patch_kernel.to(dt),
                        self.patch_bias.to(dt), cfg.patch_size)
        cls = self.cls_token.to(dt).expand(x.shape[0], 1, cfg.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(dt)
        remat = cfg.remat and torch.is_grad_enabled()
        for blk in self.blocks():
            x = _remat_block(blk, x, train) if remat else blk(x, train)
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


def get_deit_tiny(style: str = "standard", *, device="cuda", generator=None,
                  **kw) -> ViT:
    return ViT(deit_config("tiny", style, **kw), device=device, generator=generator)


def get_deit_small(style: str = "standard", *, device="cuda", generator=None,
                   **kw) -> ViT:
    return ViT(deit_config("small", style, **kw), device=device, generator=generator)


def get_deit_base(style: str = "standard", *, device="cuda", generator=None,
                  **kw) -> ViT:
    return ViT(deit_config("base", style, **kw), device=device, generator=generator)


def pruned_vit_config(size: str = "tiny", prune_encoding: str = "all_head12_ffn1.0",
                      head_dim: int | None = 64, style: str = "standard",
                      **overrides) -> ViTConfig:
    """A pruned DeiT's config: static per-layer heads and MLP widths from
    ``prune_encoding`` (``config.decode_prune_encoding``).  Pruned models
    keep a head size of 64 whatever the unpruned dim and heads, as the
    reference does; ``head_dim`` overrides it."""
    base = deit_config(size, style, **overrides)
    heads_per_layer, mlp_per_layer = decode_prune_encoding(prune_encoding, base.depth,
                                                           base.mlp_dim)
    return base.replace(heads_per_layer=heads_per_layer, mlp_dim_per_layer=mlp_per_layer,
                        head_dim=head_dim)


def get_pruned_vit(*, device="cuda", generator=None, **kw) -> ViT:
    return ViT(pruned_vit_config(**kw), device=device, generator=generator)


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


def prepare_vit_fused(model: ViT, pack_layers: bool = False) -> dict:
    """The encoder params stacked ``[L, ...]`` in the compute dtype, as
    :func:`fused_vit_apply` consumes them.  Build once and pass as
    ``stacked=`` to keep the stack and cast out of every forward.

    Layerwise-pruned models return ``{"segments": [stack, ...]}``, one per
    uniform run of layers, or with ``pack_layers`` one zero-padded uniform
    stack of every layer (``stack_vit_layer_params_packed``)."""
    from ..ops.cuda.fused_encoder import stack_vit_layer_params, stack_vit_layer_params_packed

    cfg = model.config
    p = model.params()
    segs = encoder_segments(cfg)
    if pack_layers and len(segs) > 1:
        stacks = [stack_vit_layer_params_packed(
            p, [cfg.layer_heads(i) for i in range(cfg.depth)],
            [cfg.layer_mlp_dim(i) for i in range(cfg.depth)], cfg.resolved_head_dim,
            cfg.qkv_bias)]
    else:
        stacks = [stack_vit_layer_params(p, d, cfg.qkv_bias, start=s) for s, d, _, _ in segs]
    stacks = [{k: v.to(cfg.dtype).contiguous() for k, v in st.items()} for st in stacks]
    return stacks[0] if len(stacks) == 1 else {"segments": stacks}


def _check_fused(cfg: ViTConfig) -> list:
    """The encoder segments (:func:`encoder_segments`) of a model the fused
    encoders take; raise for the NoNorm / ReLU models they do not."""
    if cfg.norm_mode != "layernorm" or cfg.act != "gelu":
        # transitions-compiled (NoNorm / ReLU) models: the kernels compute
        # real LayerNorm + GELU
        raise ValueError(
            "fused encoder supports norm_mode='layernorm' + act='gelu' only; "
            f"got norm_mode={cfg.norm_mode!r}, act={cfg.act!r} (use model(img))"
        )
    return encoder_segments(cfg)


def _segment_stacks(stacked: dict, segments: list, what: str, prepare: str) -> list:
    """The per-segment stacks of a uniform or ``{"segments": [...]}`` stack;
    raise when their number is not the config's."""
    stacks = stacked["segments"] if "segments" in stacked else [stacked]
    if len(stacks) != len(segments):
        raise ValueError(f"{what} has {len(stacks)} segment(s) but the config segments into "
                         f"{len(segments)}: re-run {prepare} for this model")
    return stacks


def _fused_embed(cfg: ViTConfig, p: dict, img: torch.Tensor) -> torch.Tensor:
    dt = cfg.dtype
    x = patch_embed(img.to(dt), p["patch_kernel"].to(dt), p["patch_bias"].to(dt),
                    cfg.patch_size)
    cls = p["cls_token"].to(dt).expand(x.shape[0], 1, cfg.dim)
    return torch.cat([cls, x], dim=1) + p["pos_embedding"].to(dt)


def _fused_head(cfg: ViTConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = cfg.dtype
    if cfg.final_norm:
        x = layer_norm(x, p["final_norm"]["scale"], p["final_norm"]["bias"],
                       cfg.layernorm_eps)
    x = x[:, 0]
    if cfg.mlp_head:
        h = x @ p["head_fc1"]["kernel"].to(dt) + p["head_fc1"]["bias"].to(dt)
        h = get_gelu(cfg.gelu_approx)(h)
        return h @ p["head_fc2"]["kernel"].to(dt) + p["head_fc2"]["bias"].to(dt)
    return x @ p["head"]["kernel"].to(dt) + p["head"]["bias"].to(dt)


def fused_vit_apply(model: ViT, img: torch.Tensor, *, stacked: dict | None = None,
                    pack_layers: bool | None = None, plain: bool = False) -> torch.Tensor:
    """Forward pass with the encoder on the hand-written kernels
    (``ops/cuda/fused_encoder.encoder_forward``); the same params and
    result as ``model(img)``.

    Patch embedding, the cls / position add, the final LayerNorm and the
    head stay plain tensor ops, as they stay outside the kernel in the
    reference.  A layerwise-pruned model runs one encoder chain per uniform
    run of layers, each with its own heads, or with ``pack_layers`` one
    chain over a zero-padded uniform stack (exact: padded heads and MLP
    units contribute zeros); the default never packs, as in the reference.
    The reference's choice among its TPU kernel variants is a VMEM budget,
    so one CUDA chain serves every segment.  ``stacked`` is
    :func:`prepare_vit_fused`'s output for the same ``pack_layers`` (built
    here when omitted).  ``plain=True`` runs the kernels' plain twins on any
    device: the reference the kernel path is checked against on the GPU.
    """
    from ..ops.cuda.fused_encoder import encoder_forward, encoder_forward_plain

    cfg = model.config
    segments = _check_fused(cfg)
    pack = bool(pack_layers) and len(segments) > 1
    if stacked is None:
        stacked = prepare_vit_fused(model, pack_layers=pack)
    if pack:
        hmax = max(s[2] for s in segments)
        if "segments" in stacked or stacked["qkv_w"].shape[0] != cfg.depth:
            raise ValueError("pack_layers=True takes one packed stack of every layer: "
                             "re-run prepare_vit_fused(model, pack_layers=True)")
        runs = [(hmax, stacked)]
    else:
        runs = [(heads, st) for (_, _, heads, _), st in zip(
            segments, _segment_stacks(stacked, segments, "stacked", "prepare_vit_fused"))]
    p = model.params()
    x = _fused_embed(cfg, p, img)
    encoder = encoder_forward_plain if plain else encoder_forward
    for heads, st in runs:
        x = encoder(x, st, heads=heads, head_dim=cfg.resolved_head_dim,
                    eps=cfg.layernorm_eps, reference_residual=cfg.reference_residual,
                    approx_gelu=cfg.gelu_approx)
    return _fused_head(cfg, p, x)


def _check_full(cfg: ViTConfig) -> None:
    if cfg.mlp_head or cfg.heads_per_layer is not None or cfg.mlp_dim_per_layer is not None:
        raise ValueError("fully-fused path requires standard head + uniform layers")


def prepare_vit_full(model: ViT) -> dict:
    """Everything :func:`fully_fused_vit_apply` reads, built once in the
    compute dtype on the model's device: the encoder stack
    (``stack_vit_layer_params``), ``patch_w``, ``embed_bias`` (row 0 ``pos[0]
    + cls``, the others ``pos[1:] + patch_bias``, added in the compute dtype
    as the reference folds them), ``fnorm_g`` / ``fnorm_b`` (ones and zeros
    without a final norm), ``head_w`` and ``head_b``."""
    from ..ops.cuda.fused_encoder import stack_vit_layer_params

    cfg = model.config
    _check_full(cfg)
    dt = cfg.dtype
    p = model.params()
    out = stack_vit_layer_params(p, cfg.depth, cfg.qkv_bias)
    pos = p["pos_embedding"].to(dt)
    embed_bias = torch.cat([pos[:1] + p["cls_token"].to(dt)[0],
                            pos[1:] + p["patch_bias"].to(dt)])
    if cfg.final_norm:
        fg, fb = p["final_norm"]["scale"], p["final_norm"]["bias"]
    else:
        fg, fb = torch.ones_like(p["patch_bias"]), torch.zeros_like(p["patch_bias"])
    out.update(patch_w=p["patch_kernel"], embed_bias=embed_bias, fnorm_g=fg, fnorm_b=fb,
               head_w=p["head"]["kernel"], head_b=p["head"]["bias"])
    return {k: v.to(dt).contiguous() for k, v in out.items()}


def fully_fused_vit_apply(model: ViT, img: torch.Tensor, *, prepared: dict | None = None,
                          batch_block: int | None = None, plain: bool = False) -> torch.Tensor:
    """Forward pass as one kernel launch (``ops/cuda/fused_vit_full.vit_full_forward``):
    patch embedding, the encoder, the final LayerNorm and the head, reading
    the NCHW image (fp32 or bf16) and writing the logits in the compute
    dtype.  The same params as ``model(img)``.

    Standard-style models with uniform layers only, as in the reference: a
    two-layer head or per-layer heads or widths raise ``ValueError``.  Like
    the reference kernel it computes LayerNorm and GELU whatever the
    config's ``norm_mode`` and ``act``.  ``batch_block`` is the reference's
    TPU blocking (images per program); it is validated and does not change
    the result, since the CUDA kernel's grid is the card's resident blocks.
    ``prepared`` is :func:`prepare_vit_full`'s output (built here when
    omitted); ``plain=True`` runs the kernel's plain twin on any device."""
    from ..ops.cuda.fused_vit_full import vit_full_forward, vit_full_forward_plain

    cfg = model.config
    _check_full(cfg)
    if batch_block is not None and (isinstance(batch_block, bool)
                                    or not isinstance(batch_block, int) or batch_block < 1):
        raise ValueError(f"batch_block must be a positive int, got {batch_block!r}")
    if prepared is None:
        prepared = prepare_vit_full(model)
    forward = vit_full_forward_plain if plain else vit_full_forward
    return forward(img, prepared, heads=cfg.heads, head_dim=cfg.resolved_head_dim,
                   eps=cfg.layernorm_eps, reference_residual=cfg.reference_residual,
                   approx_gelu=cfg.gelu_approx, final_norm=cfg.final_norm)


# ---------------------------------------------------------------------------
# Int8
# ---------------------------------------------------------------------------

# fused_vit_apply_int8's variants: the reference picks its TPU kernel by
# VMEM size; one CUDA encoder serves all three.
INT8_VARIANTS = ("auto", "streamed", "pipelined")


def prepare_vit_int8(model: ViT, variables: dict | None = None) -> dict:
    """Quantize the encoder stack to int8 once (per-layer, per-output-channel
    scales) for :func:`fused_vit_apply_int8`.  The LN affines and biases stay
    in the params' dtype (fp32), as in the reference.

    ``variables`` defaults to ``model.params()``.  Layerwise-pruned models
    return ``{"segments": [stack, ...]}``, one per uniform run of layers."""
    from ..ops.cuda.fused_encoder import quantize_stacked_int8, stack_vit_layer_params

    cfg = model.config
    p = model.params() if variables is None else variables.get("params", variables)
    segs = encoder_segments(cfg)
    stacks = [quantize_stacked_int8(stack_vit_layer_params(p, d, cfg.qkv_bias, start=s))
              for s, d, _, _ in segs]
    return stacks[0] if len(stacks) == 1 else {"segments": stacks}


def prepare_vit_int8_static(model: ViT, variables: dict | None = None, act_scales=None,
                            calib_batches=None, percentile: float | None = None,
                            method: str = "absmax") -> dict:
    """Static int8 prep: calibrate the activation scales on representative
    data (``ops/quant.calibrate_vit``, unless ``act_scales [depth, 4]`` is
    given) and fold them into the quantized stack, which then carries
    ``act_inv``.  Same shapes of result as :func:`prepare_vit_int8`."""
    from ..ops.cuda.fused_encoder import (quantize_stacked_int8_static,
                                          stack_vit_layer_params)
    from ..ops.quant import calibrate_vit

    cfg = model.config
    p = model.params() if variables is None else variables.get("params", variables)
    if act_scales is None:
        act_scales = calibrate_vit(model, p, batches=calib_batches,
                                   percentile=percentile, method=method)
    act_scales = np.asarray(act_scales, np.float32)
    segs = encoder_segments(cfg)
    stacks = [quantize_stacked_int8_static(
        stack_vit_layer_params(p, d, cfg.qkv_bias, start=s), act_scales[s:s + d])
        for s, d, _, _ in segs]
    return stacks[0] if len(stacks) == 1 else {"segments": stacks}


def stacks_from_quantized_tree(cfg: ViTConfig, qtree: dict) -> dict:
    """Rebuild the int8 stacks from a quantized param tree
    (``ops/quant.quantize_vit_params_int8[_static]`` output): pure
    re-stacking, as in the reference.  Like the reference, the float glue
    (LN affines, biases) is cast to ``cfg.dtype``, so the result equals
    :func:`prepare_vit_int8[_static]`'s bit for bit only for fp32 configs."""
    p = qtree.get("params", qtree)
    mats = (("qkv_w", "attn", "qkv_kernel"), ("out_w", "attn", "out_kernel"),
            ("fc1_w", "ffn", "fc1_kernel"), ("fc2_w", "ffn", "fc2_kernel"))

    def one_segment(start: int, depth: int) -> dict:
        blocks = [p[f"block_{i}"] for i in range(start, start + depth)]

        def stack(getter):
            out = torch.stack([torch.as_tensor(getter(b)) for b in blocks])
            return out[:, None, :] if out.dim() == 2 else out

        q0 = torch.as_tensor(blocks[0]["attn"]["qkv_kernel"]["q"])
        stacked = {
            "ln1_g": stack(lambda b: b["ln1"]["scale"]),
            "ln1_b": stack(lambda b: b["ln1"]["bias"]),
            "qkv_b": stack(lambda b: b["attn"]["qkv_bias"]) if cfg.qkv_bias
            else torch.zeros((depth, 1, q0.shape[1]), dtype=torch.float32, device=q0.device),
            "out_b": stack(lambda b: b["attn"]["out_bias"]),
            "ln2_g": stack(lambda b: b["ln2"]["scale"]),
            "ln2_b": stack(lambda b: b["ln2"]["bias"]),
            "fc1_b": stack(lambda b: b["ffn"]["fc1_bias"]),
            "fc2_b": stack(lambda b: b["ffn"]["fc2_bias"]),
        }
        static = "act_scale" in blocks[0]["attn"]["qkv_kernel"]
        act_inv = np.ones((depth, 4), np.float32)
        for j, (key, sub, leaf) in enumerate(mats):
            stacked[key] = stack(lambda b: b[sub][leaf]["q"]).to(torch.int8)
            stacked[key.replace("_w", "_s")] = stack(lambda b: b[sub][leaf]["scale"]).float()
            if static:
                for li, b in enumerate(blocks):
                    act_inv[li, j] = 1.0 / float(b[sub][leaf]["act_scale"])
        if static:
            stacked["act_inv"] = torch.from_numpy(act_inv).to(q0.device)
        for k in ("ln1_g", "ln1_b", "ln2_g", "ln2_b", "qkv_b", "out_b", "fc1_b", "fc2_b"):
            stacked[k] = stacked[k].to(cfg.dtype)
        return stacked

    segs = encoder_segments(cfg)
    if len(segs) == 1:
        return one_segment(0, cfg.depth)
    return {"segments": [one_segment(s, d) for s, d, _, _ in segs]}


def fused_vit_apply_int8(model: ViT, img: torch.Tensor, *, stacked_q: dict | None = None,
                         variant: str = "auto", plain: bool = False) -> torch.Tensor:
    """Forward pass with the int8 encoder on the hand-written kernels
    (``ops/cuda/fused_encoder.encoder_forward_int8``).

    With a :func:`prepare_vit_int8` stack: dynamic-range semantics (per-row
    activation scales, per-channel weight scales, ``ops/quant.int8_vit_apply``).
    With a :func:`prepare_vit_int8_static` stack: calibrated per-tensor
    activation scales.  Embedding and head stay float, in ``cfg.dtype``.
    ``stacked_q`` is built with :func:`prepare_vit_int8` when omitted; a
    layerwise-pruned model takes its ``{"segments": [...]}`` form and runs
    one int8 chain per uniform run of layers.  ``variant`` is one of
    :data:`INT8_VARIANTS` (all take the one encoder); ``plain=True`` runs
    the kernels' plain twins on any device."""
    from ..ops.cuda.fused_encoder import encoder_forward_int8, encoder_forward_int8_plain

    cfg = model.config
    if variant not in INT8_VARIANTS:
        raise ValueError(f"unknown int8 variant {variant!r}; one of {INT8_VARIANTS}")
    segments = _check_fused(cfg)
    if stacked_q is None:
        stacked_q = prepare_vit_int8(model)
    stacks = _segment_stacks(stacked_q, segments, "stacked_q", "prepare_vit_int8[_static]")
    p = model.params()
    x = _fused_embed(cfg, p, img)
    encoder = encoder_forward_int8_plain if plain else encoder_forward_int8
    for (_, _, heads, _), sq in zip(segments, stacks):
        x = encoder(x, sq, heads=heads, head_dim=cfg.resolved_head_dim,
                    eps=cfg.layernorm_eps, reference_residual=cfg.reference_residual,
                    approx_gelu=cfg.gelu_approx)
    return _fused_head(cfg, p, x)
