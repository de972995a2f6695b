"""Swin Transformer as PyTorch modules (port of ``edgevisiontransformer_tpu/models/swin.py``).

Patch embedding, stages of pre-norm blocks that attend within (shifted)
windows with a relative-position bias, patch merging between stages, a
final LayerNorm, a mean pool and a linear head.  Parameters keep the Flax
names and layouts (:meth:`SwinTransformer.params`); the Flax ``constants``
collection, each block's ``attn.relative_position_index`` and each shifted
block's ``attn_mask``, are buffers (:meth:`SwinTransformer.constants`).
With ``kernel_mode="pallas"`` the module's window attention runs on the
hand-written kernel ``ops/cuda/window_sdpa.window_sdpa`` (the TPU kernel
K12).

:func:`fused_swin_apply` is the inference path: every stage on the
hand-written kernels (``ops/cuda/swin_block.swin_stage_forward``, or
``swin_stage_forward_int8`` for the stages of an int8 stack) and patch
merging on ``ops/cuda/swin_merge.swin_merge``, with the constants built once
by :func:`prepare_swin_fused` and the int8 stacks by
:func:`prepare_swin_int8[_static] <prepare_swin_int8_static>`.  Static
scales come from :func:`calibrate_swin`, which runs the module forward with
a collector of the matmul inputs (the JAX modules' ``acts``, ``acts_full``
and ``acts_ch`` sows); :func:`smooth_swin` migrates activation outliers
into the weights first.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Callable, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.activations import get_gelu
from ..ops.layers import layer_norm, mlp_block, patch_embed
from ..ops.quant import MSE_CLIP_RATIOS, _smooth_s, representative_batches
from ..utils.jax_bridge import flatten_tree
from .vit import Dense, _param, lecun_normal_, model_device, nested_tree, xavier_uniform_

# collect(key, activation): what a forward hands each matmul input to, keyed
# "qkv_in", "proj_in", "fc1_in", "fc2_in" (the JAX modules' sow names)
Collect = Callable[[str, torch.Tensor], None]

_LOG2E = 1.4426950408889634


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """The JAX ``SwinConfig``'s fields and defaults, with torch dtypes."""

    image_size: int = 224
    patch_size: int = 4
    in_channels: int = 3
    num_classes: int = 1000
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    layernorm_eps: float = 1e-5
    gelu_approx: bool = False
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    kernel_mode: str = "xla"
    # fp32 softmax (the default) or softmax in the compute dtype
    softmax_fp32: bool = True
    # The JAX module's block-diagonal packing of p windows per attention
    # product, a TPU tiling choice: the port computes the same function
    # unpacked for any value.
    window_pack: int = 1

    def replace(self, **kw) -> "SwinConfig":
        return dataclasses.replace(self, **kw)


_SWIN_SHAPES = {
    "tiny": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "small": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "base": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
}


def swin_config(size: str = "tiny", **overrides) -> SwinConfig:
    return SwinConfig(**{**_SWIN_SHAPES[size], **overrides})


# ---------------------------------------------------------------------------
# Window tables (numpy, as in the JAX package, so both build the same ones)
# ---------------------------------------------------------------------------


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[b, H, W, c] -> [b*nW, w*w, c]."""
    b, h, ww_, c = x.shape
    x = x.reshape(b, h // w, w, ww_ // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def window_reverse(windows: torch.Tensor, w: int, h: int, ww_: int) -> torch.Tensor:
    """[b*nW, w*w, c] -> [b, H, W, c]."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // w) * (ww_ // w))
    x = windows.reshape(b, h // w, ww_ // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, ww_, c)


def relative_position_index(w: int) -> np.ndarray:
    """Constant [w*w, w*w] index into the (2w-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    coords = coords.reshape(2, -1)  # [2, w*w]
    rel = coords[:, :, None] - coords[:, None, :]  # [2, w*w, w*w]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int32)


def shifted_window_mask(h: int, ww_: int, w: int, shift: int) -> np.ndarray:
    """Constant additive mask [nW, w*w, w*w] for shifted windows (0 / -100)."""
    img_mask = np.zeros((h, ww_), np.float32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img_mask[hs, ws] = cnt
            cnt += 1
    mw = img_mask.reshape(h // w, w, ww_ // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    attn_mask = mw[:, None, :] - mw[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class WindowAttention(nn.Module):
    """W-MSA / SW-MSA with the relative position bias, on windows
    ``[b*nW, n, dim]``.  ``cfg.window_pack`` is accepted and computes the
    unpacked function (the JAX module's packing changes only how the TPU
    tiles the products).  ``kernel_mode="pallas"`` runs the attention core
    on ``window_sdpa`` (K12's math: fp32 scale, bias in the compute dtype,
    max-subtracted softmax)."""

    def __init__(self, cfg: SwinConfig, dim: int, heads: int):
        super().__init__()
        self.config, self.dim, self.heads = cfg, dim, heads
        w = cfg.window_size
        self.qkv = Dense(cfg, dim, 3 * dim, use_bias=cfg.qkv_bias)
        self.relative_position_bias_table = _param(((2 * w - 1) ** 2, heads), cfg)
        self.proj = Dense(cfg, dim, dim)
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(w)))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None,
                collect: Collect | None = None) -> torch.Tensor:
        """``collect``, when given, receives the qkv and proj inputs."""
        cfg = self.config
        n = cfg.window_size ** 2
        hd = self.dim // self.heads
        bw = x.shape[0]
        if collect is not None:
            collect("qkv_in", x)
        qkv = self.qkv(x)
        rpi = self.relative_position_index.reshape(-1).long()
        bias = self.relative_position_bias_table[rpi].reshape(n, n, self.heads).permute(2, 0, 1)
        if cfg.kernel_mode == "pallas":
            from ..ops.cuda.window_sdpa import window_sdpa

            out = window_sdpa(qkv, bias.to(cfg.dtype).contiguous(), mask, heads=self.heads,
                              head_dim=hd)
            if collect is not None:
                collect("proj_in", out)
            return self.proj(out)
        qkv = qkv.reshape(bw, n, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * hd ** -0.5) @ k.transpose(-1, -2)
        attn = attn + bias[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(bw // nw, nw, self.heads, n, n) + mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(bw, self.heads, n, n)
        if cfg.softmax_fp32:
            attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        else:
            attn = torch.softmax(attn, dim=-1)
        out = (attn @ v).permute(0, 2, 1, 3).reshape(bw, n, self.dim)
        if collect is not None:
            collect("proj_in", out)
        return self.proj(out)


class SwinBlock(nn.Module):
    """``x + attn(LN x)`` over (shifted) windows, then ``x + mlp(LN x)``."""

    def __init__(self, cfg: SwinConfig, dim: int, heads: int, resolution: int, shift: int):
        super().__init__()
        self.config, self.resolution = cfg, resolution
        self.window = min(cfg.window_size, resolution)
        self.shift = shift if self.window < resolution else 0
        hidden = int(dim * cfg.mlp_ratio)
        self.ln1_scale, self.ln1_bias = _param((dim,), cfg), _param((dim,), cfg)
        self.ln2_scale, self.ln2_bias = _param((dim,), cfg), _param((dim,), cfg)
        self.attn = WindowAttention(cfg, dim, heads)
        self.mlp_fc1_kernel, self.mlp_fc1_bias = _param((dim, hidden), cfg), _param((hidden,), cfg)
        self.mlp_fc2_kernel, self.mlp_fc2_bias = _param((hidden, dim), cfg), _param((dim,), cfg)
        if self.shift > 0:
            self.register_buffer("attn_mask", torch.from_numpy(
                shifted_window_mask(resolution, resolution, self.window, self.shift)))

    def forward(self, x: torch.Tensor, collect: Collect | None = None) -> torch.Tensor:
        """``collect``, when given, receives the four matmul inputs; the fc2
        input is recomputed as ``gelu(xn @ w1 + b1)`` in the compute dtype,
        as the JAX module's sow does."""
        cfg = self.config
        dt = cfg.dtype
        h, w, s = self.resolution, self.window, self.shift
        b, n, c = x.shape
        xn = layer_norm(x, self.ln1_scale, self.ln1_bias, cfg.layernorm_eps).reshape(b, h, h, c)
        if s > 0:
            xn = torch.roll(xn, (-s, -s), (1, 2))
        attn = self.attn(window_partition(xn, w), self.attn_mask if s > 0 else None, collect)
        xn = window_reverse(attn, w, h, h)
        if s > 0:
            xn = torch.roll(xn, (s, s), (1, 2))
        x = x + xn.reshape(b, n, c)
        xn = layer_norm(x, self.ln2_scale, self.ln2_bias, cfg.layernorm_eps)
        w1, b1 = self.mlp_fc1_kernel.to(dt), self.mlp_fc1_bias.to(dt)
        if collect is not None:
            collect("fc1_in", xn)
            collect("fc2_in", get_gelu(cfg.gelu_approx)(xn @ w1 + b1))
        return x + mlp_block(xn, w1, b1, self.mlp_fc2_kernel.to(dt), self.mlp_fc2_bias.to(dt),
                             get_gelu(cfg.gelu_approx))


class PatchMerging(nn.Module):
    """Downsample 2x: concatenate each 2x2 neighbourhood (the reference's
    ``[x0; x1; x2; x3]`` order), LayerNorm, Dense(2C) without bias."""

    def __init__(self, cfg: SwinConfig, dim: int, resolution: int):
        super().__init__()
        self.config, self.resolution = cfg, resolution
        self.norm_scale, self.norm_bias = _param((4 * dim,), cfg), _param((4 * dim,), cfg)
        self.reduction = Dense(cfg, 4 * dim, 2 * dim, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.resolution
        b, n, c = x.shape
        x = x.reshape(b, h, h, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1).reshape(b, n // 4, 4 * c)
        x = layer_norm(x, self.norm_scale, self.norm_bias, self.config.layernorm_eps)
        return self.reduction(x)


class SwinTransformer(nn.Module):
    """Swin Transformer; ``model(img)`` has ``model.apply``'s semantics.

    Parameters are created on the CPU, initialised from ``generator`` as the
    Flax initialisers do (lecun-normal Dense kernels, xavier-uniform patch
    and MLP kernels, normal(0.02) bias tables, zero biases, unit norm
    scales), then moved to ``device``: the card unless the caller names
    another (``models/vit.model_device``)."""

    def __init__(self, cfg: SwinConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        device = model_device(device)
        self.config = cfg
        p, dim, res = cfg.patch_size, cfg.embed_dim, cfg.image_size // cfg.patch_size
        self.patch_kernel = _param((p * p * cfg.in_channels, dim), cfg)
        self.patch_bias = _param((dim,), cfg)
        self.embed_norm_scale, self.embed_norm_bias = _param((dim,), cfg), _param((dim,), cfg)
        for si, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
            for bi in range(depth):
                self.add_module(f"stage_{si}_block_{bi}", SwinBlock(
                    cfg, dim, heads, res, shift=0 if bi % 2 == 0 else cfg.window_size // 2))
            if si < len(cfg.depths) - 1:
                self.add_module(f"downsample_{si}", PatchMerging(cfg, dim, res))
                dim, res = 2 * dim, res // 2
        self.final_norm_scale, self.final_norm_bias = _param((dim,), cfg), _param((dim,), cfg)
        self.head = Dense(cfg, dim, cfg.num_classes)
        self._init_params(generator)
        self.eval()
        self.to(device)

    @torch.no_grad()
    def _init_params(self, gen: torch.Generator | None) -> None:
        for name, prm in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "relative_position_bias_table":
                prm.normal_(0.0, 0.02, generator=gen)
            elif leaf.endswith("scale"):
                prm.fill_(1.0)
            elif leaf == "kernel":
                lecun_normal_(prm, gen)
            elif prm.dim() == 2:
                xavier_uniform_(prm, gen)
            else:
                prm.zero_()

    def params(self) -> dict:
        """The parameters as a nested dict keyed as the Flax ``params`` tree."""
        return nested_tree(self.named_parameters())

    def constants(self) -> dict:
        """The buffers as the Flax ``constants`` tree."""
        return nested_tree(self.named_buffers())

    def forward(self, img: torch.Tensor,
                collect: Callable[[str, str, torch.Tensor], None] | None = None) -> torch.Tensor:
        """``collect(block, key, activation)``, when given, receives every
        block's matmul inputs (``block`` is its name, ``"stage_0_block_1"``):
        what the JAX modules sow for calibration.  Nothing of it outlives the
        call; without it the forward computes as before."""
        cfg = self.config
        dt = cfg.dtype
        x = patch_embed(img.to(dt), self.patch_kernel.to(dt), self.patch_bias.to(dt),
                        cfg.patch_size)
        x = layer_norm(x, self.embed_norm_scale, self.embed_norm_bias, cfg.layernorm_eps)
        for si, depth in enumerate(cfg.depths):
            for bi in range(depth):
                name = f"stage_{si}_block_{bi}"
                x = getattr(self, name)(x, None if collect is None
                                        else functools.partial(collect, name))
            if si < len(cfg.depths) - 1:
                x = getattr(self, f"downsample_{si}")(x)
        x = layer_norm(x, self.final_norm_scale, self.final_norm_bias, cfg.layernorm_eps)
        return self.head(_mean_pool(x))


def _mean_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over the tokens, summed in fp32 and cast once, as ``jnp.mean``
    does for bf16."""
    return x.float().mean(dim=1).to(x.dtype)


def get_swin(size: str = "tiny", *, device="cuda", generator=None, **kw) -> SwinTransformer:
    return SwinTransformer(swin_config(size, **kw), device=device, generator=generator)


# ---------------------------------------------------------------------------
# The inference path
# ---------------------------------------------------------------------------

StageGeom = collections.namedtuple("StageGeom", "si depth heads w res dim n n_pad nwin hidden")


def _stage_geometry(cfg: SwinConfig, params: dict):
    """Per-stage geometry: the module's ``res //= 2`` progression, the
    window ``min(window_size, res)`` and its ``n``, ``nwin`` (0 when the
    window does not tile the map) and the MLP width.  ``n_pad`` is the TPU's
    row padding, kept so both packages list the same table."""
    res = cfg.image_size // cfg.patch_size
    dim = cfg.embed_dim
    for si, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
        w = min(cfg.window_size, res)
        n = w * w
        hidden = params[f"stage_{si}_block_0"]["mlp_fc1_kernel"].shape[1]
        yield StageGeom(si, depth, heads, w, res, dim, n, -(-n // 8) * 8,
                        (res // w) ** 2 if res % w == 0 else 0, hidden)
        res //= 2
        dim *= 2


def _merge_perm(c: int) -> np.ndarray:
    """Feature permutation mapping the (dy, dx, c) merge order onto the
    reference's concat order [x0; x1; x2; x3] = [(0,0); (1,0); (0,1); (1,1)],
    so the permuted params make both forms the same function."""
    k_of = {(0, 0): 0, (1, 0): 1, (0, 1): 2, (1, 1): 3}
    perm = np.empty(4 * c, np.int32)
    for dy in range(2):
        for dx in range(2):
            for ci in range(c):
                perm[dy * 2 * c + dx * c + ci] = k_of[(dy, dx)] * c + ci
    return perm


def _block_kernel_params(blk: dict, dim: int, dt: torch.dtype) -> dict:
    """One block's params as the chain takes them: matmul weights and biases
    in the compute dtype (a zero qkv bias without ``qkv_bias``), the
    LayerNorm affines as they are."""
    qkv = blk["attn"]["qkv"]
    w = qkv["kernel"]
    return {
        "ln1_g": blk["ln1_scale"], "ln1_b": blk["ln1_bias"],
        "qkv_w": w.to(dt),
        "qkv_b": qkv["bias"].to(dt) if "bias" in qkv else torch.zeros(3 * dim, dtype=dt,
                                                                       device=w.device),
        "proj_w": blk["attn"]["proj"]["kernel"].to(dt),
        "proj_b": blk["attn"]["proj"]["bias"].to(dt),
        "ln2_g": blk["ln2_scale"], "ln2_b": blk["ln2_bias"],
        "fc1_w": blk["mlp_fc1_kernel"].to(dt), "fc1_b": blk["mlp_fc1_bias"].to(dt),
        "fc2_w": blk["mlp_fc2_kernel"].to(dt), "fc2_b": blk["mlp_fc2_bias"].to(dt),
    }


def _stack_stage_params(p: dict, si: int, depth: int, dim: int, dt: torch.dtype) -> dict:
    """A stage's block params stacked on a leading ``[L]`` axis."""
    blocks = [_block_kernel_params(p[f"stage_{si}_block_{bi}"], dim, dt) for bi in range(depth)]
    return {k: torch.stack([b[k] for b in blocks]).contiguous() for k in blocks[0]}


@torch.no_grad()
def prepare_swin_fused(model: SwinTransformer) -> dict:
    """The constants of :func:`fused_swin_apply`, built once on the model's
    device so that a forward holds no host work:

    * ``stages[si]``: the block weights stacked in the compute dtype
      (:func:`_stack_stage_params`); ``bias``, per block the gathered
      relative-position bias ``[heads, n, n]`` in fp32 times log2(e) (one
      tensor each, as the kernel reads it); ``mask``, the shifted-window mask
      ``[nW, n, n]`` times log2(e) where odd blocks shift, else None;
    * ``merges[si]``: the patch-merging affine and reduction kernel
      permuted to the ``(dy, dx, c)`` feature order (the kernel in the
      compute dtype) and a zero bias for ``linear``."""
    cfg = model.config
    dt = cfg.dtype
    p = model.params()
    dev = model.patch_kernel.device
    stages = []
    for g in _stage_geometry(cfg, p):
        stage = _stack_stage_params(p, g.si, g.depth, g.dim, dt)
        rpi = torch.from_numpy(relative_position_index(g.w).reshape(-1)).long().to(dev)
        stage["bias"] = [
            (p[f"stage_{g.si}_block_{bi}"]["attn"]["relative_position_bias_table"][rpi]
             .reshape(g.n, g.n, g.heads).permute(2, 0, 1).float() * _LOG2E).contiguous()
            for bi in range(g.depth)]
        stage["mask"] = (torch.from_numpy(shifted_window_mask(g.res, g.res, g.w, g.w // 2))
                         .to(dev) * _LOG2E if g.nwin > 1 and g.depth > 1 else None)
        stages.append(stage)
    merges = []
    dim = cfg.embed_dim
    for si in range(len(cfg.depths) - 1):
        ds = p[f"downsample_{si}"]
        perm = torch.from_numpy(_merge_perm(dim)).long().to(dev)
        merges.append({
            "norm_scale": ds["norm_scale"][perm].contiguous(),
            "norm_bias": ds["norm_bias"][perm].contiguous(),
            "kernel": ds["reduction"]["kernel"][perm].to(dt).contiguous(),
            "bias": torch.zeros(2 * dim, dtype=dt, device=dev),
        })
        dim *= 2
    return {"stages": stages, "merges": merges}


# ---------------------------------------------------------------------------
# Int8: quantized stage stacks, calibration, SmoothQuant
# ---------------------------------------------------------------------------


def _params(model: SwinTransformer, variables: dict | None) -> dict:
    return model.params() if variables is None else variables.get("params", variables)


def _int8_stage_fits(g: StageGeom, dt: torch.dtype) -> bool:
    """K9's gate at int8 weights: the stages JAX makes int8 (see
    ``ops/cuda/swin_block.swin_stage_pipelined_fits``)."""
    from ..ops.cuda.swin_block import swin_stage_pipelined_fits

    return g.nwin >= 1 and swin_stage_pipelined_fits(g.dim, g.hidden, g.depth, 1, nwin=g.nwin,
                                                     n_pad=g.n_pad, heads=g.heads,
                                                     act_itemsize=dt.itemsize)


def _int8_stages(cfg: SwinConfig, p: dict, min_dim: int) -> list:
    """The geometry of the stages that become int8: at least ``min_dim``
    wide and admitted by K9's gate."""
    return [g for g in _stage_geometry(cfg, p)
            if g.dim >= min_dim and _int8_stage_fits(g, cfg.dtype)]


@torch.no_grad()
def prepare_swin_int8(model: SwinTransformer, variables: dict | None = None,
                      min_dim: int = 128) -> dict:
    """``{si: stack}``: the int8 stacks of the stages :func:`fused_swin_apply`
    runs in int8 (``int8_prepared=``), quantized once per layer and output
    channel (``fused_encoder.quantize_stacked_int8`` on the qkv, proj, fc1
    and fc2 weights, after their cast to ``cfg.dtype``).  LN affines stay as
    they are and biases in ``cfg.dtype`` (``linear_i8`` reads a bf16 bias).

    A stage qualifies when its width is at least ``min_dim`` (the JAX
    package measured stage 0 slower in int8 on the TPU and keeps it bf16)
    and K9's VMEM gate admits it at int8 weights: the same stages as the JAX
    ``prepare_swin_int8``, which fixes the model's mixed precision.
    ``variables`` defaults to ``model.params()``."""
    from ..ops.cuda.fused_encoder import quantize_stacked_int8
    from ..ops.cuda.swin_block import MATMUL_KEYS

    cfg = model.config
    p = _params(model, variables)
    return {g.si: quantize_stacked_int8(_stack_stage_params(p, g.si, g.depth, g.dim, cfg.dtype),
                                        keys=MATMUL_KEYS)
            for g in _int8_stages(cfg, p, min_dim)}


_ACT_NAMES = ("qkv_in", "proj_in", "fc1_in", "fc2_in")


def _batches(model: SwinTransformer, batches, n: int):
    cfg = model.config
    if batches is None:
        batches = representative_batches(n=n, shape=(cfg.in_channels, cfg.image_size,
                                                      cfg.image_size))
    return batches


def _collect_over(model: SwinTransformer, p: dict, batches, collect) -> None:
    """The module forward under the params ``p`` on every batch, handing
    each matmul input to ``collect(block, key, activation)``."""
    dev = model.patch_kernel.device
    flat = flatten_tree(p)
    with torch.no_grad():
        for batch in batches:
            img = torch.as_tensor(np.asarray(batch), device=dev)
            torch.func.functional_call(model, flat, (img,), {"collect": collect})


@torch.no_grad()
def calibrate_swin(model: SwinTransformer, variables: dict | None = None, batches=None,
                   n: int = 32, percentile=None, method: str = "absmax") -> dict:
    """Static int8 activation scales of every stage, ``{si: [depth, 4]}``
    fp32 in (qkv, proj, fc1, fc2) order: the largest ``|activation|`` of
    each matmul input over representative batches (``n`` random-normal
    images from the seed-0 stream unless ``batches`` is given), over 127.

    ``method="mse"`` runs the batches again and keeps, per tensor, the clip
    ``ratio * absmax`` (``ratio`` in ``MSE_CLIP_RATIOS``) whose int8
    quantization has the least summed mean squared error.  ``percentile``
    must be None: the JAX collections record the absmax only."""
    if percentile is not None:
        raise NotImplementedError("swin calibration records absmax only")
    if method not in ("absmax", "mse"):
        raise ValueError(f"unknown calibration method {method!r}")
    cfg = model.config
    p = _params(model, variables)
    batches = _batches(model, batches, n)
    if method == "mse":
        batches = list(batches)  # two passes
    run: dict = {}

    def absmax(block, key, a):
        m = a.float().abs().amax()
        run[block, key] = m if (block, key) not in run else torch.maximum(run[block, key], m)

    _collect_over(model, p, batches, absmax)
    msum: dict = {}
    if method == "mse":
        ratios = torch.tensor(MSE_CLIP_RATIOS, dtype=torch.float32,
                              device=model.patch_kernel.device)

        def mse(block, key, a):
            a = a.float()
            s = torch.clamp(run[block, key], min=1e-30) * ratios
            s = s / torch.full_like(s, 127.0)
            q = torch.clamp(torch.round(a[..., None] / s), -127, 127) * s
            e = torch.mean(torch.square(a[..., None] - q), dim=tuple(range(a.dim())))
            msum[block, key] = e if (block, key) not in msum else msum[block, key] + e

        _collect_over(model, p, batches, mse)
    out = {}
    for g in _stage_geometry(cfg, p):
        rows = np.ones((g.depth, 4), np.float32)
        for bi in range(g.depth):
            block = f"stage_{g.si}_block_{bi}"
            for j, name in enumerate(_ACT_NAMES):
                m = float(run[block, name])
                if msum and m > 0:
                    m *= MSE_CLIP_RATIOS[int(np.argmin(msum[block, name].cpu().numpy()))]
                rows[bi, j] = m / 127.0 if m > 0 else 1.0
        out[g.si] = rows
    return out


@torch.no_grad()
def smooth_swin(model: SwinTransformer, variables: dict | None = None, batches=None,
                n: int = 32, alpha: float = 0.5) -> dict:
    """SmoothQuant's offline scale migration for Swin: a new float params
    tree whose forward is the same function, with per-channel activation
    outliers moved into the weights (the JAX ``smooth_swin``).

    From the per-channel absmax of each matmul input over the batches,
    ``s = _smooth_s(act, max|W row|, alpha)``; then per block
    * qkv_in, fc1_in: ``1/s`` into the LN scale and bias, ``s`` into the
      qkv / fc1 kernel rows;
    * proj_in: ``1/s`` into the v columns ``[2C, 3C)`` of the qkv kernel
      (and bias), ``s`` into the proj kernel rows.
    fc2_in sits behind the GELU and is left to the calibration.  Feed the
    result to :func:`prepare_swin_int8_static` as ``variables``."""
    cfg = model.config
    p = _params(model, variables)
    run: dict = {}

    def channel_max(block, key, a):
        if key == "fc2_in":
            return
        m = a.float().abs().amax(dim=(0, 1))
        run[block, key] = m if (block, key) not in run else torch.maximum(run[block, key], m)

    _collect_over(model, p, _batches(model, batches, n), channel_max)

    def smooth(block, key, w):
        s = _smooth_s(run[block, key].cpu().numpy(), w.abs().amax(dim=1).cpu().numpy(), alpha)
        return torch.from_numpy(s).to(w.device)

    def fresh(tree):  # new dict containers, the same leaves
        return {k: fresh(v) if isinstance(v, dict) else v for k, v in tree.items()}

    out = dict(p)
    for g in _stage_geometry(cfg, p):
        for bi in range(g.depth):
            name = f"stage_{g.si}_block_{bi}"
            blk = fresh(p[name])
            attn = blk["attn"]
            qkv_w = attn["qkv"]["kernel"].float()
            s = smooth(name, "qkv_in", qkv_w)
            blk["ln1_scale"], blk["ln1_bias"] = blk["ln1_scale"] / s, blk["ln1_bias"] / s
            qkv_w = qkv_w * s[:, None]

            proj_w = attn["proj"]["kernel"].float()
            v0 = 2 * (qkv_w.shape[1] // 3)
            s = smooth(name, "proj_in", proj_w)
            inv = 1.0 / s
            qkv_w = torch.cat([qkv_w[:, :v0], qkv_w[:, v0:] * inv[None, :]], dim=1)
            if "bias" in attn["qkv"]:
                qb = attn["qkv"]["bias"].float()
                attn["qkv"]["bias"] = torch.cat([qb[:v0], qb[v0:] * inv])
            attn["qkv"]["kernel"] = qkv_w
            attn["proj"]["kernel"] = proj_w * s[:, None]

            fc1_w = blk["mlp_fc1_kernel"].float()
            s = smooth(name, "fc1_in", fc1_w)
            blk["ln2_scale"], blk["ln2_bias"] = blk["ln2_scale"] / s, blk["ln2_bias"] / s
            blk["mlp_fc1_kernel"] = fc1_w * s[:, None]
            out[name] = blk
    return out


@torch.no_grad()
def prepare_swin_int8_static(model: SwinTransformer, variables: dict | None = None,
                             batches=None, n: int = 32, min_dim: int = 128,
                             method: str = "absmax") -> dict:
    """:func:`prepare_swin_int8` with calibrated static activation scales
    (:func:`calibrate_swin`) folded into each stage's weight scales and
    exported inverted as ``act_inv [depth, 4]`` fp32, which the quantizer
    reads on the device.  Stages are chosen first: with none, the result is
    ``{}`` and no calibration runs."""
    from ..ops.cuda.fused_encoder import quantize_stacked_int8_static
    from ..ops.cuda.swin_block import MATMUL_KEYS

    cfg = model.config
    p = _params(model, variables)
    chosen = _int8_stages(cfg, p, min_dim)
    if not chosen:
        return {}
    act_scales = calibrate_swin(model, p, batches=batches, n=n, method=method)
    return {g.si: quantize_stacked_int8_static(
        _stack_stage_params(p, g.si, g.depth, g.dim, cfg.dtype), act_scales[g.si],
        keys=MATMUL_KEYS) for g in chosen}


def fused_swin_apply(model: SwinTransformer, img: torch.Tensor, *, prepared: dict | None = None,
                     int8_prepared: dict | None = None, plain: bool = False) -> torch.Tensor:
    """Forward pass with every stage on the hand-written kernels
    (``ops/cuda/swin_block.swin_stage_forward``: per block ``ln_rows``, four
    ``linear`` and ``window_attention``) and patch merging on ``swin_merge``
    + ``linear``; the same params and result as ``model(img)``.

    ``int8_prepared`` (:func:`prepare_swin_int8[_static]
    <prepare_swin_int8_static>`) runs each of its stages that K9's gate
    admits at int8 weights on ``swin_stage_forward_int8`` (per block
    ``ln_rows`` 2, ``quant_rows`` 4, ``linear_i8`` 4, ``window_attention``
    1), with the biases and masks of ``prepared``; every other stage, and
    every merge, stays in the compute dtype.  The JAX function re-checks the
    gate the same way.

    Tokens stay ``[b*res*res, C]`` rows in raster order from stage to stage;
    the windows exist only in the attention kernel's addressing.  Patch
    embedding, its LayerNorm, the final LayerNorm, the mean pool (summed in
    fp32) and the head are plain tensor ops.  ``prepared`` is
    :func:`prepare_swin_fused`'s output (built here when omitted).
    ``plain=True`` runs the kernels' plain twins on any device: the
    reference the kernel path is held to on the GPU.

    The JAX function's ``pallas_stages`` and ``merge_kernel`` choose between
    TPU kernels and XLA by what fits in VMEM; every stage here takes the one
    chain, so they have no counterpart."""
    from ..ops.cuda import swin_block as sb
    from ..ops.cuda.fused_encoder import CAST_THEN_BIAS, linear, linear_plain
    from ..ops.cuda.swin_merge import swin_merge, swin_merge_plain

    cfg = model.config
    dt = cfg.dtype
    p = model.params()
    geoms = list(_stage_geometry(cfg, p))
    for g in geoms:
        if g.nwin == 0:
            raise ValueError(f"stage {g.si}: window {g.w} does not tile the {g.res}x{g.res} "
                             "feature map (the reference cannot run it either)")
        if g.si < len(geoms) - 1 and g.res % 2:
            raise ValueError(f"stage {g.si}: patch merging needs an even resolution, "
                             f"got {g.res}")
    if prepared is None:
        prepared = prepare_swin_fused(model)
    stage_fn = sb.swin_stage_forward_plain if plain else sb.swin_stage_forward
    int8_fn = sb.swin_stage_forward_int8_plain if plain else sb.swin_stage_forward_int8
    merge_fn, lin = (swin_merge_plain, linear_plain) if plain else (swin_merge, linear)

    x = patch_embed(img.to(dt), p["patch_kernel"].to(dt), p["patch_bias"].to(dt),
                    cfg.patch_size)
    x = layer_norm(x, p["embed_norm_scale"], p["embed_norm_bias"], cfg.layernorm_eps)
    b = x.shape[0]
    x = x.reshape(-1, cfg.embed_dim)
    for g in geoms:
        stage = prepared["stages"][g.si]
        kw = dict(res=g.res, window=g.w, heads=g.heads, head_dim=g.dim // g.heads,
                  eps=cfg.layernorm_eps, approx_gelu=cfg.gelu_approx)
        if int8_prepared is not None and g.si in int8_prepared and _int8_stage_fits(g, dt):
            x = int8_fn(x, {**int8_prepared[g.si], "bias": stage["bias"], "mask": stage["mask"]},
                        **kw)
        else:
            x = stage_fn(x, stage, **kw)
        if g.si < len(geoms) - 1:
            m = prepared["merges"][g.si]
            x = merge_fn(x, m["norm_scale"], m["norm_bias"], res=g.res, eps=cfg.layernorm_eps)
            x = lin(x, m["kernel"], m["bias"], epilogue=CAST_THEN_BIAS)
    x = x.reshape(b, -1, x.shape[-1])
    x = layer_norm(x, p["final_norm_scale"], p["final_norm_bias"], cfg.layernorm_eps)
    return _mean_pool(x) @ p["head"]["kernel"].to(dt) + p["head"]["bias"].to(dt)
