"""Multi-head attention as plain tensor functions (port of
``edgevisiontransformer_tpu/ops/attention.py``): the eager path that
``ViT.forward`` uses.

The fused QKV axis is ordered (qkv, head, head_dim), as in the reference's
``Rearrange('b n (qkv h d) -> qkv b h n d')``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .activations import get_gelu
from .layers import layer_norm


def qkv_split(qkv: torch.Tensor, heads: int, head_dim: int):
    """``[b, n, 3*h*d]`` -> q, k, v of ``[b, h, n, d]``."""
    b, n, _ = qkv.shape
    qkv = qkv.reshape(b, n, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         scale: Optional[float] = None) -> torch.Tensor:
    """Scaled dot-product attention over ``[b, h, n, d]`` operands; softmax
    in fp32, probabilities cast back to the operand dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dots = (q @ k.transpose(-1, -2)) * scale
    attn = torch.softmax(dots.float(), dim=-1).to(q.dtype)
    return attn @ v


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``[b, h, n, d]`` -> ``[b, n, h*d]``."""
    b, h, n, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, n, h * d)


def attention_xla(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: Optional[torch.Tensor],
    w_out: torch.Tensor,
    b_out: Optional[torch.Tensor],
    heads: int,
    head_dim: int,
) -> torch.Tensor:
    """Full attention block ``[b, n, dim] -> [b, n, dim]``.

    ``w_qkv`` is ``[dim, 3*heads*head_dim]``; ``w_out`` is
    ``[heads*head_dim, dim]``.
    """
    qkv = x @ w_qkv
    if b_qkv is not None:
        qkv = qkv + b_qkv
    q, k, v = qkv_split(qkv, heads, head_dim)
    out = merge_heads(sdpa(q, k, v, scale=head_dim ** -0.5))
    out = out @ w_out
    if b_out is not None:
        out = out + b_out
    return out


def encoder_forward_xla(
    x: torch.Tensor,
    stacked: dict,
    *,
    heads: int,
    head_dim: int,
    eps: float,
    reference_residual: bool = False,
    approx_gelu: bool = False,
) -> torch.Tensor:
    """Eager encoder stack on the stacked ``[L, ...]`` params that
    ``ops/cuda/fused_encoder.encoder_forward`` takes, with the semantics of
    ``models/vit.EncoderBlock``."""
    gelu = get_gelu(approx_gelu)
    depth = stacked["qkv_w"].shape[0]
    dt = x.dtype
    for i in range(depth):
        h = layer_norm(x, stacked["ln1_g"][i, 0], stacked["ln1_b"][i, 0], eps)
        a = attention_xla(
            h, stacked["qkv_w"][i].to(dt), stacked["qkv_b"][i, 0].to(dt),
            stacked["out_w"][i].to(dt), stacked["out_b"][i, 0].to(dt),
            heads, head_dim,
        )
        x = a + (h if reference_residual else x)
        h = layer_norm(x, stacked["ln2_g"][i, 0], stacked["ln2_b"][i, 0], eps)
        m = h @ stacked["fc1_w"][i].to(dt) + stacked["fc1_b"][i, 0].to(dt)
        m = gelu(m)
        m = m @ stacked["fc2_w"][i].to(dt) + stacked["fc2_b"][i, 0].to(dt)
        x = m + (h if reference_residual else x)
    return x
