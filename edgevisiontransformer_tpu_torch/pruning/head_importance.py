"""Taylor-expansion head importance (port of
``edgevisiontransformer_tpu/pruning/head_importance.py``).

Reference semantics (are_16_heads/classifier_eval.py:111-225): loss =
logits.sum(); per layer, per head, per token compute dot[b,h,t] =
<grad(ctx), ctx> over the feature dim of the per-head context activations,
then importance[l,h] = sum_{b,t} |dot|; accumulate over batches; normalize
rows [:-1] by total tokens and row [-1] by #examples (a reference quirk kept
here); finally L2-normalize per layer.

As in the JAX package, no hook keeps the context's gradient: the forward
multiplies each layer's context by a ones-valued mask of shape [L, B, H, N],
and d loss / d mask[l,b,h,t] == <grad(ctx), ctx>[b,h,t] exactly, so one
``torch.autograd.grad`` gives every per-token dot product.  The forward is
the port's plain tensor functions (no kernel: a kernel wrapper has no
backward), as JAX runs it through XLA.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed

from ..config import ViTConfig
from ..ops.activations import get_gelu
from ..ops.attention import merge_heads, qkv_split, sdpa
from ..ops.layers import layer_norm, mlp_block, patch_embed
from ..utils.jax_bridge import tree_map


def _tree(params: dict) -> dict:
    return params["params"] if "params" in params else params


def _device(params: dict) -> torch.device:
    return _tree(params)["patch_kernel"].device


def vit_forward_head_mask(cfg: ViTConfig, params: dict, img: torch.Tensor,
                          head_mask: torch.Tensor) -> torch.Tensor:
    """ViT forward with a per-(layer, batch, head, token) context mask.

    head_mask: [depth, B, cfg.heads, n_tokens]; a pruned layer uses its
    first ``layer_heads(i)`` rows.  The same params as ``models/vit.py``."""
    p = _tree(params)
    x = patch_embed(img, p["patch_kernel"], p["patch_bias"], cfg.patch_size)
    cls = p["cls_token"].expand(x.shape[0], 1, cfg.dim)
    x = torch.cat([cls, x], dim=1) + p["pos_embedding"]

    act = get_gelu(cfg.gelu_approx)
    hd = cfg.resolved_head_dim
    for i in range(cfg.depth):
        blk = p[f"block_{i}"]
        heads = cfg.layer_heads(i)
        h = layer_norm(x, blk["ln1"]["scale"], blk["ln1"]["bias"], cfg.layernorm_eps)
        qkv = h @ blk["attn"]["qkv_kernel"]
        if cfg.qkv_bias:
            qkv = qkv + blk["attn"]["qkv_bias"]
        q, k, v = qkv_split(qkv, heads, hd)
        ctx = sdpa(q, k, v, scale=hd ** -0.5)  # [b, h, n, d]
        # mask rows 0..heads-1 (pruned models have fewer heads than the mask)
        ctx = ctx * head_mask[i][:, :heads, :, None]
        attn_out = merge_heads(ctx) @ blk["attn"]["out_kernel"] + blk["attn"]["out_bias"]
        x = (attn_out + h) if cfg.reference_residual else (x + attn_out)

        h2 = layer_norm(x, blk["ln2"]["scale"], blk["ln2"]["bias"], cfg.layernorm_eps)
        mlp = mlp_block(h2, blk["ffn"]["fc1_kernel"], blk["ffn"]["fc1_bias"],
                        blk["ffn"]["fc2_kernel"], blk["ffn"]["fc2_bias"], act)
        x = (mlp + h2) if cfg.reference_residual else (x + mlp)

    if cfg.final_norm:
        x = layer_norm(x, p["final_norm"]["scale"], p["final_norm"]["bias"],
                       cfg.layernorm_eps)
    x = x[:, 0]
    if cfg.mlp_head:
        h = act(x @ p["head_fc1"]["kernel"] + p["head_fc1"]["bias"])
        return h @ p["head_fc2"]["kernel"] + p["head_fc2"]["bias"]
    return x @ p["head"]["kernel"] + p["head"]["bias"]


def head_importance_batch(cfg: ViTConfig, params: dict, images: torch.Tensor) -> torch.Tensor:
    """Unnormalized importance accumulation for one batch: [depth, cfg.heads]
    on the params' device."""
    b = images.shape[0]
    n = cfg.num_patches + 1
    dev = _device(params)
    mask = torch.ones((cfg.depth, b, cfg.heads, n), dtype=torch.float32, device=dev,
                      requires_grad=True)
    with torch.enable_grad():
        logits = vit_forward_head_mask(cfg, tree_map(torch.Tensor.detach, _tree(params)),
                                       images.to(dev), mask)
        (g,) = torch.autograd.grad(logits.float().sum(), mask)  # [L, B, H, N] per-token dots
    return g.abs().sum(dim=(1, 3))  # sum |dot| over batch + tokens


def calculate_head_importance(
    cfg: ViTConfig,
    params: dict,
    batches,
    normalize_scores_by_layer: bool = True,
    mesh=None,
) -> np.ndarray:
    """Accumulate over an iterable of image batches (numpy arrays or
    tensors, moved to the params' device) (reference classifier_eval.py:
    111-225); returns [depth, cfg.heads] float64.

    With a ``parallel/mesh.Mesh`` (every rank of it calls this with the
    same batches), each batch is split over ``dp``, each rank sums its rows'
    importance, and the sums are all-reduced over ``dp`` before the
    normalization, which counts the examples of the whole batches: the
    reference's NCCL all_reduce of per-rank importance (:210-215)."""
    seq_len = cfg.num_patches + 1
    dev = _device(params)
    dp, r = (mesh.shape["dp"], mesh.index("dp")) if mesh is not None else (1, 0)
    importance = np.zeros((cfg.depth, cfg.heads), np.float64)
    tot_tokens = 0
    n_examples = 0
    for images in batches:
        x = torch.as_tensor(images)
        b = x.shape[0]
        if b % dp:
            raise ValueError(f"batch {b} does not split over dp={dp}")
        mine = x[r * b // dp:(r + 1) * b // dp].to(dev)
        importance += head_importance_batch(cfg, params, mine).double().cpu().numpy()
        tot_tokens += seq_len
        n_examples += b
    if dp > 1:
        total = torch.from_numpy(importance)
        torch.distributed.all_reduce(total, group=mesh.group("dp"))
        importance = total.numpy()

    # Reference normalization quirk: rows [:-1] by token count, row [-1] by
    # example count (classifier_eval.py:217-218).
    importance[:-1] /= max(tot_tokens, 1)
    importance[-1] /= max(n_examples, 1)
    if normalize_scores_by_layer:
        norm = np.sqrt(np.sum(importance**2, axis=-1, keepdims=True))
        importance = importance / (norm + 1e-20)
    return importance
