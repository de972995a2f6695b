"""LayerNorm->NoNorm and GeLU->ReLU transition schedules (port of
``edgevisiontransformer_tpu/pruning/transitions.py``).

The nn_pruning transition modules the presets can request via
``layer_norm_patch`` / ``gelu_patch`` (SparseTrainingArguments,
deit_pruning/vendor/nn_pruning_v1/nn_pruning/patch_coordinator.py:198-230):

* ``Layer2NoNorm`` (vendor modules/nonorm.py:6-103): during training, LN
  output is lerped between true layer norm and a running-statistics affine;
  a 3-vector accumulator (mean, var, count-mass) is EMA-updated with decay
  ``delta``; ``compile()`` folds the running stats into a plain affine
  ("NoNorm", nonorm.py:117-124) so inference has no normalization reductions.
* ``GeLU2ReLU`` (vendor modules/gelu2relu.py:7-50): lerp(relu, gelu, mix).
* The mix/delta schedule (patch_coordinator.py:496-525): over
  ``*_patch_steps`` steps, mix goes 1 -> 0 linearly and delta goes
  ``start_delta`` -> 1.0.

Accumulators are a tree of tensors threaded through the train step (no
module state); the forward differentiates through the accumulator it has
just updated, as JAX does, and the train step detaches what it returns.
Compiled models are ordinary ViTs with ``cfg.norm_mode="nonorm"`` /
``cfg.act="relu"``, which the fused encoders refuse.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import ViTConfig
from ..ops.activations import get_gelu
from ..ops.attention import attention_xla
from ..ops.layers import layer_norm, mlp_block, patch_embed


def transition_mix(step: int, steps: int) -> float:
    """mix: 1.0 -> 0.0 over ``steps`` (patch_coordinator.py:503-508)."""
    return max(0.0, 1.0 - step / max(steps, 1))


def transition_delta(step: int, steps: int, start_delta: float = 0.99) -> float:
    """delta: start_delta -> 1.0 as mix goes 1 -> 0 (interp(), :496-506)."""
    mix = transition_mix(step, steps)
    return start_delta * mix + 1.0 * (1.0 - mix)


def init_ln_accumulators(cfg: ViTConfig, device="cuda") -> Dict:
    """Zeroed (mean, var, mass) accumulator per LN site (nonorm.py:44-46),
    on ``device``: the card unless the caller names another."""
    from ..models.vit import model_device

    dev = model_device(device)
    acc = {
        f"block_{i}": {"ln1": torch.zeros(3, device=dev), "ln2": torch.zeros(3, device=dev)}
        for i in range(cfg.depth)
    }
    if cfg.final_norm:
        acc["final_norm"] = torch.zeros(3, device=dev)
    return acc


def layer2nonorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 acc: torch.Tensor, mix, delta, eps: float,
                 train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Layer2NoNorm forward (nonorm.py:48-90).  Returns (y, new_acc)."""
    xf = x.float()
    batch_mean = xf.mean(dim=-1, keepdim=True)
    batch_var = (xf - batch_mean).square().mean(dim=-1, keepdim=True)

    if train:
        new_acc = torch.stack([batch_mean.mean(), batch_var.mean(),
                               torch.ones((), device=xf.device)])
        acc = new_acc + delta * (acc - new_acc)  # lerp(new, old, delta)

    mass = torch.clamp(acc[2], min=1e-12)
    run_mean, run_var = acc[0] / mass, acc[1] / mass
    mean = run_mean + mix * (batch_mean - run_mean)
    var = run_var + mix * (batch_var - run_var)

    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * gamma.float() + beta.float()
    return y.to(x.dtype), acc


def compile_nonorm(gamma: torch.Tensor, beta: torch.Tensor, acc: torch.Tensor, eps: float):
    """Fold running stats into (scale, bias): nonorm.py compile():92-103."""
    mass = torch.clamp(acc[2], min=1e-12)
    mean, var = acc[0] / mass, acc[1] / mass
    inv = torch.rsqrt(var + eps)
    w = gamma * inv
    b = -mean * inv * gamma + beta
    return w, b


def gelu2relu(x: torch.Tensor, mix, approx: bool = False) -> torch.Tensor:
    """lerp(relu, gelu, mix) (gelu2relu.py:40-45)."""
    r = torch.relu(x)
    g = get_gelu(approx)(x)
    return r + mix * (g - r)


def vit_forward_transitions(
    cfg: ViTConfig,
    params: dict,
    img: torch.Tensor,
    ln_acc: Dict,
    mix_ln,
    delta,
    mix_gelu,
    ln_patch: bool = True,
    gelu_patch: bool = True,
    train: bool = True,
) -> Tuple[torch.Tensor, Dict]:
    """ViT forward with the transition modules swapped in.

    Same params as models/vit.py; returns (logits, new_ln_acc).  This is the
    body the sparse train step runs when a preset enables layer_norm_patch /
    gelu_patch."""
    p = params["params"] if "params" in params else params
    new_acc = {k: dict(v) if isinstance(v, dict) else v for k, v in ln_acc.items()}

    def norm(x, site_params, acc):
        if ln_patch:
            return layer2nonorm(x, site_params["scale"], site_params["bias"], acc,
                                mix_ln, delta, cfg.layernorm_eps, train=train)
        return layer_norm(x, site_params["scale"], site_params["bias"],
                          cfg.layernorm_eps), acc

    act = (lambda h: gelu2relu(h, mix_gelu, cfg.gelu_approx)) if gelu_patch \
        else get_gelu(cfg.gelu_approx)

    x = patch_embed(img, p["patch_kernel"], p["patch_bias"], cfg.patch_size)
    cls = p["cls_token"].expand(x.shape[0], 1, cfg.dim)
    x = torch.cat([cls, x], dim=1) + p["pos_embedding"]

    hd = cfg.resolved_head_dim
    for i in range(cfg.depth):
        blk = p[f"block_{i}"]
        heads = cfg.layer_heads(i)
        h, new_acc[f"block_{i}"]["ln1"] = norm(x, blk["ln1"], ln_acc[f"block_{i}"]["ln1"])
        attn_out = attention_xla(h, blk["attn"]["qkv_kernel"], blk["attn"].get("qkv_bias"),
                                 blk["attn"]["out_kernel"], blk["attn"]["out_bias"], heads, hd)
        x = (attn_out + h) if cfg.reference_residual else (x + attn_out)

        h2, new_acc[f"block_{i}"]["ln2"] = norm(x, blk["ln2"], ln_acc[f"block_{i}"]["ln2"])
        mlp = mlp_block(h2, blk["ffn"]["fc1_kernel"], blk["ffn"]["fc1_bias"],
                        blk["ffn"]["fc2_kernel"], blk["ffn"]["fc2_bias"], act)
        x = (mlp + h2) if cfg.reference_residual else (x + mlp)

    if cfg.final_norm:
        x, new_acc["final_norm"] = norm(x, p["final_norm"], ln_acc["final_norm"])
    x = x[:, 0]
    if cfg.mlp_head:
        h = get_gelu(cfg.gelu_approx)(x @ p["head_fc1"]["kernel"] + p["head_fc1"]["bias"])
        logits = h @ p["head_fc2"]["kernel"] + p["head_fc2"]["bias"]
    else:
        logits = x @ p["head"]["kernel"] + p["head"]["bias"]
    return logits, new_acc


def compile_transitions(cfg: ViTConfig, params: dict, ln_acc: Dict,
                        ln_patch: bool = True, gelu_patch: bool = True):
    """Bake transitions to their endpoints: fold accumulators into LN params
    (-> norm_mode="nonorm") and switch the act to relu.  Returns
    (new_cfg, new_params) usable with the ordinary ViT module."""
    had_wrapper = "params" in params
    p = dict(params["params"] if had_wrapper else params)

    if ln_patch:
        def fold(site_params, acc):
            w, b = compile_nonorm(site_params["scale"], site_params["bias"], acc,
                                  cfg.layernorm_eps)
            return {"scale": w, "bias": b}

        for i in range(cfg.depth):
            blk = dict(p[f"block_{i}"])
            blk["ln1"] = fold(blk["ln1"], ln_acc[f"block_{i}"]["ln1"])
            blk["ln2"] = fold(blk["ln2"], ln_acc[f"block_{i}"]["ln2"])
            p[f"block_{i}"] = blk
        if cfg.final_norm:
            p["final_norm"] = fold(p["final_norm"], ln_acc["final_norm"])

    new_cfg = cfg.replace(
        norm_mode="nonorm" if ln_patch else cfg.norm_mode,
        act="relu" if gelu_patch else cfg.act,
    )
    new_params = {"params": p} if had_wrapper else p
    return new_cfg, new_params
