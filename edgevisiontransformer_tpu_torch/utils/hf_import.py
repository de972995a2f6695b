"""HuggingFace and official T2T-ViT checkpoints into the port (port of
``edgevisiontransformer_tpu/utils/hf_import.py``).

The reference's model getters (``get_torch_deit`` via torch.hub,
``get_huggingface_vit``, its ``utils.py:52-118``) wrap torch modules; here a
state dict is converted once into the Flax-keyed parameter tree the port's
models carry (``ViT.params()``, ``SwinTransformer.params()``,
``T2TViT.params()`` / ``.constants()``), and
``utils/jax_bridge.load_jax_params`` / ``load_jax_variables`` put it into a
model, raising on a missing or extra leaf.

Supported: ViT/DeiT (``ViTForImageClassification``), Swin
(``SwinForImageClassification``) and the official T2T-ViT ``*.pth.tar``
files.  Conversion is pure numpy over a state-dict mapping; each importer
returns the same tree as the JAX one, with numpy leaves.  ``transformers``
is imported only by :func:`load_hf_model_params`.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from ..config import ViTConfig
from ..models.swin import SwinConfig


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def vit_config_from_hf(hf_config, num_classes: int | None = None) -> ViTConfig:
    """The port's standard-style config from a transformers ViTConfig
    (HF's defaults kept: ``layer_norm_eps`` 1e-12, ``num_labels`` 2)."""
    return ViTConfig(
        image_size=hf_config.image_size,
        patch_size=hf_config.patch_size,
        num_classes=num_classes
        if num_classes is not None
        else getattr(hf_config, "num_labels", 1000),
        dim=hf_config.hidden_size,
        depth=hf_config.num_hidden_layers,
        heads=hf_config.num_attention_heads,
        mlp_dim=hf_config.intermediate_size,
        in_channels=hf_config.num_channels,
        reference_residual=False,
        mlp_head=False,
        final_norm=True,
        qkv_bias=hf_config.qkv_bias,
        gelu_approx=False,
        layernorm_eps=hf_config.layer_norm_eps,
    )


def import_hf_vit(state_dict: Mapping[str, "np.ndarray"], cfg: ViTConfig) -> Dict:
    """Convert a ViTForImageClassification state dict to ``{"params": tree}``.

    Layout notes:
    * HF patch embedding is a conv [dim, c, p, p]; the port's is a matmul
      kernel [p*p*c, dim] over patches flattened as (p1, p2, c) — so
      transpose to (ph, pw, c, dim).
    * HF has separate q/k/v Linears (torch weight [out, in]); the fused
      qkv_kernel is [dim, 3*h*hd] with the fused axis ordered (qkv, h, hd),
      so concat the three transposed weights along the output axis.
    """
    sd = {k: _np(v) for k, v in state_dict.items()}
    pfx = "vit." if any(k.startswith("vit.") for k in sd) else ""

    p = cfg.patch_size
    c = cfg.in_channels
    dim = cfg.dim

    conv_w = sd[f"{pfx}embeddings.patch_embeddings.projection.weight"]
    params: Dict = {
        "cls_token": sd[f"{pfx}embeddings.cls_token"],
        "pos_embedding": sd[f"{pfx}embeddings.position_embeddings"][0],
        "patch_kernel": conv_w.transpose(2, 3, 1, 0).reshape(p * p * c, dim),
        "patch_bias": sd[f"{pfx}embeddings.patch_embeddings.projection.bias"],
    }

    for i in range(cfg.depth):
        lp = f"{pfx}encoder.layer.{i}."
        wq = sd[lp + "attention.attention.query.weight"].T
        wk = sd[lp + "attention.attention.key.weight"].T
        wv = sd[lp + "attention.attention.value.weight"].T
        blk = {
            "attn": {
                "qkv_kernel": np.concatenate([wq, wk, wv], axis=1),
                "out_kernel": sd[lp + "attention.output.dense.weight"].T,
                "out_bias": sd[lp + "attention.output.dense.bias"],
            },
            "ffn": {
                "fc1_kernel": sd[lp + "intermediate.dense.weight"].T,
                "fc1_bias": sd[lp + "intermediate.dense.bias"],
                "fc2_kernel": sd[lp + "output.dense.weight"].T,
                "fc2_bias": sd[lp + "output.dense.bias"],
            },
            "ln1": {
                "scale": sd[lp + "layernorm_before.weight"],
                "bias": sd[lp + "layernorm_before.bias"],
            },
            "ln2": {
                "scale": sd[lp + "layernorm_after.weight"],
                "bias": sd[lp + "layernorm_after.bias"],
            },
        }
        if cfg.qkv_bias:
            blk["attn"]["qkv_bias"] = np.concatenate(
                [
                    sd[lp + "attention.attention.query.bias"],
                    sd[lp + "attention.attention.key.bias"],
                    sd[lp + "attention.attention.value.bias"],
                ]
            )
        params[f"block_{i}"] = blk

    params["final_norm"] = {
        "scale": sd[f"{pfx}layernorm.weight"],
        "bias": sd[f"{pfx}layernorm.bias"],
    }
    if "classifier.weight" in sd:
        params["head"] = {
            "kernel": sd["classifier.weight"].T,
            "bias": sd["classifier.bias"],
        }
    else:  # headless backbone: zero classifier
        params["head"] = {
            "kernel": np.zeros((dim, cfg.num_classes), np.float32),
            "bias": np.zeros((cfg.num_classes,), np.float32),
        }
    return {"params": params}


def swin_config_from_hf(hf_config, num_classes: int | None = None) -> SwinConfig:
    return SwinConfig(
        image_size=hf_config.image_size,
        patch_size=hf_config.patch_size,
        in_channels=hf_config.num_channels,
        num_classes=num_classes
        if num_classes is not None
        else getattr(hf_config, "num_labels", 1000),
        embed_dim=hf_config.embed_dim,
        depths=tuple(hf_config.depths),
        num_heads=tuple(hf_config.num_heads),
        window_size=hf_config.window_size,
        mlp_ratio=hf_config.mlp_ratio,
        qkv_bias=hf_config.qkv_bias,
        layernorm_eps=hf_config.layer_norm_eps,
        gelu_approx=False,
    )


def import_hf_swin(state_dict: Mapping[str, "np.ndarray"], cfg: SwinConfig):
    """Convert a SwinForImageClassification state dict to ``{"params": tree}``.

    Only the relative-position bias *table* is imported: the port's Swin
    builds its relative-position index and shift masks itself (its
    buffers), so HF's ``relative_position_index`` is not read.  The patch
    merging's reduction has no bias.
    """
    sd = {k: _np(v) for k, v in state_dict.items()}
    pfx = "swin." if any(k.startswith("swin.") for k in sd) else ""

    p = cfg.patch_size
    c = cfg.in_channels
    conv_w = sd[f"{pfx}embeddings.patch_embeddings.projection.weight"]
    params: Dict = {
        "patch_kernel": conv_w.transpose(2, 3, 1, 0).reshape(
            p * p * c, cfg.embed_dim
        ),
        "patch_bias": sd[f"{pfx}embeddings.patch_embeddings.projection.bias"],
        "embed_norm_scale": sd[f"{pfx}embeddings.norm.weight"],
        "embed_norm_bias": sd[f"{pfx}embeddings.norm.bias"],
        "final_norm_scale": sd[f"{pfx}layernorm.weight"],
        "final_norm_bias": sd[f"{pfx}layernorm.bias"],
    }

    for si, depth in enumerate(cfg.depths):
        for bi in range(depth):
            lp = f"{pfx}encoder.layers.{si}.blocks.{bi}."
            wq = sd[lp + "attention.self.query.weight"].T
            wk = sd[lp + "attention.self.key.weight"].T
            wv = sd[lp + "attention.self.value.weight"].T
            blk = {
                "ln1_scale": sd[lp + "layernorm_before.weight"],
                "ln1_bias": sd[lp + "layernorm_before.bias"],
                "ln2_scale": sd[lp + "layernorm_after.weight"],
                "ln2_bias": sd[lp + "layernorm_after.bias"],
                "mlp_fc1_kernel": sd[lp + "intermediate.dense.weight"].T,
                "mlp_fc1_bias": sd[lp + "intermediate.dense.bias"],
                "mlp_fc2_kernel": sd[lp + "output.dense.weight"].T,
                "mlp_fc2_bias": sd[lp + "output.dense.bias"],
                "attn": {
                    "qkv": {
                        "kernel": np.concatenate([wq, wk, wv], axis=1),
                        "bias": np.concatenate(
                            [
                                sd[lp + "attention.self.query.bias"],
                                sd[lp + "attention.self.key.bias"],
                                sd[lp + "attention.self.value.bias"],
                            ]
                        ),
                    },
                    "proj": {
                        "kernel": sd[lp + "attention.output.dense.weight"].T,
                        "bias": sd[lp + "attention.output.dense.bias"],
                    },
                    "relative_position_bias_table": sd[
                        lp + "attention.self.relative_position_bias_table"
                    ],
                },
            }
            params[f"stage_{si}_block_{bi}"] = blk
        if si < len(cfg.depths) - 1:
            dp = f"{pfx}encoder.layers.{si}.downsample."
            params[f"downsample_{si}"] = {
                "norm_scale": sd[dp + "norm.weight"],
                "norm_bias": sd[dp + "norm.bias"],
                "reduction": {"kernel": sd[dp + "reduction.weight"].T},
            }

    if "classifier.weight" in sd:
        params["head"] = {
            "kernel": sd["classifier.weight"].T,
            "bias": sd["classifier.bias"],
        }
    return {"params": params}


def t2t_config_from_variant(variant: int, num_classes: int = 1000) -> ViTConfig:
    """Config matching the official yitu-opensource T2T-ViT checkpoints
    (the ``*.pth.tar`` files the reference loads, its ``tools.py:360-365``):
    standard residuals, no qkv bias, exact GELU, torch LayerNorm eps."""
    from ..models.t2t_vit import t2t_vit_config

    return t2t_vit_config(
        variant, style="standard", qkv_bias=False, layernorm_eps=1e-5,
        gelu_approx=False, num_classes=num_classes,
    )


def import_t2t_torch(state_dict: Mapping[str, "np.ndarray"], variant: int,
                     num_classes: int = 1000):
    """Convert an official T2T-ViT torch state dict to the port's variables.

    Key map (yitu-opensource/T2T-ViT ``models/{t2t_vit,token_performer}.py``;
    the reference's TF port mirrors it in ``modeling/models/t2t_vit.py`` and
    ``layers/transformer_encoder.py:39-101``):

      tokens_to_token.attention{1,2}.{kqv,proj,norm1,norm2,mlp.0,mlp.2,w}
      tokens_to_token.project | cls_token | pos_embed
      blocks.N.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2} | norm | head

    Returns (config, variables) where variables holds the ``"constants"``
    collection too (the performers' frozen random-feature matrices ``w`` and
    the sinusoid ``pos_embed`` come from the checkpoint — w is NOT
    recomputable); ``utils/jax_bridge.load_jax_variables`` puts both into a
    ``T2TViT``.
    """
    cfg = t2t_config_from_variant(variant, num_classes)
    sd = {k: _np(v) for k, v in state_dict.items()}

    def lin(prefix):
        out = {"kernel": sd[f"{prefix}.weight"].T}
        if f"{prefix}.bias" in sd:
            out["bias"] = sd[f"{prefix}.bias"]
        return out

    def performer(tag):
        pre = f"tokens_to_token.{tag}"
        return {
            "kqv": lin(f"{pre}.kqv"),
            "attn_output": lin(f"{pre}.proj"),
            "norm1_scale": sd[f"{pre}.norm1.weight"],
            "norm1_bias": sd[f"{pre}.norm1.bias"],
            "norm2_scale": sd[f"{pre}.norm2.weight"],
            "norm2_bias": sd[f"{pre}.norm2.bias"],
            "mlp_fc1_kernel": sd[f"{pre}.mlp.0.weight"].T,
            "mlp_fc1_bias": sd[f"{pre}.mlp.0.bias"],
            "mlp_fc2_kernel": sd[f"{pre}.mlp.2.weight"].T,
            "mlp_fc2_bias": sd[f"{pre}.mlp.2.bias"],
        }

    params: Dict = {
        "tokens_to_token": {
            "performer1": performer("attention1"),
            "performer2": performer("attention2"),
            "project": lin("tokens_to_token.project"),
        },
        "cls_token": sd["cls_token"],
        "final_norm": {"scale": sd["norm.weight"], "bias": sd["norm.bias"]},
        "head": lin("head"),
    }
    for i in range(cfg.depth):
        pre = f"blocks.{i}"
        blk = {
            "ln1": {"scale": sd[f"{pre}.norm1.weight"],
                    "bias": sd[f"{pre}.norm1.bias"]},
            "ln2": {"scale": sd[f"{pre}.norm2.weight"],
                    "bias": sd[f"{pre}.norm2.bias"]},
            "attn": {
                # torch Linear [out, in] -> [in, out]; out ordering
                # (qkv, head, hd) matches the fused layout
                "qkv_kernel": sd[f"{pre}.attn.qkv.weight"].T,
                "out_kernel": sd[f"{pre}.attn.proj.weight"].T,
                "out_bias": sd[f"{pre}.attn.proj.bias"],
            },
            "ffn": {
                "fc1_kernel": sd[f"{pre}.mlp.fc1.weight"].T,
                "fc1_bias": sd[f"{pre}.mlp.fc1.bias"],
                "fc2_kernel": sd[f"{pre}.mlp.fc2.weight"].T,
                "fc2_bias": sd[f"{pre}.mlp.fc2.bias"],
            },
        }
        if f"{pre}.attn.qkv.bias" in sd:
            blk["attn"]["qkv_bias"] = sd[f"{pre}.attn.qkv.bias"]
        params[f"block_{i}"] = blk

    constants = {
        "tokens_to_token": {
            "performer1": {"w": sd["tokens_to_token.attention1.w"]},
            "performer2": {"w": sd["tokens_to_token.attention2.w"]},
        },
        "pos_embedding": sd["pos_embed"][0],
    }
    return cfg, {"params": params, "constants": constants}


def load_t2t_checkpoint(path: str, variant: int, num_classes: int = 1000):
    """Load an official ``*.pth.tar`` T2T checkpoint (the reference's
    ``tools.py:360-365`` filenames, like ``71.7_T2T_ViT_7.pth.tar``): the
    state dict under ``state_dict_ema``, ``state_dict`` or ``model``, or the
    file's top level."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict_ema", "state_dict", "model"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    return import_t2t_torch(ckpt, variant, num_classes)


def load_hf_model_params(name_or_path: str, family: str = "vit", *, device="cuda"):
    """Load a pretrained HF checkpoint (local files or cache; needs
    ``transformers``) and convert it: the ``get_torch_deit`` /
    ``get_huggingface_vit`` replacement (reference ``utils.py:52-118``), e.g.
    ``facebook/deit-tiny-patch16-224``.

    Returns ``(cfg, variables)`` as the JAX function does.  The port's model
    (``ViT`` or ``SwinTransformer``) is built on ``device``, the card unless
    the caller names another, and the imported tree loaded into it with
    ``utils/jax_bridge.load_jax_params`` (a missing or extra leaf raises);
    ``variables`` is ``{"params": model.params()}``, that model's tensors on
    ``device``, which ``models/vit.load_params`` copies into another model
    of ``cfg``."""
    from ..models.swin import SwinTransformer
    from ..models.vit import ViT
    from .jax_bridge import load_jax_params

    if family == "vit":
        from transformers import ViTForImageClassification

        hf = ViTForImageClassification.from_pretrained(name_or_path)
        cfg = vit_config_from_hf(hf.config)
        tree, model_cls = import_hf_vit(hf.state_dict(), cfg), ViT
    elif family == "swin":
        from transformers import SwinForImageClassification

        hf = SwinForImageClassification.from_pretrained(name_or_path)
        cfg = swin_config_from_hf(hf.config)
        tree, model_cls = import_hf_swin(hf.state_dict(), cfg), SwinTransformer
    else:
        raise ValueError(f"unknown family {family!r}")
    model = load_jax_params(model_cls(cfg, device=device), tree["params"])
    return cfg, {"params": model.params()}
