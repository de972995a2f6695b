"""Analytic FLOPs accounting (port of ``edgevisiontransformer_tpu/utils/flops.py``,
pure Python, the same constants and functions).

ELECTRA-derived, matching the reference's ``flops_calculation.py``
conventions so its MACs grids remain the expectation oracle for
pruned-model speedups (BASELINE.md):

* matmul = 2*m*n FLOPs; activation/LN/softmax/dropout constants 8/5/5/4;
* ViT: patch-embed + L blocks + 2-layer classifier head (ViTHparams:216-251);
* pruned ViT: heads*head_size projections + (1-sparsity)*i FFN
  (PrunedViTHparams:254-310, head_size fixed 64);
* Swin per-stage window attention + patch merging (SwinFlops:313-386 — note
  the reference counts some Swin matmuls as m*n MACs, reproduced verbatim).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

DROPOUT_FLOPS = 4
LAYER_NORM_FLOPS = 5
ACTIVATION_FLOPS = 8
SOFTMAX_FLOPS = 5


def transformer_block_flops(
    h: int,
    s: int,
    i: int,
    heads: int,
    head_size: int | None = None,
) -> int:
    """Forward FLOPs of one encoder block (TransformerHparams.get_block_flops)."""
    kqv = h if head_size is None else head_size * heads
    per_token = (
        3 * 2 * h * kqv            # qkv projections
        + 3 * kqv                  # qkv bias
        + 2 * kqv * s              # attention scores
        + SOFTMAX_FLOPS * s * heads
        + DROPOUT_FLOPS * s * heads
        + s * heads                # scale
        + 2 * kqv * s              # weighted avg of values
        + 2 * kqv * h              # output projection
        + h                        # out bias
        + DROPOUT_FLOPS * h
        + h                        # residual
        + LAYER_NORM_FLOPS         # ln (reference counts 5, not 5h — kept)
        + 2 * h * i                # intermediate
        + ACTIVATION_FLOPS * i
        + i
        + 2 * h * i                # output
        + h
        + DROPOUT_FLOPS * h
        + h
        + LAYER_NORM_FLOPS * h
    )
    return per_token * s


def vit_flops(
    h: int = 768,
    l: int = 12,
    image_size: int = 224,
    patch_size: int = 16,
    channels: int = 3,
    num_classes: int = 1000,
    mlp_dim: int | None = None,
    i: int | None = None,
    heads: int | None = None,
    head_size: int | None = None,
) -> int:
    """ViTHparams.get_infer_flops: embed + blocks + 2-layer MLP head."""
    num_patches = (image_size // patch_size) ** 2
    s = num_patches + 1
    i = i if i is not None else h * 4
    mlp_dim = mlp_dim if mlp_dim is not None else h * 4
    heads = heads if heads is not None else max(h // 64, 1)

    embed = 2 * num_patches * channels * patch_size**2 * h + s * h
    blocks = l * transformer_block_flops(h, s, i, heads, head_size)
    head = (
        2 * h * mlp_dim + mlp_dim + ACTIVATION_FLOPS * mlp_dim
        + 2 * mlp_dim * num_classes + num_classes + num_classes
    )
    return embed + blocks + head


_DEIT_H = {"tiny": 192, "small": 384, "base": 768}


def pruned_deit_flops(
    size: str, num_heads_per_layer: int, ffn_sparsity: float, head_size: int = 64
) -> int:
    """PrunedViTHparams.get_pruned_deit_flops (:254-268)."""
    h = _DEIT_H[size]
    i = int((1 - ffn_sparsity) * h * 4)
    return vit_flops(
        h=h, l=12, heads=num_heads_per_layer, head_size=head_size, i=i
    )


def pruned_deit_grids() -> Dict[str, Dict]:
    """The reference's printed MACs grids (experiment_show_pruned_deit_flops,
    :270-310) as data: MMACs = flops / 2e6."""
    heads_full = {"tiny": 3, "small": 6, "base": 12}
    out = {"ffn_only": {}, "head_only": {}, "head_plus_ffn": {}}
    for size in ("tiny", "small", "base"):
        out["ffn_only"][size] = [
            round(pruned_deit_flops(size, heads_full[size], s / 100) / 2e6, 2)
            for s in range(0, 100, 10)
        ]
        out["head_only"][size] = [
            round(pruned_deit_flops(size, k, 0.0) / 2e6, 2)
            for k in range(1, heads_full[size] + 1)
        ]
    out["head_plus_ffn"]["tiny_head2"] = [
        round(pruned_deit_flops("tiny", 2, s) / 2e6, 2) for s in (0.1, 0.2, 0.3)
    ]
    out["head_plus_ffn"]["small_head4"] = [
        round(pruned_deit_flops("small", 4, s) / 2e6, 2) for s in (0.1, 0.2, 0.3, 0.4)
    ]
    out["head_plus_ffn"]["small_head5"] = [
        round(pruned_deit_flops("small", 5, s) / 2e6, 2) for s in (0.1, 0.2, 0.3, 0.4)
    ]
    return out


def swin_flops(
    depths: Sequence[int],
    base_dim: int,
    mlp_ratio: float,
    base_heads: int,
    image_size: int = 224,
    patch_size: int = 4,
    window_size: int = 7,
    num_classes: int = 1000,
) -> int:
    """SwinFlops.get_flops (:313-386), formulas reproduced as-published."""
    num_stages = len(depths)
    total = (image_size // patch_size) ** 2 * 3 * patch_size**2 * base_dim
    for st in range(num_stages):
        h = (1 << st) * base_dim
        s = (image_size // patch_size) ** 2 // (1 << st) ** 2
        heads = (1 << st) * base_heads
        w2 = window_size**2
        head_size = h // heads
        attn = 4 * s * h * h + (s // w2) * heads * (
            2 * w2**2 * head_size + 2 * w2**2
        )
        block = s * h + attn + s * h + int(2 * s * h * h * mlp_ratio)
        total += depths[st] * block
        total += s * h + (s // 4) * (4 * h) * (2 * h)  # patch merging
    s_last = (image_size // patch_size) ** 2 // (1 << (num_stages - 1)) ** 2
    h_last = (1 << (num_stages - 1)) * base_dim
    total += 2 * s_last * h_last + h_last * num_classes
    return total


MODEL_FLOPS: Dict[str, int] = {
    "deit_base": vit_flops(h=768, l=12),
    "deit_small": vit_flops(h=384, l=12),
    "deit_tiny": vit_flops(h=192, l=12),
    "vit_base_384": vit_flops(h=768, l=12, image_size=384),
    "swin_tiny": swin_flops((2, 2, 6, 2), 96, 4.0, 3),
    "swin_small": swin_flops((2, 2, 18, 2), 96, 4.0, 3),
    "swin_base": swin_flops((2, 2, 18, 2), 128, 4.0, 4),
}


def model_macs(name: str) -> float:
    """MACs (= FLOPs / 2) for a registry model name."""
    return MODEL_FLOPS[name] / 2


def t2t_vit_flops(
    hidden: int = 384,
    depth: int = 14,
    heads: int = 6,
    mlp_dim: int = 1152,
    image_size: int = 224,
    token_size: int = 64,
    kernel_ratio: float = 0.5,
    num_classes: int = 1000,
) -> int:
    """T2T-ViT forward FLOPs (our extension — the reference has no analytic
    model for T2T; SwinFlops-style conventions).

    Tokenizer: 3 soft-splits (7s4p2, 3s2p1, 3s2p1) + 2 single-head
    TokenPerformers (hidden 64, m = 64*kernel_ratio random features) +
    projection; encoder: standard blocks at (hidden, heads, mlp_dim).
    """
    m = int(token_size * kernel_ratio)

    def performer(tokens: int, in_dim: int) -> int:
        h = token_size
        f = 2 * tokens * in_dim * 3 * h          # kqv dense
        f += 2 * (2 * tokens * h * m + tokens * m)  # prm_exp for k and q (+exp)
        f += 2 * tokens * m                      # D
        f += 2 * tokens * h * m                  # kptv
        f += 2 * tokens * m * h                  # y
        f += 2 * tokens * h * h                  # attn_output
        f += 2 * 2 * tokens * h * h              # mlp (h->h->h)
        return f

    s0 = image_size // 4          # 56
    s1 = s0 // 2                  # 28
    s2 = s1 // 2                  # 14
    total = performer(s0 * s0, 7 * 7 * 3)
    total += performer(s1 * s1, token_size * 9)
    total += 2 * s2 * s2 * (token_size * 9) * hidden  # projection
    s = s2 * s2 + 1
    total += depth * transformer_block_flops(hidden, s, mlp_dim, heads)
    total += 2 * hidden * num_classes
    return int(total)


MODEL_FLOPS.update({
    "t2t_vit_7": t2t_vit_flops(256, 7, 4, 512),
    "t2t_vit_10": t2t_vit_flops(256, 10, 4, 512),
    "t2t_vit_12": t2t_vit_flops(256, 12, 4, 512),
    "t2t_vit_14": t2t_vit_flops(384, 14, 6, 1152),
})


def bench_row_flops(name: str):
    """FLOPs for a benchmark-row model name: strips impl suffixes
    (_fused/_int8[_static]/_xla/...) and resolves pruned_deit encodings
    (uniform and layerwise; layerwise averages the per-layer settings).
    Returns None for names with no analytic model (CNN zoo rows)."""
    base = (name.replace("_xla", "").replace("_fullfused", "")
            .replace("_pallas", ""))
    # npad experiment rows ("deit_tiny_fused_npad8") carry the kernel-mode
    # token in the middle — match BEFORE the suffix strip removes it
    if base.startswith("deit_tiny_fused_npad"):
        return MODEL_FLOPS["deit_tiny"]
    for suffix in ("_fused", "_int8_static", "_int8"):
        base = base.replace(suffix, "")
    if base.startswith("pruned_deit_"):
        rest = base[len("pruned_deit_"):]
        size, _, enc = rest.partition("@")
        if enc.startswith("layerwise_"):
            toks = enc[len("layerwise_"):].split("_")
            pairs = [t.split("-") for t in toks]
            total = 0.0
            for h, d in pairs:
                total += pruned_deit_flops(
                    size, int(h.replace("h", "")),
                    1.0 - float(d.replace("d", "")),
                ) / len(pairs)
            return total
        toks = enc.split("_")
        heads = int(toks[1].replace("head", ""))
        ffn_keep = float(toks[2].replace("ffn", ""))
        return pruned_deit_flops(size, heads, 1.0 - ffn_keep)
    return MODEL_FLOPS.get(base)
