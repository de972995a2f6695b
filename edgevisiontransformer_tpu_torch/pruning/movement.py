"""Movement / topK structured sparsity, the nn_pruning engine (port of
``edgevisiontransformer_tpu/pruning/movement.py``).

A functional design of the reference's vendored nn_pruning
(deit_pruning/vendor/nn_pruning_v1/): no module patching; mask scores are
a second tree of tensors, the mask is recomputed each forward from the
current threshold (as MaskedLinear.forward, masked_nn.py:382-444), and
"compile" is a pure function giving a smaller static-shape model
(patch_coordinator.py:853-872 + inference_model_patcher).

Capability map (reference -> here):
* TopK/Threshold/sigmoied/magnitude binarizers with straight-through
  gradients (binarizer.py:24-154) -> topk_mask / threshold_mask / ...,
  ``torch.autograd.Function``s
* block mask expansion via repeat (masked_nn.py:272-332) -> expand_block_mask
* per-layer cubic threshold schedule + "h_X_d_Y-..." DSL
  (patch_coordinator.py:354-528,396-406) -> schedule_thresholds /
  parse_layerwise_thresholds
* regularization split attn/dense (patch_coordinator.py:530-627) -> regularization_loss
* distillation (trainer.py:72-97) -> distillation_loss
* compile: bake masks, score heads 0-3 by q/k/v block nnz, prune heads
  (>=1 kept), slice FFN zero units (inference_model_patcher.py:8-317)
  -> compile_sparse_model
* unzero_parameters head re-seed (deit_pruning/src/utils.py:44-65) -> unzero_params

Random numbers come from explicit ``torch.Generator``s where the JAX
package takes a key, so the two packages draw different numbers: tests
carry JAX's scores across (``utils/jax_bridge.tree_to_torch``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ViTConfig
from ..utils.jax_bridge import flatten_tree, tree_map
from .apply import prune_ffn_params, prune_heads_params


# ---------------------------------------------------------------------------
# Sparse training arguments
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SparseConfig:
    """Subset of SparseTrainingArguments (patch_coordinator.py:51-277) that is
    meaningful for the DeiT path, with the same defaults."""

    method: str = "topk"  # topk | threshold | sigmoied_threshold | magnitude | l0
    # Attention masks are blocked at head granularity by default (the
    # topk-hybrid-struct presets use block = one head of qkv).  -1 rows means
    # "one head" regardless of head_dim; explicit sizes give 2D block masks.
    attn_block_rows: int = -1   # rows of W^T = output units; -1 => head_dim
    attn_block_cols: int = -1   # -1 => whole input dim
    dense_pruning: str = "1d_alt"  # 1d_alt: fc1 rows / fc2 cols; "blocks": 2D
    dense_block_rows: int = 1      # used when dense_pruning == "blocks"
    dense_block_cols: int = 1
    initial_threshold: float = 1.0
    final_threshold: float = 0.5
    initial_warmup: float = 1.0   # in units of warmup_steps
    final_warmup: float = 2.0
    warmup_steps: int = 120
    regularization: Optional[str] = None  # None | "l1"
    regu_lambda_attention: float = 0.0
    regu_lambda_dense: float = 0.0
    distil_alpha: float = 0.5
    distil_temperature: float = 2.0
    mask_init_scale: float = 0.0  # scores init (0 = uniform start like reference)
    layerwise_thresholds: Optional[str] = None  # "h_0.5_d_0.3-..." DSL
    # Transition patches (patch_coordinator.py:198-230 -> pruning/transitions.py)
    layer_norm_patch: bool = False
    layer_norm_patch_steps: int = 50000
    layer_norm_patch_start_delta: float = 0.99
    gelu_patch: bool = False
    gelu_patch_steps: int = 50000
    # Quantization-aware training (vendor modules/quantization.py analogue)
    qat: bool = False
    qat_bits: int = 8


def parse_layerwise_thresholds(s: str, depth: int) -> List[Tuple[float, float]]:
    """DSL "h_0.50_d_0.3-h_0.4_d_0.2-..." -> [(h, d)] per layer
    (reference patch_coordinator.py:396-406, latency_model.py:27-36)."""
    out = []
    for tok in s.split("-"):
        parts = tok.split("_")
        if len(parts) != 4 or parts[0] != "h" or parts[2] != "d":
            raise ValueError(f"bad layerwise threshold token {tok!r}")
        out.append((float(parts[1]), float(parts[3])))
    if len(out) != depth:
        raise ValueError(f"{len(out)} tokens for depth {depth}")
    return out


def format_layerwise_thresholds(pairs) -> str:
    return "-".join(f"h_{h:g}_d_{d:g}" for h, d in pairs)


# ---------------------------------------------------------------------------
# Binarizers (STE)
# ---------------------------------------------------------------------------


class _STEMask(torch.autograd.Function):
    """Forward: the mask; backward: the gradient to the scores unchanged
    (straight-through, binarizer.py:63-68)."""

    @staticmethod
    def forward(ctx, scores, mask):
        return mask

    @staticmethod
    def backward(ctx, g):
        return g, None


def _as_fp32(threshold, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(threshold, dtype=torch.float32, device=like.device)


def quantile_linear(flat: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(flat, q)`` (method "linear") in its own arithmetic: the
    sorted values at floor / ceil of ``q * (n - 1)`` weighted ``1 - w`` and
    ``w``, in fp32, the second product added to the rounded first in one
    fused multiply-add, as XLA's CPU backend contracts it (emulated in
    float64, where the fp32 product is exact).  ``torch.quantile``
    interpolates by ``lerp``, which rounds otherwise, so its cut can land a
    spacing away from JAX's."""
    a = torch.sort(flat).values
    n = a.numel()
    pos = q * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1.0 - w_high
    lo = a[low.clamp(0, n - 1).long()].to(q.dtype)
    hi = a[high.clamp(0, n - 1).long()].to(q.dtype)
    return (hi.double() * w_high.double() + (lo * w_low).double()).to(flat.dtype)


def topk_mask(scores: torch.Tensor, threshold) -> torch.Tensor:
    """Keep the top ``threshold`` fraction of scores (TopKBinarizer,
    binarizer.py:73-118): the cut is the ``1 - threshold`` quantile, kept
    where ``scores >= cut`` (ties at the cut all kept).  ``1 - threshold``
    is taken as JAX takes it: in fp32 for a tensor threshold (the train
    step's), in float64 and then rounded for a Python float (compile's)."""
    flat = scores.detach().reshape(-1)
    top = 1.0 - 1.0 / flat.numel()
    if isinstance(threshold, torch.Tensor):
        q = torch.clamp(1.0 - threshold.to(scores.device, torch.float32), 0.0, top)
    else:
        q = _as_fp32(min(max(1.0 - threshold, 0.0), top), scores)
    cut = quantile_linear(flat, q)
    mask = (scores.detach() >= cut).to(scores.dtype)
    return _STEMask.apply(scores, mask)


def threshold_mask(scores: torch.Tensor, threshold, sigmoid: bool = True) -> torch.Tensor:
    """ThresholdBinarizer (binarizer.py:24-70) incl. the >=0.5% floor."""
    s = torch.sigmoid(scores.detach()) if sigmoid else scores.detach()
    nb_min = max(int(0.005 * scores.numel()), 1)
    kth = torch.sort(s.reshape(-1)).values[-nb_min]
    cut = torch.minimum(_as_fp32(threshold, s).to(s.dtype), kth)
    mask = (s >= cut).to(scores.dtype)
    return _STEMask.apply(scores, mask)


def magnitude_mask(weight_norms: torch.Tensor, threshold) -> torch.Tensor:
    """MagnitudeBinarizer: like topk but scored by |W| (binarizer.py:121-154)."""
    return topk_mask(weight_norms, threshold)


# Hard-concrete (L0) gate constants (Louizos et al.; nn_pruning's l0 method).
_L0_TEMP = 2.0 / 3.0
_L0_GAMMA = -0.1
_L0_ZETA = 1.1


def l0_gate(scores: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Hard-concrete gate: stochastic (train, with a generator, whose
    device the noise is drawn on) or deterministic (eval).  Differentiable:
    no STE needed."""
    if generator is not None:
        u = torch.rand(scores.shape, generator=generator, device=generator.device)
        u = (u * (1 - 2e-6) + 1e-6).to(scores.device, scores.dtype)
        sc = (torch.log(u) - torch.log1p(-u) + scores) / _L0_TEMP
    else:
        sc = scores
    s = torch.sigmoid(sc) * (_L0_ZETA - _L0_GAMMA) + _L0_GAMMA
    return torch.clamp(s, 0.0, 1.0)


def l0_penalty(scores: torch.Tensor) -> torch.Tensor:
    """Expected L0 (probability a gate is nonzero): the regularizer that
    drives sparsity for method="l0"."""
    return torch.sigmoid(scores - _L0_TEMP * math.log(-_L0_GAMMA / _L0_ZETA)).mean()


def expand_block_mask(mask: torch.Tensor, out_dim: int, in_dim: int) -> torch.Tensor:
    """[nbr, nbc] block mask -> [out_dim, in_dim] elementwise mask
    (masked_nn.py:272-332 repeat_interleave)."""
    nbr, nbc = mask.shape
    return mask.repeat_interleave(out_dim // nbr, dim=0).repeat_interleave(in_dim // nbc, dim=1)


# ---------------------------------------------------------------------------
# Mask-score parameters for a ViT
# ---------------------------------------------------------------------------


def _attn_head_granular(cfg: ViTConfig, sparse: SparseConfig) -> bool:
    """True when the attention block == one head's rows x full input (the
    topk-hybrid-struct presets): masks collapse to per-head scalars."""
    hd = cfg.resolved_head_dim
    rows = sparse.attn_block_rows
    cols = sparse.attn_block_cols
    return (rows == -1 or rows == hd) and (cols <= 0 or cols >= cfg.dim)


def _attn_block_shape(cfg: ViTConfig, sparse: SparseConfig, heads: int):
    """(nbr, nbc) for one q/k/v matrix [out=heads*hd, in=dim]."""
    hd = cfg.resolved_head_dim
    out_dim, in_dim = heads * hd, cfg.dim
    br = sparse.attn_block_rows if sparse.attn_block_rows > 0 else out_dim
    bc = sparse.attn_block_cols if sparse.attn_block_cols > 0 else in_dim
    return max(out_dim // br, 1), max(in_dim // bc, 1)


def _dense_block_shapes(cfg: ViTConfig, sparse: SparseConfig, mlp: int):
    """fc1 is [out=mlp, in=dim]; fc2 is [out=dim, in=mlp] (torch orientation,
    like nn_pruning's LAYER_PATTERNS)."""
    br = max(sparse.dense_block_rows, 1)
    bc = max(sparse.dense_block_cols, 1)
    return (mlp // br, cfg.dim // bc), (cfg.dim // br, mlp // bc)


def init_mask_scores(cfg: ViTConfig, sparse: SparseConfig,
                     generator: Optional[torch.Generator] = None, device="cuda") -> Dict:
    """One fp32 score tensor per maskable matrix per layer,
    ``(mask_init_scale + 1e-3) * N(0, 1)`` as the JAX package draws them
    (one normal draw scaled twice), drawn on the CPU from ``generator`` and
    put on ``device``: the card unless the caller names another.

    Head-granular presets (attention block = one head of qkv): q/k/v/out get
    [heads] scores, fc1/fc2 get [mlp] row/col scores (1d_alt).  Generic block
    presets (32x32, 16x16, unstructured 1x1, ...): 2D [nbr, nbc] scores per
    matrix in torch [out, in] orientation (masked_nn.py block machinery).
    """
    from ..models.vit import model_device

    dev = model_device(device)
    head_gran = _attn_head_granular(cfg, sparse)
    dense_1d = sparse.dense_pruning in ("1d", "1d_alt")

    def mk(shape):
        n = torch.randn(shape, generator=generator)
        return (sparse.mask_init_scale * n + 1e-3 * n).to(dev)

    scores = {}
    for i in range(cfg.depth):
        heads = cfg.layer_heads(i)
        mlp = cfg.layer_mlp_dim(i)
        if head_gran:
            attn_shapes = {n: (heads,) for n in ("q", "k", "v", "out")}
        else:
            qshape = _attn_block_shape(cfg, sparse, heads)
            # att out matrix is [out=dim, in=heads*hd] -> transposed blocks
            oshape = (max(cfg.dim // max(sparse.attn_block_rows, 1), 1),
                      max(heads * cfg.resolved_head_dim // max(sparse.attn_block_cols, 1), 1))
            attn_shapes = {"q": qshape, "k": qshape, "v": qshape, "out": oshape}
        if dense_1d:
            fc1_shape = fc2_shape = (mlp,)
        else:
            fc1_shape, fc2_shape = _dense_block_shapes(cfg, sparse, mlp)
        shapes = {**attn_shapes, "fc1": fc1_shape, "fc2": fc2_shape}
        scores[f"block_{i}"] = {k: mk(shape) for k, shape in shapes.items()}
    return scores


def _binarize(scores, threshold, sparse: SparseConfig):
    if sparse.method == "topk":
        return topk_mask(scores, threshold)
    if sparse.method in ("threshold", "sigmoied_threshold"):
        return threshold_mask(scores, threshold, sigmoid=sparse.method == "sigmoied_threshold")
    if sparse.method == "magnitude":
        return magnitude_mask(scores, threshold)
    if sparse.method == "l0":
        # deterministic gate; sparsity is driven by l0_penalty, the
        # threshold knob is unused (matches nn_pruning's l0 semantics)
        return l0_gate(scores)
    raise ValueError(f"unknown method {sparse.method!r}")


def apply_masks(
    cfg: ViTConfig,
    params: Dict,
    mask_scores: Dict,
    thresholds,  # [(thr_attn, thr_ffn)] per layer, or a [depth, 2] tensor
    sparse: SparseConfig,
) -> Dict:
    """Masked copy of the params (mask recomputed from current scores, like
    MaskedLinear.forward).  Head-granular masks broadcast over the fused-qkv
    layout [dim, 3*H*hd] / out [H*hd, dim]; FFN row/col masks over fc1/fc2."""
    p = params["params"] if "params" in params else params
    hd = cfg.resolved_head_dim
    new_p = dict(p)
    for i in range(cfg.depth):
        heads = cfg.layer_heads(i)
        thr_a, thr_f = thresholds[i]
        sc = mask_scores[f"block_{i}"]
        blk = dict(p[f"block_{i}"])
        attn = dict(blk["attn"])
        ffn = dict(blk["ffn"])

        mq = _binarize(sc["q"], thr_a, sparse)
        mk_ = _binarize(sc["k"], thr_a, sparse)
        mv = _binarize(sc["v"], thr_a, sparse)
        mo = _binarize(sc["out"], thr_a, sparse)
        if mq.dim() == 1:
            # head-granular: mask over output cols ordered (qkv, head, hd)
            qkv_mask = torch.cat([mq.repeat_interleave(hd), mk_.repeat_interleave(hd),
                                  mv.repeat_interleave(hd)])
            attn["qkv_kernel"] = attn["qkv_kernel"] * qkv_mask[None, :]
            if "qkv_bias" in attn:
                attn["qkv_bias"] = attn["qkv_bias"] * qkv_mask
            out_mask = mo.repeat_interleave(hd)
            attn["out_kernel"] = attn["out_kernel"] * out_mask[:, None]
        else:
            # generic 2D blocks in torch [out, in] orientation; the kernels
            # are [in, out] so the expanded mask is transposed
            out_dim, in_dim = heads * hd, attn["qkv_kernel"].shape[0]
            eq = expand_block_mask(mq, out_dim, in_dim).T
            ek = expand_block_mask(mk_, out_dim, in_dim).T
            ev = expand_block_mask(mv, out_dim, in_dim).T
            attn["qkv_kernel"] = attn["qkv_kernel"] * torch.cat([eq, ek, ev], dim=1)
            eo = expand_block_mask(mo, in_dim, out_dim).T  # att out: [dim, h*hd]
            attn["out_kernel"] = attn["out_kernel"] * eo

        m1 = _binarize(sc["fc1"], thr_f, sparse)
        m2 = _binarize(sc["fc2"], thr_f, sparse)
        if m1.dim() == 1:
            ffn["fc1_kernel"] = ffn["fc1_kernel"] * m1[None, :]
            ffn["fc1_bias"] = ffn["fc1_bias"] * m1
            ffn["fc2_kernel"] = ffn["fc2_kernel"] * m2[:, None]
        else:
            mlp_dim = ffn["fc1_kernel"].shape[1]
            dim_in = ffn["fc1_kernel"].shape[0]
            ffn["fc1_kernel"] = ffn["fc1_kernel"] * expand_block_mask(m1, mlp_dim, dim_in).T
            ffn["fc2_kernel"] = ffn["fc2_kernel"] * expand_block_mask(m2, dim_in, mlp_dim).T

        blk["attn"] = attn
        blk["ffn"] = ffn
        new_p[f"block_{i}"] = blk
    return {"params": new_p} if "params" in params else new_p


# ---------------------------------------------------------------------------
# Threshold schedule (cubic)
# ---------------------------------------------------------------------------


def schedule_thresholds(step: int, total_steps: int, cfg: ViTConfig, sparse: SparseConfig):
    """Per-layer (thr_attn, thr_ffn) at ``step`` plus regu multiplier.

    Reproduces schedule_threshold (patch_coordinator.py:411-528): constant
    ``initial_threshold`` during initial warmup, per-layer final threshold
    after final warmup, cubic interpolation between; the regularization
    coefficient ramps with the complementary cubic.
    """
    if sparse.layerwise_thresholds is not None:
        finals = parse_layerwise_thresholds(sparse.layerwise_thresholds, cfg.depth)
    else:
        finals = [(sparse.final_threshold, sparse.final_threshold)] * cfg.depth

    t0 = sparse.initial_warmup * sparse.warmup_steps
    t1 = sparse.final_warmup * sparse.warmup_steps
    span = max(total_steps - (t0 + t1), 1)

    if step <= t0:
        frac = 0.0
    elif step > total_steps - t1:
        frac = 1.0
    else:
        mul = (step - t0) / span
        frac = 1.0 - (1.0 - mul) ** 3

    thresholds = [
        (
            sparse.initial_threshold + frac * (fh - sparse.initial_threshold),
            sparse.initial_threshold + frac * (fd - sparse.initial_threshold),
        )
        for (fh, fd) in finals
    ]
    regu_mul = frac  # lambda ramps in as sparsity ramps
    return thresholds, regu_mul


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def regularization_loss(mask_scores: Dict, sparse: SparseConfig, regu_mul=1.0):
    """L1-of-sigmoid (or expected-L0) on mask scores, lambda split attention
    vs dense (patch_coordinator.py:530-627).  0.0 without regularization."""
    if sparse.regularization not in ("l1", "l0"):
        return 0.0
    term = l0_penalty if sparse.regularization == "l0" else (
        lambda v: torch.sigmoid(v).mean()
    )
    attn_terms, dense_terms = [], []
    for blk in mask_scores.values():
        for k, v in blk.items():
            (attn_terms if k in ("q", "k", "v", "out") else dense_terms).append(term(v))
    loss = 0.0
    if attn_terms:
        loss = loss + sparse.regu_lambda_attention * sum(attn_terms) / len(attn_terms)
    if dense_terms:
        loss = loss + sparse.regu_lambda_dense * sum(dense_terms) / len(dense_terms)
    return regu_mul * loss


def distillation_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                      ce_loss: torch.Tensor, alpha: float, temperature: float):
    """(1-alpha)*ce + alpha*T^2*KL(student||teacher) (trainer.py:72-97,
    src/utils.py:241-258)."""
    t = temperature
    s = torch.log_softmax(student_logits.float() / t, dim=-1)
    q = torch.softmax(teacher_logits.float() / t, dim=-1)
    kl = (q * (torch.log(torch.clamp(q, min=1e-20)) - s)).sum(dim=-1).mean()
    return (1.0 - alpha) * ce_loss + alpha * kl * t * t


# ---------------------------------------------------------------------------
# Compile: bake masks -> structural shrink
# ---------------------------------------------------------------------------


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def compile_sparse_model(
    cfg: ViTConfig,
    params: Dict,
    mask_scores: Dict,
    sparse: SparseConfig,
    final_thresholds=None,
):
    """Bake final masks into weights, then shrink shapes:

    1. apply final masks (MaskedLinearModelCompiler, masked_nn.py:453-464);
    2. score each head 0..3 = #{q,k,v} masks nonzero (BertHeadsPruner
       analyze_head, inference_model_patcher.py:22-46), keep the best
       ceil(thr_attn*heads) heads, >=1 per layer (:56-76);
    3. FFN: keep units where fc1-row mask AND fc2-col mask are nonzero
       (optimize_model zero-propagation, :278-308), at least one;
    4. physically slice to static shapes.
    Returns (new_cfg, {"params": new_params}, report).
    """
    if final_thresholds is None:
        final_thresholds, _ = schedule_thresholds(10**9, 10**9, cfg, sparse)

    with torch.no_grad():
        masked = apply_masks(cfg, params, mask_scores, final_thresholds, sparse)
    p = masked["params"] if "params" in masked else masked

    to_prune: Dict[int, set] = {}
    ffn_keep: Dict[int, list] = {}
    report = {}
    for i in range(cfg.depth):
        heads = cfg.layer_heads(i)
        thr_a, thr_f = final_thresholds[i]
        sc = mask_scores[f"block_{i}"]
        hd = cfg.resolved_head_dim
        mq = _np(_binarize(sc["q"], thr_a, sparse))
        mk_ = _np(_binarize(sc["k"], thr_a, sparse))
        mv = _np(_binarize(sc["v"], thr_a, sparse))
        if mq.ndim == 1:
            head_score = mq + mk_ + mv  # 0..3 per head
        else:
            # 2D block masks: head is "alive" in a matrix if ANY of its rows
            # has a nonzero block (BertHeadsPruner.analyze_head semantics)
            def _head_alive(m):
                e = _np(expand_block_mask(torch.from_numpy(m), heads * hd, cfg.dim))
                return (np.abs(e.reshape(heads, hd, -1)) > 0).any(axis=(1, 2))

            head_score = (
                _head_alive(mq).astype(np.float64)
                + _head_alive(mk_)
                + _head_alive(mv)
            )
        n_keep = max(1, math.ceil(float(thr_a) * heads))
        order = np.argsort(-head_score, kind="stable")
        keep = set(order[:n_keep].tolist())
        pruned = {h for h in range(heads) if h not in keep}
        if pruned:
            to_prune[i] = pruned

        m1 = _np(_binarize(sc["fc1"], thr_f, sparse))
        m2 = _np(_binarize(sc["fc2"], thr_f, sparse))
        mlp = cfg.layer_mlp_dim(i)
        if m1.ndim == 1:
            both = (m1 > 0) & (m2 > 0)
        else:
            e1 = _np(expand_block_mask(torch.from_numpy(m1), mlp, cfg.dim))
            e2 = _np(expand_block_mask(torch.from_numpy(m2), cfg.dim, mlp))
            both = (np.abs(e1) > 0).any(axis=1) & (np.abs(e2) > 0).any(axis=0)
        keep_units = np.nonzero(both)[0].tolist() or [0]
        ffn_keep[i] = keep_units
        report[i] = {
            "heads_kept": n_keep,
            "head_scores": head_score.tolist(),
            "ffn_kept": len(keep_units),
            "ffn_total": int(m1.size),
        }

    cfg1, p1 = prune_heads_params(cfg, {"params": p}, to_prune)
    cfg2, p2 = prune_ffn_params(cfg1, p1, ffn_keep)
    return cfg2, p2, report


def unzero_params(params: Dict, generator: Optional[torch.Generator] = None,
                  scale: float = 0.02) -> Dict:
    """Re-seed exactly-zero weights of every leaf of 2+ dims with
    ``scale * N(0, 1)`` before the final finetune
    (deit_pruning/src/utils.py:44-65 unzero_parameters).  The normals are
    drawn on the CPU from ``generator``, leaf by leaf in the tree's order."""
    def fn(leaf):
        if leaf.dim() < 2:
            return leaf
        noise = torch.randn(leaf.shape, generator=generator).to(leaf.device, leaf.dtype)
        return torch.where(leaf == 0.0, scale * noise, leaf)

    return tree_map(fn, params)


def sparsity_report(params: Dict) -> Dict[str, float]:
    """show_deit_sparsity analogue (src/utils.py:261-283): fraction of zeros
    per 2D+ weight (keyed ``['block_0']['attn']['qkv_kernel']``, as
    ``jax.tree_util.keystr`` writes a path) and overall."""
    p = params["params"] if "params" in params else params
    rep = {}
    tot = nz = 0
    for name, leaf in flatten_tree(p).items():
        if leaf.dim() < 2:
            continue
        z = int((leaf == 0.0).sum())
        n = leaf.numel()
        rep["".join(f"[{k!r}]" for k in name.split("."))] = z / n
        tot += n
        nz += z
    rep["__overall__"] = nz / max(tot, 1)
    return rep
