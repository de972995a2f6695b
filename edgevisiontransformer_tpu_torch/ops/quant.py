"""Quantization of ViT encoders (port of ``edgevisiontransformer_tpu/ops/quant.py``):
the parameter cast, int8 (dynamic and static, with calibration),
quantization-aware training and SmoothQuant.

Weights are quantized symmetrically per output channel; activations per row
at run time (dynamic, the TFLite dynamic-range mode) or per tensor with
scales calibrated on representative data (static, the full-integer mode).
The int8 product is exact: it runs in float64, where every partial sum of
int8 products is an integer below 2^53, and is rounded once to fp32 as the
reference's int32 -> f32 cast rounds.

Parameter trees are nested dicts of tensors keyed as the Flax tree
(``models.vit.ViT.params()``).  A quantized kernel leaf becomes
``{"q": int8 [in, out], "scale": f32 [out]}``, plus ``"act_scale"`` (f32
scalar) in the static tree.  Divisions that JAX evaluates eagerly are IEEE
quotients here too (tensor by tensor: PyTorch may turn a division by a
Python scalar into a product with its reciprocal).
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict

import numpy as np
import torch

from .activations import get_gelu
from .attention import merge_heads, qkv_split, sdpa
from .layers import layer_norm, patch_embed

# ---------------------------------------------------------------------------
# Casting (float16 / bfloat16 mode)
# ---------------------------------------------------------------------------


def cast_params(params, dtype: torch.dtype = torch.bfloat16):
    """Every floating leaf of a nested dict of tensors cast to ``dtype``;
    the other leaves as they are (the float16 / bfloat16 conversion)."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, torch.Tensor) and params.is_floating_point():
        return params.to(dtype)
    return params


# ---------------------------------------------------------------------------
# Weights and activations
# ---------------------------------------------------------------------------


def _div127(a: torch.Tensor) -> torch.Tensor:
    return a / torch.full_like(a, 127.0)


def quantize_weight_int8(w: torch.Tensor):
    """Per-output-channel symmetric int8: ``w [in, out]`` -> ``(q int8,
    scale f32 [out])``."""
    absmax = w.abs().amax(dim=0)
    scale = torch.where(absmax > 0, _div127(absmax), torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_weight_int8(q: torch.Tensor, scale: torch.Tensor,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale[None, :].to(dtype)


def _true_div(x: torch.Tensor, scale) -> torch.Tensor:
    """``x / scale`` as an IEEE quotient on any device: a divisor that is a
    Python number or a CPU scalar becomes a product with its reciprocal on
    a CUDA tensor, and a flipped rounding tie there moves a whole quantum."""
    return x / torch.as_tensor(scale, dtype=x.dtype, device=x.device)


class _FakeQuantSTE(torch.autograd.Function):
    """Per-output-channel int8 round trip of a weight ``[in, out]``; the
    backward is the identity (straight-through)."""

    @staticmethod
    def forward(ctx, w):
        q, scale = quantize_weight_int8(w)
        return dequantize_weight_int8(q, scale, w.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quant_ste(w: torch.Tensor) -> torch.Tensor:
    """QAT weight fake quant: the deployment quantizer's round trip
    (:func:`quantize_weight_int8`, :func:`dequantize_weight_int8`) with a
    straight-through gradient."""
    return _FakeQuantSTE.apply(w)


def fake_quant_tree(params, min_ndim: int = 2):
    """Fake-quantize every leaf of at least ``min_ndim`` dims of a nested
    dict of tensors (the QAT training forward)."""
    if isinstance(params, dict):
        return {k: fake_quant_tree(v, min_ndim) for k, v in params.items()}
    return fake_quant_ste(params) if getattr(params, "ndim", 0) >= min_ndim else params


def fake_quant_vit_encoder(params: Dict) -> Dict:
    """QAT fake quant of the encoder matmul kernels only (``_VIT_MATMUL_KEYS``),
    the ones the int8 paths quantize: embeddings and heads stay float at
    deployment, so training against their quantization noise would be
    training against noise the deployment does not have."""
    p = _unwrap(params)
    new_p = dict(p)
    for name, blk in p.items():
        if not name.startswith("block_"):
            continue
        blk = _copy_block(blk)
        for sub, key in _VIT_MATMUL_KEYS:
            blk[sub][key] = fake_quant_ste(blk[sub][key])
        new_p[name] = blk
    return {**params, "params": new_p} if "params" in params else new_p


class _FakeQuantActSTE(torch.autograd.Function):
    """Symmetric int8 round trip of an activation at a fixed scale; the
    backward passes the gradient where ``|x / scale| <= 127`` and zeroes it
    in the saturated region, where the forward is flat."""

    @staticmethod
    def forward(ctx, x, scale: float):
        xs = _true_div(x, scale)
        ctx.save_for_backward(xs.abs() <= 127.0)
        q = torch.clamp(torch.round(xs), -127, 127)
        return (q * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return torch.where(mask, g, torch.zeros_like(g)), None


def fake_quant_act_ste(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Static-QAT activation fake quant at a fixed calibrated ``scale`` (a
    Python number) with the clip-masked straight-through gradient; with the
    weight STE it makes the static-int8-aware forward
    (:func:`fake_quant_vit_apply_static`).  For a scale that changes during
    training use :func:`fake_quant_act`."""
    return _FakeQuantActSTE.apply(x, float(scale))


def fake_quant_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """:func:`fake_quant_act_ste` with ``scale`` a tensor (the live-observer
    path, whose scales move during training): the same forward and the same
    clip-masked straight-through gradient, through the ``detach``
    identity ``passthrough + (fq(x) - passthrough).detach()``."""
    xs = _true_div(x.float(), scale)
    q = (torch.clamp(torch.round(xs), -127, 127) * scale).to(x.dtype)
    mask = (xs.abs() <= 127.0).to(x.dtype)
    passthrough = x * mask
    return passthrough + (q - passthrough).detach()


def _int8_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``xq @ wq`` of int8 operands, exact, as fp32."""
    return (xq.double() @ wq.double()).float()


def quantize_activation_rows(x: torch.Tensor):
    """Per-row dynamic activation quant: ``x [m, k]`` -> ``(q int8, scale
    f32 [m, 1])``.  The absmax and its ``/ 127`` stay in ``x.dtype``, as in
    the reference."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, _div127(absmax.float()).to(x.dtype),
                        torch.ones_like(absmax)).float()
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul_dynamic(x: torch.Tensor, wq: torch.Tensor,
                        w_scale: torch.Tensor) -> torch.Tensor:
    """Dynamic-range int8 matmul: quantize ``x`` per row at run time, exact
    int8 product, dequantize with row and column scales."""
    shape = x.shape
    xq, x_scale = quantize_activation_rows(x.reshape(-1, shape[-1]))
    out = _int8_product(xq, wq) * x_scale * w_scale[None, :]
    return out.to(x.dtype).reshape(*shape[:-1], wq.shape[1])


def quantize_activation_static(x: torch.Tensor, scale) -> torch.Tensor:
    """Per-tensor static activation quant with a calibrated ``scale``."""
    inv = 1.0 / torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() * inv), -127, 127).to(torch.int8)


def int8_matmul_static(x: torch.Tensor, wq: torch.Tensor, comb_scale: torch.Tensor,
                       act_scale) -> torch.Tensor:
    """Static int8 matmul: ``int8(x / act_scale) @ wq``, dequantized by the
    combined per-channel scale ``w_scale * act_scale``."""
    shape = x.shape
    xq = quantize_activation_static(x.reshape(-1, shape[-1]), act_scale)
    out = _int8_product(xq, wq) * comb_scale[None, :]
    return out.to(x.dtype).reshape(*shape[:-1], wq.shape[1])


# ---------------------------------------------------------------------------
# Whole-model int8 (ViT)
# ---------------------------------------------------------------------------

_VIT_MATMUL_KEYS = (
    ("attn", "qkv_kernel"),
    ("attn", "out_kernel"),
    ("ffn", "fc1_kernel"),
    ("ffn", "fc2_kernel"),
)

# Per-layer matmul-input names, in the order the static kernels consume them.
VIT_ACT_KEYS = ("qkv_in", "out_in", "fc1_in", "fc2_in")


def _unwrap(tree: Dict) -> Dict:
    return tree["params"] if "params" in tree else tree


def _copy_block(blk: Dict) -> Dict:
    return {k: dict(v) if isinstance(v, dict) else v for k, v in blk.items()}


def quantize_vit_params_int8(params: Dict) -> Dict:
    """Quantize every encoder matmul kernel of a ViT param tree to int8:
    each becomes ``{"q": int8, "scale": f32 [out]}``.  Embedding, patch and
    head stay float."""
    p = _unwrap(params)
    new_p = dict(p)
    for name, blk in p.items():
        if not name.startswith("block_"):
            continue
        blk = _copy_block(blk)
        for sub, key in _VIT_MATMUL_KEYS:
            q, s = quantize_weight_int8(blk[sub][key])
            blk[sub][key] = {"q": q, "scale": s}
        new_p[name] = blk
    return {**params, "params": new_p} if "params" in params else new_p


def quantize_vit_params_int8_static(params: Dict, act_scales) -> Dict:
    """Static-int8 ViT param tree: each encoder matmul kernel becomes
    ``{"q": int8, "scale": f32 [out] (w_scale * act_scale), "act_scale": f32
    scalar}``, with ``act_scales [depth, 4]`` from :func:`calibrate_vit`."""
    act_scales = np.asarray(act_scales, np.float32)
    p = _unwrap(params)
    new_p = dict(p)
    for name, blk in p.items():
        if not name.startswith("block_"):
            continue
        i = int(name.split("_")[1])
        blk = _copy_block(blk)
        for j, (sub, key) in enumerate(_VIT_MATMUL_KEYS):
            q, s = quantize_weight_int8(blk[sub][key])
            a = float(act_scales[i, j])
            blk[sub][key] = {"q": q, "scale": s * a,
                             "act_scale": torch.tensor(a, dtype=torch.float32,
                                                       device=s.device)}
        new_p[name] = blk
    return {**params, "params": new_p} if "params" in params else new_p


def _mm_int8_dynamic(x: torch.Tensor, leaf: Dict) -> torch.Tensor:
    return int8_matmul_dynamic(x, leaf["q"], leaf["scale"])


def _mm_int8_static(x: torch.Tensor, leaf: Dict) -> torch.Tensor:
    return int8_matmul_static(x, leaf["q"], leaf["scale"], leaf["act_scale"])


def _int8_encoder_blocks(cfg, p: Dict, x: torch.Tensor, mm) -> torch.Tensor:
    """Eager encoder walk over embedded tokens with every matmul routed
    through ``mm(x, quantized_leaf)`` (dynamic or static)."""
    act = get_gelu(cfg.gelu_approx)
    hd = cfg.resolved_head_dim
    for i in range(cfg.depth):
        blk = p[f"block_{i}"]
        heads = cfg.layer_heads(i)
        h = layer_norm(x, blk["ln1"]["scale"], blk["ln1"]["bias"], cfg.layernorm_eps)
        qkv = mm(h, blk["attn"]["qkv_kernel"])
        if cfg.qkv_bias:
            qkv = qkv + blk["attn"]["qkv_bias"].to(qkv.dtype)
        q, k, v = qkv_split(qkv, heads, hd)
        ctx = merge_heads(sdpa(q, k, v, scale=hd ** -0.5))
        attn_out = mm(ctx, blk["attn"]["out_kernel"])
        attn_out = attn_out + blk["attn"]["out_bias"].to(attn_out.dtype)
        x = (attn_out + h) if cfg.reference_residual else (x + attn_out)

        h2 = layer_norm(x, blk["ln2"]["scale"], blk["ln2"]["bias"], cfg.layernorm_eps)
        hid = act(mm(h2, blk["ffn"]["fc1_kernel"]) + blk["ffn"]["fc1_bias"].to(x.dtype))
        mlp = mm(hid, blk["ffn"]["fc2_kernel"])
        mlp = mlp + blk["ffn"]["fc2_bias"].to(mlp.dtype)
        x = (mlp + h2) if cfg.reference_residual else (x + mlp)
    return x


def _dense(x: torch.Tensor, leaf: Dict) -> torch.Tensor:
    """``x @ kernel + bias`` with JAX's type promotion (a bf16 activation
    against fp32 params computes in fp32)."""
    dt = torch.promote_types(x.dtype, leaf["kernel"].dtype)
    return x.to(dt) @ leaf["kernel"].to(dt) + leaf["bias"].to(dt)


def _vit_head(cfg, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """ViT epilogue: optional final norm, cls select, 1- or 2-layer head."""
    if cfg.final_norm:
        x = layer_norm(x, p["final_norm"]["scale"], p["final_norm"]["bias"],
                       cfg.layernorm_eps)
    x = x[:, 0]
    if cfg.mlp_head:
        return _dense(get_gelu(cfg.gelu_approx)(_dense(x, p["head_fc1"])), p["head_fc2"])
    return _dense(x, p["head"])


def _embed_vit(cfg, p: Dict, img: torch.Tensor) -> torch.Tensor:
    """ViT embedding prologue: patch embed + cls + learned pos, in the
    compute dtype."""
    dt = cfg.dtype
    x = patch_embed(img.to(dt), p["patch_kernel"].to(dt), p["patch_bias"].to(dt),
                    cfg.patch_size)
    cls = p["cls_token"].to(dt).expand(x.shape[0], 1, cfg.dim)
    return torch.cat([cls, x], dim=1) + p["pos_embedding"].to(dt)


def _fake_quant_vit(model, params: Dict, act_scales, img: torch.Tensor, seen=None):
    cfg = model.config
    p = _unwrap(params)
    scales = torch.as_tensor(act_scales, dtype=torch.float32, device=img.device)
    counter = itertools.count()

    def mm(x_, w):
        i, j = divmod(next(counter), 4)
        if seen is not None:
            seen.append(x_.detach().abs().max().float())
        xq = fake_quant_act(x_, scales[i, j])
        return xq @ fake_quant_ste(w).to(xq.dtype)

    x = _int8_encoder_blocks(cfg, p, _embed_vit(cfg, p, img), mm)
    return _vit_head(cfg, p, x)


def fake_quant_vit_apply_static(model, params: Dict, act_scales, img: torch.Tensor
                                ) -> torch.Tensor:
    """Differentiable ViT forward that sees the static-int8 deployment's
    quantization: every encoder matmul runs ``fq(x; calibrated scale) @
    fq(w)`` with straight-through gradients, embeddings and head float.
    ``act_scales [depth, 4]`` (:func:`calibrate_vit`) may change between
    calls; ``params`` is a Flax-keyed tree, bare or under ``"params"``."""
    return _fake_quant_vit(model, params, act_scales, img)


def fake_quant_vit_apply_observed(model, params: Dict, act_scales, img: torch.Tensor):
    """:func:`fake_quant_vit_apply_static` that also returns the batch
    absmax of every matmul input it saw, ``[depth, 4]`` fp32, detached: the
    live observer a training loop updates its scales from."""
    seen: list = []
    logits = _fake_quant_vit(model, params, act_scales, img, seen)
    return logits, torch.stack(seen).reshape(model.config.depth, 4)


def int8_vit_apply(model, qparams: Dict, img: torch.Tensor) -> torch.Tensor:
    """Forward pass with int8 dynamic-range encoder matmuls: ``model``'s
    math with each encoder matmul through :func:`int8_matmul_dynamic`."""
    cfg = model.config
    p = _unwrap(qparams)
    x = _int8_encoder_blocks(cfg, p, _embed_vit(cfg, p, img), _mm_int8_dynamic)
    return _vit_head(cfg, p, x)


def int8_vit_apply_static(model, qparams: Dict, img: torch.Tensor) -> torch.Tensor:
    """Forward pass with static int8 encoder matmuls (``qparams`` from
    :func:`quantize_vit_params_int8_static`): the eager oracle of the static
    kernel path."""
    cfg = model.config
    p = _unwrap(qparams)
    x = _int8_encoder_blocks(cfg, p, _embed_vit(cfg, p, img), _mm_int8_static)
    return _vit_head(cfg, p, x)


# ---------------------------------------------------------------------------
# Static int8 calibration (representative dataset)
# ---------------------------------------------------------------------------


def percentile_linear(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(a, q)`` over all elements, linear interpolation.

    Two ``kthvalue`` selections instead of a sort or ``torch.quantile``
    (which refuses inputs above 2^24 elements).  The position is computed
    in fp32, as JAX computes it."""
    flat = a.reshape(-1)
    n = flat.numel()
    pos = np.float32(q) / np.float32(100.0) * np.float32(n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w_hi = np.float32(pos - np.float32(lo))
    lo_v = torch.kthvalue(flat, min(max(lo, 0), n - 1) + 1).values
    hi_v = torch.kthvalue(flat, min(max(hi, 0), n - 1) + 1).values
    return lo_v * float(np.float32(1) - w_hi) + hi_v * float(w_hi)


def calibrate_activation_scales(apply_collect: Callable[[torch.Tensor], Dict],
                                batches, percentile: float | None = None) -> Dict[str, float]:
    """Run representative batches through ``apply_collect`` (``{name:
    activation}`` per batch), keep each tensor's running absmax (or
    per-batch abs-percentile) and return ``{name: max / 127}`` (1.0 where
    the max is 0)."""
    maxes: Dict[str, torch.Tensor] = {}
    for batch in batches:
        acts = apply_collect(torch.as_tensor(np.asarray(batch)))
        for name, a in acts.items():
            aa = a.abs().float()
            m = percentile_linear(aa, percentile) if percentile is not None else aa.max()
            maxes[name] = m if name not in maxes else torch.maximum(maxes[name], m)
    names = list(maxes)
    vals = torch.stack([maxes[k] for k in names]).cpu().numpy()
    return {k: (float(v) / 127.0 if v > 0 else 1.0) for k, v in zip(names, vals)}


def encoder_collect_matmul_inputs(cfg, p: Dict, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Float encoder walk over embedded tokens ``x`` recording every matmul
    input activation (``"block_{i}/qkv_in" | "out_in" | "fc1_in" |
    "fc2_in"``)."""
    act = get_gelu(cfg.gelu_approx)
    hd = cfg.resolved_head_dim
    out: Dict[str, torch.Tensor] = {}
    for i in range(cfg.depth):
        blk = p[f"block_{i}"]
        heads = cfg.layer_heads(i)
        h = layer_norm(x, blk["ln1"]["scale"], blk["ln1"]["bias"], cfg.layernorm_eps)
        out[f"block_{i}/qkv_in"] = h
        qkv = h @ blk["attn"]["qkv_kernel"].to(h.dtype)
        if cfg.qkv_bias:
            qkv = qkv + blk["attn"]["qkv_bias"].to(qkv.dtype)
        q, k, v = qkv_split(qkv, heads, hd)
        ctx = merge_heads(sdpa(q, k, v, scale=hd ** -0.5))
        out[f"block_{i}/out_in"] = ctx
        attn_out = ctx @ blk["attn"]["out_kernel"].to(ctx.dtype)
        attn_out = attn_out + blk["attn"]["out_bias"].to(attn_out.dtype)
        x = (attn_out + h) if cfg.reference_residual else (x + attn_out)

        h2 = layer_norm(x, blk["ln2"]["scale"], blk["ln2"]["bias"], cfg.layernorm_eps)
        out[f"block_{i}/fc1_in"] = h2
        hid = act(h2 @ blk["ffn"]["fc1_kernel"].to(h2.dtype)
                  + blk["ffn"]["fc1_bias"].to(h2.dtype))
        out[f"block_{i}/fc2_in"] = hid
        mlp = hid @ blk["ffn"]["fc2_kernel"].to(hid.dtype)
        mlp = mlp + blk["ffn"]["fc2_bias"].to(mlp.dtype)
        x = (mlp + h2) if cfg.reference_residual else (x + mlp)
    return out


def vit_collect_matmul_inputs(model, variables: Dict, img: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Float forward recording every encoder matmul input activation: the
    tensors the static-int8 kernels quantize with calibrated scales."""
    cfg = model.config
    p = _unwrap(variables)
    return encoder_collect_matmul_inputs(cfg, p, _embed_vit(cfg, p, img))


def representative_batches(n: int = 100, batch: int = 1, shape=(3, 224, 224), seed=0):
    """Random-normal representative dataset: the reference's stream, so both
    packages see identical batches from one seed."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        yield rng.randn(batch, *shape).astype(np.float32)


# Candidate clip fractions for method="mse" (of the pass-1 absmax).
MSE_CLIP_RATIOS = (0.6, 0.7, 0.8, 0.85, 0.9, 0.95, 1.0)


def _smooth_s(act_max: np.ndarray, w_in_max: np.ndarray, alpha: float) -> np.ndarray:
    """SmoothQuant migration strength ``s_j = max|X_j|^a / max|W_j|^(1-a)``
    in float64, cast to fp32: channels the calibration set never activates
    (``act_max`` 0) keep ``s = 1``, and ``s`` is clipped to ``[1e-3, 1e3]``
    so a dead weight row cannot explode the fold."""
    a = np.maximum(act_max.astype(np.float64), 1e-12)
    w = np.maximum(w_in_max.astype(np.float64), 1e-12)
    s = a ** alpha / w ** (1.0 - alpha)
    s = np.where(act_max > 0, s, 1.0)
    return np.clip(s, 1e-3, 1e3).astype(np.float32)


def _calibrate_encoder(embed_fn, model, variables, batches=None, n: int = 100,
                       percentile: float | None = None,
                       method: str = "absmax") -> np.ndarray:
    """Embed each representative batch with ``embed_fn(p, img)`` and reduce
    the encoder matmul-input absmaxes (or abs-percentiles) to ``act_scales
    [depth, 4]`` fp32 (VIT_ACT_KEYS order).  ``method="mse"`` adds a second
    pass that picks, per tensor, the clip ``ratio * absmax`` (ratio in
    MSE_CLIP_RATIOS) with the least int8 quantization MSE."""
    cfg = model.config
    if batches is None:
        batches = representative_batches(n=n, shape=(3, cfg.image_size, cfg.image_size))
    if method == "mse":
        batches = list(batches)  # two passes
    elif method != "absmax":
        raise ValueError(f"unknown calibration method {method!r}")
    p = _unwrap(variables)
    device = p["block_0"]["ln1"]["scale"].device  # every encoder family has block_0
    depth = cfg.depth

    def acts_of(batch):
        img = torch.as_tensor(np.asarray(batch), device=device)
        acts = encoder_collect_matmul_inputs(cfg, p, embed_fn(p, img))
        return [[acts[f"block_{i}/{key}"].float() for key in VIT_ACT_KEYS]
                for i in range(depth)]

    run_max = None
    with torch.no_grad():
        for batch in batches:
            m = torch.stack([torch.stack([
                percentile_linear(a.abs(), percentile) if percentile is not None
                else a.abs().max()
                for a in row]) for row in acts_of(batch)])
            run_max = m if run_max is None else torch.maximum(run_max, m)

        if method == "mse":
            ratios = torch.tensor(MSE_CLIP_RATIOS, dtype=torch.float32, device=device)
            mse_sum = None
            for batch in batches:
                rows = []
                for i, row in enumerate(acts_of(batch)):
                    cols = []
                    for j, a in enumerate(row):
                        s = torch.clamp(run_max[i, j], min=1e-30) * ratios / 127.0
                        errs = []
                        for r in range(len(MSE_CLIP_RATIOS)):
                            qa = torch.clamp(torch.round(a / s[r]), -127, 127) * s[r]
                            errs.append(torch.mean(torch.square(a - qa)))
                        cols.append(torch.stack(errs))
                    rows.append(torch.stack(cols))
                m = torch.stack(rows)  # [depth, 4, R]
                mse_sum = m if mse_sum is None else mse_sum + m
            best = ratios[mse_sum.argmin(dim=-1)]
            run_max = run_max * best

    out = run_max.cpu().numpy().astype(np.float32)
    out = out / 127.0
    out[out <= 0] = 1.0
    return out


def calibrate_vit(model, variables: Dict | None = None, batches=None, n: int = 100,
                  percentile: float | None = None, method: str = "absmax") -> np.ndarray:
    """Calibrate a ViT's encoder matmul-input scales on representative data.

    Returns ``act_scales [depth, 4]`` fp32 (VIT_ACT_KEYS columns), the input
    of ``prepare_vit_int8_static`` / :func:`quantize_vit_params_int8_static`.
    ``variables`` defaults to ``model.params()``; ``batches`` to the
    reference's 100 random-normal images; ``method`` is ``"absmax"`` or
    ``"mse"``; ``percentile`` (e.g. 99.9) clips outliers per batch."""
    if variables is None:
        variables = model.params()
    return _calibrate_encoder(lambda p, im: _embed_vit(model.config, p, im), model,
                              variables, batches=batches, n=n, percentile=percentile,
                              method=method)


def calibrate_t2t(model, variables: Dict | None = None, batches=None, n: int = 100,
                  percentile: float | None = None, method: str = "absmax") -> np.ndarray:
    """:func:`calibrate_vit` for T2T-ViT: the tokenizer embeds (the exact
    plain-unfold form, ``models/t2t_vit.t2t_tokenize(fast=False)``) and
    stays float at deployment; the encoder matmul inputs are collected as
    for a ViT."""
    from ..models.t2t_vit import t2t_tokenize

    if variables is None:
        variables = model.params()
    return _calibrate_encoder(lambda p, im: t2t_tokenize(model, im, params=p, fast=False),
                              model, variables, batches=batches, n=n, percentile=percentile,
                              method=method)


def _int8_t2t(model, qparams: Dict, img: torch.Tensor, mm) -> torch.Tensor:
    from ..models.t2t_vit import t2t_tokenize

    cfg = model.config
    p = _unwrap(qparams)
    x = _int8_encoder_blocks(cfg, p, t2t_tokenize(model, img, params=p, fast=False), mm)
    return _vit_head(cfg, p, x)


def int8_t2t_apply(model, qparams: Dict, img: torch.Tensor) -> torch.Tensor:
    """T2T forward with int8 dynamic-range encoder matmuls (``qparams`` from
    :func:`quantize_vit_params_int8` over the T2T tree); the tokenizer, in
    its plain-unfold form, stays float."""
    return _int8_t2t(model, qparams, img, _mm_int8_dynamic)


def int8_t2t_apply_static(model, qparams: Dict, img: torch.Tensor) -> torch.Tensor:
    """T2T forward with static int8 encoder matmuls (``qparams`` from
    :func:`quantize_vit_params_int8_static`): the eager oracle of
    ``fused_t2t_apply_int8`` on a ``prepare_t2t_int8_static`` stack."""
    return _int8_t2t(model, qparams, img, _mm_int8_static)


# ---------------------------------------------------------------------------
# SmoothQuant: offline scale migration (static-int8 preprocessing)
# ---------------------------------------------------------------------------

# The matmul inputs whose per-channel outlier spread folds exactly into the
# weights: qkv_in and fc1_in come out of a LayerNorm (1/s folds into its
# scale and bias, valid only when the LayerNorm output feeds nothing but the
# matmul: not with reference_residual, whose skip reuses LN(x)); out_in is
# the merged attention context, whose channel c is v's column c (softmax
# mixes tokens, not channels), so 1/s folds into the v columns of the fused
# qkv kernel and bias and s into the out kernel's rows, in both residual
# forms.  fc2_in sits behind the GELU and cannot be folded.
SMOOTH_KEYS = ("qkv_in", "out_in", "fc1_in")


def _collect_channel_maxes(embed_fn, model, variables: Dict, batches=None,
                           n: int = 32) -> Dict:
    """Per-channel absmax of the smoothable matmul inputs over representative
    batches (``n`` random-normal ones by default): ``{"block_i": {key:
    np.float32[channels]}}`` for ``key`` in :data:`SMOOTH_KEYS`.
    ``embed_fn(p, img)`` embeds a batch with the bare tree ``p``; the
    running max stays on the device until the end."""
    cfg = model.config
    if batches is None:
        batches = representative_batches(n=n, shape=(3, cfg.image_size, cfg.image_size))
    p = _unwrap(variables)
    device = p["block_0"]["ln1"]["scale"].device
    run_max: Dict[tuple, torch.Tensor] = {}
    with torch.no_grad():
        for batch in batches:
            img = torch.as_tensor(np.asarray(batch), device=device)
            acts = encoder_collect_matmul_inputs(cfg, p, embed_fn(p, img))
            for i in range(cfg.depth):
                for key in SMOOTH_KEYS:
                    a = acts[f"block_{i}/{key}"]
                    m = a.float().abs().reshape(-1, a.shape[-1]).amax(dim=0)
                    k = (i, key)
                    run_max[k] = m if k not in run_max else torch.maximum(run_max[k], m)
    return {f"block_{i}": {key: run_max[(i, key)].cpu().numpy() for key in SMOOTH_KEYS}
            for i in range(cfg.depth)}


def smooth_encoder_params(cfg, params: Dict, ch_maxes: Dict, alpha: float = 0.5) -> Dict:
    """Fold per-channel smoothing scales ``s`` (:func:`_smooth_s`) into an
    encoder param tree: a new float tree whose forward is the same function,
    re-parameterized so that the outlier channels of the smoothed matmul
    inputs shrink toward the weights, and the per-tensor static activation
    scales lose less resolution.  Offline only; the kernels are unchanged.
    With ``cfg.reference_residual`` only the ``out_in`` fold applies."""

    def strength(act_max: np.ndarray, w: torch.Tensor) -> torch.Tensor:
        w_in_max = w.abs().amax(dim=1).cpu().numpy()
        return torch.as_tensor(_smooth_s(act_max, w_in_max, alpha), device=w.device)

    p = _unwrap(params)
    new_p = dict(p)
    for name, blk in p.items():
        if not name.startswith("block_"):
            continue
        blk = _copy_block(blk)
        mx = ch_maxes[name]
        qkv_w = blk["attn"]["qkv_kernel"].float()
        if not cfg.reference_residual:
            # qkv_in and fc1_in: 1/s into the LayerNorm's affine, s into the
            # kernel's rows
            sj = strength(mx["qkv_in"], qkv_w)
            blk["ln1"] = {k: v / sj for k, v in blk["ln1"].items()}
            qkv_w = qkv_w * sj[:, None]
            fc1_w = blk["ffn"]["fc1_kernel"].float()
            sj = strength(mx["fc1_in"], fc1_w)
            blk["ln2"] = {k: v / sj for k, v in blk["ln2"].items()}
            blk["ffn"]["fc1_kernel"] = fc1_w * sj[:, None]
        # out_in: 1/s into the v columns [2W/3, W) of the fused qkv kernel
        # and bias (ctx channel c is v column v0 + c), s into the out
        # kernel's rows
        out_w = blk["attn"]["out_kernel"].float()
        v0 = 2 * (qkv_w.shape[1] // 3)
        sj = strength(mx["out_in"], out_w)
        inv = 1.0 / sj
        qkv_w = torch.cat([qkv_w[:, :v0], qkv_w[:, v0:] * inv[None, :]], dim=1)
        if cfg.qkv_bias:
            qb = blk["attn"]["qkv_bias"].float()
            blk["attn"]["qkv_bias"] = torch.cat([qb[..., :v0], qb[..., v0:] * inv], dim=-1)
        blk["attn"]["qkv_kernel"] = qkv_w
        blk["attn"]["out_kernel"] = out_w * sj[:, None]
        new_p[name] = blk
    return {**params, "params": new_p} if "params" in params else new_p


def smooth_vit(model, variables: Dict | None = None, batches=None, n: int = 32,
               alpha: float = 0.5) -> Dict:
    """SmoothQuant preprocessing for the ViT family: per-channel activation
    maxima on representative data, folded into the param tree
    (``variables`` defaults to ``model.params()``).  The result goes
    through :func:`calibrate_vit` and the static-int8 preparation as any
    tree does."""
    if variables is None:
        variables = model.params()
    ch = _collect_channel_maxes(lambda p, im: _embed_vit(model.config, p, im), model,
                                variables, batches=batches, n=n)
    return smooth_encoder_params(model.config, variables, ch, alpha=alpha)


def smooth_t2t(model, variables: Dict | None = None, batches=None, n: int = 32,
               alpha: float = 0.5) -> Dict:
    """:func:`smooth_vit` for T2T-ViT: the tokenizer (its plain-unfold form,
    ``t2t_tokenize(fast=False)``) embeds and stays float; the encoder
    blocks share the ViT layout."""
    from ..models.t2t_vit import t2t_tokenize

    if variables is None:
        variables = model.params()
    ch = _collect_channel_maxes(
        lambda p, im: t2t_tokenize(model, im, params=p, fast=False), model, variables,
        batches=batches, n=n)
    return smooth_encoder_params(model.config, variables, ch, alpha=alpha)
