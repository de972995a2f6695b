"""T2T-ViT as PyTorch modules (port of ``edgevisiontransformer_tpu/models/t2t_vit.py``).

Three soft splits (unfold k7 s4 p2, k3 s2 p1, k3 s2 p1) with a
TokenPerformer (positive-random-feature linear attention) after each of the
first two, a Dense projection to the embedding size, then the pre-norm ViT
encoder with a fixed sinusoid position table, a final LayerNorm and a linear
head.  Parameters keep the Flax names (:meth:`T2TViT.params`); the Flax
``constants`` collection (each performer's random-feature matrix ``w`` and
the position table) are buffers (:meth:`T2TViT.constants`).

:func:`fused_t2t_apply` and :func:`fused_t2t_apply_int8` are the inference
paths: :func:`t2t_tokenize` (at batch < 8 through the stage-1 kernel,
``ops/cuda/t2t_stage1.stage1_kqv``; both performers on the K16 kernels,
``ops/cuda/performer.performer_rest``; optionally the int8 stem of
:func:`prepare_t2t_stem_int8_static`), then the encoder on the hand-written
kernels (``ops/cuda/fused_encoder``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import REFERENCE_STYLE, STANDARD_STYLE, ViTConfig
from ..ops.activations import get_gelu
from ..ops.cuda.fused_encoder import BIAS, linear_i8, linear_i8_plain, quant_rows, quant_rows_plain
from ..ops.cuda.performer import performer_operands, performer_rest, performer_rest_plain
from ..ops.cuda.t2t_stage1 import (FEATURES, K9, S2D, SHIFTS, shift_concat, stage1_kqv,
                                   stage1_kqv_plain)
from ..ops.layers import layer_norm, mlp_block
from ..ops.quant import _dense, _unwrap, int8_matmul_static, quantize_weight_int8
from ..ops.unfold import unfold, unfold_output_size
from .vit import (INT8_VARIANTS, Dense, EncoderBlock, LayerNormP, _check_fused, _fused_head,
                  _param, _remat_block, lecun_normal_, model_device, nested_tree,
                  prepare_vit_fused, xavier_uniform_)


def sinusoid_encoding(n_position: int, d_hid: int) -> np.ndarray:
    """Fixed sinusoid position table (numpy, as in the JAX package, so both
    packages hold the same table)."""
    position = np.arange(n_position)[:, None]
    hid = np.arange(d_hid)[None, :]
    angle = position / np.power(10000, 2 * (hid // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def _prm_exp(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``exp(w . t - |t|^2 / 2) / sqrt(m)`` in fp32."""
    t = t.float()
    td = (t * t).sum(dim=-1, keepdim=True) / 2.0
    return torch.exp(torch.einsum("bti,mi->btm", t, w) - td) / math.sqrt(w.shape[0])


def _linear_attention(kqv: torch.Tensor, w: torch.Tensor, eps: float):
    """The performer's attention in fp32 on the ``k, q, v`` thirds of
    ``kqv``: returns ``(y, v)`` as fp32."""
    k, q, v = kqv.chunk(3, dim=-1)
    kp, qp = _prm_exp(k, w), _prm_exp(q, w)
    vf = v.float()
    D = torch.einsum("bti,bi->bt", qp, kp.sum(dim=1))[..., None]
    kptv = torch.einsum("bin,bim->bnm", vf, kp)
    return torch.einsum("bti,bni->btn", qp, kptv) / (D + eps), vf


class TokenPerformer(nn.Module):
    """Performer token mixer: ``h = v + attn_output(attn(norm1 x))``, then
    ``h + mlp(norm2 h)``, with ``k, q, v`` in that order from ``kqv``.

    ``w [m, hidden]`` (``m = hidden * kernel_ratio``) is a fixed buffer,
    initialised as ``orthogonal * sqrt(m)`` from the model's generator; the
    JAX package draws it from ``jax.random.key(42)``, so parity comes from
    copying its ``constants`` (``utils/jax_bridge.load_jax_variables``).
    Dropout (``dp1``, ``dp2``) applies with ``train=True`` only."""

    kernel_ratio = 0.5
    eps = 1e-8
    layernorm_eps = 1e-5
    dp1 = 0.1
    dp2 = 0.1

    def __init__(self, cfg: ViTConfig, in_dim: int, hidden_size: int):
        super().__init__()
        self.config = cfg
        hs = hidden_size
        self.kqv = Dense(cfg, in_dim, 3 * hs)
        self.attn_output = Dense(cfg, hs, hs)
        self.norm1_scale = _param((in_dim,), cfg)
        self.norm1_bias = _param((in_dim,), cfg)
        self.norm2_scale = _param((hs,), cfg)
        self.norm2_bias = _param((hs,), cfg)
        self.mlp_fc1_kernel = _param((hs, hs), cfg)
        self.mlp_fc1_bias = _param((hs,), cfg)
        self.mlp_fc2_kernel = _param((hs, hs), cfg)
        self.mlp_fc2_bias = _param((hs,), cfg)
        self.register_buffer("w", torch.empty(int(hs * self.kernel_ratio), hs))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.config.dtype
        x = layer_norm(x, self.norm1_scale, self.norm1_bias, self.layernorm_eps)
        y, vf = _linear_attention(self.kqv(x), self.w, self.eps)
        y = vf + F.dropout(self.attn_output(y.to(dt)), self.dp1, train).float()
        y = y.to(dt)
        h = layer_norm(y, self.norm2_scale, self.norm2_bias, self.layernorm_eps)
        h = mlp_block(h, self.mlp_fc1_kernel.to(dt), self.mlp_fc1_bias.to(dt),
                      self.mlp_fc2_kernel.to(dt), self.mlp_fc2_bias.to(dt),
                      get_gelu(self.config.gelu_approx))
        return y + F.dropout(h, self.dp2, train)


class T2TModule(nn.Module):
    """Tokens-to-token tokenizer: ``[b, 3, H, W]`` -> ``[b, (H/16)^2, dim]``."""

    def __init__(self, cfg: ViTConfig, token_size: int = 64):
        super().__init__()
        self.config = cfg
        self.token_size = token_size
        self.performer1 = TokenPerformer(cfg, cfg.in_channels * 7 * 7, token_size)
        self.performer2 = TokenPerformer(cfg, token_size * 9, token_size)
        self.project = Dense(cfg, token_size * 9, cfg.dim)

    def forward(self, img: torch.Tensor, train: bool = False) -> torch.Tensor:
        cfg, ts = self.config, self.token_size
        b = img.shape[0]
        s0 = unfold_output_size(cfg.image_size, 7, 4, 2)
        s1 = unfold_output_size(s0, 3, 2, 1)
        x = self.performer1(unfold(img.to(cfg.dtype), 7, 4, 2), train)
        x = unfold(x.reshape(b, s0, s0, ts).permute(0, 3, 1, 2), 3, 2, 1)
        x = self.performer2(x, train)
        x = unfold(x.reshape(b, s1, s1, ts).permute(0, 3, 1, 2), 3, 2, 1)
        return self.project(x)


class T2TViT(nn.Module):
    """T2T-ViT: the tokenizer, cls token and sinusoid positions, the
    pre-norm encoder (``models/vit.EncoderBlock``, both residual forms), a
    final LayerNorm and a linear head.

    Parameters are created on the CPU and initialised from ``generator`` as
    the Flax initialisers do (lecun-normal Dense kernels, xavier-uniform
    performer MLP and encoder kernels, normal(0.02) cls token, zero biases,
    unit norm scales), then moved to ``device``, the card unless the caller
    names another (``models/vit.model_device``).  Dropout follows
    ``forward``'s ``train`` argument, as ``model.apply``'s, and not the
    module's training mode; the model is built in eval mode all the same."""

    def __init__(self, cfg: ViTConfig, token_size: int = 64, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        device = model_device(device)
        self.config = cfg
        self.token_size = token_size
        n = (cfg.image_size // 16) ** 2  # three soft splits: strides 4 * 2 * 2
        self.tokens_to_token = T2TModule(cfg, token_size)
        self.cls_token = _param((1, 1, cfg.dim), cfg)
        self.register_buffer("pos_embedding", torch.from_numpy(sinusoid_encoding(n + 1, cfg.dim)))
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", EncoderBlock(cfg, i))
        self.final_norm = LayerNormP(cfg, cfg.dim)
        self.head = Dense(cfg, cfg.dim, cfg.num_classes)
        self._init_params(generator)
        self.eval()
        self.to(device)

    @torch.no_grad()
    def _init_params(self, gen: torch.Generator | None) -> None:
        for name, prm in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name == "cls_token":
                prm.normal_(0.0, 0.02, generator=gen)
            elif leaf.endswith("scale"):
                prm.fill_(1.0)
            elif leaf == "kernel":
                lecun_normal_(prm, gen)
            elif prm.dim() == 2:
                xavier_uniform_(prm, gen)
            else:
                prm.zero_()
        for perf in (self.tokens_to_token.performer1, self.tokens_to_token.performer2):
            nn.init.orthogonal_(perf.w, generator=gen)
            perf.w.mul_(math.sqrt(perf.w.shape[0]))

    def blocks(self) -> list:
        return [getattr(self, f"block_{i}") for i in range(self.config.depth)]

    def params(self) -> dict:
        """The parameters as a nested dict keyed as the Flax ``params`` tree."""
        return nested_tree(self.named_parameters())

    def constants(self) -> dict:
        """The buffers as the Flax ``constants`` tree."""
        return nested_tree(self.named_buffers())

    def forward(self, img: torch.Tensor, train: bool = False) -> torch.Tensor:
        """``model.apply(variables, img, train)``: dropout (the performers'
        and the blocks') only with ``train=True``; with ``cfg.remat`` and
        grad mode on, each encoder block is recomputed in the backward
        (``models/vit._remat_block``; the JAX model ignores ``remat``, and
        the values are the same)."""
        cfg = self.config
        dt = cfg.dtype
        x = self.tokens_to_token(img, train)
        cls = self.cls_token.to(dt).expand(x.shape[0], 1, cfg.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(dt)
        remat = cfg.remat and torch.is_grad_enabled()
        for blk in self.blocks():
            x = _remat_block(blk, x, train) if remat else blk(x, train)
        return self.head(self.final_norm(x)[:, 0])


_T2T_SHAPES = {
    7: dict(dim=256, depth=7, heads=4, mlp_dim=512),
    10: dict(dim=256, depth=10, heads=4, mlp_dim=512),
    12: dict(dim=256, depth=12, heads=4, mlp_dim=512),
    14: dict(dim=384, depth=14, heads=6, mlp_dim=1152),
}


def t2t_vit_config(variant: int = 14, style: str = "reference", **overrides) -> ViTConfig:
    """T2T-ViT-{7,10,12,14}; a final norm and a linear head in either style."""
    style_kw = dict(REFERENCE_STYLE if style == "reference" else STANDARD_STYLE)
    style_kw.update(final_norm=True, mlp_head=False)
    return ViTConfig(**{**_T2T_SHAPES[variant], **style_kw, **overrides})


def get_t2t_vit(variant: int = 14, style: str = "reference", *, device="cuda", generator=None,
                **kw) -> T2TViT:
    return T2TViT(t2t_vit_config(variant, style, **kw), device=device, generator=generator)


# ---------------------------------------------------------------------------
# The inference paths
# ---------------------------------------------------------------------------


def _np32(a) -> np.ndarray:
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a, np.float32)


def build_stage1_weights(kqv_kernel, kqv_bias, g, b):
    """Fold performer1's norm1 and kqv params into the shift-expanded form:
    ``(W9 [432, d], M9 [432, 1] 0/1 mask, c1 [d], c2 [d])``, fp32 CPU
    tensors computed in numpy as the JAX package computes them, so that
    ``stage1_kqv(img, W9, M9, c1, c2) == kqv(LN(unfold(img, 7, 4, 2)))``."""
    W = _np32(kqv_kernel)                      # [147, d]
    gw = W * _np32(g)[:, None]
    d = W.shape[1]
    W9 = np.zeros((len(SHIFTS), S2D, d), np.float32)
    M9 = np.zeros((len(SHIFTS), S2D, 1), np.float32)
    sidx = {sh: i for i, sh in enumerate(SHIFTS)}
    for c in range(3):
        for ky in range(7):
            dy, phy = (ky - 2) // 4, (ky - 2) % 4
            for kx in range(7):
                dx, phx = (kx - 2) // 4, (kx - 2) % 4
                f = c * 49 + ky * 7 + kx
                ph = c * 16 + phy * 4 + phx
                W9[sidx[(dy, dx)], ph] = gw[f]
                M9[sidx[(dy, dx)], ph] = 1.0
    c1 = gw.sum(0)
    c2 = _np32(b) @ W
    if kqv_bias is not None:
        c2 = c2 + _np32(kqv_bias)
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (W9.reshape(K9, d), M9.reshape(K9, 1), c1, c2))


def prepare_t2t_fused(model: T2TViT) -> dict:
    """The stage-1 weights of :func:`build_stage1_weights` on the model's
    device, built once: ``W9`` in the compute dtype (as every form uses it),
    ``M9``, ``c1`` and ``c2`` in fp32; and each performer's K16 operands
    (``"performer1"``, ``"performer2"``: ``ops/cuda/performer.performer_operands``,
    its weights in the compute dtype and its vectors in fp32).  Pass as
    ``prepared=`` to keep the host work (and a host round trip) and the casts
    out of every forward."""
    tok = model.params()["tokens_to_token"]
    t2t = model.tokens_to_token
    p = tok["performer1"]
    W9, M9, c1, c2 = build_stage1_weights(p["kqv"]["kernel"], p["kqv"].get("bias"),
                                          p["norm1_scale"], p["norm1_bias"])
    dev = model.cls_token.device
    return {"W9": W9.to(dev, model.config.dtype), "M9": M9.to(dev), "c1": c1.to(dev),
            "c2": c2.to(dev),
            "performer1": performer_operands(tok["performer1"], t2t.performer1.w,
                                             model.config.dtype),
            "performer2": performer_operands(tok["performer2"], t2t.performer2.w,
                                             model.config.dtype)}


def fast_stage1_kqv(img: torch.Tensor, W9: torch.Tensor, M9: torch.Tensor, c1: torch.Tensor,
                    c2: torch.Tensor, eps: float = TokenPerformer.layernorm_eps) -> torch.Tensor:
    """``kqv(LN(unfold(img, k7 s4 p2)))`` as eager tensor ops on the 9
    shifted s2d views, with the JAX form's cast points: operands in
    ``img.dtype`` with fp32 sums, the squares for the variance rounded to
    ``img.dtype`` first."""
    dt = img.dtype
    big = shift_concat(img)
    m9 = M9.to(dt).float()
    out = big.float() @ W9.to(dt).float()
    mu = (big.float() @ m9) / float(FEATURES)
    sq = ((big * big).float() @ m9) / float(FEATURES)
    var = sq - mu * mu
    y = (out - mu * c1.float()) * torch.rsqrt(var + eps) + c2.float()
    return y.to(dt)


def _kqv_dense(x: torch.Tensor, node: dict, dt: torch.dtype) -> torch.Tensor:
    y = x @ node["kernel"].to(dt)
    return y + node["bias"].to(dt) if "bias" in node else y


def _performer_rest(x_kqv: torch.Tensor, p: dict, w: torch.Tensor,
                    cfg: ViTConfig) -> torch.Tensor:
    """TokenPerformer after norm1 and kqv as eager tensor ops, with the JAX
    fused path's promotions (the ``attn_output`` product in fp32 against
    fp32 params): the JAX package's ``_performer_dispatch`` always takes
    this form."""
    dt = cfg.dtype
    eps = TokenPerformer.layernorm_eps
    y, vf = _linear_attention(x_kqv, w, TokenPerformer.eps)
    y = (vf + _dense(y.to(dt), p["attn_output"]).float()).to(dt)
    h = layer_norm(y, p["norm2_scale"], p["norm2_bias"], eps)
    h = mlp_block(h, p["mlp_fc1_kernel"].to(dt), p["mlp_fc1_bias"].to(dt),
                  p["mlp_fc2_kernel"].to(dt), p["mlp_fc2_bias"].to(dt),
                  get_gelu(cfg.gelu_approx))
    return y + h


def _performer_dispatch(x_kqv: torch.Tensor, p: dict, w: torch.Tensor, cfg: ViTConfig,
                        plain: bool = False, operands: dict | None = None) -> torch.Tensor:
    """The TokenPerformer after kqv: K16 (``ops/cuda/performer.performer_rest``,
    two kernels, on ``operands`` where :func:`prepare_t2t_fused` built them)
    on a CUDA tensor at every batch, its twin with ``plain``, and on a CPU
    tensor the eager chain :func:`_performer_rest`, which the JAX package
    dispatches to everywhere (its K16 lost a TPU A/B,
    ``ops/pallas/performer.py:22-29``, which does not carry over)."""
    kw = dict(eps_ln=TokenPerformer.layernorm_eps, approx_gelu=cfg.gelu_approx)
    if plain:
        return performer_rest_plain(x_kqv, p, w, **kw)
    if x_kqv.device.type == "cpu":
        return _performer_rest(x_kqv, p, w, cfg)
    return performer_rest(x_kqv, p, w, operands=operands, **kw)


def _stem_matmul(x: torch.Tensor, entry: dict, dt: torch.dtype, plain: bool) -> torch.Tensor:
    """``x @ kernel + bias`` of one stem matmul in static int8 (an entry of
    :func:`prepare_t2t_stem_int8_static`): ``int8(x / act_scale) @ q``
    dequantized by the combined scale and cast to ``dt``, then the bias added
    in ``dt``, rounding twice as the reference does.  On the CPU
    ``ops/quant.int8_matmul_static``; on the card ``quant_rows`` (static)
    and ``linear_i8`` (epilogue ``BIAS`` on a zero bias), or their twins
    with ``plain``."""
    if x.device.type == "cpu":
        y = int8_matmul_static(x, entry["q"], entry["scale"], entry["act_scale"])
    else:
        quant, lin = (quant_rows_plain, linear_i8_plain) if plain else (quant_rows, linear_i8)
        act_inv = 1.0 / torch.as_tensor(entry["act_scale"], dtype=torch.float32,
                                        device=x.device).reshape(1)
        n = entry["q"].shape[1]
        q, _ = quant(x.reshape(-1, x.shape[-1]).contiguous(), act_inv, 0)
        y = lin(q, None, entry["q"], entry["scale"],
                torch.zeros(n, dtype=torch.float32, device=x.device), epilogue=BIAS,
                out_dtype=dt).reshape(*x.shape[:-1], n)
    return y + entry["bias"].to(dt) if "bias" in entry else y


STAGE1_IMPLS = ("auto", "kernel", "fast")


def t2t_tokenize(model: T2TViT, img: torch.Tensor, *, params: dict | None = None,
                 prepared: dict | None = None, fast: bool | None = None,
                 stem_q: dict | None = None, stage1_impl: str = "auto",
                 plain: bool = False) -> torch.Tensor:
    """Everything before the encoder: the tokenizer, the cls token and the
    sinusoid positions, ``[b, 197, dim]`` in the compute dtype.

    ``fast`` (default: batch < 8, the reference's gate) takes the
    shift-expanded stage-1 form, else the plain unfold + LayerNorm + matmul
    (the exact form, which calibration uses).  In the fast form
    ``stage1_impl`` picks ``stage1_kqv`` (``"auto"``, ``"kernel"``: the
    hand-written kernel on a CUDA tensor) or the eager
    :func:`fast_stage1_kqv` (``"fast"``).  Both performers go through
    :func:`_performer_dispatch`.  ``stem_q``
    (:func:`prepare_t2t_stem_int8_static`) runs the stem's big matmuls in
    static int8: stage-1 kqv in the plain-unfold form only (the fast form
    keeps its float kernel, as the reference does), stage-2 kqv and the
    projection in both.  ``plain=True`` takes the kernels' plain twins.
    ``prepared`` defaults to :func:`prepare_t2t_fused` in the fast form (the
    plain-unfold form without it casts the performers' weights on each
    call); ``params`` (a Flax-keyed tree, float tokenizer) to
    ``model.params()``.  The performer matrices and the position table are
    the model's buffers."""
    if stage1_impl not in STAGE1_IMPLS:
        raise ValueError(f"unknown stage1_impl {stage1_impl!r}; one of {STAGE1_IMPLS}")
    cfg = model.config
    dt = cfg.dtype
    p = model.params() if params is None else _unwrap(params)
    tok = p["tokens_to_token"]
    t2t = model.tokens_to_token
    ts = t2t.token_size
    eps = TokenPerformer.layernorm_eps
    img = img.to(dt)
    if fast is None:
        fast = img.shape[0] < 8
    p1, p2 = tok["performer1"], tok["performer2"]
    if fast:
        if prepared is None:
            prepared = prepare_t2t_fused(model)
        args = (img, prepared["W9"].to(dt), prepared["M9"], prepared["c1"], prepared["c2"])
        if stage1_impl == "fast":
            x = fast_stage1_kqv(*args, eps=eps)
        else:
            x = (stage1_kqv_plain if plain else stage1_kqv)(*args, eps=eps)
    else:
        x = layer_norm(unfold(img, 7, 4, 2), p1["norm1_scale"], p1["norm1_bias"], eps)
        x = (_stem_matmul(x, stem_q["kqv1"], dt, plain) if stem_q is not None
             else _kqv_dense(x, p1["kqv"], dt))
    ops = prepared or {}
    x = _performer_dispatch(x, p1, t2t.performer1.w, cfg, plain, ops.get("performer1"))

    bsz = x.shape[0]
    s0 = unfold_output_size(cfg.image_size, 7, 4, 2)
    s1 = unfold_output_size(s0, 3, 2, 1)
    x = unfold(x.reshape(bsz, s0, s0, ts).permute(0, 3, 1, 2), 3, 2, 1)
    x = layer_norm(x, p2["norm1_scale"], p2["norm1_bias"], eps)
    x = (_stem_matmul(x, stem_q["kqv2"], dt, plain) if stem_q is not None
         else _kqv_dense(x, p2["kqv"], dt))
    x = _performer_dispatch(x, p2, t2t.performer2.w, cfg, plain, ops.get("performer2"))
    x = unfold(x.reshape(bsz, s1, s1, ts).permute(0, 3, 1, 2), 3, 2, 1)
    if stem_q is not None:
        x = _stem_matmul(x, stem_q["project"], dt, plain)
    else:
        x = x @ tok["project"]["kernel"].to(dt) + tok["project"]["bias"].to(dt)

    cls = p["cls_token"].to(dt).expand(bsz, 1, cfg.dim)
    return torch.cat([cls, x], dim=1) + model.pos_embedding.to(dt)


def _uniform_heads(cfg: ViTConfig) -> int:
    """The heads of the one uniform encoder the fused T2T paths run, as the
    reference's do (its stack spans every layer with ``cfg.heads``)."""
    segments = _check_fused(cfg)
    if len(segments) != 1:
        raise NotImplementedError(f"{len(segments)} encoder segments: the fused T2T paths run "
                                  "one uniform encoder (use model(img))")
    return segments[0][2]


def fused_t2t_apply(model: T2TViT, img: torch.Tensor, *, prepared: dict | None = None,
                    stacked: dict | None = None, fast: bool | None = None,
                    plain: bool = False) -> torch.Tensor:
    """T2T forward with :func:`t2t_tokenize` (the stage-1 kernel at batch <
    8) and the encoder on the hand-written kernels
    (``ops/cuda/fused_encoder.encoder_forward``); the same params and result
    as ``model(img)``.

    The encoder runs on the kernels at every batch.  The JAX function sends
    batch >= 8 at dim <= 256 to its XLA encoder instead, a choice timed on
    the TPU that does not carry over.  ``prepared`` is
    :func:`prepare_t2t_fused`'s output and ``stacked``
    ``models/vit.prepare_vit_fused``'s, each built here when omitted;
    ``fast`` is :func:`t2t_tokenize`'s; ``plain=True`` runs the kernels'
    plain twins on any device."""
    from ..ops.cuda.fused_encoder import encoder_forward, encoder_forward_plain

    cfg = model.config
    heads = _uniform_heads(cfg)
    p = model.params()
    x = t2t_tokenize(model, img, params=p, prepared=prepared, fast=fast, plain=plain)
    if stacked is None:
        stacked = prepare_vit_fused(model)
    encoder = encoder_forward_plain if plain else encoder_forward
    x = encoder(x, stacked, heads=heads, head_dim=cfg.resolved_head_dim, eps=cfg.layernorm_eps,
                reference_residual=cfg.reference_residual, approx_gelu=cfg.gelu_approx)
    return _fused_head(cfg, p, x)


def prepare_t2t_int8(model: T2TViT) -> dict:
    """The encoder stack quantized to int8 once (per-layer, per-output-channel
    scales) for :func:`fused_t2t_apply_int8`; the tokenizer stays float."""
    from ..ops.cuda.fused_encoder import quantize_stacked_int8, stack_vit_layer_params

    cfg = model.config
    return quantize_stacked_int8(stack_vit_layer_params(model.params(), cfg.depth, cfg.qkv_bias))


def prepare_t2t_int8_static(model: T2TViT, act_scales=None, calib_batches=None,
                            percentile: float | None = None, method: str = "absmax") -> dict:
    """Static int8 prep: the activation scales from ``ops/quant.calibrate_t2t``
    (unless ``act_scales [depth, 4]`` is given) folded into the quantized
    stack, which then carries ``act_inv``."""
    from ..ops.cuda.fused_encoder import quantize_stacked_int8_static, stack_vit_layer_params
    from ..ops.quant import calibrate_t2t

    cfg = model.config
    if act_scales is None:
        act_scales = calibrate_t2t(model, batches=calib_batches, percentile=percentile,
                                   method=method)
    stacked = stack_vit_layer_params(model.params(), cfg.depth, cfg.qkv_bias)
    return quantize_stacked_int8_static(stacked, np.asarray(act_scales, np.float32))


def calibrate_t2t_stem(model: T2TViT, variables: dict | None = None, batches=None,
                       n: int = 32) -> dict:
    """Absmax activation scales ``{"kqv1", "kqv2", "project": float}`` of the
    three stem matmuls' inputs in the plain-unfold form: the LayerNorm of
    the stage-1 unfold, the LayerNorm of the stage-2 unfold, the stage-3
    unfold; ``max / 127`` (1.0 where the max is 0).  The performers run
    through :func:`_performer_dispatch` (K16 on the card).  ``batches``
    defaults to ``n`` representative batches (``ops/quant.representative_batches``);
    ``variables`` (a Flax-keyed tree) to ``model.params()``."""
    from ..ops.quant import representative_batches

    cfg = model.config
    dt = cfg.dtype
    p = model.params() if variables is None else _unwrap(variables)
    tok = p["tokens_to_token"]
    p1, p2 = tok["performer1"], tok["performer2"]
    t2t = model.tokens_to_token
    ts = t2t.token_size
    eps = TokenPerformer.layernorm_eps
    dev = model.cls_token.device
    if batches is None:
        batches = representative_batches(n=n, shape=(3, cfg.image_size, cfg.image_size))
    s0 = unfold_output_size(cfg.image_size, 7, 4, 2)
    s1 = unfold_output_size(s0, 3, 2, 1)
    run_max = None
    with torch.no_grad():
        for batch in batches:
            im = torch.as_tensor(np.asarray(batch), device=dev).to(dt)
            x1 = layer_norm(unfold(im, 7, 4, 2), p1["norm1_scale"], p1["norm1_bias"], eps)
            y = _performer_dispatch(_kqv_dense(x1, p1["kqv"], dt), p1, t2t.performer1.w, cfg)
            b = y.shape[0]
            y = unfold(y.reshape(b, s0, s0, ts).permute(0, 3, 1, 2), 3, 2, 1)
            x2 = layer_norm(y, p2["norm1_scale"], p2["norm1_bias"], eps)
            z = _performer_dispatch(_kqv_dense(x2, p2["kqv"], dt), p2, t2t.performer2.w, cfg)
            x3 = unfold(z.reshape(b, s1, s1, ts).permute(0, 3, 1, 2), 3, 2, 1)
            m = torch.stack([x1.abs().max(), x2.abs().max(), x3.abs().max()])
            run_max = m if run_max is None else torch.maximum(run_max, m)
    vals = run_max.float().cpu().numpy()
    return {k: (float(v) / 127.0 if v > 0 else 1.0)
            for k, v in zip(("kqv1", "kqv2", "project"), vals)}


def prepare_t2t_stem_int8_static(model: T2TViT, variables: dict | None = None, batches=None,
                                 n: int = 32) -> dict:
    """Static int8 for the stem's three big matmuls (performer1's and
    performer2's kqv, the projection): per-output-channel int8 weights with
    the calibrated activation scale (:func:`calibrate_t2t_stem`) folded into
    the combined dequant scale, as ``{"kqv1" | "kqv2" | "project": {"q",
    "scale", "act_scale", "bias"}}`` on the model's device.  Feeds
    :func:`t2t_tokenize` and :func:`fused_t2t_apply_int8` (``stem_q=``)."""
    p = model.params() if variables is None else _unwrap(variables)
    tok = p["tokens_to_token"]
    scales = calibrate_t2t_stem(model, p, batches=batches, n=n)
    out = {}
    for key, node in (("kqv1", tok["performer1"]["kqv"]), ("kqv2", tok["performer2"]["kqv"]),
                      ("project", tok["project"])):
        q, w_scale = quantize_weight_int8(node["kernel"])
        entry = {"q": q, "scale": (w_scale * scales[key]).float(),
                 "act_scale": torch.tensor(scales[key], dtype=torch.float32,
                                           device=q.device)}
        if "bias" in node:
            entry["bias"] = node["bias"]
        out[key] = entry
    return out


def fused_t2t_apply_int8(model: T2TViT, img: torch.Tensor, *, stacked_q: dict | None = None,
                         prepared: dict | None = None, variant: str = "auto",
                         stem_q: dict | None = None, plain: bool = False) -> torch.Tensor:
    """T2T forward with the int8 encoder on the hand-written kernels
    (``ops/cuda/fused_encoder.encoder_forward_int8``): dynamic scales with a
    :func:`prepare_t2t_int8` stack (the default), static with a
    :func:`prepare_t2t_int8_static` one.  The tokenizer stays float unless
    ``stem_q`` (:func:`prepare_t2t_stem_int8_static`) runs its big matmuls
    in static int8; the final norm and head stay float.  ``variant`` is one
    of ``models/vit.INT8_VARIANTS`` (all take the one encoder); ``prepared``
    and ``plain`` are :func:`fused_t2t_apply`'s."""
    from ..ops.cuda.fused_encoder import encoder_forward_int8, encoder_forward_int8_plain

    cfg = model.config
    if variant not in INT8_VARIANTS:
        raise ValueError(f"unknown int8 variant {variant!r}; one of {INT8_VARIANTS}")
    heads = _uniform_heads(cfg)
    if stacked_q is None:
        stacked_q = prepare_t2t_int8(model)
    p = model.params()
    x = t2t_tokenize(model, img, params=p, prepared=prepared, stem_q=stem_q, plain=plain)
    encoder = encoder_forward_int8_plain if plain else encoder_forward_int8
    x = encoder(x, stacked_q, heads=heads, head_dim=cfg.resolved_head_dim,
                eps=cfg.layernorm_eps, reference_residual=cfg.reference_residual,
                approx_gelu=cfg.gelu_approx)
    return _fused_head(cfg, p, x)
