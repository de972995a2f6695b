"""Pipeline (pp) and sequence (sp) parallelism for the uniform-block encoder
(port of ``edgevisiontransformer_tpu/parallel/pipeline.py``).

Both work on the stacked ``[L, ...]`` layout of
``ops/cuda/fused_encoder.stack_vit_layer_params`` (vectors ``[L, 1, d]``,
matrices ``[L, in, out]``), on ranks of a :class:`~.mesh.Mesh`, in plain
PyTorch with autograd (the JAX package runs plain einsums here too):

* pp: a GPipe schedule over the mesh's ``axis`` in M + S - 1 ticks.  Stage
  ``s`` holds blocks ``[s L/S, (s+1) L/S)``; at each tick stage 0 feeds the
  next microbatch (zeros once they run out), every stage applies its
  blocks to what it holds, and one exchange shifts the activations a stage
  down the ring (``mesh.exchange``: the send and the receive posted
  together).  The shift is an autograd function whose backward sends the
  cotangent the other way round the ring, as ``ppermute`` transposes, so
  the backward is the reversed pipeline.  A stage skips its blocks on the
  ticks that hold no microbatch of its (their outputs are zeros, so they
  add no gradient), but still takes part in every exchange.  The last
  stage's outputs reach every rank through one all-reduce; since every
  rank then computes the same loss, its backward hands the cotangent on
  unsummed (summing S equal cotangents would scale every gradient by S).
* sp: the tokens are split across the ranks of ``axis`` for LayerNorm, the
  projections and the MLP; an all-to-all switches to a split by heads for
  attention and back.  A token count that does not divide is padded with
  zero tokens whose keys are masked out, so the result does not depend on
  the padding; heads that do not divide are split as evenly as they go
  (:func:`head_split`: deit_tiny's 3 heads over 2 ranks as 2 and 1).
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.activations import get_gelu
from ..ops.layers import layer_norm, mlp_block
from .mesh import Mesh, enter_tp, exchange, reduce_tp


def vit_block_apply(pl: dict, h: torch.Tensor, *, heads: int, eps: float,
                    approx_gelu: bool, reference_residual: bool) -> torch.Tensor:
    """One pre-norm encoder block from a per-layer slice of the stacked
    params (vectors ``[1, d]``, matrices ``[in, out]``); the semantics of
    ``models/vit.EncoderBlock``, both residual forms."""
    b, n, d = h.shape
    hd = pl["qkv_w"].shape[1] // (3 * heads)

    def attn(x):
        qkv = x @ pl["qkv_w"] + pl["qkv_b"][0]
        q, k, v = (t.reshape(b, n, heads, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        s = (q @ k.transpose(-1, -2)) * (hd ** -0.5)
        p = torch.softmax(s.float(), dim=-1).to(x.dtype)
        o = (p @ v).transpose(1, 2).reshape(b, n, heads * hd)
        return o @ pl["out_w"] + pl["out_b"][0]

    def ffn(x):
        return mlp_block(x, pl["fc1_w"], pl["fc1_b"][0], pl["fc2_w"], pl["fc2_b"][0],
                         get_gelu(approx_gelu))

    ln1 = lambda x: layer_norm(x, pl["ln1_g"][0], pl["ln1_b"][0], eps)  # noqa: E731
    ln2 = lambda x: layer_norm(x, pl["ln2_g"][0], pl["ln2_b"][0], eps)  # noqa: E731
    if reference_residual:
        hh = ln1(h)
        h = attn(hh) + hh
        hh = ln2(h)
        return ffn(hh) + hh
    h = h + attn(ln1(h))
    return h + ffn(ln2(h))


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------


class _RingShift(torch.autograd.Function):
    """Send ``x`` one stage down the ring and receive the stage above's.
    The stage's parameters are inputs too, so the shift stays in the graph
    of every stage at every tick (a stage whose tick held no microbatch
    still joins the backward's exchange); they get no gradient here."""

    @staticmethod
    def forward(ctx, x, members, idx, group, *params):
        s = len(members)
        ctx.ring = (members[(idx - 1) % s], members[(idx + 1) % s], group)
        ctx.n_params = len(params)
        return exchange(x, members[(idx + 1) % s], members[(idx - 1) % s], group)

    @staticmethod
    def backward(ctx, g):
        prev, nxt, group = ctx.ring
        return (exchange(g, prev, nxt, group), None, None, None) + (None,) * ctx.n_params


def _check_pipeline(depth: int, batch: int, stages: int, microbatches: int) -> None:
    if depth % stages != 0:
        raise ValueError(f"depth {depth} not divisible by pp={stages}")
    if batch % microbatches != 0:
        raise ValueError(f"batch {batch} not divisible by microbatches={microbatches}")


def _gpipe(local: dict, x: torch.Tensor, mesh: Mesh, microbatches: int, axis: str,
           block_fn: Callable) -> torch.Tensor:
    """The schedule on this stage's blocks ``local`` ([L/S, ...]); returns
    the last stage's outputs ``[B, n, d]`` on every rank of the ring."""
    group, members, idx = mesh.group(axis), mesh.members(axis), mesh.index(axis)
    S, M = len(members), microbatches
    b, n, d = x.shape
    xs = x.reshape(M, b // M, n, d)
    per = local["qkv_w"].shape[0]
    params = [v for v in local.values() if v.requires_grad]
    first = torch.tensor(idx == 0, device=x.device)
    recv = torch.zeros_like(xs[0])
    outs = []
    for t in range(M + S - 1):
        feed = xs[t] if t < M else torch.zeros_like(xs[0])
        inp = torch.where(first, feed, recv)
        if 0 <= t - idx < M:
            out = inp
            for i in range(per):
                out = block_fn({k: v[i] for k, v in local.items()}, out)
        else:  # no microbatch here at this tick: zeros, in the graph
            out = inp * 0
        if t >= S - 1:
            outs.append(out)
        if S > 1 and t < M + S - 2:  # the last tick's shift would feed nothing
            recv = _RingShift.apply(out, members, idx, group, *params)
    # only the last stage's outputs are real: broadcast them (a psum of
    # zeros elsewhere; the backward hands every rank's cotangent on as is)
    last = torch.tensor(float(idx == S - 1), device=x.device, dtype=x.dtype)
    return reduce_tp(torch.stack(outs) * last, group).reshape(b, n, d)


def _block_fn(block_fn, heads, eps, approx_gelu, reference_residual):
    return block_fn or functools.partial(vit_block_apply, heads=heads, eps=eps,
                                         approx_gelu=approx_gelu,
                                         reference_residual=reference_residual)


def _local_stack(stacked: dict, mesh: Mesh, axis: str) -> dict:
    per = stacked["qkv_w"].shape[0] // mesh.shape[axis]
    s = mesh.index(axis)
    return {k: v[s * per:(s + 1) * per] for k, v in stacked.items()}


def pipeline_encoder_apply(
    stacked: dict,
    x: torch.Tensor,
    mesh: Mesh,
    *,
    microbatches: int,
    heads: int,
    eps: float = 1e-6,
    approx_gelu: bool = False,
    reference_residual: bool = False,
    axis: str = "pp",
    block_fn: Callable | None = None,
) -> torch.Tensor:
    """GPipe forward of a depth-L uniform encoder over the mesh's ``axis``
    (module docstring), run by every rank of it with the same ``stacked``
    ([L, ...]; each stage uses only its L/S blocks) and ``x`` ([B, n, d]).
    Raises ``ValueError`` unless S divides L and ``microbatches`` divides
    B.  Returns ``[B, n, d]`` on every rank."""
    S = mesh.shape[axis]
    _check_pipeline(stacked["qkv_w"].shape[0], x.shape[0], S, microbatches)
    return _gpipe(_local_stack(stacked, mesh, axis), x, mesh, microbatches, axis,
                  _block_fn(block_fn, heads, eps, approx_gelu, reference_residual))


def make_pipeline_train_step(
    mesh: Mesh,
    *,
    microbatches: int,
    heads: int,
    eps: float = 1e-6,
    approx_gelu: bool = False,
    reference_residual: bool = False,
    axis: str = "pp",
    learning_rate: float = 1e-3,
):
    """SGD through the GPipe schedule: ``step(stacked, head_w, x, labels) ->
    (stacked', head_w', loss)``, run by every rank of the ring.  The loss is
    the mean-pooled linear head's softmax cross-entropy; each stage
    differentiates its own blocks (the backward runs the pipeline in
    reverse), the head is differentiated on every rank alike, and the
    updated stages are all-gathered, so every rank returns the whole tree."""
    fn = _block_fn(None, heads, eps, approx_gelu, reference_residual)

    def step(stacked, head_w, x, labels):
        S = mesh.shape[axis]
        _check_pipeline(stacked["qkv_w"].shape[0], x.shape[0], S, microbatches)
        local = {k: v.detach().requires_grad_() for k, v in
                 _local_stack(stacked, mesh, axis).items()}
        hw = head_w.detach().requires_grad_()
        h = _gpipe(local, x, mesh, microbatches, axis, fn)
        logp = F.log_softmax((h.mean(dim=1) @ hw).float(), dim=-1)
        loss = -logp.gather(-1, labels.long()[:, None]).mean()
        *g_local, g_head = torch.autograd.grad(loss, [*local.values(), hw])
        group = mesh.group(axis)
        new = {}
        with torch.no_grad():
            for (k, p), g in zip(local.items(), g_local):
                mine = (p - learning_rate * g).contiguous()
                parts = [torch.empty_like(mine) for _ in range(S)]
                dist.all_gather(parts, mine, group=group)
                new[k] = torch.cat(parts)
            return new, hw - learning_rate * g_head, loss.detach()

    return step


# ---------------------------------------------------------------------------
# Sequence parallelism
# ---------------------------------------------------------------------------


def _all_to_all(x: torch.Tensor, send: list, recv: list, group) -> torch.Tensor:
    """``x`` (1-D) cut into ``send`` sizes, piece ``j`` to rank ``j``; rank
    ``j``'s piece for this rank (``recv[j]`` elements) at piece ``j`` of the
    result."""
    out = x.new_empty(sum(recv))
    dist.all_to_all_single(out, x.contiguous(), recv, send, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """:func:`_all_to_all`, whose transpose swaps the sizes."""

    @staticmethod
    def forward(ctx, x, send, recv, group):
        ctx.sizes = (send, recv, group)
        return _all_to_all(x, send, recv, group)

    @staticmethod
    def backward(ctx, g):
        send, recv, group = ctx.sizes
        return _all_to_all(g, recv, send, group), None, None, None


def head_split(heads: int, ranks: int) -> list:
    """The heads each rank of a group attends to: as even as may be, the
    first ``heads % ranks`` ranks one more (a rank may have none)."""
    return [heads // ranks + (j < heads % ranks) for j in range(ranks)]


class _GatherTokens(torch.autograd.Function):
    """Every rank's ``[b, n_l, d]`` tokens as ``[b, G n_l, d]`` on every
    rank; every rank's consumer of the result is the same, so the backward
    keeps this rank's slice of the cotangent, unsummed."""

    @staticmethod
    def forward(ctx, x, group, idx):
        ctx.slice = (idx * x.shape[1], (idx + 1) * x.shape[1])
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.slice
        return g[:, lo:hi], None, None


def sequence_sharded_encoder_apply(
    stacked: dict,
    x: torch.Tensor,
    mesh: Mesh,
    *,
    heads: int,
    eps: float = 1e-6,
    approx_gelu: bool = False,
    reference_residual: bool = False,
    axis: str = "tp",
) -> torch.Tensor:
    """Encoder forward with sequence-parallel activations over the mesh's
    ``axis`` (module docstring), run by every rank of it with the same
    ``stacked`` and ``x`` ([B, n, d]); returns ``[B, n, d]`` on every rank.
    Differentiable: the gradients of ``stacked`` and ``x`` are the whole
    ones on every rank (each rank's share summed over the group)."""
    group, G, r = mesh.group(axis), mesh.shape[axis], mesh.index(axis)
    b, n, d = x.shape
    n_l = -(-n // G)
    counts = head_split(heads, G)
    first = [sum(counts[:j]) for j in range(G)]
    mine = counts[r]
    gelu = get_gelu(approx_gelu)
    keys = torch.arange(n_l * G, device=x.device) < n  # padded keys masked
    params = {k: enter_tp(v, group) for k, v in stacked.items()}
    h = F.pad(enter_tp(x, group), (0, 0, 0, n_l * G - n))[:, r * n_l:(r + 1) * n_l]
    for i in range(stacked["qkv_w"].shape[0]):
        pl = {k: v[i] for k, v in params.items()}
        hd = pl["qkv_w"].shape[1] // (3 * heads)
        hh = layer_norm(h, pl["ln1_g"][0], pl["ln1_b"][0], eps)
        qkv = (hh @ pl["qkv_w"] + pl["qkv_b"][0]).reshape(b, n_l, 3, heads, hd)
        # tokens split -> heads split: rank j gets its heads of every token
        per = b * n_l * 3 * hd
        qkv = _AllToAll.apply(torch.cat([qkv[:, :, :, f:f + c].reshape(-1)
                                         for f, c in zip(first, counts)]),
                              [per * c for c in counts], [per * mine] * G, group)
        q, k, v = qkv.view(G, b, n_l, 3, mine, hd).permute(3, 1, 4, 0, 2, 5).reshape(
            3, b, mine, G * n_l, hd)
        s = (q @ k.transpose(-1, -2)) * (hd ** -0.5)
        p = torch.softmax(s.float().masked_fill(~keys, float("-inf")), dim=-1).to(h.dtype)
        o = (p @ v).reshape(b, mine, G, n_l, hd).permute(2, 0, 3, 1, 4)  # [G, b, n_l, mine, hd]
        # heads split -> tokens split: this rank's tokens, every rank's heads
        per = b * n_l * hd
        o = _AllToAll.apply(o.reshape(-1), [per * mine] * G, [per * c for c in counts], group)
        o = torch.cat([t.view(b, n_l, c * hd) for t, c in
                       zip(o.split([per * c for c in counts]), counts)], dim=-1)
        att = o @ pl["out_w"] + pl["out_b"][0]
        h = (att + hh) if reference_residual else (h + att)
        hh = layer_norm(h, pl["ln2_g"][0], pl["ln2_b"][0], eps)
        f = mlp_block(hh, pl["fc1_w"], pl["fc1_b"][0], pl["fc2_w"], pl["fc2_b"][0], gelu)
        h = (f + hh) if reference_residual else (h + f)
    return _GatherTokens.apply(h, group, r)[:, :n]
