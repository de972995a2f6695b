"""Process mesh and sharding rules (port of ``edgevisiontransformer_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a 2-D ("dp", "tp") mesh and lets
XLA place the collectives from sharding annotations.  Here the mesh is a
layout of the ranks of the default ``torch.distributed`` process group, with
one process group per line of each axis, and the collectives are explicit
calls on those groups:

* dp: the batch is split over the ranks of a dp line; gradients are
  averaged over it (``parallel/train.jit_sharded_train_step``).
* tp: Megatron tensor parallelism over attention heads and the MLP hidden
  width: qkv and fc1 column-sharded, out and fc2 row-sharded, so each block
  needs one all-reduce after ``out`` and one after ``fc2``.

A sharded leaf holds this rank's slice of the JAX rule's axis, with one
exception: a fused ``[q | k | v]`` kernel (``qkv_kernel``, T2T's ``kqv``)
is held as ``[q_r | k_r | v_r]``, the r-th of ``tp`` equal column blocks of
each section, so a rank holds whole heads where JAX's rule would give it a
contiguous slice of the concatenation (at tp = 2, q and half of k).  The
spec says so (:class:`Spec` ``.layout == "qkv"``); :func:`gather_params`
undoes it.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """Ranks of the default process group laid out as ``ranks`` (an integer
    array, one dimension per axis of ``axis_names``), with a process group
    for every line of every axis.  Every rank of the world constructs it
    (``dist.new_group`` is collective); a rank outside ``ranks`` holds no
    group and must not call the functions that take the mesh."""

    def __init__(self, ranks, axis_names):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"ranks of shape {self.ranks.shape} for axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        me = dist.get_rank()
        self._lines = {}
        for i, axis in enumerate(self.axis_names):
            lines = np.moveaxis(self.ranks, i, -1).reshape(-1, self.ranks.shape[i])
            for line in lines:
                members = [int(r) for r in line]
                group = dist.new_group(members)
                if me in members:
                    self._lines[axis] = (group, members)

    def __contains__(self, rank: int) -> bool:
        return bool((self.ranks == rank).any())

    def group(self, axis: str):
        """This rank's process group along ``axis``."""
        return self._lines[axis][0]

    def members(self, axis: str) -> list:
        """The global ranks of this rank's line along ``axis``, in order."""
        return self._lines[axis][1]

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
        return self.members(axis).index(dist.get_rank())


def make_mesh(dp: Optional[int] = None, tp: int = 1) -> Mesh:
    """The ("dp", "tp") mesh over the initialised default process group:
    rank ``i * tp + j`` at ``(i, j)``, as the JAX package lays out its
    devices.  Raises ``ValueError`` unless ``dp * tp`` is the world size."""
    n = dist.get_world_size()
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp={dp * tp} != world size {n}")
    return Mesh(np.arange(n).reshape(dp, tp), ("dp", "tp"))


class Spec(tuple):
    """A partition spec, equal to the JAX ``PartitionSpec`` of the same
    entries; ``layout`` is ``"qkv"`` where a fused q | k | v axis is held
    as whole heads per rank (module docstring), else ``""``."""

    layout = ""

    def __new__(cls, *entries, layout: str = ""):
        spec = super().__new__(cls, entries)
        spec.layout = layout
        return spec


# Param-name pattern -> spec over ("dp", "tp").  Column-parallel: shard the
# output features; row-parallel: shard the input features.
_PARAM_RULES = [
    (r".*attn/qkv_kernel$", Spec(None, "tp", layout="qkv")),
    (r".*attn/qkv_bias$", Spec("tp", layout="qkv")),
    (r".*attn/out_kernel$", Spec("tp", None)),
    (r".*ffn/fc1_kernel$", Spec(None, "tp")),
    (r".*ffn/fc1_bias$", Spec("tp")),
    (r".*ffn/fc2_kernel$", Spec("tp", None)),
    (r".*kqv/kernel$", Spec(None, "tp", layout="qkv")),
    (r".*kqv/bias$", Spec("tp", layout="qkv")),
    (r".*attn_output/kernel$", Spec("tp", None)),
]


def param_partition_spec(path: str) -> Spec:
    for pattern, spec in _PARAM_RULES:
        if re.match(pattern, path):
            return spec
    return Spec()  # replicated


def tree_partition_specs(params: dict, prefix: str = "") -> dict:
    """The spec of every leaf of a nested-dict param tree, the same nesting;
    a leaf's path is its keys joined by ``/``."""
    return {k: tree_partition_specs(v, f"{prefix}{k}/") if isinstance(v, dict)
            else param_partition_spec(f"{prefix}{k}") for k, v in params.items()}


def _sharded_axis(spec: Spec) -> Optional[int]:
    return spec.index("tp") if "tp" in spec else None


def _local_slice(full: torch.Tensor, spec: Spec, tp: int, r: int) -> torch.Tensor:
    """Rank ``r``'s shard (of ``tp``) of the whole leaf ``full`` under ``spec``."""
    axis = _sharded_axis(spec)
    if axis is None:
        return full
    if full.shape[axis] % (3 * tp if spec.layout == "qkv" else tp):
        raise ValueError(f"axis {axis} of a {tuple(full.shape)} leaf does not split over "
                         f"tp={tp}{' in each of q, k, v' if spec.layout == 'qkv' else ''}")
    if spec.layout == "qkv":
        return torch.cat([sec.chunk(tp, dim=axis)[r] for sec in full.chunk(3, dim=axis)],
                         dim=axis)
    return full.chunk(tp, dim=axis)[r]


def _whole(shards: list, spec: Spec) -> torch.Tensor:
    """The inverse of :func:`_local_slice` over every rank's shard, in order."""
    axis = _sharded_axis(spec)
    if spec.layout == "qkv":
        parts = [s.chunk(3, dim=axis) for s in shards]
        return torch.cat([p[i] for i in range(3) for p in parts], dim=axis)
    return torch.cat(shards, dim=axis)


def _map_specs(fn, params: dict, specs: dict) -> dict:
    return {k: _map_specs(fn, v, specs[k]) if isinstance(v, dict) else fn(v, specs[k])
            for k, v in params.items()}


def shard_params(params: dict, mesh: Mesh) -> dict:
    """This rank's parameters on ``mesh``, copies: its tp shard of every
    leaf a rule shards, the whole of every other leaf (a train step updates
    its tree in place; the caller's stays as it was)."""
    tp, r = mesh.shape["tp"], mesh.index("tp")
    return _map_specs(lambda t, s: _local_slice(t, s, tp, r).clone(),
                      params, tree_partition_specs(params))


def gather_params(params: dict, mesh: Mesh) -> dict:
    """The whole tree from every rank's :func:`shard_params` tree, new
    tensors: each sharded leaf all-gathered over the tp group and
    reassembled, every other leaf copied."""
    tp, group = mesh.shape["tp"], mesh.group("tp")

    def whole(t, spec):
        if "tp" not in spec or tp == 1:
            return t.clone()
        t = t.contiguous()
        shards = [torch.empty_like(t) for _ in range(tp)]
        dist.all_gather(shards, t, group=group)
        return _whole(shards, spec)

    return _map_specs(whole, params, tree_partition_specs(params))


def batch_spec() -> Spec:
    return Spec("dp")


# ---------------------------------------------------------------------------
# Transports and differentiable collectives
# ---------------------------------------------------------------------------


def exchange(send: torch.Tensor, dst: int, src: int, group) -> torch.Tensor:
    """Send ``send`` to global rank ``dst`` and receive a tensor of its shape
    from ``src``, both posted at once (``batch_isend_irecv``), so no order
    of the ranks can deadlock.  gloo carries no point-to-point transfer of a
    CUDA tensor (torch 2.11: "writev ... Bad address"), so on gloo a CUDA
    buffer is copied through host memory for this transfer only; the
    result is on ``send``'s device."""
    staged = send.is_cuda and dist.get_backend(group) == "gloo"
    out = send.detach().to("cpu" if staged else send.device).contiguous()
    recv = torch.empty_like(out)
    ops = [dist.P2POp(dist.isend, out, dst, group), dist.P2POp(dist.irecv, recv, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(send.device) if staged else recv


class _EnterTP(torch.autograd.Function):
    """Identity forward; the backward all-reduces the cotangent over the
    group (Megatron's ``f`` before a column-parallel product, and the
    summed gradient of a replicated input of a sharded computation)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceTP(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward (Megatron's ``g`` after a
    row-parallel product: every rank's consumer of the sum gives the same
    cotangent)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _EnterTP.apply(x, group)


def reduce_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceTP.apply(x, group)
