"""Shared helpers for the encoder kernels (port of the numerics half of
``edgevisiontransformer_tpu/ops/pallas/common.py``)."""

from __future__ import annotations

import functools

import torch


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Max-free softmax clamp: normalisation is deferred past the PV product, so
# the row-max subtract is redundant and exp2(min(s, 60)) is the overflow
# guard.  2^60 keeps even a row of a few hundred clamped keys far below the
# fp32 maximum in both the row sum and the PV accumulator.
SOFTMAX_CLAMP = 60.0


def softmax_unnorm(s: torch.Tensor, dtype: torch.dtype, *, nomax: bool = True,
                   clamp: float = SOFTMAX_CLAMP):
    """Unnormalised exp2 probabilities ``p`` (fp32) and row sums ``r`` of the
    log2-scaled scores ``s``; the caller divides after the PV product.

    The max-free path serves bf16 / fp32 and floors ``r`` at 1e-30, so a
    row whose keys are all masked (scores near -1e30) gives zeros.  float16
    takes the row-max subtract instead, because ``p`` would overflow its
    range when cast; that branch has no floor (a fully masked row there
    gives uniform weights, as in the reference).
    """
    if nomax and dtype != torch.float16:
        p = torch.exp2(torch.clamp(s, max=clamp))
        r = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    else:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
        r = p.sum(dim=-1, keepdim=True)
    return p, r


# ---------------------------------------------------------------------------
# Autograd: no kernel has a backward
# ---------------------------------------------------------------------------


class _NoBackward(torch.autograd.Function):
    """Views of a kernel's outputs that depend on its inputs in the autograd
    graph, through a node whose backward raises."""

    @staticmethod
    def forward(ctx, what, n_out, *tensors):
        ctx.what = what
        return tuple(t.view_as(t) for t in tensors[:n_out])

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            f"{ctx.what}: no backward kernel yet; train through the plain path "
            "(kernel_mode='xla', the eager model or the plain twins), as the JAX package "
            "trains through its XLA path")


class _NoBackwardInPlace(torch.autograd.Function):
    """As :class:`_NoBackward`, for a kernel that wrote into a given ``out``."""

    @staticmethod
    def forward(ctx, what, out, *tensors):
        ctx.what = what
        ctx.mark_dirty(out)
        return out

    backward = _NoBackward.backward


def _tensors(values):
    for v in values:
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, dict):
            yield from _tensors(v.values())
        elif isinstance(v, (list, tuple)):
            yield from _tensors(v)


def no_backward(fn):
    """Decorate a kernel wrapper so that it never cuts the autograd graph
    silently.  With grad mode on and an input (or a tensor in a dict, list or
    tuple argument) that requires grad, the wrapper runs under ``no_grad``, its
    kernel on a CUDA tensor and its plain twin on a CPU tensor alike, and its
    floating outputs (or the ``out`` it wrote into) carry a node whose
    backward raises: a loss through a kernel fails at ``backward()`` instead
    of leaving the weights behind it without a gradient.  Forward values are
    unchanged; the plain twins called directly stay differentiable."""
    what = fn.__name__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        inputs = [t for t in _tensors((args, kwargs)) if t.requires_grad]
        if not inputs:
            return fn(*args, **kwargs)
        with torch.no_grad():
            result = fn(*args, **kwargs)
        out = kwargs.get("out")
        if out is not None:
            return _NoBackwardInPlace.apply(what, out, *inputs)
        single = isinstance(result, torch.Tensor)
        results = (result,) if single else tuple(result)
        floating = [i for i, r in enumerate(results)
                    if isinstance(r, torch.Tensor) and r.is_floating_point()]
        if not floating:
            return result
        views = _NoBackward.apply(what, len(floating), *(results[i] for i in floating),
                                  *inputs)
        results = list(results)
        for i, v in zip(floating, views):
            results[i] = v
        return results[0] if single else type(result)(results)

    return wrapper
