"""Loop-delta wall timing (port of ``edgevisiontransformer_tpu/bench/looptimer.py``).

Method: ``run(n)`` calls ``fn`` ``n`` times, each call's arguments chained
to the previous call's output, then waits for the device
(``torch.cuda.synchronize()`` when an argument lies on the card; nothing on
the CPU, where every op has finished when it returns).  Measure wall(run(K))
and wall(run(1)); the per-call time is ``(t_K - t_1) / (K - 1)``: the fixed
costs of one run (the sync, the first call's wait for a device that was
idle) cancel in the difference.

Chaining: every output leaf of a call is reduced in full to one fp32
scalar, times 1e-38, and added to the first tensor leaf of
``args[chain_arg]``, so each call depends on the whole of the one before
it, as in the JAX package, where the same term keeps XLA from eliding or
reordering the iterations of its loop.  Here the reduction is a few small
launches a call, timed with it.

What this time is: the wall time of one call with the host in it.  The
port launches its kernels from Python, so at small batches the host's
launch work sets it: deit_tiny bf16 b1 through ``fused_vit_apply`` took
7.0791 ms a call this way against 0.4741 ms on the device (NVIDIA H100
80GB HBM3, 700 W; PERF.md section 5).  ``bench/harness.measure_graph_time``
replays the same calls as a CUDA graph and gives the device's share.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Callable, Sequence

import torch

from ..utils.jax_bridge import flatten_tree


def _leaves(tree) -> list:
    """The tensor leaves of a tensor, a nested dict or a tuple / list of
    them, in order (a dict in ``jax_bridge.flatten_tree``'s order)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [v for v in flatten_tree(tree).values() if isinstance(v, torch.Tensor)]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return []


def _replace_first(tree, new: torch.Tensor):
    """``tree`` (a tensor or a nested dict) with its first tensor leaf
    replaced by ``new`` (new dicts; the other leaves are shared)."""
    if isinstance(tree, torch.Tensor):
        return new
    out, done = {}, False
    for k, v in tree.items():
        if not done and _leaves(v):
            v, done = _replace_first(v, new), True
        out[k] = v
    return out


def _reduce(out) -> torch.Tensor:
    """Every output leaf summed in full to one fp32 scalar."""
    leaves = _leaves(out)
    if not leaves:
        raise TypeError(f"fn returned {type(out).__name__}, which holds no tensor")
    return sum(leaf.detach().float().sum() for leaf in leaves)


def _chained_runner(fn: Callable, args: Sequence[Any], chain_arg: int):
    """``run(n)``: ``fn`` called ``n`` times with data-dependent
    chaining through ``args[chain_arg]``, then the device waited for; the
    caller's ``args`` are left as they are."""
    args = list(args)
    idx = chain_arg % len(args)
    if not isinstance(args[idx], (torch.Tensor, dict)) or not _leaves(args[idx]):
        raise TypeError(f"args[{chain_arg}] holds no tensor or dict of tensors to chain "
                        "through")
    cuda = any(leaf.is_cuda for a in args for leaf in _leaves(a))

    def run(n: int) -> None:
        cur = list(args)
        for _ in range(n):
            out = fn(*cur)
            with torch.no_grad():
                first = _leaves(cur[idx])[0]
                tick = (_reduce(out) * 1e-38).to(first.device)
                cur[idx] = _replace_first(cur[idx], first + tick.to(first.dtype))
        if cuda:
            torch.cuda.synchronize()

    return run


def measure_op_time(
    fn: Callable,
    args: Sequence[Any],
    *,
    iters: int = 100,
    repeats: int = 5,
    chain_arg: int = -1,
    warmup: int = 1,
    auto_iters: bool = True,
    min_delta_ms: float = 1.0,
    max_iters: int = 200_000,
) -> dict:
    """Per-call wall time of ``fn(*args)`` by the loop-delta method: ms
    statistics (``avg_ms p50_ms min_ms max_ms std_ms``) over ``repeats``
    measurements, and the ``iters`` and ``repeats`` used.

    ``fn`` runs in the caller's grad mode (a train step needs autograd; an
    inference caller runs this under ``torch.no_grad()``).

    ``auto_iters``: the loop delta must clear the fixed-cost jitter, or the
    estimate degenerates to 0-clamped noise.  When on, ``iters`` is scaled
    until wall(run(K)) - wall(run(1)) >= the larger of ``min_delta_ms`` and
    half the fixed cost wall(run(1)), the JAX package's rule unchanged: on
    the card the fixed cost is one synchronize, so it settles in a step or
    two.
    """
    run = _chained_runner(fn, args, chain_arg)

    def timed(n) -> float:
        t0 = time.perf_counter()
        run(n)
        return time.perf_counter() - t0

    for _ in range(warmup):
        timed(1)
        timed(iters)

    if auto_iters:
        for _ in range(16):
            if iters >= max_iters:
                break
            t1 = timed(1)
            delta_ms = (timed(iters) - t1) * 1e3
            floor_ms = max(min_delta_ms, 0.5 * t1 * 1e3)
            if delta_ms >= floor_ms:
                break
            if delta_ms <= 0:
                iters = min(max_iters, iters * 8)
            else:
                # Aim for 2x the floor so one rescale usually suffices.
                need = int(iters * 2.0 * floor_ms / delta_ms)
                iters = min(max_iters, max(iters * 2, need))
            timed(iters)  # warm the new trip count

    samples = []
    for _ in range(repeats):
        t1 = timed(1)
        tk = timed(iters)
        samples.append(max(tk - t1, 0.0) / (iters - 1) * 1e3)

    samples.sort()
    return {
        "avg_ms": sum(samples) / len(samples),
        "p50_ms": samples[len(samples) // 2],
        "min_ms": samples[0],
        "max_ms": samples[-1],
        "std_ms": statistics.pstdev(samples) if len(samples) > 1 else 0.0,
        "iters": iters,
        "repeats": repeats,
    }
