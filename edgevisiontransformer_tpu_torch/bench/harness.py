"""GPU timing and memory (port of ``edgevisiontransformer_tpu/bench/harness.py``
and ``bench/looptimer.py``, reduced to what the port measures so far).

Times come from CUDA events around a run of ``iters`` back-to-back calls on
the current stream, after a warmup, so they are device times per call;
a call whose host-side launch work outlasts its device work is measured at
its launch rate, which is what a caller of it gets.
"""

from __future__ import annotations

import statistics
from typing import Any, Callable, Sequence

import torch


def _stats(samples: list, iters: int, repeats: int) -> dict:
    return {
        "p50_ms": statistics.median(samples),
        "avg_ms": statistics.fmean(samples),
        "min_ms": min(samples),
        "max_ms": max(samples),
        "std_ms": statistics.pstdev(samples),
        "iters": iters,
        "repeats": repeats,
    }


def measure_op_time(fn: Callable, args: Sequence[Any], iters: int = 20,
                    repeats: int = 5, warmup: int = 3) -> dict:
    """Per-call time of ``fn(*args)`` in ms: p50, avg, min, max and std over
    ``repeats`` samples, each the mean of ``iters`` calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_op_time needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return _stats(samples, iters, repeats)


def measure_graph_time(fn: Callable, iters: int = 20, repeats: int = 5,
                       warmup: int = 3) -> dict:
    """Device time per call of ``fn()`` in ms, with the host taken out:
    ``iters`` calls are captured once into a CUDA graph, which is replayed
    ``repeats`` times between CUDA events.  Same statistics as
    :func:`measure_op_time`."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_graph_time needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    del graph
    return _stats(samples, iters, repeats)


def device_time_by_kernel(fn: Callable, tries: int = 8) -> list:
    """One traced call of ``fn()``: ``[(kernel name, calls, device ms)]``,
    largest first, from ``torch.profiler``'s CUDA activity.  Only the
    kernels' own events count: the host-side operators that launched them,
    and the device-side rows of ``record_function`` regions (such as
    ``Optimizer.step#AdamW.step``), span kernels counted already and would
    count the same time twice.  ``fn`` must launch device work: the
    tracer now and then loses every kernel record of a trace (on the H100,
    1 trace in 18, sometimes twice in a row), so a trace that holds no
    kernel is taken again, ``tries`` times in all, and ``[]`` means that
    every one of them came back empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rows = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [(ev.key, ev.count, ev.self_device_time_total / 1e3)
                for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
                and not ev.is_user_annotation]
        if rows:
            break
    return sorted(rows, key=lambda r: -r[2])


def device_mem_mb(device=None) -> float:
    """Peak device memory allocated by PyTorch since the last
    ``torch.cuda.reset_peak_memory_stats``, in MiB."""
    return torch.cuda.max_memory_allocated(device) / (1024 * 1024)
