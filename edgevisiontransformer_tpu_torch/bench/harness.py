"""GPU latency / memory benchmark harness (port of
``edgevisiontransformer_tpu/bench/harness.py``).

The reference's API: :class:`BenchResult`, :func:`device_mem_mb`,
:func:`compiled_mem_mb`, :func:`benchmark_fn` and
:func:`benchmark_throughput` on ``measure_op_time``, the loop-delta timer of
``bench/looptimer.py`` (wall time per call, the host in it), imported here
as the JAX harness imports it.

Beside them, the port's own timers:

* :func:`measure_call_time`: CUDA events around a run of ``iters``
  back-to-back calls on the current stream after a warmup, so per-call
  times; a call whose host-side launch work outlasts its device work is
  measured at its launch rate, which is what a caller of it gets;
* :func:`measure_graph_time`: the same calls replayed as a CUDA graph, the
  host taken out: the device's share;
* :func:`device_time_by_kernel`: one traced call, by kernel;
* :func:`device_peak_mb`: the allocator's peak since the last reset.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import time
from typing import Any, Callable, Optional, Sequence

import torch

from .looptimer import _leaves, measure_op_time  # noqa: F401  (the reference's name)


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


def measure_call_time(fn: Callable, args: Sequence[Any], iters: int = 20,
                      repeats: int = 5, warmup: int = 3) -> dict:
    """Per-call time of ``fn(*args)`` in ms from CUDA events: p50, avg, min,
    max and std over ``repeats`` samples, each the mean of ``iters`` calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_call_time needs a CUDA device")
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
    :func:`measure_call_time`."""
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


def device_peak_mb(device=None) -> float:
    """Peak device memory allocated by PyTorch since the last
    ``torch.cuda.reset_peak_memory_stats``, in MiB."""
    return torch.cuda.max_memory_allocated(device) / (1024 * 1024)


def _sync(args) -> None:
    if any(leaf.is_cuda for leaf in _leaves(list(args))):
        torch.cuda.synchronize()


@dataclasses.dataclass
class BenchResult:
    name: str
    avg_ms: float
    std_ms: float
    min_ms: float
    max_ms: float
    p50_ms: float
    p99_ms: float
    first_ms: float          # the second call's wall time, synchronized
    init_ms: float           # the first call's wall time (kernels built there when first used)
    count: int
    warmup: int
    iters: int = 0           # loop-delta chain length actually used
    peak_hbm_mb: Optional[float] = None
    live_hbm_mb: Optional[float] = None
    throughput_per_s: Optional[float] = None  # items/s if batch provided

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    def summary(self) -> str:
        # The reference's printed contract (tools.py:550):
        # "Avg latency X ms, Std Y ms, Mem footprint(MB): Z"
        mem = f"{self.peak_hbm_mb:.2f}" if self.peak_hbm_mb is not None else "n/a"
        return (
            f"{self.name}: Avg latency {self.avg_ms:.3f} ms, Std {self.std_ms:.3f} ms, "
            f"p50 {self.p50_ms:.3f} ms, init {self.init_ms:.1f} ms, "
            f"Mem footprint(MB): {mem}"
        )


def device_mem_mb(device=None) -> tuple[Optional[float], Optional[float]]:
    """(peak_mb, live_mb) from the CUDA caching allocator (the peak since the
    last ``torch.cuda.reset_peak_memory_stats``), or (None, None) without a
    card, as the reference returns where its backend has no memory stats."""
    if not torch.cuda.is_available():
        return None, None
    to_mb = 1.0 / (1024 * 1024)
    return (torch.cuda.max_memory_allocated(device) * to_mb,
            torch.cuda.memory_allocated(device) * to_mb)


def compiled_mem_mb(fn: Callable, args: Sequence[Any]) -> Optional[float]:
    """Device memory (MB) that one call of ``fn(*args)`` needs: the peak the
    allocator reaches during the call above what was live before it (its
    outputs and temporaries), read after ``torch.cuda.reset_peak_memory_stats``,
    which it leaves reset.  None on the CPU.

    PyTorch has no compiled executable to ask, so this runs the call where
    the reference reads XLA's static memory analysis, which also counts the
    arguments and the program; it differs by the arguments' size."""
    if not any(leaf.is_cuda for leaf in _leaves(list(args))):
        return None
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn(*args)
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - live) / (1024 * 1024)


def benchmark_fn(
    fn: Callable,
    args: Sequence[Any],
    *,
    name: str = "fn",
    num_runs: int = 50,
    warmup_runs: int = 2,
    batch_size: Optional[int] = None,
    iters: int = 100,
    chain_arg: int = -1,
) -> BenchResult:
    """Benchmark ``fn(*args)`` with the loop-delta timer.

    ``num_runs`` = loop-delta repeats (each one (K, 1) measurement pair, the
    reference's num_runs samples); ``iters`` is the starting chain length,
    raised until the delta clears the fixed-cost jitter.  ``init_ms`` is the
    first call's wall time, synchronized: the analogue of TFLite's "init"
    line, which on the card includes building the kernels when this process
    launches them first; ``first_ms`` the second call's.  Memory: the
    allocator's peak since the last reset and what is live after the run."""
    t0 = time.perf_counter()
    fn(*args)
    _sync(args)
    init_ms = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    fn(*args)
    _sync(args)
    first_ms = (time.perf_counter() - t0) * 1e3

    stats = measure_op_time(
        fn, args, iters=iters, repeats=num_runs, chain_arg=chain_arg,
        warmup=warmup_runs,
    )
    peak_mb, live_mb = device_mem_mb()
    if peak_mb is None:
        peak_mb = compiled_mem_mb(fn, args)
    avg = stats["avg_ms"]
    return BenchResult(
        name=name,
        avg_ms=avg,
        std_ms=stats["std_ms"],
        min_ms=stats["min_ms"],
        max_ms=stats["max_ms"],
        p50_ms=stats["p50_ms"],
        p99_ms=stats["max_ms"],
        first_ms=first_ms,
        init_ms=init_ms,
        count=num_runs,
        warmup=warmup_runs,
        iters=stats["iters"],
        peak_hbm_mb=peak_mb,
        live_hbm_mb=live_mb,
        throughput_per_s=(batch_size * 1e3 / avg) if batch_size and avg > 0 else None,
    )


def benchmark_throughput(
    fn: Callable,
    args: Sequence[Any],
    *,
    name: str = "fn",
    num_runs: int = 10,
    warmup_runs: int = 2,
    batch_size: int = 1,
    iters: int = 30,
) -> BenchResult:
    """Throughput-oriented variant: the same loop-delta core on a serving
    batch, so items/s = batch / per-call time."""
    return benchmark_fn(
        fn, args, name=name, num_runs=num_runs, warmup_runs=warmup_runs,
        batch_size=batch_size, iters=iters,
    )
