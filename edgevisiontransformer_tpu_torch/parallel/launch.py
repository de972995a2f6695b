"""Start a world of ranks and collect what each returns.

``spawn(fn, world, backend=..., device=..., deadline_s=...)`` starts
``world`` processes with the ``spawn`` start method; rank ``r`` runs
``fn(r, world, *args)`` inside an initialised default process group and
sends back its result (tensors moved to the host, pickled by value).  The
rendezvous is a file store in a fresh temporary directory, so worlds
started side by side (test workers) never share a port.  The backend is the caller's choice:
the ranks of one card share it over ``"gloo"`` (NCCL takes one device per
rank).

A rank that raises, or a world that is not done by ``deadline_s``, kills
every rank and raises in the caller with the rank's traceback: a hung
collective never outlives its deadline (the process group's own timeout is
the deadline too).  A rank never builds the kernel library: it opens the
one its parent built (``ops/cuda/build.forbid_build``).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback

# after a rank fails, how long its peers' failures are awaited for the report
_GRACE_S = 3.0


def _to_host(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(fn, rank, world, backend, device, store_path, deadline_s, args, results):
    try:
        import torch
        import torch.distributed as dist

        from ..ops.cuda import build

        torch.set_num_threads(1)
        build.forbid_build()
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device).index or 0)
        dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=deadline_s))
        try:
            out = _to_host(fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
        # by value: torch's queue reductions would hand tensors over through
        # shared memory that a rank which has exited can no longer serve
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # reported to the caller, which raises it
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world: int, *, backend: str, device: str, deadline_s: float, args=()) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` ranks; return the ranks'
    results in rank order.  ``fn`` and ``args`` must pickle (``fn`` a
    module-level function); ``device`` is where the ranks compute
    (``"cpu"``, or ``"cuda"``: every rank on the current card).  Raises
    ``RuntimeError`` with the traceback of every rank that failed (one
    rank's failure closes its peers' connections), and ``TimeoutError``
    naming the ranks not done when ``deadline_s`` passes."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    done, failed, procs = {}, {}, []
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        end = time.monotonic() + deadline_s
        try:
            for r in range(world):
                p = ctx.Process(target=_rank_main, daemon=True,
                                args=(fn, r, world, backend, device, store, deadline_s,
                                      tuple(args), results))
                p.start()
                procs.append(p)
            while len(done) + len(failed) < world:
                try:
                    rank, ok, out = results.get(timeout=max(0.0, min(1.0, end - time.monotonic())))
                except queue.Empty:
                    if time.monotonic() < end:
                        dead = [r for r, p in enumerate(procs) if r not in done and r not in failed
                                and not p.is_alive() and p.exitcode != 0]
                        for r in dead:
                            failed[r] = f"exited with code {procs[r].exitcode} without a result"
                        continue
                    if failed:
                        break
                    raise TimeoutError(f"spawn: ranks {sorted(set(range(world)) - set(done))} "
                                       f"of {world} not done within {deadline_s} s") from None
                if ok:
                    done[rank] = pickle.loads(out)
                else:  # its peers fail next, on the closed connections: report them all
                    failed[rank] = out
                    end = min(end, time.monotonic() + _GRACE_S)
            if failed:
                raise RuntimeError("\n".join(f"spawn: rank {r} of {world} failed:\n{failed[r]}"
                                             for r in sorted(failed)))
            for p in procs:
                p.join(timeout=max(1.0, end - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
            results.close()
    return [done[r] for r in range(world)]
