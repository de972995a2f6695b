"""Per-op profiling -> TFLite-schema CSV (port of
``edgevisiontransformer_tpu/bench/profile.py``).

The reference gets per-op latencies from the TFLite benchmark binary's
``--enable_op_profiling`` CSV.  Two modes reproduce that here:

* **micro** (:func:`profile_vit`): each stage of a ViT forward timed alone
  with the loop-delta timer (``bench/looptimer.measure_op_time``) and
  emitted as a row: the JAX package's stage rows, names and node types,
  built from the port's ``ops/layers.py``, ``ops/attention.py`` and
  ``ops/activations.get_gelu``.
* **trace** (:func:`profile_trace`): a real trace from ``torch.profiler``.
  On the card each row is one CUDA kernel launch of an iteration, in
  launch order, its time averaged over the traced iterations; on the CPU
  each row is one CPU operator.  The sanity oracle of the reference
  applies: the rows' sum must reconcile with the end-to-end time.

Both emit the schema ``bench/analyse.py`` reads: a section headed
"Operator-wise Profiling Info for Regular Benchmark Run", a schema row
``node type,name,avg_ms,%,start``, then one row per op.
"""

from __future__ import annotations

import bisect
import collections
import csv
import re
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..ops.activations import get_gelu
from ..ops.attention import merge_heads, qkv_split, sdpa
from ..ops.layers import layer_norm, patch_embed
from .looptimer import measure_op_time


def profile_vit(model, params, x: torch.Tensor, iters: int = 100, repeats: int = 3):
    """Stage-wise latency decomposition of a ViT forward.

    Returns (rows, total_ms): rows are dicts with node_type / name / avg_ms /
    percent / start.  Stage names embed the block index and sublayer
    (attn / ffn) so that the attention-vs-FFN analyser splits them.
    ``params`` is ``model.params()`` or ``{"params": ...}``; ``total_ms``
    is the whole ``model(x)`` forward.  Runs under ``torch.no_grad()``."""
    cfg = model.config
    p = params.get("params", params)
    hd = cfg.resolved_head_dim
    dt = cfg.dtype
    b = x.shape[0]
    act = get_gelu(cfg.gelu_approx)
    rows: List[Dict] = []

    def time_stage(node_type, name, fn, args):
        r = measure_op_time(fn, args, iters=iters, repeats=repeats, chain_arg=0)
        rows.append({"node_type": node_type, "name": name, "avg_ms": r["p50_ms"]})

    with torch.no_grad():
        x0 = x.to(dt)
        embed = lambda img: patch_embed(img, p["patch_kernel"].to(dt),  # noqa: E731
                                        p["patch_bias"].to(dt), cfg.patch_size)
        time_stage("PATCH_EMBED", "embed/patch_to_embedding", embed, (x0,))

        # representative per-layer stages on the embedding: every layer's own
        # weights, the same input
        emb = embed(x0)
        cls = p["cls_token"].to(dt).expand(b, 1, cfg.dim)
        h0 = torch.cat([cls, emb], dim=1) + p["pos_embedding"].to(dt)

        for i in range(cfg.depth):
            blk = p[f"block_{i}"]
            heads = cfg.layer_heads(i)
            ln1 = lambda t, blk=blk: layer_norm(  # noqa: E731
                t, blk["ln1"]["scale"], blk["ln1"]["bias"], cfg.layernorm_eps)
            qkv_fn = lambda t, blk=blk: t @ blk["attn"]["qkv_kernel"].to(dt)  # noqa: E731
            qkv_out = qkv_fn(h0)
            sdpa_fn = lambda qkv, heads=heads: sdpa(  # noqa: E731
                *qkv_split(qkv, heads, hd), scale=hd ** -0.5)
            ctx = sdpa_fn(qkv_out)
            out_fn = lambda c, blk=blk: (  # noqa: E731
                merge_heads(c) @ blk["attn"]["out_kernel"].to(dt))
            # the FFN decomposed so that the activation gets its own row, as
            # the reference's GELU share isolates it from the matmuls
            fc1_fn = lambda t, blk=blk: (  # noqa: E731
                t @ blk["ffn"]["fc1_kernel"].to(dt) + blk["ffn"]["fc1_bias"].to(dt))
            hid0 = fc1_fn(h0)
            fc2_fn = lambda t, blk=blk: (  # noqa: E731
                t @ blk["ffn"]["fc2_kernel"].to(dt) + blk["ffn"]["fc2_bias"].to(dt))

            time_stage("LAYER_NORM", f"block_{i}/attn/layer_norm", ln1, (h0,))
            time_stage("FULLY_CONNECTED", f"block_{i}/attn/qkv", qkv_fn, (h0,))
            time_stage("ATTENTION", f"block_{i}/attn/sdpa", sdpa_fn, (qkv_out,))
            time_stage("FULLY_CONNECTED", f"block_{i}/attn/out_proj", out_fn, (ctx,))
            # the JAX package times ln1 here too (the same shapes as ln2)
            time_stage("LAYER_NORM", f"block_{i}/ffn/layer_norm", ln1, (h0,))
            time_stage("FULLY_CONNECTED", f"block_{i}/ffn/fc1", fc1_fn, (h0,))
            time_stage("GELU", f"block_{i}/ffn/gelu", act, (hid0,))
            time_stage("FULLY_CONNECTED", f"block_{i}/ffn/fc2", fc2_fn, (hid0,))

        if cfg.final_norm:
            time_stage(
                "LAYER_NORM", "final/layer_norm",
                lambda t: layer_norm(t, p["final_norm"]["scale"], p["final_norm"]["bias"],
                                     cfg.layernorm_eps),
                (h0,),
            )

        total = measure_op_time(model, (x0,), iters=iters, repeats=repeats, chain_arg=0)
    total_ms = total["p50_ms"]

    # percent and synthetic start timestamps
    cum = 0.0
    for r in rows:
        r["percent"] = 100.0 * r["avg_ms"] / total_ms if total_ms else 0.0
        r["start"] = cum
        cum += r["avg_ms"]
    return rows, total_ms


# Kernel or operator name -> node type, the first pattern that matches
# (the counterpart of the JAX package's HLO-op table).
_NODE_TYPES = (
    (r"ln_rows|layer_?norm", "LAYER_NORM"),
    (r"quant_rows", "QUANTIZE"),
    (r"linear_i8|linear_kernel|gemm|xmma|nvjet|cutlass|aten::(add)?mm|aten::linear|aten::matmul"
     r"|aten::bmm", "FULLY_CONNECTED"),
    (r"attention_rows|sdpa|window_attention|window_sdpa|flash|fmha|attention",
     "ATTENTION"),
    (r"mlp_kernel", "GELU_MLP"),
    (r"swin_merge", "PATCH_MERGING"),
    (r"t2t_stage1", "TOKENIZER"),
    (r"performer", "PERFORMER"),
    (r"vit_full", "VIT_FULL"),
    (r"conv", "CONV_2D"),
    (r"softmax", "SOFTMAX"),
    (r"gelu|erf|tanh", "GELU"),
    (r"cat|Cat", "CONCATENATION"),
    (r"reduce|sum|mean|amax", "REDUCE"),
    (r"[Mm]emset", "MEMSET"),
    (r"[Mm]emcpy|copy", "COPY"),
    (r"elementwise|aten::", "ELEMENTWISE"),
)


def node_type(name: str) -> str:
    """The TFLite-style node type of a CUDA kernel or a CPU operator: the
    port's kernels by their function names (``ln_rows`` -> LAYER_NORM,
    ``linear`` / ``linear_i8`` / cuBLAS GEMMs -> FULLY_CONNECTED,
    ``attention_rows`` / ``sdpa`` / ``window_*`` -> ATTENTION, ``quant_rows``
    -> QUANTIZE, ...), PyTorch's by theirs."""
    for pattern, nt in _NODE_TYPES:
        if re.search(pattern, name):
            return nt
    return "OTHER"


def _short(name: str) -> str:
    """A kernel's function name without ``void``, an anonymous namespace,
    its template arguments and its argument list."""
    s = re.sub(r"^void\s+", "", name.strip().replace("(anonymous namespace)::", ""))
    m = re.match(r"[\w:]+", s)
    return m.group(0) if m else name


# the CPU range around each traced iteration, which sorts the kernels into
# their iterations
_ITERATION = "evt_profile_iteration"
# traces taken before an empty one is believed: the tracer on the H100 now
# and then loses every kernel record of a trace, at times twice in a row
_TRIES = 8


def _trace(run_once: Callable[[], None], iters: int, cuda: bool):
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(iters):
            with record_function(_ITERATION):
                run_once()
        if cuda:
            torch.cuda.synchronize()
    return prof.events()


def _iterations(kernels, marks) -> List[List]:
    """The kernels of each traced iteration: those that start at or after its
    mark (the CPU range around ``run_once``, which waits for the card) and
    before the next mark."""
    starts = sorted(m.time_range.start for m in marks)
    runs: List[List] = [[] for _ in starts]
    for ev in sorted(kernels, key=lambda ev: ev.time_range.start):
        k = bisect.bisect_right(starts, ev.time_range.start) - 1
        if k >= 0:
            runs[k].append(ev)
    return runs


def _kernel_rows(runs: List[List]) -> List[Dict]:
    """One row per launch position of an iteration, over the iterations that
    launched the most common sequence of kernels (the tracer now and then
    drops records of one): its mean time (ms) and its first start (us)."""
    seqs = collections.Counter(tuple(ev.name for ev in run) for run in runs if run)
    if not seqs:
        return []
    seq = seqs.most_common(1)[0][0]
    used = [run for run in runs if tuple(ev.name for ev in run) == seq]
    return [{"op": op,
             "ms": sum(run[j].time_range.elapsed_us() for run in used) / len(used) / 1e3,
             "first": used[0][j].time_range.start}
            for j, op in enumerate(seq)]


def _operator_rows(events, iters: int) -> List[Dict]:
    """One row per CPU operator name: its self time (nested operators are
    not counted twice) per iteration (ms), its first start (us)."""
    agg: Dict[str, Dict] = {}
    for ev in events:
        row = agg.setdefault(ev.name, {"op": ev.name, "ms": 0.0, "first": ev.time_range.start})
        row["ms"] += ev.self_cpu_time_total / iters / 1e3
        row["first"] = min(row["first"], ev.time_range.start)
    return list(agg.values())


def profile_trace(run_once: Callable[[], None], iters: int = 10, warmup: int = 3,
                  module_hint: Optional[str] = None, device: Optional[str] = None):
    """A real trace via ``torch.profiler``: run ``run_once`` (one iteration of
    the target, waiting for the card at its end) ``iters`` times under the
    profiler and return (rows, total_ms) in :func:`profile_vit`'s schema;
    ``total_ms`` is the per-iteration sum of the rows, which should
    reconcile with the end-to-end loop-delta time.

    ``device`` ("cuda" by default where there is a card, else "cpu"): on the
    card each row is one CUDA kernel launch of an iteration, in launch order
    (``avg_ms`` its time averaged over the iterations that launched the most
    common sequence, ``start`` its first start; named
    ``<position>/<node type>/<kernel>``, so a LayerNorm kernel's row says
    ``layer_norm``).  Only the kernels' own records count: the device-side
    rows of ``record_function`` regions span kernels counted already.  An
    empty trace is taken again, ``_TRIES`` times in all, before this raises.
    On the CPU each row is one CPU operator (its self time).

    ``module_hint``: keep only kernels (operators) whose name contains it."""
    from torch.autograd import DeviceType

    cuda = (device or ("cuda" if torch.cuda.is_available() else "cpu")) == "cuda"
    for _ in range(warmup):
        run_once()
    rows = []
    for _ in range(_TRIES if cuda else 1):
        evs = _trace(run_once, iters, cuda)
        marks = [ev for ev in evs if ev.name == _ITERATION and ev.device_type == DeviceType.CPU]
        want = DeviceType.CUDA if cuda else DeviceType.CPU
        evs = [ev for ev in evs if ev.device_type == want
               and not getattr(ev, "is_user_annotation", False)
               and (ev.time_range.elapsed_us() > 0 or not cuda)]
        if module_hint is not None:
            evs = [ev for ev in evs if module_hint in ev.name]
        rows = _kernel_rows(_iterations(evs, marks)) if cuda else _operator_rows(evs, iters)
        if rows:
            break
    if not rows:
        raise RuntimeError(
            f"the trace holds no {'CUDA kernel' if cuda else 'CPU operator'}"
            + (f" whose name contains {module_hint!r}" if module_hint else "")
            + (f" in {_TRIES} tries" if cuda else ""))
    rows.sort(key=lambda r: r["first"])
    t0 = rows[0]["first"]
    out: List[Dict] = []
    for pos, r in enumerate(rows):
        nt = node_type(r["op"])
        name = f"{pos:04d}/{nt.lower()}/{_short(r['op'])}" if cuda else \
            f"{nt.lower()}/{r['op']}"
        out.append({"node_type": nt, "name": name, "avg_ms": r["ms"],
                    "start": (r["first"] - t0) / 1e3})
    total_ms = sum(r["avg_ms"] for r in out)
    for r in out:
        r["percent"] = 100.0 * r["avg_ms"] / total_ms if total_ms else 0.0
    return out, total_ms


def write_profile_csv(path: str, rows: Sequence[Dict], total_ms: float) -> None:
    """Emit the TFLite op-profiling CSV section ``bench/analyse.py`` parses
    (header line, blank, schema row, data rows)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([f"Total inference avg_ms {total_ms:.4f}"])
        w.writerow(["Operator-wise Profiling Info for Regular Benchmark Run"])
        w.writerow([])
        w.writerow(["node type", "name", "avg_ms", "%", "start"])
        for r in rows:
            w.writerow([
                r["node_type"], r["name"], f"{r['avg_ms']:.6f}",
                f"{r['percent']:.3f}%", f"{r['start']:.6f}",
            ])
        w.writerow([])
