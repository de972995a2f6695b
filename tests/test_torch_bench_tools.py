"""The port's measuring stack against the JAX package's, on the CPU: the
loop-delta timer (``bench/looptimer``), the harness (``BenchResult``,
``benchmark_fn``, memory), the profiler (``bench/profile``), the
experiments (``bench/experiments``) and ``utils/latency_model.measure_pruned_deit``."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu.bench import experiments as jex
from edgevisiontransformer_tpu.bench import harness as jharness
from edgevisiontransformer_tpu.bench import profile as jprofile
from edgevisiontransformer_tpu.config import ViTConfig as JViTConfig
from edgevisiontransformer_tpu.models.vit import ViT as JViT
from edgevisiontransformer_tpu_torch.bench import analyse as tanalyse
from edgevisiontransformer_tpu_torch.bench import experiments as tex
from edgevisiontransformer_tpu_torch.bench import harness as tharness
from edgevisiontransformer_tpu_torch.bench import looptimer as tlt
from edgevisiontransformer_tpu_torch.bench import profile as tprofile
from edgevisiontransformer_tpu_torch.config import ViTConfig
from edgevisiontransformer_tpu_torch.models.vit import ViT
from edgevisiontransformer_tpu_torch.utils.jax_bridge import load_jax_params

torch.set_num_threads(1)

TIMER_KEYS = {"avg_ms", "p50_ms", "min_ms", "max_ms", "std_ms", "iters", "repeats"}
# a 2-layer ViT small enough for the CPU (the same config in both packages)
SMALL = dict(image_size=32, patch_size=8, dim=32, depth=2, heads=2, mlp_dim=64,
             num_classes=10)


def _stub_timer(calls=None):
    """A stand-in for measure_op_time: one call of fn (checked to run), 1 ms."""
    def stub(fn, args, **kw):
        out = fn(*args)
        if calls is not None:
            calls.append((out, kw))
        return {"avg_ms": 1.0, "p50_ms": 1.0, "min_ms": 1.0, "max_ms": 1.0, "std_ms": 0.0,
                "iters": kw.get("iters", 1), "repeats": kw.get("repeats", 1)}
    return stub


# ---------------------------------------------------------------------------
# Loop-delta timer
# ---------------------------------------------------------------------------


def test_looptimer_returns_the_reference_keys():
    from edgevisiontransformer_tpu.bench.looptimer import measure_op_time as jmeasure

    want = jmeasure(lambda a: a * 2.0, (jnp.ones((8, 8)),), iters=4, repeats=2)
    got = tlt.measure_op_time(lambda a: a * 2.0, (torch.ones(8, 8),), iters=4, repeats=2)
    assert set(got) == set(want) == TIMER_KEYS
    assert got["repeats"] == 2 and got["min_ms"] <= got["p50_ms"] <= got["max_ms"]


class _Clock:
    """A fake wall clock that each call of ``fn`` advances by 2^-10 s (exact
    in binary, so the rule's arithmetic is exact)."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t

    def fn(self, x):
        self.t += 2.0 ** -10
        return x


@pytest.mark.parametrize("auto", [True, False])
def test_looptimer_rescales_iters_as_the_reference(monkeypatch, auto):
    """With every call 0.9765625 ms and no fixed cost, the delta of 5
    iterations is 3.90625 ms: under the reference's rule (looptimer.py:103-118)
    a 100 ms floor asks for int(5 * 2 * 100 / 3.90625) = 256 iterations,
    whose delta clears it."""
    clock = _Clock()
    monkeypatch.setattr(tlt, "time", types.SimpleNamespace(perf_counter=clock.perf_counter))
    r = tlt.measure_op_time(clock.fn, (torch.ones(3),), iters=5, repeats=3,
                            auto_iters=auto, min_delta_ms=100.0)
    assert r["iters"] == (256 if auto else 5)
    assert r["p50_ms"] == 1e3 / 1024 and r["std_ms"] == 0.0


def test_looptimer_chains_each_call_to_the_last():
    """The first call gets the caller's arguments, each later one a new first
    leaf of args[chain_arg] (the last output reduced, times 1e-38, added to
    it); the other leaves and the caller's arguments are left as they are; a
    dict argument is chained through its first leaf."""
    seen = []

    def fn(w, tree):
        seen.append((w, tree["a"], tree["b"]))
        return tree["a"] * w

    w = torch.full((4,), 2.0)
    a, b = torch.ones(4), torch.zeros(2)
    run = tlt._chained_runner(fn, (w, {"a": a, "b": b}), chain_arg=-1)
    run(3)
    assert len(seen) == 3
    assert all(s[0] is w and s[2] is b for s in seen)
    assert seen[0][1] is a and seen[1][1] is not a and seen[2][1] is not seen[1][1]
    assert all(torch.equal(s[1], a) for s in seen)  # 1e-38 * 8 does not move 1.0
    with pytest.raises(TypeError, match="no tensor"):
        tlt._chained_runner(fn, (w, 3), chain_arg=-1)
    with pytest.raises(TypeError, match="no tensor"):
        tlt._chained_runner(fn, (w, (a, b)), chain_arg=-1)


# ---------------------------------------------------------------------------
# Harness
# ---------------------------------------------------------------------------


def _result_values():
    return dict(name="deit_tiny b1", avg_ms=1.23456, std_ms=0.0123, min_ms=1.2, max_ms=1.3,
                p50_ms=1.234, p99_ms=1.3, first_ms=2.5, init_ms=1234.5, count=5, warmup=2,
                iters=100, peak_hbm_mb=151.4, live_hbm_mb=40.0, throughput_per_s=810.0)


def test_bench_result_is_the_references():
    assert ([f.name for f in dataclasses.fields(tharness.BenchResult)]
            == [f.name for f in dataclasses.fields(jharness.BenchResult)])
    got, want = tharness.BenchResult(**_result_values()), jharness.BenchResult(**_result_values())
    assert got.summary() == want.summary()
    assert got.to_json() == want.to_json()
    v = dict(_result_values(), peak_hbm_mb=None)
    assert tharness.BenchResult(**v).summary() == jharness.BenchResult(**v).summary()


def test_harness_on_the_cpu():
    """Without a card: no allocator to read, memory None; benchmark_fn and
    benchmark_throughput time the call with the loop-delta timer."""
    assert tharness.device_mem_mb() == (None, None)
    assert tharness.compiled_mem_mb(lambda a: a @ a, (torch.ones(4, 4),)) is None
    assert tharness.measure_op_time is tlt.measure_op_time
    res = tharness.benchmark_fn(lambda a: a @ a, (torch.ones(32, 32),), name="mm", num_runs=3,
                                iters=8, batch_size=4)
    assert res.count == 3 and res.p50_ms >= 0 and res.init_ms > 0 and res.first_ms > 0
    assert res.peak_hbm_mb is None and res.live_hbm_mb is None
    res = tharness.benchmark_throughput(lambda a: a + 1, (torch.ones(8),), num_runs=2, iters=8,
                                        batch_size=8)
    assert res.count == 2 and res.warmup == 2
    with pytest.raises(RuntimeError, match="CUDA"):
        tharness.measure_call_time(lambda: None, ())


# ---------------------------------------------------------------------------
# Profiler
# ---------------------------------------------------------------------------


def _pair():
    jcfg = JViTConfig(**SMALL)
    jmodel = JViT(jcfg)
    x = np.random.RandomState(0).randn(2, 3, 32, 32).astype(np.float32)
    variables = jmodel.init(jax.random.key(0), jnp.asarray(x))
    tmodel = ViT(ViTConfig(**SMALL), device="cpu")
    load_jax_params(tmodel, jax.tree.map(np.asarray, variables["params"]))
    return jmodel, variables, tmodel, x


def test_profile_vit_rows_are_jaxs(monkeypatch):
    """The same stage rows, names, node types, percents and starts in the
    same order, each stage run once (the timers stubbed to 1 ms)."""
    jmodel, variables, tmodel, x = _pair()
    monkeypatch.setattr(jprofile, "measure_op_time", _stub_timer())
    calls = []
    monkeypatch.setattr(tprofile, "measure_op_time", _stub_timer(calls))
    want, want_total = jprofile.profile_vit(jmodel, variables, jnp.asarray(x))
    got, got_total = tprofile.profile_vit(tmodel, tmodel.params(), torch.from_numpy(x))
    assert got == want and got_total == want_total
    assert len(got) == 2 + 8 * SMALL["depth"]
    # the last timed call is the whole forward: the model's logits
    assert tuple(calls[-1][0].shape) == (2, SMALL["num_classes"])


def test_profile_vit_times_every_stage():
    _, _, tmodel, x = _pair()
    rows, total = tprofile.profile_vit(tmodel, {"params": tmodel.params()},
                                       torch.from_numpy(x), iters=4, repeats=1)
    assert total > 0 and all(r["avg_ms"] >= 0 for r in rows)
    assert [r["start"] for r in rows] == sorted(r["start"] for r in rows)


def _rows():
    return [{"node_type": "LAYER_NORM", "name": "block_0/attn/layer_norm", "avg_ms": 0.0123456,
             "percent": 12.3456, "start": 0.0},
            {"node_type": "FULLY_CONNECTED", "name": "block_0/attn/qkv", "avg_ms": 1 / 3,
             "percent": 87.65, "start": 0.0123456}]


def test_write_profile_csv_is_jaxs_byte_for_byte(tmp_path):
    jprofile.write_profile_csv(str(tmp_path / "j.csv"), _rows(), 0.3456789)
    tprofile.write_profile_csv(str(tmp_path / "t.csv"), _rows(), 0.3456789)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def test_cpu_trace_csv_round_trips_through_analyse(tmp_path):
    """On the CPU each row is one operator (its self time); the CSV reads
    back through bench/analyse with the same rows and totals."""
    _, _, tmodel, x = _pair()
    img = torch.from_numpy(x)
    with torch.no_grad():
        rows, total = tprofile.profile_trace(lambda: tmodel(img), iters=2, warmup=1)
    assert total > 0 and len({r["name"] for r in rows}) == len(rows)
    assert all(r["name"].startswith(r["node_type"].lower() + "/aten::") for r in rows)
    assert sum(r["percent"] for r in rows) == pytest.approx(100.0)
    assert any(r["node_type"] == "FULLY_CONNECTED" for r in rows)
    path = str(tmp_path / "trace.csv")
    tprofile.write_profile_csv(path, rows, total)
    table = tanalyse.analyse_op(path)
    assert sum(v["latency"] for v in table.values()) == pytest.approx(total, abs=1e-5 * len(rows))
    series = tanalyse.fetch_all_op_latency(path)
    assert [name for name, _ in series] == [r["name"] for r in rows]
    with torch.no_grad():
        mm = tprofile.profile_trace(lambda: tmodel(img), iters=1, warmup=0, module_hint="mm")[0]
    assert mm and all("mm" in r["name"] for r in mm)
    with pytest.raises(RuntimeError, match="no CPU operator"):
        tprofile.profile_trace(lambda: tmodel(img), iters=1, warmup=0, module_hint="no_such_op")


@pytest.mark.parametrize("name,node", [
    ("void ln_rows_kernel<__nv_bfloat16>(__nv_bfloat16 const*, void const*)", "LAYER_NORM"),
    ("void linear_kernel<__nv_bfloat16, 128, 64, 4, 2, 3>(Params)", "FULLY_CONNECTED"),
    ("void linear_i8_kernel<__nv_bfloat16, 64, 64>(Params)", "FULLY_CONNECTED"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "FULLY_CONNECTED"),
    ("nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_NNN", "FULLY_CONNECTED"),
    ("void attention_rows_kernel<__nv_bfloat16, 4, 64>(...)", "ATTENTION"),
    ("void sdpa_kernel<__nv_bfloat16, 64, true>(...)", "ATTENTION"),
    ("void window_attention_kernel<__nv_bfloat16, 32, true>(...)", "ATTENTION"),
    ("void window_sdpa_kernel<__nv_bfloat16, 32>(...)", "ATTENTION"),
    ("void quant_rows_kernel<__nv_bfloat16, true>(...)", "QUANTIZE"),
    ("void mlp_kernel<__nv_bfloat16, 128, 64>(...)", "GELU_MLP"),
    ("void performer_rows_kernel<__nv_bfloat16>(...)", "PERFORMER"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     "ELEMENTWISE"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", "REDUCE"),
    ("aten::addmm", "FULLY_CONNECTED"),
    ("aten::mean", "REDUCE"),
])
def test_node_types_of_kernels_and_operators(name, node):
    assert tprofile.node_type(name) == node


@pytest.mark.parametrize("name,short", [
    ("void (anonymous namespace)::ln_rows_kernel<__nv_bfloat16>(__nv_bfloat16 const*, int)",
     "ln_rows_kernel"),
    ("void linear_kernel<__nv_bfloat16, 128, 64>(Params)", "linear_kernel"),
    ("void at::native::reduce_kernel<512, 1>(at::native::ReduceOp)",
     "at::native::reduce_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy"),
])
def test_trace_rows_name_the_kernel_function(name, short):
    assert tprofile._short(name) == short


def _ev(name, start, us, self_us=0.0):
    return types.SimpleNamespace(name=name, self_cpu_time_total=self_us,
                                 time_range=types.SimpleNamespace(start=start,
                                                                  elapsed_us=lambda: us))


def test_kernel_rows_average_each_launch_position():
    """The card's rows: the kernels sorted into iterations by the CPU marks
    around them, one row per launch position of the most common sequence,
    its time the mean over the iterations that launched it (an iteration
    whose records the tracer lost is left out)."""
    marks = [_ev("it", 0, 9), _ev("it", 10, 9), _ev("it", 20, 9)]
    kernels = [_ev("ln", 1, 2.0), _ev("linear", 3, 4.0), _ev("ln", 8, 2.0),
               _ev("ln", 24, 6.0), _ev("linear", 25, 8.0), _ev("ln", 28, 4.0),
               _ev("ln", 11, 9.0), _ev("ln", 12, 9.0)]
    runs = tprofile._iterations(kernels, marks)
    assert [[ev.name for ev in run] for run in runs] == [["ln", "linear", "ln"], ["ln", "ln"],
                                                         ["ln", "linear", "ln"]]
    rows = tprofile._kernel_rows(runs)
    assert [r["op"] for r in rows] == ["ln", "linear", "ln"]
    assert [r["ms"] for r in rows] == [4e-3, 6e-3, 3e-3]
    assert [r["first"] for r in rows] == [1, 3, 8]
    assert tprofile._kernel_rows([[], []]) == []
    ops = tprofile._operator_rows([_ev("aten::mm", 5, 9, 4.0), _ev("aten::add", 2, 1, 1.0),
                                   _ev("aten::mm", 1, 9, 2.0)], iters=2)
    assert {r["op"]: (r["ms"], r["first"]) for r in ops} == {"aten::mm": (3e-3, 1),
                                                            "aten::add": (0.5e-3, 2)}


# ---------------------------------------------------------------------------
# Experiments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["tiny", "small", "base"])
def test_prune_benchmark_grid_is_jaxs(size):
    assert tex.prune_benchmark_grid(size) == jex.prune_benchmark_grid(size)


@pytest.mark.parametrize("which", ["micro_attention", "micro_ffn", "micro_dense_plus_input"])
def test_micro_models_give_jaxs_outputs_on_jaxs_arrays(which):
    jfn, jargs = getattr(jex, which)()
    tfn, targs = getattr(tex, which)(device="cpu")
    assert [tuple(a.shape) for a in targs] == [tuple(a.shape) for a in jargs]
    assert all(a.dtype == torch.float32 for a in targs)
    want = np.asarray(jax.jit(jfn)(*jargs))
    got = tfn(*[torch.from_numpy(np.asarray(a)) for a in jargs]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_fusion_stages_fused_and_unfused_compute_the_same_chain():
    """On the CPU the fused stages run the kernels' twins: they and the seven
    separate bf16 ops compute the same chain, apart by where each rounds to
    bf16 (the twins round GELU and the bias + residual sum once, the
    separate ops after each op): a few bf16 spacings before the LayerNorm."""
    stages = tex.fusion_test_transformer_stages(64, 256, device="cpu")
    x = torch.randn(10, 64, generator=torch.Generator().manual_seed(0)).bfloat16()
    fused, unfused = stages(x, False), stages(x, True)
    assert fused.dtype == unfused.dtype == torch.bfloat16
    torch.testing.assert_close(fused.float(), unfused.float(), rtol=2.0 ** -5, atol=0.05)


def test_experiments_return_jaxs_keys(monkeypatch):
    for mod in (jex, tex):
        monkeypatch.setattr(mod, "measure_op_time", _stub_timer())
    kw = dict(iters=2, repeats=1)
    assert (set(tex.fusion_ab(rows=4, dim=16, mlp=32, device="cpu", **kw))
            == set(jex.fusion_ab(rows=4, dim=16, mlp=32, **kw)))
    got, want = tex.quant_op_sweep((16,), device="cpu", **kw), jex.quant_op_sweep((16,), **kw)
    assert [set(r) for r in got] == [set(r) for r in want] and got[0]["size"] == 16
    assert (set(tex.bench_micro_models(dim=16, heads=2, device="cpu", **kw))
            == set(jex.bench_micro_models(dim=16, heads=2, **kw)))


# ---------------------------------------------------------------------------
# measure_pruned_deit
# ---------------------------------------------------------------------------

ENCODINGS = ["-".join(["h_1_d_0.3"] * 12),
             "-".join(["h_3_d_1"] * 6 + ["h_2_d_0.5"] * 6),
             "h_1_d_0.25-h_2_d_0.7-h_3_d_0.1-h_1_d_1-h_2_d_0.5-h_3_d_0.9-h_1_d_0.6-h_2_d_0.35"
             "-h_3_d_0.05-h_1_d_0.8-h_2_d_0.15-h_3_d_0.45"]


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_measure_pruned_deit_builds_jaxs_model(monkeypatch, encoding):
    """The same per-layer heads, MLP widths and head size as the JAX
    function builds; the port's measure runs its forward (timer stubbed)."""
    import edgevisiontransformer_tpu.bench.looptimer as jlt
    import edgevisiontransformer_tpu.models.vit as jvit
    from edgevisiontransformer_tpu.utils.latency_model import measure_pruned_deit as jmeasure
    from edgevisiontransformer_tpu_torch.utils import latency_model as tlm

    built = []

    class FakeViT:
        def __init__(self, cfg):
            built.append(cfg)

        def init(self, *a):
            return {}

    monkeypatch.setattr(jvit, "ViT", FakeViT)
    monkeypatch.setattr(jlt, "measure_op_time", lambda *a, **k: {"p50_ms": 1.0})
    jmeasure("tiny", impl="xla")(encoding)
    want = built[0]
    got = tlm.pruned_deit_config(encoding, "tiny")
    assert got.heads_per_layer == want.heads_per_layer
    assert got.mlp_dim_per_layer == want.mlp_dim_per_layer
    assert got.head_dim == want.head_dim == 64 and got.dtype == torch.bfloat16

    calls = []
    monkeypatch.setattr(tlt, "measure_op_time", _stub_timer(calls))
    r = tlm.measure_pruned_deit("tiny", dtype="float32", impl="fused", detailed=True,
                                device="cpu")(encoding)
    assert r["p50_ms"] == 1.0 and tuple(calls[0][0].shape) == (1, 1000)
    assert calls[0][1]["repeats"] == 7 and calls[0][1]["min_delta_ms"] == 120.0
    assert tlm.measure_pruned_deit("tiny", dtype="float32", impl="xla",
                                   device="cpu")(encoding) == 1.0
    with pytest.raises(ValueError, match="unknown impl"):
        tlm.measure_pruned_deit("tiny", impl="tpu", device="cpu")(encoding)
