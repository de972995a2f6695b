"""The port's CLI (``edgevisiontransformer_tpu_torch/cli.py``) on the CPU
(``--device cpu``: every kernel wrapper takes its plain twin), against the
JAX package's CLI: its commands and printed text, its artifacts carried
across with ``utils/jax_bridge``, and the corners the port settles.  The
timing commands run with the loop-delta timer stubbed to one call."""

import csv
import json

import numpy as np
import pytest
import torch

from edgevisiontransformer_tpu import cli as jcli
from edgevisiontransformer_tpu_torch import cli
from edgevisiontransformer_tpu_torch.bench import looptimer as tlt

torch.set_num_threads(1)
CPU = ["--device", "cpu"]


def _stub_timer(calls):
    def stub(fn, args, **kw):
        calls.append(fn(*args))
        return {"avg_ms": 2.0, "p50_ms": 2.0, "min_ms": 2.0, "max_ms": 2.0, "std_ms": 0.0,
                "iters": kw.get("iters", 1), "repeats": kw.get("repeats", 1)}
    return stub


@pytest.fixture
def timed(monkeypatch):
    """The port's loop-delta timer replaced by one call of the function, in
    its module and in the two that import it by name."""
    from edgevisiontransformer_tpu_torch.bench import experiments, profile

    calls = []
    for mod in (tlt, profile, experiments):
        monkeypatch.setattr(mod, "measure_op_time", _stub_timer(calls))
    return calls


def _out(capsys):
    return capsys.readouterr().out


# ---------------------------------------------------------------------------
# Commands and printed text
# ---------------------------------------------------------------------------


def test_commands_are_jaxs():
    assert list(cli.COMMANDS) == list(jcli.COMMANDS)
    assert len(cli.COMMANDS) == 21


def test_help_and_main_coerce_as_jaxs(capsys, monkeypatch):
    assert cli.main([]) == 0 and cli.main(["-h"]) == 0
    out = _out(capsys)
    assert "python -m edgevisiontransformer_tpu_torch.cli" in out
    assert out.splitlines()[1] == "commands: " + ", ".join(jcli.COMMANDS)
    assert cli.main(["bogus_command"]) == 1
    for ret, rc in (({"p50_ms": 1.0}, 0), (True, 0), (None, 0), (3, 3)):
        monkeypatch.setitem(cli.COMMANDS, "models", lambda a, ret=ret: ret)
        assert cli.main(["models"]) == rc


@pytest.mark.parametrize("argv", [["models"], ["flops"], ["experiments", "prune_grid"],
                                  ["experiments", "prune_grid", "--size", "small"],
                                  ["experiments", "prune_grid", "--size", "base"]])
def test_text_commands_print_jaxs_text(capsys, argv):
    assert jcli.main(argv) == 0
    want = _out(capsys)
    assert cli.main(argv) == 0
    assert _out(capsys) == want


def _trace_csv(tmp_path, capsys, timed):
    path = tmp_path / "trace.csv"
    assert cli.main(["profile", "--mode", "trace", "--kernel-mode", "fused", "--iters", "2",
                     "--output", str(path), *CPU]) == 0
    out = _out(capsys)
    assert "trace per-op sum" in out and out.rstrip().endswith(f"-> {path}")
    return path


@pytest.mark.parametrize("which", ["analyse_op", "analyse_attn_ffn", "analyse_gelu_ln",
                                   "fetch_all_op_latency"])
def test_analyse_commands_print_jaxs_text_on_a_traced_csv(tmp_path, capsys, timed, which):
    path = _trace_csv(tmp_path, capsys, timed)
    for model_type in ("deit", "swin"):
        argv = [which, "--file", str(path), "--type", model_type]
        assert jcli.main(argv) == 0
        want = _out(capsys)
        assert cli.main(argv) == 0
        assert _out(capsys) == want and want


def test_profile_micro_writes_jaxs_stage_rows(tmp_path, capsys, timed):
    path = tmp_path / "micro.csv"
    assert cli.main(["profile", "--mode", "micro", "--output", str(path), *CPU]) == 0
    assert "total 2.0000 ms" in _out(capsys)
    rows = list(csv.reader(open(path)))
    assert rows[3] == ["node type", "name", "avg_ms", "%", "start"]
    assert rows[4][:2] == ["PATCH_EMBED", "embed/patch_to_embedding"]
    assert rows[-2][:2] == ["LAYER_NORM", "final/layer_norm"] and len(rows) == 4 + 98 + 1
    with pytest.raises(SystemExit, match="decomposes a ViT"):
        cli.main(["profile", "--mode", "micro", "--model", "swin_tiny", *CPU])


def test_logscrape_prints_jaxs_text(tmp_path, capsys):
    log = tmp_path / "bench.log"
    log.write_text("Avg latency 1.2345 ms, Std 0.0100 ms\nnoise\n"
                   "Avg latency 7.0 ms, Std 0.5 ms\nMem footprint(MB): 151.40\n"
                   "top1 0.7123\n")
    (tmp_path / "m" / "a").mkdir(parents=True)
    (tmp_path / "m" / "a" / "accuracy7212.txt").touch()
    for argv in (["latency_std", "--file", str(log)], ["mem", "--file", str(log)],
                 ["accuracy", "--file", str(log)], ["markers", "--dir", str(tmp_path / "m")]):
        assert jcli.main(["logscrape", *argv]) == 0
        want = _out(capsys)
        assert cli.main(["logscrape", *argv]) == 0
        assert _out(capsys) == want


# ---------------------------------------------------------------------------
# The timing commands: arguments and dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["xla", "pallas", "fused", "int8", "int8_static"])
def test_benchmark_dispatches_each_kernel_mode(capsys, timed, mode):
    """Each mode's forward runs once (the timer stubbed) and gives the
    model's logits; the printed contract is JAX's."""
    assert cli.main(["benchmark", "--kernel-mode", mode, "--iters", "2", "--repeats", "1",
                     *CPU]) == 0
    lines = _out(capsys).splitlines()
    assert lines[-2] == "Avg latency 2.0000 ms, Std 0.0000 ms"
    r = json.loads(lines[-1])
    assert r["model"] == "deit_tiny" and r["batch"] == 1 and r["throughput_per_s"] == 500.0
    assert tuple(timed[-1].shape) == (1, 1000) and timed[-1].dtype == torch.bfloat16


def test_kernel_mode_pallas_reaches_the_module_path(monkeypatch, capsys, timed):
    """The JAX CLI drops --kernel-mode pallas; the port builds the model with
    kernel_mode="pallas", whose forward runs the sdpa and mlp wrappers."""
    from edgevisiontransformer_tpu_torch.ops.cuda import fused_attention, fused_mlp

    seen = []
    for mod, name in ((fused_attention, "attention"), (fused_mlp, "mlp")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, real=real, name=name, **k: (
            seen.append(name), real(*a, **k))[1])
    assert cli.main(["benchmark", "--kernel-mode", "pallas", "--iters", "2", *CPU]) == 0
    assert seen.count("attention") == 12 and seen.count("mlp") == 12
    seen.clear()
    assert cli.main(["benchmark", "--kernel-mode", "xla", "--iters", "2", *CPU]) == 0
    assert not seen


def test_benchmark_swin_int8_stages_and_refusals(capsys, timed):
    assert cli.main(["benchmark", "--model", "swin_tiny", "--kernel-mode", "int8",
                     "--iters", "2", *CPU]) == 0
    assert "int8 stages: [1, 2, 3] of [0, 1, 2, 3]" in _out(capsys)
    with pytest.raises(SystemExit, match="--stem-int8 needs"):
        cli.main(["benchmark", "--model", "deit_tiny", "--kernel-mode", "int8_static",
                  "--stem-int8", *CPU])
    with pytest.raises(SystemExit, match="--device-time needs"):
        cli.main(["benchmark", "--iters", "2", "--device-time", *CPU])


def test_swin_int8_refusal_fires(monkeypatch, capsys):
    """No stage qualifies for the int8 whole-stage kernel: the JAX CLI
    refuses (cli.py:188-192), and so does the port, whose fused_swin_apply
    would otherwise run the float path on an empty int8_prepared."""
    from edgevisiontransformer_tpu_torch.models import swin

    monkeypatch.setattr(swin, "_int8_stage_fits", lambda g, dt: False)
    for argv in (["benchmark", "--model", "swin_tiny", "--kernel-mode", "int8"],
                 ["convert", "--model", "swin_tiny", "--quantization", "dynamic", "--output",
                  "unused"]):
        with pytest.raises(SystemExit, match="no stage qualifies"):
            cli.main([*argv, *CPU])


def test_benchmark_train_runs_both_steps(capsys, timed):
    assert cli.main(["benchmark_train", "--batch", "2", "--iters", "2", "--repeats", "1",
                     *CPU]) == 0
    out = _out(capsys).splitlines()
    assert out[0].startswith("finetune: step 2.0000 ms") and "scores=" in out[1]
    assert out[2] == "sparse marginal (masking+topK+regu+2nd opt): 0.0000 ms/step"
    r = json.loads(out[-1])
    assert set(r) == {"finetune", "sparse", "model", "batch"} and r["sparse"]["mask_scores"] > 0
    assert all(torch.isfinite(m["loss"]) for _, _, m in timed[:1])
    with pytest.raises(SystemExit, match="--qat requires --mode sparse"):
        cli.main(["benchmark_train", "--qat", *CPU])
    with pytest.raises(SystemExit, match="needs a ViT-family model"):
        cli.main(["benchmark_train", "--model", "swin_tiny", "--mode", "sparse", *CPU])


def test_experiments_run_on_the_cpu(capsys, timed):
    for which, keys in (("fusion_ab", {"fused_ms", "unfused_ms", "fusion_speedup"}),
                        ("micro", {"attention", "ffn", "dense_plus_input"})):
        assert cli.main(["experiments", which, "--dim", "32", "--heads", "2", *CPU]) == 0
        assert set(json.loads(_out(capsys))) == keys
    assert cli.main(["experiments", "quant_sweep", "--sizes", "32", "64", *CPU]) == 0
    assert [r["size"] for r in json.loads(_out(capsys))] == [32, 64]


def test_latency_model_collect_fit_predict(tmp_path, capsys, monkeypatch):
    """collect (the measure stubbed), fit and predict print JAX's lines;
    fit on the same CSV gives JAX's metrics; predict --batch on a fit made
    without the batch feature is refused (JAX ignores it, ADVICE r5 #2)."""
    from edgevisiontransformer_tpu_torch.utils import latency_model

    def measure_pruned_deit(size, batch, impl, detailed, device):
        assert (size, impl, detailed, device) == ("tiny", "fused", True, "cpu")
        return lambda enc: {"p50_ms": 1.0 + 0.1 * enc.count("h_3"), "std_ms": 0.01,
                            "iters": 100}

    monkeypatch.setattr(latency_model, "measure_pruned_deit", measure_pruned_deit)
    data = tmp_path / "lat.csv"
    assert cli.main(["latency_model", "collect", "--n", "12", "--output", str(data), *CPU]) == 0
    out = _out(capsys).splitlines()
    assert out[-1] == f"saved 12 rows -> {data}" and out[0].startswith("[1/12] h_")
    rows = list(csv.DictReader(open(data)))
    assert list(rows[0]) == ["encoding", "ms", "std_ms", "iters", "batch"]
    for fit in ((jcli, tmp_path / "j.pkl"), (cli, tmp_path / "t.pkl")):
        assert fit[0].main(["latency_model", "fit", "--data", str(data), "--output",
                            str(fit[1])]) == 0
    outs = _out(capsys).split("saved predictor -> ")
    assert json.loads(outs[0]) == json.loads(outs[1].split("\n", 1)[1])
    enc = rows[0]["encoding"]
    assert cli.main(["latency_model", "predict", "--predictor", str(tmp_path / "t.pkl"),
                     "--encoding", enc]) == 0
    assert _out(capsys).strip().endswith(" ms")
    with pytest.raises(SystemExit, match="without the batch"):
        cli.main(["latency_model", "predict", "--predictor", str(tmp_path / "t.pkl"),
                  "--encoding", enc, "--batch", "32"])


# ---------------------------------------------------------------------------
# Conversion, weights and training on the CPU
# ---------------------------------------------------------------------------


def _write_bmps(root, per_class=3):
    from edgevisiontransformer_tpu_torch.utils.imagenet import write_bmp

    rng = np.random.RandomState(0)
    for k in range(2):
        (root / f"class_{k}").mkdir(parents=True)
        for j in range(per_class):
            img = rng.randint(0, 255, (40 + 8 * j, 48, 3)).astype(np.uint8)
            write_bmp(root / f"class_{k}" / f"img_{j}.bmp", img)
    return root


@pytest.fixture(scope="module")
def jax_artifacts(tmp_path_factory):
    """JAX's export of deit_tiny (an orbax checkpoint) and the same tree
    carried across into the port's checkpoint format, then JAX's static
    int8 convert of it."""
    from edgevisiontransformer_tpu.utils.checkpoint import load_checkpoint as jload
    from edgevisiontransformer_tpu_torch.utils.checkpoint import save_checkpoint
    from edgevisiontransformer_tpu_torch.utils.jax_bridge import tree_to_torch

    root = tmp_path_factory.mktemp("artifacts")
    jdir, tdir, jint8 = root / "jax_ckpt", root / "torch_ckpt", root / "jax_int8"
    assert jcli.main(["export", "--model", "deit_tiny", "--output", str(jdir)]) == 0
    tree = jload(str(jdir))
    save_checkpoint(str(tdir), tree_to_torch(tree), meta={"model": "deit_tiny"})
    assert jcli.main(["convert", "--model", "deit_tiny", "--quantization", "int8",
                      "--calib-batches", "2", "--checkpoint", str(jdir), "--output",
                      str(jint8)]) == 0
    return jdir, tdir, jint8


def test_convert_int8_on_jaxs_checkpoint_gives_jaxs_weights(tmp_path, capsys, jax_artifacts):
    from edgevisiontransformer_tpu.utils.checkpoint import load_checkpoint as jload
    from edgevisiontransformer_tpu.utils.checkpoint import load_meta as jmeta
    from edgevisiontransformer_tpu_torch.utils.checkpoint import load_checkpoint, load_meta
    from edgevisiontransformer_tpu_torch.utils.jax_bridge import flatten_tree

    _, tdir, jint8 = jax_artifacts
    out = tmp_path / "int8"
    assert cli.main(["convert", "--model", "deit_tiny", "--quantization", "int8",
                     "--calib-batches", "2", "--checkpoint", str(tdir), "--output", str(out),
                     *CPU]) == 0
    assert "calibrated 12 layers x 4 activation scales on 2 batches (absmax)" in _out(capsys)
    want = {k: np.asarray(v) for k, v in flatten_tree(jload(str(jint8))).items()}
    got = {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
           for k, v in flatten_tree(load_checkpoint(str(out))).items()}
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith(".q"):
            np.testing.assert_array_equal(got[k], w, err_msg=k)  # int8 weights: bit for bit
        elif k.endswith((".scale", ".act_scale")):
            np.testing.assert_allclose(got[k], w, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)  # the float leaves carried over
    np.testing.assert_allclose(load_meta(str(out))["act_scales"], jmeta(str(jint8))["act_scales"],
                               rtol=1e-6)


def test_eval_xla_on_jaxs_checkpoint_gives_jaxs_top1_and_logits(tmp_path, capsys, monkeypatch,
                                                                 jax_artifacts):
    import edgevisiontransformer_tpu.utils.imagenet as jim
    import edgevisiontransformer_tpu_torch.utils.imagenet as tim

    jdir, tdir, _ = jax_artifacts
    folder = _write_bmps(tmp_path / "val")
    seen = {}
    jeval, teval = jim.evaluate, tim.evaluate

    def jcapture(apply_fn, params, *a, **k):
        seen["jax"] = (apply_fn, params)
        return jeval(apply_fn, params, *a, **k)

    def tcapture(forward, *a, **k):
        seen["torch"] = forward
        return teval(forward, *a, **k)

    monkeypatch.setattr(jim, "evaluate", jcapture)
    monkeypatch.setattr(tim, "evaluate", tcapture)
    argv = ["eval", "--model", "deit_tiny", "--impl", "xla", "--data-dir", str(folder),
            "--batch", "4"]
    assert jcli.main([*argv, "--checkpoint", str(jdir)]) == 0
    want = _out(capsys)
    assert cli.main([*argv, "--checkpoint", str(tdir), *CPU]) == 0
    assert _out(capsys) == want and want.startswith("top1 ")
    samples, _ = tim.list_image_folder(str(folder))
    x = next(tim.iterate_batches(samples, len(samples)))[0]
    apply_fn, params = seen["jax"]
    ref = np.asarray(apply_fn(params, x))
    with torch.no_grad():
        got = seen["torch"](torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_eval_kernel_impls_and_the_quantized_artifact(tmp_path, capsys, monkeypatch):
    """The fused and int8 impls (their twins on the CPU) and a convert
    artifact read back through eval and benchmark; a float cast artifact
    is refused by the int8 consumer, as in JAX."""
    import edgevisiontransformer_tpu_torch.utils.imagenet as tim

    folder = _write_bmps(tmp_path / "val", per_class=1)
    logits = {}
    teval = tim.evaluate

    def capture(forward, *a, **k):
        logits[len(logits)] = forward
        return teval(forward, *a, **k)

    monkeypatch.setattr(tim, "evaluate", capture)
    for impl in ("fused", "int8", "int8_fused"):
        assert cli.main(["eval", "--impl", impl, "--data-dir", str(folder), "--batch", "2",
                         *CPU]) == 0
        assert _out(capsys).startswith("top1 ")
    art = tmp_path / "dyn"
    assert cli.main(["convert", "--quantization", "dynamic", "--output", str(art), *CPU]) == 0
    assert cli.main(["eval", "--quantized-checkpoint", str(art), "--data-dir", str(folder),
                     "--batch", "2", "--marker-dir", str(tmp_path / "m"), *CPU]) == 0
    assert _out(capsys).splitlines()[-1].startswith("top1 ")
    assert list((tmp_path / "m").glob("accuracy*.txt"))
    # the artifact's int8 forward is the prepare-time int8 forward of the same weights
    from edgevisiontransformer_tpu_torch.models.vit import fused_vit_apply_int8, prepare_vit_int8

    model, _ = cli._build_model("deit_tiny", dtype="bfloat16", device="cpu")
    x = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = logits[3](x)
        want = fused_vit_apply_int8(model, x, stacked_q=prepare_vit_int8(model))
    torch.testing.assert_close(got, want, rtol=0.05, atol=0.05 * float(want.abs().max()))
    calls = []
    monkeypatch.setattr(tlt, "measure_op_time", _stub_timer(calls))
    assert cli.main(["benchmark", "--quantized-checkpoint", str(art), *CPU]) == 0
    assert json.loads(_out(capsys).splitlines()[-1])["model"] == str(art)
    fp = tmp_path / "fp16"
    assert cli.main(["convert", "--quantization", "float16", "--output", str(fp), *CPU]) == 0
    with pytest.raises(SystemExit, match="not a quantized convert artifact"):
        cli.main(["benchmark", "--quantized-checkpoint", str(fp), *CPU])


def test_convert_swin_dynamic_saves_stage_stacks(tmp_path, capsys):
    from edgevisiontransformer_tpu_torch.utils.checkpoint import load_checkpoint, load_meta

    out = tmp_path / "swin8"
    assert cli.main(["convert", "--model", "swin_tiny", "--quantization", "dynamic",
                     "--output", str(out), *CPU]) == 0
    assert load_meta(str(out))["int8_stages"] == [1, 2, 3]
    tree = load_checkpoint(str(out))
    assert set(tree) == {"stage_1", "stage_2", "stage_3", "variables"}
    assert tree["stage_1"]["qkv_w"].dtype == torch.int8 and "act_inv" not in tree["stage_1"]
    assert "params" in tree["variables"]


def test_quant_accuracy_table(capsys):
    assert cli.main(["quant_accuracy", "--batches", "1", "--batch", "1", "--calib-batches",
                     "1", *CPU]) == 0
    out = _out(capsys).splitlines()
    assert out[0].split() == ["mode", "max|dlogit|", "max", "rel", "argmax", "agree"]
    stats = json.loads(out[-1])
    assert list(stats) == ["bf16", "dynamic_int8", "static_int8"]
    assert all(s["n"] == 1 and s["max_rel"] < 0.5 for s in stats.values())


def test_prune_heads_prints_jaxs_pruning(tmp_path, capsys):
    imp = tmp_path / "imp.txt"
    np.savetxt(imp, np.random.RandomState(0).rand(12, 3))
    argv = ["prune_heads", "--importance-file", str(imp), "--prune-percent", "30", "50"]
    assert jcli.main(argv) == 0
    want = _out(capsys)
    out = tmp_path / "pruned"
    assert cli.main([*argv, "--output", str(out), *CPU]) == 0
    got = _out(capsys)
    assert got == want + f"saved -> {out}\n"
    with pytest.raises(SystemExit, match="need an importance source"):
        cli.main(["prune_heads", *CPU])


@pytest.mark.parametrize("func", ["l1_unstructured", "hybrid"])
def test_prune_prints_jaxs_sparsity(capsys, func):
    argv = ["prune", "--func", func, "--amount", "0.5"]
    assert jcli.main(argv) == 0
    want = json.loads(_out(capsys))
    assert cli.main([*argv, *CPU]) == 0
    got = json.loads(_out(capsys))
    assert got == pytest.approx(want)


def test_finetune_and_sparse_train_run(tmp_path, capsys):
    from edgevisiontransformer_tpu_torch.utils.checkpoint import load_checkpoint, load_meta

    out = tmp_path / "ft"
    assert cli.main(["finetune", "--synthetic", "1", "--batch", "2", "--max-steps", "1",
                     "--output", str(out), *CPU]) == 0
    assert _out(capsys).splitlines()[-1] == "finetune done"
    assert "params" in load_checkpoint(str(out))
    sp = tmp_path / "sparse"
    assert cli.main(["sparse_train", "--synthetic", "1", "--batch", "2", "--steps", "2",
                     "--checkpoint", str(out), "--teacher-checkpoint", str(out),
                     "--output", str(sp), *CPU]) == 0
    summary = json.loads([ln for ln in _out(capsys).splitlines() if ln.startswith("{")][-1])
    assert set(summary) == {"steps", "preset", "heads_per_layer", "mlp_dim_per_layer",
                            "sparsity"}
    meta = load_meta(str(sp))
    assert meta["heads_per_layer"] == summary["heads_per_layer"] and "config" in meta
    # a compiled checkpoint's config travels into convert
    assert cli.main(["convert", "--quantization", "dynamic", "--checkpoint", str(sp),
                     "--output", str(tmp_path / "sp8"), *CPU]) == 0
    assert "carries a compiled config" in _out(capsys)
    with pytest.raises(SystemExit, match="--data-dir or --synthetic"):
        cli.main(["finetune", *CPU])


def test_export_checkpoint_round_trips_through_eval_weights(tmp_path, capsys):
    from edgevisiontransformer_tpu_torch.utils.checkpoint import load_meta

    out = tmp_path / "ck"
    assert cli.main(["export", "--model", "t2t_vit_7", "--output", str(out), *CPU]) == 0
    assert _out(capsys) == f"saved -> {out}\n"
    assert load_meta(str(out)) == {"model": "t2t_vit_7", "style": "standard"}
    model, _ = cli._build_model("t2t_vit_7", device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    cli._checkpoint_weights(model, str(out))
    ref, _ = cli._build_model("t2t_vit_7", device="cpu")
    x = torch.randn(1, 3, 224, 224, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        assert torch.equal(model(x), ref(x))


def test_plot_commands(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    assert cli.main(["plot", "macs_accuracy", "--output", str(tmp_path / "a.png")]) == 0
    sweep = tmp_path / "s.jsonl"
    sweep.write_text(json.dumps({"name": "deit_tiny", "batch": 1, "ms": 0.5}) + "\n")
    assert cli.main(["plot", "latency_macs", "--sweep", str(sweep), "--output",
                     str(tmp_path / "b.png")]) == 0
    assert (tmp_path / "a.png").exists() and (tmp_path / "b.png").exists()
    with pytest.raises(SystemExit, match="needs --sweep"):
        cli.main(["plot", "latency_macs"])


def test_commands_need_the_card_by_default():
    """--device defaults to cuda: without a card a command raises, as the
    models do, rather than running its twins."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["benchmark", "--iters", "2"])
