"""The port's numpy-only tools against the JAX package's: the FLOPs model,
the latency predictor, the log scrapers, the profile-CSV analyser and the
plots (CPU)."""

import dataclasses
import inspect
import os

import numpy as np
import pytest

from edgevisiontransformer_tpu.bench import analyse as j_analyse
from edgevisiontransformer_tpu.utils import flops as j_flops
from edgevisiontransformer_tpu.utils import latency_model as j_lat
from edgevisiontransformer_tpu.utils import logscrape as j_scrape
from edgevisiontransformer_tpu_torch.bench import analyse as t_analyse
from edgevisiontransformer_tpu_torch.models import vit as tvit
from edgevisiontransformer_tpu_torch.utils import flops as t_flops
from edgevisiontransformer_tpu_torch.utils import latency_model as t_lat
from edgevisiontransformer_tpu_torch.utils import logscrape as t_scrape
from edgevisiontransformer_tpu_torch.utils import plots as t_plots

# tests/test_flops.py's cases and more, as (function name, args, kwargs)
FLOPS_CASES = [
    ("vit_flops", (), dict(h=192, l=12)), ("vit_flops", (), dict(h=384, l=12)),
    ("vit_flops", (), dict(h=768, l=12)), ("vit_flops", (), dict(h=768, l=12, image_size=384)),
    ("vit_flops", (), dict(h=192, l=12, heads=3, head_size=64)),
    ("pruned_deit_flops", ("tiny", 2, 0.3), {}), ("pruned_deit_flops", ("tiny", 3, 0.0), {}),
    ("pruned_deit_flops", ("base", 7, 0.55), {}),
    ("swin_flops", ((2, 2, 6, 2), 96, 4.0, 3), {}),
    ("swin_flops", ((2, 2, 18, 2), 128, 4.0, 4), dict(image_size=384, window_size=12)),
    ("t2t_vit_flops", (), {}), ("t2t_vit_flops", (256, 7, 4, 512), {}),
    ("transformer_block_flops", (192, 197, 768, 3), {}),
    ("transformer_block_flops", (768, 197, 3072, 12, 32), {}),
    ("pruned_deit_grids", (), {}),
]


@pytest.mark.parametrize("fn,args,kw", FLOPS_CASES)
def test_flops_function_equals_jax(fn, args, kw):
    assert getattr(t_flops, fn)(*args, **kw) == getattr(j_flops, fn)(*args, **kw)


def test_flops_goldens_and_tables_equal_jax():
    assert t_flops.vit_flops(h=192, l=12) == 2548260836
    assert t_flops.pruned_deit_flops("tiny", 2, 0.3) == 1767230696
    assert t_flops.swin_flops((2, 2, 6, 2), 96, 4.0, 3) == 4555068960
    assert t_flops.MODEL_FLOPS == j_flops.MODEL_FLOPS
    for name in j_flops.MODEL_FLOPS:
        assert t_flops.model_macs(name) == j_flops.model_macs(name)
    consts = ("DROPOUT_FLOPS", "LAYER_NORM_FLOPS", "ACTIVATION_FLOPS", "SOFTMAX_FLOPS")
    assert all(getattr(t_flops, c) == getattr(j_flops, c) for c in consts)
    public = {n for n, v in vars(j_flops).items() if inspect.isfunction(v)}
    assert public <= set(vars(t_flops))


@pytest.mark.parametrize("row", [
    "deit_tiny", "deit_tiny_fused", "deit_base_int8_static", "swin_tiny_xla",
    "t2t_vit_14_pallas", "deit_tiny_fused_npad8", "pruned_deit_tiny@all_head2_ffn0.5",
    "pruned_deit_small_int8@layerwise_h2-d1.0_h3-d0.5", "mobilenet_v2", "vit_base_384_fullfused"])
def test_bench_row_flops_equals_jax(row):
    assert t_flops.bench_row_flops(row) == j_flops.bench_row_flops(row)


def _dataset(n=40, depth=12, max_heads=3, seed=0):
    encs = j_lat.sample_random_configs(n, depth, max_heads, seed=seed)
    assert encs == t_lat.sample_random_configs(n, depth, max_heads, seed=seed)
    # a latency that is a known function of the features, plus seeded noise
    rng = np.random.RandomState(seed)
    lat = [0.3 + 0.05 * sum(j_lat.parse_features(e)[0::2]) + 0.2 * sum(
        j_lat.parse_features(e)[1::2]) + 0.01 * rng.rand() for e in encs]
    return encs, lat


def test_latency_features_equal_jax():
    encs, _ = _dataset()
    for enc in encs[:10]:
        assert t_lat.parse_features(enc) == j_lat.parse_features(enc)
        for size in ("tiny", "small", "base"):
            for batch in (None, 1, 32):
                assert (t_lat.physical_features(enc, size, batch)
                        == j_lat.physical_features(enc, size, batch))
    assert t_lat.format_features([2, 3], [0.5, 1.0]) == j_lat.format_features([2, 3], [0.5, 1.0])
    y, p = [1.0, 2.0, 4.0], [1.04, 2.3, 3.9]
    assert t_lat.lat_metrics(p, y) == j_lat.lat_metrics(p, y)
    assert t_lat.accuracy_within(p, y, 0.05) == j_lat.accuracy_within(p, y, 0.05)


@pytest.mark.parametrize("features,size,batch_feature", [
    ("raw", None, False), ("physical", "tiny", False), ("physical", "tiny", True)])
def test_latency_predictor_fit_and_predictions_equal_jax(features, size, batch_feature):
    encs, lat = _dataset()
    batches = [1 + (i % 3) * 15 for i in range(len(encs))] if batch_feature else None
    kw = dict(features=features, size=size, batch_feature=batch_feature, n_estimators=40)
    tp, jp = t_lat.LatencyPredictor(**kw), j_lat.LatencyPredictor(**kw)
    assert tp.model.get_params() == jp.model.get_params()
    assert tp.model.random_state == 10
    assert tp.fit(encs, lat, batches=batches) == jp.fit(encs, lat, batches=batches)
    probe = t_lat.sample_random_configs(5, 12, 3, seed=9)
    for enc in probe:
        for b in (1, 32):
            assert tp.predict(enc, b) == jp.predict(enc, b)
    assert tp.cv_metrics(encs, lat, k=3, batches=batches) == jp.cv_metrics(
        encs, lat, k=3, batches=batches)


def test_latency_predictor_save_load_and_jax_pickles(tmp_path):
    encs, lat = _dataset()
    tp = t_lat.LatencyPredictor(features="physical", size="small", n_estimators=20)
    tp.fit(encs, lat)
    path = str(tmp_path / "p.pkl")
    tp.save(path)
    back = t_lat.LatencyPredictor.load(path)
    assert (back.features, back.size, back.batch_feature) == ("physical", "small", False)
    assert back.predict(encs[0]) == tp.predict(encs[0])
    # a JAX-package pickle loads into the port, features and predictions alike
    jp = j_lat.LatencyPredictor(n_estimators=20)
    jp.fit(encs, lat)
    jp.save(str(tmp_path / "j.pkl"))
    assert t_lat.LatencyPredictor.load(str(tmp_path / "j.pkl")).predict(encs[1]) == jp.predict(
        encs[1])


def test_latency_predictor_refuses_what_jax_refuses():
    with pytest.raises(ValueError):
        t_lat.LatencyPredictor(features="physical", size="huge")
    with pytest.raises(ValueError):
        t_lat.LatencyPredictor(batch_feature=True)
    with pytest.raises(ValueError):
        t_lat.LatencyPredictor(features="other")


def test_size_shapes_in_sync_with_the_ports_vit():
    for size, (dim, mlp) in t_lat._SIZE_SHAPES.items():
        assert tvit._DEIT_SHAPES[size]["dim"] == dim and tvit._DEIT_SHAPES[size]["mlp_dim"] == mlp


def test_collect_latency_dataset():
    logged = []
    xs, ys = t_lat.collect_latency_dataset(["h_1_d_1", "h_2_d_0.5"], lambda e: float(len(e)),
                                           log=logged.append)
    assert xs == ["h_1_d_1", "h_2_d_0.5"] and ys == [7.0, 9.0] and len(logged) == 2


def test_log_scrapers_equal_jax(tmp_path):
    log = tmp_path / "bench.log"
    log.write_text("noise\nAvg latency 12.500 ms, Std 0.300 ms\nMem footprint(MB): 26.66\n"
                   "top1 0.7221\naccuracy: 81.5\nAvg latency 7.1 ms, Std 0.1 ms\nacc=250\n")
    for fn in ("fetch_latency_std", "fetch_mem_footprints", "fetch_accuracies_from_log"):
        assert getattr(t_scrape, fn)(str(log)) == getattr(j_scrape, fn)(str(log))
    assert t_scrape.fetch_latency_std(str(log)) == [(12.5, 0.3), (7.1, 0.1)]
    for sub, acc in (("deit_t_prune14", 7221), ("a/b", 8150)):
        (tmp_path / "m" / sub).mkdir(parents=True)
        (tmp_path / "m" / sub / f"accuracy{acc}.txt").touch()
    res = t_scrape.fetch_results_from_markers(str(tmp_path / "m"))
    assert res == j_scrape.fetch_results_from_markers(str(tmp_path / "m"))
    assert res == {"deit_t_prune14": 0.7221, os.path.join("a", "b"): 0.815}


_PORT_CSV = ("Operator-wise Profiling Info for Regular Benchmark Run\n\n"
             "node type,name,avg_ms,%,start\n"
             "EMBED,embed,0.1,5%,0.0\n"
             "LAYER_NORM,block_0/attn/ln,0.05,2.5%,0.1\n"
             "FULLY_CONNECTED,block_0/attn/qkv,0.4,20%,0.15\n"
             "SDPA,block_0/attn/sdpa,0.3,15%,0.55\n"
             "LAYER_NORM,block_0/ffn/ln,0.05,2.5%,0.85\n"
             "FULLY_CONNECTED,block_0/ffn/fc1,0.5,25%,0.9\n"
             "GELU,block_0/ffn/gelu,0.1,5%,1.4\n"
             "FULLY_CONNECTED,block_0/ffn/fc2,0.5,25%,1.5\n\n")
_REF_CSV = ("junk line\nOperator-wise Profiling Info for Regular Benchmark Run\n\n"
            "node type,name,avg_ms,%,start\n"
            "TfLiteFlexDelegate,model/roll_1:0,1.5,10%,0.0\n"
            "CONV_2D,model/conv,3.0,20%,1.5\n"
            "LAYER_NORM,model/layer_norm,0.5,3%,4.5\n"
            "POW,model/gelu/pow,0.1,1%,5.0\n" + "".join(
                f"MUL,model/gelu/m{i},0.1,1%,{5.1 + 0.1 * i}\n" for i in range(7)) +
            "FULLY_CONNECTED,model/fc,2.0,12%,6.0\n"
            "layer_norm,model/LayerNorm_1,0.4,2%,8.0\n"
            "FULLY_CONNECTED,model/fc2,1.0,6%,8.4\n"
            "TfLiteFlexDelegate,model/einsum/Einsum:0,0.7,4%,9.4\n\n")


@pytest.mark.parametrize("csv_text,model_type", [(_PORT_CSV, "deit"), (_REF_CSV, "swin"),
                                                 (_REF_CSV, "t2t_vit"), (_REF_CSV, "deit")])
def test_analyse_equals_jax(tmp_path, csv_text, model_type):
    path = str(tmp_path / "profile.csv")
    with open(path, "w") as f:
        f.write(csv_text)
    for fn in ("analyse_op", "analyse_attn_ffn", "analyse_gelu_ln"):
        assert (getattr(t_analyse, fn)(path, model_type=model_type)
                == getattr(j_analyse, fn)(path, model_type=model_type))
    assert t_analyse.fetch_all_op_latency(path) == j_analyse.fetch_all_op_latency(path)
    rows = t_analyse.read_rows(path)
    assert t_analyse.find_op_wise_range(rows) == j_analyse.find_op_wise_range(rows)


def test_analyse_reads_the_port_csv_schema(tmp_path):
    path = str(tmp_path / "profile.csv")
    with open(path, "w") as f:
        f.write(_PORT_CSV)
    split = t_analyse.analyse_attn_ffn(path)
    assert split == pytest.approx({"attention_ms": 0.75, "ffn_ms": 1.15, "other_ms": 0.1})
    g = t_analyse.analyse_gelu_ln(path)
    assert g == pytest.approx({"gelu_ms": 0.1, "layernorm_ms": 0.1, "total_ms": 2.0})
    assert t_analyse.analyse_op(path)["FULLY_CONNECTED"]["latency"] == pytest.approx(1.4)


def test_plots(tmp_path):
    from edgevisiontransformer_tpu.utils import plots as j_plots

    assert ({k: dataclasses.asdict(v) for k, v in t_plots.MODEL_INFO.items()}
            == {k: dataclasses.asdict(v) for k, v in j_plots.MODEL_INFO.items()})
    assert t_plots.FAMILIES == j_plots.FAMILIES
    p1 = t_plots.draw_macs_accuracy_curve(str(tmp_path / "a.png"),
                                          extra_points={"ours": (1.28, 72.0)})
    p2 = t_plots.draw_latency_vs_macs({"deit_tiny": (1.28, 0.08)}, str(tmp_path / "b.png"))
    assert os.path.getsize(p1) > 1000 and os.path.getsize(p2) > 1000
    with open(p1, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
