"""The port's image-folder evaluation against the JAX package's: the native
preprocessing (built under ``build/``, never touching
``native/libevtpre.so``), ``preprocess_image``, the BMP decode without PIL,
``list_image_folder``, ``iterate_batches`` and ``evaluate`` (CPU)."""

import builtins
import hashlib
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from edgevisiontransformer_tpu.utils import imagenet as jimg  # noqa: E402
from edgevisiontransformer_tpu.utils import native_preprocess as jnpre  # noqa: E402
from edgevisiontransformer_tpu_torch.utils import imagenet as timg  # noqa: E402
from edgevisiontransformer_tpu_torch.utils import native_preprocess as npre  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

# The port's library and the JAX package's compile the same source, perhaps
# with other flags on another host: a resampled value may round to the other
# uint8 (one step is 1 / (255 * 0.225) = 0.0174 after normalizing)
NATIVE_VS_JAX = 0.035
# tests/test_native_preprocess.py's bounds, native against the PIL path
PIL_MEAN, PIL_P99 = 0.02, 0.06


def _rgb(h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)


@pytest.fixture(scope="module")
def lib():
    if not npre.available():
        pytest.skip("g++ unavailable: the native library does not build")
    return npre.library_path()


def test_native_library_builds_under_build_and_leaves_the_jax_library_alone():
    committed = REPO / "native" / "libevtpre.so"
    before = hashlib.sha256(committed.read_bytes()).hexdigest() if committed.exists() else None
    mtime = committed.stat().st_mtime_ns if committed.exists() else None
    path = npre.library_path()
    assert path.parent == REPO / "build" / "native_preprocess"
    assert npre.available()
    assert path.exists()
    lib = npre.load_library()
    assert Path(lib._name) == path
    if before is not None:
        assert hashlib.sha256(committed.read_bytes()).hexdigest() == before
        assert committed.stat().st_mtime_ns == mtime
    assert "build/" in (REPO / ".gitignore").read_text().split()


def test_a_failed_build_is_cached_and_native_true_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(npre, "_lib", None)
    monkeypatch.setattr(npre, "_lib_checked", False)
    monkeypatch.setattr(npre, "BUILD_DIR", tmp_path / "b")
    calls = []

    def no_compiler(*a, **k):
        calls.append(a)
        raise OSError("no g++")

    monkeypatch.setattr(npre.subprocess, "run", no_compiler)
    assert not npre.available() and not npre.available()
    assert len(calls) == 1
    with pytest.raises(RuntimeError, match="unavailable"):
        timg.preprocess_image(_rgb(40, 50, 0), resize=32, crop=24, native=True)
    got = timg.preprocess_image(_rgb(40, 50, 0), resize=32, crop=24)  # auto: the PIL path
    ref = timg.preprocess_image(_rgb(40, 50, 0), resize=32, crop=24, native=False)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("h,w,resize,crop", [(260, 300, 256, 224), (384, 256, 256, 224),
                                             (300, 260, 64, 48), (75, 93, 40, 32)])
def test_preprocess_native_matches_jax_and_pil(lib, h, w, resize, crop):
    img = _rgb(h, w, seed=h + w)
    got = npre.preprocess_native(img, resize, crop)
    assert got.shape == (3, crop, crop) and got.dtype == np.float32
    ref = jimg.preprocess_image(Image.fromarray(img), resize, crop, native=True)
    assert np.abs(got - ref).max() <= NATIVE_VS_JAX
    pil = timg.preprocess_image(Image.fromarray(img), resize, crop, native=False)
    np.testing.assert_array_equal(pil, jimg.preprocess_image(Image.fromarray(img), resize, crop,
                                                             native=False))
    diff = np.abs(got - pil)
    assert diff.mean() < PIL_MEAN and np.percentile(diff, 99) < PIL_P99
    # the array form takes the same path as the PIL image
    np.testing.assert_array_equal(timg.preprocess_image(img, resize, crop, native=True), got)
    np.testing.assert_array_equal(timg.preprocess_image(img, resize, crop, native=False), pil)


def test_resize_native_matches_jax(lib):
    if not jnpre.available():
        pytest.skip("the JAX package's native library does not load")
    img = _rgb(75, 93, seed=1)
    got = npre.resize_bicubic_native(img, 32, 40)
    ref = jnpre.resize_bicubic_native(img, 32, 40)
    assert np.abs(np.round(got) - np.round(ref)).max() <= 1


def test_preprocess_native_refuses_bad_input(lib):
    with pytest.raises(ValueError):
        npre.preprocess_native(_rgb(40, 40, 0)[:, :, :2])
    with pytest.raises(ValueError):
        npre.preprocess_native(_rgb(40, 40, 0), resize=32, crop=48)


@pytest.mark.parametrize("h,w", [(1, 1), (7, 5), (26, 30), (33, 17)])
def test_bmp_decode_equals_pil(tmp_path, h, w):
    img = _rgb(h, w, seed=h * w)
    Image.fromarray(img).save(tmp_path / "pil.bmp")
    chip_smoke.write_bmp(tmp_path / "ours.bmp", img)
    for name in ("pil.bmp", "ours.bmp"):
        with Image.open(tmp_path / name) as im:
            want = np.asarray(im.convert("RGB"))
        got = timg.read_bmp(str(tmp_path / name))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, img)


def test_bmp_decode_top_down_and_refusals(tmp_path):
    img = _rgb(6, 5, seed=2)
    chip_smoke.write_bmp(tmp_path / "a.bmp", img)
    data = bytearray((tmp_path / "a.bmp").read_bytes())
    # flip to a top-down file: negative height, rows in reading order
    stride = (3 * 5 + 3) // 4 * 4
    rows = np.frombuffer(bytes(data[54:]), np.uint8).reshape(6, stride)[::-1]
    data[22:26] = (-6).to_bytes(4, "little", signed=True)
    data[54:] = rows.tobytes()
    (tmp_path / "b.bmp").write_bytes(bytes(data))
    np.testing.assert_array_equal(timg.read_bmp(str(tmp_path / "b.bmp")), img)
    Image.fromarray(img).convert("L").save(tmp_path / "gray.bmp")
    with pytest.raises(ValueError, match="24-bit"):
        timg.read_bmp(str(tmp_path / "gray.bmp"))
    (tmp_path / "x.bmp").write_bytes(b"GIF89a" + bytes(60))
    with pytest.raises(ValueError, match="not a BMP"):
        timg.read_bmp(str(tmp_path / "x.bmp"))


def test_load_one_without_pil(monkeypatch, tmp_path, lib):
    img = _rgb(50, 60, seed=3)
    chip_smoke.write_bmp(tmp_path / "a.bmp", img)
    Image.fromarray(img).save(tmp_path / "a.png")
    with_pil = timg._load_one(str(tmp_path / "a.bmp"), 40, 32, True)
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    np.testing.assert_array_equal(timg._load_one(str(tmp_path / "a.bmp"), 40, 32, True), with_pil)
    with pytest.raises(ImportError, match="PIL"):
        timg._load_one(str(tmp_path / "a.png"), 40, 32, True)
    with pytest.raises(ImportError, match="PIL"):
        timg._load_one(str(tmp_path / "a.bmp"), 40, 32, False)


def _folder(root: Path, counts=(3, 2, 4), exts=(".bmp", ".png", ".jpg")):
    for k, count in enumerate(counts):
        (root / f"c{k}").mkdir(parents=True)
        for j in range(count):
            img = _rgb(40 + 7 * j, 50 + 5 * k, seed=10 * k + j)
            ext = exts[(k + j) % len(exts)]
            if ext == ".bmp":
                chip_smoke.write_bmp(root / f"c{k}" / f"i{j}{ext}", img)
            else:
                Image.fromarray(img).save(root / f"c{k}" / f"i{j}{ext}")
    (root / "c0" / "notes.txt").write_text("not an image")
    (root / "stray.bmp").write_bytes(b"")


def test_list_image_folder_equals_jax(tmp_path):
    _folder(tmp_path)
    got = timg.list_image_folder(str(tmp_path))
    assert got == jimg.list_image_folder(str(tmp_path))
    samples, classes = got
    assert classes == ["c0", "c1", "c2"] and len(samples) == 9
    assert [lab for _, lab in samples] == [0] * 3 + [1] * 2 + [2] * 4


@pytest.mark.parametrize("drop", [False, True])
def test_iterate_batches_workers_agree_and_the_tail(tmp_path, drop):
    _folder(tmp_path)
    samples, _ = timg.list_image_folder(str(tmp_path))
    kw = dict(resize=40, crop=32, drop_remainder=drop, native=False)
    sync = list(timg.iterate_batches(samples, 4, workers=0, **kw))
    pooled = list(timg.iterate_batches(samples, 4, workers=4, **kw))
    ref = list(jimg.iterate_batches(samples, 4, 40, 32, drop_remainder=drop, workers=0))
    assert [x.shape[0] for x, _ in sync] == ([4, 4] if drop else [4, 4, 1])
    for (xa, ya), (xb, yb), (xr, yr) in zip(sync, pooled, ref):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
        np.testing.assert_array_equal(ya, yr)
        assert ya.dtype == np.int32 and xa.dtype == np.float32
    assert len(sync) == len(pooled) == len(ref)


@pytest.mark.parametrize("native", [False, True])
def test_evaluate_equals_jax_with_a_constant_model(tmp_path, lib, native):
    _folder(tmp_path, counts=(3, 5, 2))
    onehot = np.zeros(3, np.float32)
    onehot[1] = 1.0

    def t_forward(x):
        assert x.shape == (4, 3, 32, 32) and x.dtype == torch.float32
        return torch.from_numpy(onehot).expand(x.shape[0], 3)

    kw = dict(batch_size=4, crop=32, resize=40)
    got = timg.evaluate(t_forward, str(tmp_path), device="cpu", native=native, **kw)
    ref = jimg.evaluate(lambda p, x: jnp.broadcast_to(jnp.asarray(onehot), (x.shape[0], 3)),
                        None, str(tmp_path), **kw)
    assert got == ref == 5 / 10
    assert timg.evaluate(t_forward, str(tmp_path), device="cpu", native=native, limit=3,
                         **kw) == 0.0


def test_evaluate_counts_labels_and_drops_the_pad(tmp_path):
    _folder(tmp_path, counts=(3, 5, 2))

    def by_mean(x):  # a prediction that depends on each image
        m = x.mean(dim=(1, 2, 3))
        return torch.stack([m, -m, torch.zeros_like(m)], dim=1)

    seen = []
    kw = dict(batch_size=4, crop=32, resize=40, native=False)
    acc = timg.evaluate(lambda x: seen.append(x.shape[0]) or by_mean(x), str(tmp_path),
                        device="cpu", **kw)
    assert seen == [4, 4, 4]  # the tail of 2 padded to 4
    samples, _ = timg.list_image_folder(str(tmp_path))
    preds = []
    for x, _ in timg.iterate_batches(samples, 4, 40, 32, native=False):
        preds += by_mean(torch.from_numpy(x)).argmax(-1).tolist()
    labels = [lab for _, lab in samples]
    assert acc == sum(p == y for p, y in zip(preds, labels)) / len(labels)


def test_evaluate_defaults_to_the_card(tmp_path, monkeypatch):
    _folder(tmp_path, counts=(1,))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        timg.evaluate(lambda x: x, str(tmp_path))
