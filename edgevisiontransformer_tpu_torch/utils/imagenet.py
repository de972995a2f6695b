"""ImageNet-1k eval pipeline (port of ``edgevisiontransformer_tpu/utils/imagenet.py``).

The reference protocol (its ``utils.py:593-663``): Resize(shorter side 256,
bicubic) -> CenterCrop(224) -> ToTensor -> Normalize(ImageNet mean/std),
over an ImageFolder-layout directory, reporting top-1 accuracy.  The forward
is any callable mapping an NCHW tensor on the device to logits: the port's
models and their kernel entry points (``fused_vit_apply``, ...).

Decoding is PIL's where PIL is installed.  Without it (the GPU machine has
none) uncompressed 24-bit ``.bmp`` files decode with numpy
(:func:`read_bmp`) and any other format raises an error naming PIL; the
resize-crop-normalize loop is the native library's
(``utils/native_preprocess``) or PIL's.

Also keeps the reference's idempotence convention: an empty marker file
``accuracy{int(acc*10000)}.txt`` written into the model directory
(``evaluate_iterative_pruned_deit.py:44-46``), so a sweep skips a model it
has already evaluated.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def preprocess_image(
    img, resize: int = 256, crop: int = 224, native: Optional[bool] = None
) -> np.ndarray:
    """PIL image or HWC uint8 RGB array -> normalized CHW float32 (the
    reference transform, its ``utils.py:604-609``).

    The hot loop (antialiased bicubic resize -> center crop -> normalize ->
    CHW) runs in the native C++ library (``native/preprocess.cpp``) when it
    builds, with the pure-PIL path as fallback.  ``native=None``
    auto-detects, ``native=True`` raises when the library is unavailable,
    ``native=False`` takes the PIL path."""
    if not isinstance(img, np.ndarray) and img.mode != "RGB":
        img = img.convert("RGB")
    if native is None or native:
        from . import native_preprocess as npre

        if npre.available():
            return npre.preprocess_native(np.asarray(img, np.uint8), resize, crop)
        if native:
            raise RuntimeError("native preprocessing requested but unavailable")
    from PIL import Image

    if isinstance(img, np.ndarray):
        img = Image.fromarray(np.ascontiguousarray(img, np.uint8), "RGB")
    w, h = img.size
    if w < h:
        nw, nh = resize, int(round(h * resize / w))
    else:
        nw, nh = int(round(w * resize / h)), resize
    img = img.resize((nw, nh), Image.BICUBIC)
    left = (nw - crop) // 2
    top = (nh - crop) // 2
    img = img.crop((left, top, left + crop, top + crop))
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return arr.transpose(2, 0, 1)  # CHW


def list_image_folder(root: str) -> Tuple[List[Tuple[str, int]], List[str]]:
    """ImageFolder layout: root/<class>/<img>; classes sorted by name."""
    rootp = Path(root)
    classes = sorted(d.name for d in rootp.iterdir() if d.is_dir())
    samples = []
    for idx, cls in enumerate(classes):
        for f in sorted((rootp / cls).rglob("*")):
            if f.suffix.lower() in _EXTS:
                samples.append((str(f), idx))
    return samples, classes


def read_bmp(path: str) -> np.ndarray:
    """An uncompressed 24-bit BMP (a BITMAPINFOHEADER or later header,
    ``BI_RGB``, rows bottom-up or top-down) as an HWC uint8 RGB array, with
    numpy alone; any other BMP raises ``ValueError``."""
    data = Path(path).read_bytes()
    if len(data) < 54 or data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    offset = int.from_bytes(data[10:14], "little")
    header = int.from_bytes(data[14:18], "little")
    width = int.from_bytes(data[18:22], "little", signed=True)
    height = int.from_bytes(data[22:26], "little", signed=True)
    bits = int.from_bytes(data[28:30], "little")
    compression = int.from_bytes(data[30:34], "little")
    if header < 40 or bits != 24 or compression != 0 or width <= 0 or height == 0:
        raise ValueError(f"{path}: only uncompressed 24-bit BMPs decode without PIL "
                         f"(header {header}, {bits} bits, compression {compression})")
    rows, stride = abs(height), (3 * width + 3) // 4 * 4
    if offset + rows * stride > len(data):
        raise ValueError(f"{path}: truncated pixel data")
    px = np.frombuffer(data, np.uint8, rows * stride, offset).reshape(rows, stride)
    px = px[:, :3 * width].reshape(rows, width, 3)[:, :, ::-1]  # BGR -> RGB
    return np.ascontiguousarray(px[::-1] if height > 0 else px)


def write_bmp(path, rgb: np.ndarray) -> None:
    """An HWC uint8 RGB image as an uncompressed 24-bit BMP (bottom-up rows,
    BGR, each row padded to 4 bytes), with numpy alone: what
    :func:`read_bmp` reads."""
    import struct

    h, w, _ = rgb.shape
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = rgb[::-1, :, ::-1].reshape(h, 3 * w)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0)
    head = b"BM" + struct.pack("<IHHI", 14 + len(info) + rows.size, 0, 0, 14 + len(info))
    Path(path).write_bytes(head + info + rows.tobytes())


def _decode_without_pil(path: str) -> np.ndarray:
    if Path(path).suffix.lower() != ".bmp":
        raise ImportError(f"{path}: decoding {Path(path).suffix} images needs PIL (Pillow), "
                          "which is not installed; without it only uncompressed 24-bit .bmp "
                          "files decode")
    return read_bmp(path)


def _load_one(path: str, resize: int, crop: int,
              native: Optional[bool] = None) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        return preprocess_image(_decode_without_pil(path), resize, crop, native)
    with Image.open(path) as im:
        return preprocess_image(im, resize, crop, native)


def iterate_batches(
    samples: Sequence[Tuple[str, int]],
    batch_size: int,
    resize: int = 256,
    crop: int = 224,
    drop_remainder: bool = False,
    workers: int = 8,
    prefetch_batches: int = 2,
    native: Optional[bool] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Batched loader with worker-thread decode+preprocess and batch
    prefetch — the reference DataLoader(num_workers, prefetch_factor)
    analogue.  Image decode and the native resize loop both release the
    GIL, so threads scale; ``workers=0`` iterates synchronously.
    ``native`` is :func:`preprocess_image`'s."""
    if workers <= 0:
        buf_x, buf_y = [], []
        for path, label in samples:
            buf_x.append(_load_one(path, resize, crop, native))
            buf_y.append(label)
            if len(buf_x) == batch_size:
                yield np.stack(buf_x), np.asarray(buf_y, np.int32)
                buf_x, buf_y = [], []
        if buf_x and not drop_remainder:
            yield np.stack(buf_x), np.asarray(buf_y, np.int32)
        return

    import concurrent.futures as cf
    from collections import deque

    batches = [samples[i:i + batch_size]
               for i in range(0, len(samples), batch_size)]
    if drop_remainder and batches and len(batches[-1]) < batch_size:
        batches.pop()

    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        def submit(batch):
            xs = [pool.submit(_load_one, path, resize, crop, native)
                  for path, _ in batch]
            ys = np.asarray([label for _, label in batch], np.int32)
            return xs, ys

        window: deque = deque()
        it = iter(batches)
        for _ in range(prefetch_batches + 1):
            nxt = next(it, None)
            if nxt is not None:
                window.append(submit(nxt))
        while window:
            xs, ys = window.popleft()
            nxt = next(it, None)
            if nxt is not None:
                window.append(submit(nxt))
            yield np.stack([f.result() for f in xs]), ys


def evaluate(
    forward: Callable[[torch.Tensor], torch.Tensor],
    data_dir: str,
    batch_size: int = 64,
    limit: Optional[int] = None,
    crop: int = 224,
    resize: int = 256,
    progress: bool = False,
    device="cuda",
    native: Optional[bool] = None,
) -> float:
    """Top-1 accuracy over an ImageFolder val set (the reference's
    ``utils.py:631-663``): ``forward`` maps an NCHW float32 batch on
    ``device`` (the card unless the caller names another) to logits, and
    runs under ``torch.no_grad()``.  The tail batch is padded with zeros to
    ``batch_size``, so ``forward`` sees one shape, and the pad rows'
    predictions are dropped.  ``native`` is :func:`iterate_batches`'."""
    from ..models.vit import model_device

    dev = model_device(device)
    samples, _ = list_image_folder(data_dir)
    if limit:
        samples = samples[:limit]

    correct = total = 0
    with torch.no_grad():
        for x, y in iterate_batches(samples, batch_size, resize, crop, native=native):
            n = x.shape[0]
            if n != batch_size:  # pad the tail to keep shapes static
                x = np.concatenate([x, np.zeros((batch_size - n,) + x.shape[1:], x.dtype)])
            logits = forward(torch.from_numpy(x).to(dev))
            pred = logits.argmax(-1)[:n].cpu().numpy()
            correct += int((pred == y).sum())
            total += n
            if progress and total % (batch_size * 50) == 0:
                print(f"eval {total}/{len(samples)}: top1={correct / total:.4f}")
    return correct / max(total, 1)


def evaluate_sharded(
    forward: Callable[[torch.Tensor], torch.Tensor],
    data_dir: str,
    mesh,
    batch_size: int = 64,
    limit: Optional[int] = None,
    crop: int = 224,
    resize: int = 256,
    device="cuda",
    native: Optional[bool] = None,
) -> float:
    """:func:`evaluate` over a ``parallel/mesh.Mesh``, run by every rank of
    it: every rank lists the same folder and cuts it into the same batches
    of ``batch_size``; each rank decodes and runs ``forward`` on its dp share
    of every batch (``batch_size / dp`` rows, the tail padded with zeros as
    :func:`evaluate` pads it), and the correct counts are summed over dp:
    the protocol that replaces the reference's DistributedSampler +
    ``dist.reduce`` (its ``classifier_eval.py:37-106``).  Returns the
    accuracy :func:`evaluate` returns on the same folder, on every rank."""
    from ..models.vit import model_device

    dev = model_device(device)
    dp, r = mesh.shape["dp"], mesh.index("dp")
    if batch_size % dp:
        raise ValueError(f"batch_size {batch_size} does not split over dp={dp}")
    share = batch_size // dp
    samples, _ = list_image_folder(data_dir)
    if limit:
        samples = samples[:limit]
    mine = [s for i in range(0, len(samples), batch_size)
            for s in samples[i:i + batch_size][r * share:(r + 1) * share]]
    correct = 0
    with torch.no_grad():
        for x, y in iterate_batches(mine, share, resize, crop, native=native):
            n = x.shape[0]
            if n != share:
                x = np.concatenate([x, np.zeros((share - n,) + x.shape[1:], x.dtype)])
            pred = forward(torch.from_numpy(x).to(dev)).argmax(-1)[:n].cpu().numpy()
            correct += int((pred == y).sum())
    counts = torch.tensor([correct], dtype=torch.int64)
    torch.distributed.all_reduce(counts, group=mesh.group("dp"))
    return int(counts[0]) / max(len(samples), 1)


def write_accuracy_marker(model_dir: str, acc: float) -> str:
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, f"accuracy{int(acc * 10000)}.txt")
    Path(path).touch()
    return path


def has_accuracy_marker(model_dir: str) -> Optional[float]:
    """The accuracy a marker in ``model_dir`` records, or None."""
    if not os.path.isdir(model_dir):
        return None
    for f in os.listdir(model_dir):
        if f.startswith("accuracy") and f.endswith(".txt"):
            try:
                return int(f[len("accuracy"):-len(".txt")]) / 10000.0
            except ValueError:
                continue
    return None
