"""ctypes bindings for the native preprocessing library (port of
``edgevisiontransformer_tpu/utils/native_preprocess.py``).

The source is the repository's ``native/preprocess.cpp``.  The port builds
it with g++ at first use into ``build/native_preprocess/`` at the
repository root, named by a hash of the source, its flags and the host,
and loads that file: it
never loads or rewrites ``native/libevtpre.so``, which belongs to the JAX
package and may have been built with ``-march=native`` on another host.
A failed build is cached (no g++ re-probe per image); ``utils/imagenet``
then takes the PIL path unless native preprocessing was asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "preprocess.cpp"
BUILD_DIR = _REPO / "build" / "native_preprocess"
_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-fPIC", "-shared", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_lib_checked = False  # failure is cached too: no per-image g++ re-probe
_lib_lock = threading.Lock()


def library_path() -> Path:
    """The built library for the current source, flags and host: the build
    is ``-march=native``, so a copied ``build/`` never hands this host a
    library compiled for another one."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((*_FLAGS, platform.machine(), platform.node())).encode())
    return BUILD_DIR / f"libevtpre_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    # write to a temp path and rename: concurrent loaders (threaded
    # iterate_batches workers, other processes) never CDLL a half-written .so
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = f"{path}.build.{os.getpid()}.{threading.get_ident()}"
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.CalledProcessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def load_library() -> Optional[ctypes.CDLL]:
    global _lib, _lib_checked
    if _lib is not None or _lib_checked:
        return _lib
    with _lib_lock:
        if _lib is not None or _lib_checked:
            return _lib
        return _load_library_locked()


def _load_library_locked() -> Optional[ctypes.CDLL]:
    global _lib, _lib_checked
    try:
        if not SOURCE.exists():
            return None
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        lib = ctypes.CDLL(str(path))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.evt_preprocess.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, f32p, f32p,
        ]
        lib.evt_preprocess.restype = None
        lib.evt_resize_bicubic.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, ctypes.c_int, ctypes.c_int,
        ]
        lib.evt_resize_bicubic.restype = None
        _lib = lib
        return lib
    finally:
        # set only once the attempt is over: load_library's unlocked check
        # would otherwise tell a thread that arrives during another's load
        # that there is no library
        _lib_checked = True


def available() -> bool:
    return load_library() is not None


def preprocess_native(
    rgb: np.ndarray, resize: int = 256, crop: int = 224,
    mean=None, std=None,
) -> np.ndarray:
    """uint8 HWC image -> normalized float32 CHW (native hot loop)."""
    from .imagenet import IMAGENET_MEAN, IMAGENET_STD

    lib = load_library()
    if lib is None:
        raise RuntimeError("native preprocessing library unavailable")
    mean = np.ascontiguousarray(mean if mean is not None else IMAGENET_MEAN, np.float32)
    std = np.ascontiguousarray(std if std is not None else IMAGENET_STD, np.float32)
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected an HWC RGB image, got shape {rgb.shape}")
    if crop > resize:
        raise ValueError(f"crop {crop} > resize {resize}: the crop would leave the image")
    h, w, _ = rgb.shape
    out = np.empty((3, crop, crop), np.float32)
    lib.evt_preprocess(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, resize, crop,
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def resize_bicubic_native(rgb: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    lib = load_library()
    if lib is None:
        raise RuntimeError("native preprocessing library unavailable")
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    out = np.empty((out_h, out_w, c), np.float32)
    lib.evt_resize_bicubic(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_h, out_w,
    )
    return out
