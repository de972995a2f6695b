"""Build the port's CUDA kernels into one shared library and load it.

``edgevisiontransformer_tpu_torch/csrc/*.cu`` compile with ``nvcc``, each
twice: as it is (the bf16 instance of its kernels) and with ``-DEVT_F16``
(the fp16 instance, whose entry points end in ``_f16``; csrc/common.cuh).
One process per object, all started together, and one link into a single
``.so`` with a plain C interface, loaded with :mod:`ctypes` (no PyTorch
headers, so a build takes seconds).  The library lands in
``build/torch_kernels/`` at the repository root, named by a hash of the
sources and the compile command, so a changed source rebuilds and an
unchanged one loads the cached file.  Nothing here runs on import: the first
kernel launch calls :func:`load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# the define that selects a source's fp16 instance, and its entry points' suffix
F16_DEFINE = "-DEVT_F16"
F16_SUFFIX = "_f16"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every exported function: (name, restype, argtypes).
_SIGNATURES = (
    ("evt_ln_rows", _I, (_P, _P, _P, _P, _I, _I, _F, _I, _P)),
    ("evt_linear", _I, (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
    ("evt_attention_rows", _I, (_P, _P, _I, _I, _I, _I, _I, _F, _I, _P)),
    ("evt_quant_rows", _I, (_P, _P, _P, _P, _I, _I, _I, _P)),
    ("evt_linear_i8", _I, (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)),
    ("evt_t2t_stage1", _I, (_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P)),
    ("evt_window_attention", _I, (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P)),
    ("evt_swin_merge", _I, (_P, _P, _P, _P, _I, _I, _I, _F, _I, _P)),
    ("evt_window_sdpa", _I, (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P)),
    ("evt_sdpa", _I, (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P)),
    ("evt_mlp", _I, (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)),
    ("evt_vit_full", _I, (_P, _P, _P, _P)),
    ("evt_vit_full_blocks_per_sm", _I, (_I, _I, _I, _P)),
    ("evt_vit_full_barrier_probe", _I, (_I, _I, _P)),
    ("evt_performer_reduce", _I, (_P, _P, _P, _P, _P, _I, _I, _P)),
    ("evt_performer_rows", _I, (_P, _P, _P, _P, _P, _I, _I, _F, _I, _P)),
    ("evt_error_string", ctypes.c_char_p, (_I,)),
)
# the entry points without an fp16 instance: no element type
_TYPELESS = ("evt_vit_full_barrier_probe", "evt_error_string")

_lib = None


class KernelBuildError(RuntimeError):
    pass


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, F16_DEFINE)).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libevt_kernels_{h.hexdigest()[:16]}.so"


def compile_library(out: Path, csrc: Path = CSRC, f16: bool = True) -> dict:
    """Compile every ``*.cu`` of ``csrc`` to an object, and with ``f16`` once
    more with :data:`F16_DEFINE`, one ``nvcc`` process per object running
    side by side, then link them into ``out``; raise with nvcc's stderr on
    failure.  Works in a temporary directory beside ``out`` so a concurrent
    build never loads a half-written file.  Returns ptxas's report of each
    kernel (``{object: [line, ...]}``, the fp16 objects' names ending in
    ``_f16``: its name, then its registers and spills).  ``csrc`` and
    ``f16=False`` build another checkout's sources (``bench/parent_bits``)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    report = {}
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        jobs = []
        for src in sorted(Path(csrc).glob("*.cu")):
            for defines, stem in [((), src.stem)] + ([((F16_DEFINE,), src.stem + F16_SUFFIX)]
                                                       if f16 else []):
                obj = Path(tmp) / f"{stem}.o"
                cmd = [nvcc, *NVCC_FLAGS, *defines, "-Xptxas", "-v", "-I", str(csrc), "-c",
                       "-o", str(obj), str(src)]
                jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.PIPE, text=True)))
        errors = []
        for cmd, obj, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
            report[obj.stem] = [line.split("info    : ")[-1].strip() for line in err.splitlines()
                                if "Compiling entry" in line or "registers" in line
                                or "spill" in line]
        if errors:
            raise KernelBuildError("\n".join(errors))
        lib = Path(tmp) / out.name
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *(str(j[1]) for j in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(lib, out)
    return report


def open_library(path: Path) -> ctypes.CDLL:
    """Load a built library and declare the C signature of every entry point
    it exports (an fp16 instance's as its bf16 one's)."""
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelBuildError(f"loading {path} failed: {e}") from e
    for name, restype, argtypes in _SIGNATURES:
        for entry in (name,) if name in _TYPELESS else (name, name + F16_SUFFIX):
            if hasattr(lib, entry):
                fn = getattr(lib, entry)
                fn.restype = restype
                fn.argtypes = list(argtypes)
    return lib


def load() -> ctypes.CDLL:
    """Return the kernel library, building it first if its cached file is
    missing.  Raises :class:`KernelBuildError` on a failed build or load."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        compile_library(path)
    _lib = open_library(path)
    return _lib


def entry(name: str, f16: bool):
    """The entry point ``name`` of the instance for the element type: the
    bf16 one, or with ``f16`` the fp16 one (``name`` + ``_f16``)."""
    return getattr(load(), name + F16_SUFFIX if f16 else name)


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = load().evt_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
