"""Build the port's CUDA kernels into one shared library and load it.

``edgevisiontransformer_tpu_torch/csrc/*.cu`` compile with ``nvcc``, one
process per source, all started together, and link into a single ``.so``
with a plain C interface, loaded with :mod:`ctypes` (no PyTorch headers, so
a build takes seconds).  The library lands in
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libevt_kernels_{h.hexdigest()[:16]}.so"


def compile_library(out: Path) -> dict:
    """Compile every ``csrc/*.cu`` to an object, one ``nvcc`` process per
    source running side by side, then link them into ``out``; raise with
    nvcc's stderr on failure.  Works in a temporary directory beside ``out``
    so a concurrent build never loads a half-written file.  Returns ptxas's
    report of each kernel (``{source: [line, ...]}``: its name, then its
    registers and spills)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    report = {}
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c", "-o", str(obj),
                   str(src)]
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


def load() -> ctypes.CDLL:
    """Return the kernel library, building it first if its cached file is
    missing.  Raises :class:`KernelBuildError` on a failed build or load."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        compile_library(path)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelBuildError(f"loading {path} failed: {e}") from e
    for name, restype, argtypes in _SIGNATURES:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = list(argtypes)
    _lib = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = load().evt_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
