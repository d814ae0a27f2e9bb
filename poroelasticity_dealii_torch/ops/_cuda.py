"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded through :mod:`ctypes`.  The build runs at first
use (never at import: the CPU tests import every module) into
``build/torch_kernels/`` at the repository root, under a file name keyed on
a hash of the sources and flags, so a checkout builds everything it needs
from its own sources and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "comp_major.cu",)
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: argtypes (after the dtype suffix _f32/_f64)
    "elasticity_rows_apply": (_P, _P, _P, _P, _I, _I, _I, _P),
    "coupling_rows": (_P, _P, _P, _I, _I, _P),
    "projection_rows": (_P, _P, _P, _I, _I, _I, _P),
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "$CUDA_HOME/bin, default /usr/local/cuda/bin)")


class KernelLibrary:
    """The loaded kernel library and the time its build took."""

    def __init__(self, path: Path, build_seconds: float):
        self.path = path
        self.build_seconds = build_seconds   # 0.0 when already built
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            for suffix in _SUFFIX.values():
                fn = getattr(self._lib, f"{name}_{suffix}")
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int

    def launch(self, name: str, dtype: torch.dtype, *args) -> None:
        """Call entry point ``name`` for ``dtype``; raise on a CUDA error."""
        fn = getattr(self._lib, f"{name}_{_SUFFIX[dtype]}")
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {name} ({dtype}) failed to "
                               f"launch: cudaError {err}")


def _build() -> KernelLibrary:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libcomp_major_{h.hexdigest()[:16]}.so"
    if so.exists():
        return KernelLibrary(so, 0.0)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                              *map(str, SOURCES)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, so)     # atomic: concurrent builders never see half
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return KernelLibrary(so, time.perf_counter() - t0)


@functools.cache
def library() -> KernelLibrary:
    """Build (if needed) and load the kernels; cached for the process."""
    return _build()


def launch(name: str, tensor: torch.Tensor, *args) -> None:
    """Launch kernel ``name`` on ``tensor``'s device and current stream.

    ``args`` are the entry point's arguments before the stream; tensors are
    passed as device pointers (``None`` as a null pointer)."""
    conv = [a.data_ptr() if isinstance(a, torch.Tensor)
            else (0 if a is None else a) for a in args]
    with torch.cuda.device(tensor.device):
        stream = torch.cuda.current_stream(tensor.device).cuda_stream
        library().launch(name, tensor.dtype, *conv, stream)
