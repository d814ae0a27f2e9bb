"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded through :mod:`ctypes`: one ``nvcc -c``
per source, all started together, then one link.  The build runs at first
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..utils import profiling

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "cg_update.cu", _PKG / "csrc" / "comp_major.cu",
           _PKG / "csrc" / "generic.cu")
# headers the sources include: part of the build's hash
HEADERS = (_PKG / "csrc" / "cell_products.cuh",)
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    # name: argtypes (after the dtype suffix _f32/_f64); the last is the
    # stream
    # x, m, ke, y, product scratch, n, cell layers swept and real (nz,
    # nv), W, scratch stride, grid, shared bytes, mode
    "elasticity_rows_apply": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _P),
    "coupling_rows": (_P, _P, _P, _I, _I, _P),
    # x, pe, out, product scratch, n, W, scratch stride, grid, shared bytes
    "projection_rows": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # u, ke, y, product scratch, n, cell layers along z (nz), scratch
    # stride, grid, shared bytes
    "elasticity_grid_apply": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # generic.cu: u, the record's tensor maps (host), dref, the map's
    # gradients dn1 and weights wq, plan table, y, product scratch, lam,
    # mu, dim, cells E, plan width V, output length, grid, shared bytes
    "generic_elasticity_apply": (_P, _P, _P, _P, _P, _P, _P, _P, _D, _D,
                                 _I, _I, _I, _I, _I, _I, _P),
    # x, the record's tensor maps (host), plan table, y, product scratch,
    # alpha, beta, dim, lanes, input length, E, V, output length, grid
    "generic_q1_apply": (_P, _P, _P, _P, _P, _D, _D, _I, _I, _I, _I, _I,
                         _I, _I, _P),
    # cg_update.cu: x, r, p, ap, dinv, alpha, active, x_out, r_out, z_out,
    # n, lane length, blocks per lane, 16-byte packs
    "cg_jacobi_step": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _P),
    # z, p, beta, active, p_out, n, lane length, blocks per lane, packs
    "cg_direction": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# generic.cu's tensor-map encoder (no dtype suffix, no stream): the host
# buffer, conn, offsets, kernel (0 elasticity, 1 Q1), value bytes, dim, E,
# row stride Ep
MAP_SIGNATURE = ("generic_tensor_maps", (_P, _P, _P, _I, _I, _I, _I, _I))
MAP_BYTES = 128        # one CUtensorMap


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

    def __init__(self, path: Path, build_seconds: float,
                 compile_seconds: dict = None):
        self.path = path
        self.build_seconds = build_seconds   # 0.0 when already built
        # wall seconds of each source's nvcc (run in parallel): their sum
        # is what one nvcc over all sources would take, about
        self.compile_seconds = compile_seconds or {}
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            for suffix in _SUFFIX.values():
                fn = getattr(self._lib, f"{name}_{suffix}")
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
        fn = getattr(self._lib, MAP_SIGNATURE[0])
        fn.argtypes = list(MAP_SIGNATURE[1])
        fn.restype = ctypes.c_int

    def encode_maps(self, *args) -> None:
        """Encode an operand record's two TMA tensor maps
        (:data:`MAP_SIGNATURE`); raise on an error code."""
        err = getattr(self._lib, MAP_SIGNATURE[0])(*args)
        if err != 0:
            raise RuntimeError(f"{MAP_SIGNATURE[0]} failed: error {err} "
                               f"(a cudaError_t or the encoder's CUresult)")

    def launch(self, name: str, dtype: torch.dtype, *args) -> None:
        """Call entry point ``name`` for ``dtype``; raise on a CUDA error."""
        fn = getattr(self._lib, f"{name}_{_SUFFIX[dtype]}")
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {name} ({dtype}) failed to "
                               f"launch: cudaError {err}")


def _nvcc_run(args) -> float:
    """Run nvcc with ``args``; raise on failure; return its wall seconds."""
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc(), *args], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {' '.join(args)} failed ({res.returncode})"
                           f":\n{res.stdout}\n{res.stderr}")
    return time.perf_counter() - t0


def _build() -> KernelLibrary:
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libtorch_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return KernelLibrary(so, 0.0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in SOURCES]
        # one nvcc per source, all at once (the threads only wait on them);
        # the pool joins every process before it returns or raises
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            seconds = list(pool.map(
                lambda src, obj: _nvcc_run([*NVCC_FLAGS, "-c", "-o", obj,
                                            str(src)]), SOURCES, objs))
        lib = str(Path(tmp) / so.name)
        _nvcc_run([*NVCC_FLAGS, "-shared", "-o", lib, *objs])
        os.replace(lib, so)     # atomic: concurrent builders never see half
    return KernelLibrary(so, time.perf_counter() - t0,
                         {src.name: s for src, s in zip(SOURCES, seconds)})


@functools.cache
def library() -> KernelLibrary:
    """Build (if needed) and load the kernels; cached for the process."""
    return _build()


def launch(name: str, tensor: torch.Tensor, *args) -> None:
    """Launch kernel ``name`` on ``tensor``'s device and current stream.

    ``args`` are the entry point's arguments before the stream; tensors are
    passed as device pointers (``None`` as a null pointer).  While a
    profiler records, the enqueue is a ``kernel.enqueue`` span."""
    with profiling.leaf("kernel.enqueue", name):
        conv = [a.data_ptr() if isinstance(a, torch.Tensor)
                else (0 if a is None else a) for a in args]
        with torch.cuda.device(tensor.device):
            stream = torch.cuda.current_stream(tensor.device).cuda_stream
            library().launch(name, tensor.dtype, *conv, stream)


def check(name, t, shape, dtype, device):
    """Raise unless tensor ``t`` has the device, dtype, shape and
    contiguity a kernel takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_cuda(x):
    """Raise unless ``x`` is a float32/float64 CUDA tensor that int32
    indexing covers."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernels take float32/float64, got {x.dtype}")
    if x.numel() >= 2 ** 31:
        raise ValueError("tensor too large for the kernels' int32 indexing")
