"""ctypes bindings for the native I/O library (native/meshio.cpp).

Compiles the shared library on first use (g++, cached under ``build/``) and
exposes fast gmsh parsing / VTK writing.  Every caller has a pure-Python
fallback, so absence of a toolchain degrades gracefully.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))
_SRC = os.path.join(_ROOT, "native", "meshio.cpp")
_LIB_PATH = os.path.join(_ROOT, "build", "libporomeshio.so")

_lock = threading.Lock()
_lib = None
_tried = False


class _MshData(ctypes.Structure):
    _fields_ = [
        ("n_nodes", ctypes.c_int64),
        ("node_ids", ctypes.POINTER(ctypes.c_int64)),
        ("coords", ctypes.POINTER(ctypes.c_double)),
        ("n_elems", ctypes.c_int64),
        ("elem_types", ctypes.POINTER(ctypes.c_int32)),
        ("elem_ntags", ctypes.POINTER(ctypes.c_int32)),
        ("elem_tag0", ctypes.POINTER(ctypes.c_int64)),
        ("conn", ctypes.POINTER(ctypes.c_int64)),
        ("conn_offsets", ctypes.POINTER(ctypes.c_int64)),
    ]


def _build_library():
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    subprocess.run(
        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", _LIB_PATH,
         _SRC],
        check=True, capture_output=True)


def get_library():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if (not os.path.exists(_LIB_PATH)
                    or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)):
                _build_library()
            lib = ctypes.CDLL(_LIB_PATH)
            lib.msh_parse.restype = ctypes.c_int
            lib.msh_parse.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(_MshData)]
            lib.msh_free.argtypes = [ctypes.POINTER(_MshData)]
            lib.vtk_write.restype = ctypes.c_int
            lib.vtk_write.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32, ctypes.POINTER(ctypes.c_double),
                ctypes.c_int32, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_double)]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def parse_msh_native(path: str):
    """Parse a gmsh 2.2 file with the native parser.

    Returns ``(node_ids, coords3, elem_types, elem_tag0, conn, offsets)``
    numpy arrays, or None if the native library is unavailable.
    """
    lib = get_library()
    if lib is None:
        return None
    data = _MshData()
    rc = lib.msh_parse(path.encode(), ctypes.byref(data))
    if rc != 0:
        raise ValueError(f"native gmsh parser failed with code {rc}: {path}")
    try:
        n, m = data.n_nodes, data.n_elems
        nconn = data.conn_offsets[m]
        out = (
            np.ctypeslib.as_array(data.node_ids, (n,)).copy(),
            np.ctypeslib.as_array(data.coords, (n, 3)).copy(),
            np.ctypeslib.as_array(data.elem_types, (m,)).copy(),
            np.ctypeslib.as_array(data.elem_tag0, (m,)).copy(),
            np.ctypeslib.as_array(data.conn, (nconn,)).copy(),
            np.ctypeslib.as_array(data.conn_offsets, (m + 1,)).copy(),
        )
    finally:
        lib.msh_free(ctypes.byref(data))
    return out


def write_vtk_native(path: str, xyz3: np.ndarray, conn: np.ndarray,
                     vtk_cell_type: int, vectors3, scalar_names,
                     scalars: np.ndarray) -> bool:
    """Write a legacy VTK file natively; returns False if unavailable.

    ``scalars``: (n_scalars, n_points) row-major.
    """
    lib = get_library()
    if lib is None:
        return False
    xyz3 = np.ascontiguousarray(xyz3, dtype=np.float64)
    conn = np.ascontiguousarray(conn, dtype=np.int32)
    scalars = np.ascontiguousarray(scalars, dtype=np.float64)
    vec_ptr = None
    if vectors3 is not None:
        vectors3 = np.ascontiguousarray(vectors3, dtype=np.float64)
        vec_ptr = vectors3.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    rc = lib.vtk_write(
        path.encode(), xyz3.shape[0],
        xyz3.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        conn.shape[0], conn.shape[1],
        conn.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vtk_cell_type, vec_ptr,
        len(scalar_names), ";".join(scalar_names).encode(),
        scalars.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return rc == 0
