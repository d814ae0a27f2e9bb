"""The benchmark's own hexahedral meshes: the box of a deck, cut into n
cells per axis, and its distorted copy drawn from the seed.

Both sides read these arrays: the program gets them as its mesh, the
reference builds its operators on them.  Numbering as deal.II's
``GridGenerator::hyper_rectangle`` with ``colorize``: vertices and cells
lexicographic with x fastest, cell corners ``ix + 2 iy + 4 iz``, boundary
face ``2 * axis + side`` labelled with that same number.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class HexMesh:
    vertices: np.ndarray      # (nv, 3) float64
    cells: np.ndarray         # (E, 8) int32
    face_cells: np.ndarray    # (F,) int32: the cell of each boundary face
    face_local: np.ndarray    # (F,) int32: its face in the cell, 2 axis + side
    face_ids: np.ndarray      # (F,) int32: the boundary label
    n: int                    # cells per axis


def box(domain, n: int) -> HexMesh:
    """The box ``[-d/2, d/2]`` per axis (the deck's ``Domain size`` d),
    ``n`` cells per axis."""
    d = np.asarray(domain, np.float64)
    ax = [np.linspace(-d[a] / 2, d[a] / 2, n + 1) for a in range(3)]
    iz, iy, ix = (a.reshape(-1) for a in np.meshgrid(
        *[np.arange(n + 1)] * 3, indexing="ij"))
    vertices = np.stack([ax[0][ix], ax[1][iy], ax[2][iz]], -1)
    cz, cy, cx = (a.reshape(-1) for a in np.meshgrid(
        *[np.arange(n)] * 3, indexing="ij"))
    g = n + 1
    cells = np.stack([(cx + bx) + g * ((cy + by) + g * (cz + bz))
                      for bz in (0, 1) for by in (0, 1) for bx in (0, 1)],
                     -1).astype(np.int32)
    cid = cx + n * (cy + n * cz)
    coords = (cx, cy, cz)
    fc, fl = [], []
    for axis in range(3):
        for side in (0, 1):
            on = coords[axis] == (n - 1 if side else 0)
            fc.append(cid[on])
            fl.append(np.full(int(on.sum()), 2 * axis + side))
    face_cells = np.concatenate(fc).astype(np.int32)
    face_local = np.concatenate(fl).astype(np.int32)
    return HexMesh(vertices, cells, face_cells, face_local,
                   face_local.copy(), n)


def distort(mesh: HexMesh, amplitude: float, rng) -> HexMesh:
    """Every interior vertex moved by up to ``amplitude`` of its cell size
    along each axis, uniformly, drawn from ``rng``; the boundary stays on
    the box."""
    v = mesh.vertices
    lo, hi = v.min(0), v.max(0)
    h = (hi - lo) / mesh.n
    tol = 1e-9 * float(np.linalg.norm(hi - lo))
    interior = np.all((v - lo > tol) & (hi - v > tol), axis=1)
    shift = rng.uniform(-1.0, 1.0, v.shape) * amplitude * h
    out = v.copy()
    out[interior] += shift[interior]
    return dataclasses.replace(mesh, vertices=out)
