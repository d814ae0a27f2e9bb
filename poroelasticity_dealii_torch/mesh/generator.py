"""Structured hyper-rectangle mesh generator.

Replicates the reference's ``create_mesh()`` semantics
(``PoroelasticityFSS.h:419-435``): a rectangle/box centered at the origin
spanning ``[-size_d/2, +size_d/2]`` per axis, globally refined ``level``
times (``2**level`` cells per axis), with deal.II ``colorize=true`` boundary
ids: 0/1 = low/high x, 2/3 = low/high y, 4/5 = low/high z (see the comment
block in the reference ``input.data``).
"""

from __future__ import annotations

import numpy as np

from .core import Mesh


def normalize_cells_per_axis(cells_per_axis, dim: int):
    """int | sequence -> per-axis tuple ``(n_x, n_y[, n_z])``."""
    if np.ndim(cells_per_axis) == 0:
        return (int(cells_per_axis),) * dim
    ns = tuple(int(c) for c in cells_per_axis)
    if len(ns) != dim:
        raise ValueError(f"cells_per_axis {ns} does not match dim={dim}")
    return ns


def perturb_interior(mesh, amplitude: float, seed: int = 0):
    """Randomly displace every INTERIOR vertex by up to ``amplitude`` of
    the local cell size — distorted-geometry testing (deal.II's
    ``GridTools::distort_random`` analogue).

    Boundary vertices (on the mesh's bounding box — the generators here
    produce rectangles) stay fixed so boundary labels/faces keep their
    geometry.  The per-element bilinear/trilinear Jacobians of the generic
    discretization (solvers/discretization.py) handle the resulting
    non-axis-aligned elements; tests/test_distorted.py verifies this at
    machine precision against patch tests and the dense oracle.
    """
    import dataclasses
    v = np.asarray(mesh.vertices)
    dim = mesh.dim
    lo, hi = v.min(axis=0), v.max(axis=0)
    # local scale: min over cells containing a vertex of the cell diameter
    corner = v[mesh.cells]
    h_cell = np.linalg.norm(corner.max(axis=1) - corner.min(axis=1), axis=1)
    h_vert = np.full(v.shape[0], np.inf)
    for k in range(mesh.cells.shape[1]):
        np.minimum.at(h_vert, mesh.cells[:, k], h_cell)
    tol = 1e-9 * np.linalg.norm(hi - lo)
    interior = np.ones(v.shape[0], bool)
    for d in range(dim):
        interior &= (np.abs(v[:, d] - lo[d]) > tol) \
            & (np.abs(v[:, d] - hi[d]) > tol)
    rng = np.random.default_rng(seed)
    shift = (rng.uniform(-1.0, 1.0, v.shape)
             * (amplitude * h_vert / np.sqrt(dim))[:, None])
    v2 = v.copy()
    v2[interior] += shift[interior]
    return dataclasses.replace(mesh, vertices=v2)


def hyper_rectangle(domain_size, refinement_level: int = None,
                    lower=None, upper=None, cells_per_axis=None) -> Mesh:
    """Structured quad/hex mesh, 2**refinement_level cells per axis, or
    ``cells_per_axis`` — an int (same per axis) or a per-axis tuple
    ``(n_x, n_y[, n_z])`` for anisotropic cell counts."""
    domain_size = np.asarray(domain_size, dtype=np.float64)
    dim = len(domain_size)
    if cells_per_axis is not None:
        ns = normalize_cells_per_axis(cells_per_axis, dim)
    else:
        ns = (2 ** refinement_level,) * dim  # cells per axis
    if lower is None:
        lower = -domain_size / 2.0
    if upper is None:
        upper = domain_size / 2.0
    lower = np.asarray(lower, dtype=np.float64)
    upper = np.asarray(upper, dtype=np.float64)

    # vertices, lexicographic x fastest
    axes = [np.linspace(lower[d], upper[d], ns[d] + 1) for d in range(dim)]
    idx = np.indices([ns[dim - 1 - d] + 1 for d in range(dim)]) \
        .reshape(dim, -1)                             # C-order: last fastest
    coord_idx = [idx[dim - 1 - d] for d in range(dim)]  # coord d index array
    vertices = np.stack([axes[d][coord_idx[d]] for d in range(dim)], axis=-1)

    def vid(ix):  # ix: (dim, ...) integer coords -> global vertex id
        out = np.zeros_like(ix[0])
        stride = 1
        for d in range(dim):
            out = out + ix[d] * stride
            stride *= (ns[d] + 1)
        return out

    # cells, lexicographic x fastest; local corners lexicographic too
    cidx = np.indices([ns[dim - 1 - d] for d in range(dim)]).reshape(dim, -1)
    ccoord = [cidx[dim - 1 - d] for d in range(dim)]  # coord-d cell index
    corners = []
    for corner in range(2 ** dim):
        off = [(corner >> d) & 1 for d in range(dim)]
        corners.append(vid([ccoord[d] + off[d] for d in range(dim)]))
    cells = np.stack(corners, axis=-1).astype(np.int32)

    # cell flat index from per-axis cell coords (x fastest)
    def cell_id(cc):
        out = np.zeros_like(cc[0])
        stride = 1
        for d in range(dim):
            out = out + cc[d] * stride
            stride *= ns[d]
        return out

    face_cells, face_local, face_ids = [], [], []
    for d in range(dim):
        other = [a for a in range(dim) if a != d]
        oidx = np.indices([ns[other[dim - 2 - k]]
                           for k in range(dim - 1)]).reshape(dim - 1, -1) \
            if dim > 1 else np.zeros((0, 1), dtype=np.int64)
        # lexicographic over remaining axes, lowest-numbered axis fastest
        ocoord = [oidx[dim - 2 - k] for k in range(dim - 1)]
        for side in (0, 1):
            cc = [None] * dim
            cc[d] = np.full(ocoord[0].shape if ocoord else (1,),
                            0 if side == 0 else ns[d] - 1, dtype=np.int64)
            if dim == 1:
                cc[d] = np.array([0 if side == 0 else ns[d] - 1])
            for k, a in enumerate(other):
                cc[a] = ocoord[k]
            face_cells.append(cell_id(cc))
            face_local.append(np.full(cc[0].shape, 2 * d + side, np.int32))
            face_ids.append(np.full(cc[0].shape, 2 * d + side, np.int32))

    return Mesh(
        dim=dim,
        vertices=vertices,
        cells=cells,
        face_cells=np.concatenate(face_cells).astype(np.int32),
        face_local=np.concatenate(face_local).astype(np.int32),
        face_ids=np.concatenate(face_ids).astype(np.int32),
    )
