"""Structured-grid Q_k spaces with lexicographic node numbering.

On a uniform rectilinear ``hyper_rectangle`` mesh, numbering the Q_k nodes
lexicographically (x fastest) turns the cell gather into axis-strided
slices and the scatter-transpose into interior-padded adds — no gather or
scatter instructions at all (see ops/structured.py).  This module builds
the :class:`FESpace` with that numbering.

The generic entity-dedup numbering (mesh/qk.py) stays the path for
unstructured gmsh meshes; both produce identical *spaces* (same nodes, same
continuity), only the numbering differs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..ops.shape import node_lattice
from .core import FESpace, Mesh
from .generator import hyper_rectangle


@dataclasses.dataclass(frozen=True)
class GridInfo:
    """Static metadata the strided-slice kernels need.

    ``cells_per_axis`` / ``nodes_per_axis`` are per-axis tuples in
    ``(x, y[, z])`` order (anisotropic counts supported); node grids are
    stored ``(z, y, x)`` — reverse when building array shapes.
    """
    dim: int
    cells_per_axis: Tuple[int, ...]
    degree: int                  # k
    @property
    def nodes_per_axis(self) -> Tuple[int, ...]:
        return tuple(self.degree * n + 1 for n in self.cells_per_axis)

    @property
    def isotropic(self) -> bool:
        return len(set(self.cells_per_axis)) == 1


def structured_mesh(domain_size, cells_per_axis,
                    lower=None, upper=None) -> Mesh:
    """Uniform mesh whose vertex numbering is already lexicographic."""
    return hyper_rectangle(domain_size, lower=lower, upper=upper,
                           cells_per_axis=cells_per_axis)


def build_structured_space(mesh: Mesh, cells_per_axis,
                           degree: int) -> Tuple[FESpace, GridInfo]:
    """Q_degree space with grid-lexicographic global numbering."""
    from .generator import normalize_cells_per_axis
    dim = mesh.dim
    ns = normalize_cells_per_axis(cells_per_axis, dim)
    k = degree
    gs = tuple(k * n + 1 for n in ns)
    info = GridInfo(dim=dim, cells_per_axis=ns, degree=k)

    # node coordinates: uniform lattice over the mesh bounding box
    lo = mesh.vertices.min(axis=0)
    hi = mesh.vertices.max(axis=0)
    axes = [np.linspace(lo[d], hi[d], gs[d]) for d in range(dim)]
    idx = np.indices([gs[dim - 1 - d] for d in range(dim)]).reshape(dim, -1)
    coord_idx = [idx[dim - 1 - d] for d in range(dim)]   # x fastest
    node_coords = np.stack([axes[d][coord_idx[d]] for d in range(dim)],
                           axis=-1)

    # cell -> node connectivity
    lat = node_lattice(k, dim)                            # (N, dim)
    n_cells = int(np.prod(ns))
    cidx = np.indices([ns[dim - 1 - d] for d in range(dim)]).reshape(dim, -1)
    ccoord = [cidx[dim - 1 - d] for d in range(dim)]      # (E,) per axis
    conn = np.zeros((n_cells, lat.shape[0]), dtype=np.int64)
    for a, off in enumerate(lat):
        flat = np.zeros(n_cells, dtype=np.int64)
        stride = 1
        for d in range(dim):
            flat += (k * ccoord[d] + off[d]) * stride
            stride *= gs[d]
        conn[:, a] = flat

    space = FESpace(mesh=mesh, degree=k, node_coords=node_coords,
                    cell_nodes=conn.astype(np.int32))
    return space, info
