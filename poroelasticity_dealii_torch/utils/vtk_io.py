"""Legacy-VTK unstructured-grid writer (copy of
``poroelasticity_dealii_tpu/utils/vtk_io.py`` with the port's own Voigt
constants and the pure-Python writer only).

Produces one ``solution-NNNN.vtk`` per time step with the same point-data
layout the reference emits through deal.II ``DataOut``
(``PoroelasticityFSS.h:228-291``): vector ``u``, scalar ``p``, all unique
strain components ``eps_*`` and stress components ``sigma_*``.

Deliberate fix: the reference writes ``sigma_yy`` from ``stresses[0]``
(= sigma_xx) in 2D (``PoroelasticityFSS.h:257-258``, SURVEY §2.1.1); here
``sigma_yy`` is the actual yy component.

Data lives on the Q1 pressure nodes (= mesh vertices for degree 1), cells
are the mesh cells — equivalent to the reference's degree-1
``build_patches`` output.
"""

from __future__ import annotations

import os

import numpy as np

from ..mesh.core import FESpace
from ..ops.shape import node_lattice
from ..ops.operators import VOIGT_PAIRS

_VTK_CELL_TYPE = {1: 3, 2: 9, 3: 12}  # VTK_LINE, VTK_QUAD, VTK_HEXAHEDRON
# lexicographic corners -> VTK node order
_LEX_TO_VTK = {1: [0, 1], 2: [0, 1, 3, 2], 3: [0, 1, 3, 2, 4, 5, 7, 6]}

_COMP_NAMES = {
    1: ["xx"],
    2: ["xx", "xy", "yy"],
    3: ["xx", "xy", "xz", "yy", "yz", "zz"],
}


def write_vtk(path: str, pressure_space: FESpace, u_at_pnodes: np.ndarray,
              p: np.ndarray, strains: np.ndarray, stresses: np.ndarray):
    """Write one legacy-ASCII VTK file.

    Args:
      pressure_space: Q1 space whose nodes carry the point data.
      u_at_pnodes: ``(n_nodes, dim)`` displacement sampled at those nodes.
      p: ``(n_nodes,)`` pressure.
      strains/stresses: ``(n_voigt, n_nodes)`` unique symmetric components.
    """
    mesh = pressure_space.mesh
    dim = mesh.dim
    coords = pressure_space.node_coords
    n_pts = coords.shape[0]
    # pad coordinates and vectors to 3D as VTK requires
    xyz = np.zeros((n_pts, 3))
    xyz[:, :dim] = coords
    u3 = np.zeros((n_pts, 3))
    u3[:, :dim] = u_at_pnodes

    conn = pressure_space.cell_nodes[:, _corner_locals(pressure_space)]
    conn = conn[:, _LEX_TO_VTK[dim]]
    n_cells, n_per = conn.shape

    lines = ["# vtk DataFile Version 3.0",
             "poroelasticity_dealii_torch output", "ASCII",
             "DATASET UNSTRUCTURED_GRID",
             f"POINTS {n_pts} double"]
    lines += [" ".join(f"{v:.16g}" for v in row) for row in xyz]
    lines.append(f"CELLS {n_cells} {n_cells * (n_per + 1)}")
    lines += [f"{n_per} " + " ".join(map(str, row)) for row in conn]
    lines.append(f"CELL_TYPES {n_cells}")
    lines += [str(_VTK_CELL_TYPE[dim])] * n_cells

    lines.append(f"POINT_DATA {n_pts}")
    lines.append("VECTORS u double")
    lines += [" ".join(f"{v:.16g}" for v in row) for row in u3]

    def scalar(name, arr):
        lines.append(f"SCALARS {name} double 1")
        lines.append("LOOKUP_TABLE default")
        lines.extend(f"{v:.16g}" for v in np.asarray(arr))

    scalar("p", p)
    names = _COMP_NAMES[dim]
    for c in range(len(VOIGT_PAIRS[dim])):
        scalar(f"eps_{names[c]}", strains[c])
    for c in range(len(VOIGT_PAIRS[dim])):
        scalar(f"sigma_{names[c]}", stresses[c])

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _is_grid_lexicographic(space: FESpace, g: int) -> bool:
    """Cheap check that node numbering is grid-lexicographic (x fastest)."""
    dim = space.mesh.dim
    c = space.node_coords
    if len(c) < 2:
        return False
    # consecutive nodes along x except at row wraps
    dx = c[1] - c[0]
    return bool(abs(dx[0]) > 0 and np.allclose(dx[1:], 0.0)
                and np.allclose(c[g - 1][0], c[:g, 0].max()))


def _corner_locals(space: FESpace):
    """Local node indices of the cell corners in a Q_k space (lattice
    extremes), lexicographic corner order."""
    k = space.degree
    lat = node_lattice(k, space.mesh.dim)
    corners = []
    for corner in range(2 ** space.mesh.dim):
        target = [(k if (corner >> d) & 1 else 0)
                  for d in range(space.mesh.dim)]
        idx = np.nonzero((lat == target).all(axis=1))[0][0]
        corners.append(int(idx))
    return np.asarray(corners)


def displacement_at_pressure_nodes(pressure_space: FESpace,
                                   displacement_space: FESpace,
                                   u: np.ndarray) -> np.ndarray:
    """Sample the (vector, interleaved) displacement at pressure nodes.

    For Q2 displacement / Q1 pressure on the same mesh, every pressure node
    is geometrically a displacement node; match them by coordinates (or by
    index arithmetic on structured grids)."""
    dim = pressure_space.mesh.dim
    u = np.asarray(u).reshape(-1, dim)
    # structured grids: pure index arithmetic, no coordinate hashing
    kp, ku = pressure_space.degree, displacement_space.degree
    gp = round(pressure_space.n_nodes ** (1.0 / dim))
    gu = round(displacement_space.n_nodes ** (1.0 / dim))
    if (gp ** dim == pressure_space.n_nodes
            and gu ** dim == displacement_space.n_nodes
            and (gp - 1) * ku == (gu - 1) * kp
            and _is_grid_lexicographic(pressure_space, gp)
            and _is_grid_lexicographic(displacement_space, gu)):
        step = ku // kp if ku % kp == 0 else None
        if step:
            idx1 = np.arange(gp) * step
            grids = np.meshgrid(*([idx1] * dim), indexing="ij")
            flat = np.zeros_like(grids[0])
            stride = 1
            # x fastest: coordinate d uses the (dim-1-d)-th meshgrid axis
            for d in range(dim):
                flat = flat + grids[dim - 1 - d] * stride
                stride *= gu
            return u[flat.reshape(-1)]
    # round-keyed coordinate lookup
    scale = max(1.0, np.abs(displacement_space.node_coords).max())
    key = lambda c: tuple(np.round(c / scale, 12))  # noqa: E731
    lookup = {key(c): i for i, c in enumerate(displacement_space.node_coords)}
    idx = np.array([lookup[key(c)] for c in pressure_space.node_coords])
    return u[idx]
