"""Immutable structure-of-arrays mesh and FE-space containers.

The TPU-native replacement for deal.II's ``Triangulation`` + ``DoFHandler``
pair (reference ``PoroelasticityFSS.h:75-79``): plain int32/float64 arrays
that shard and gather well, instead of pointer-based cell iterators.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Conforming quad/hex mesh as flat arrays.

    Attributes:
      dim: spatial dimension (2 or 3).
      vertices: ``(n_vertices, dim)`` float64 coordinates.
      cells: ``(n_cells, 2**dim)`` int32 corner-vertex ids, local ordering
        lexicographic with x fastest (ix + 2*iy + 4*iz).
      face_cells: ``(n_bfaces,)`` int32 — owning cell of each boundary face.
      face_local: ``(n_bfaces,)`` int32 — local face id in the owning cell,
        ``2*axis + side`` (side 0 = low, 1 = high), matching deal.II's
        colorize boundary-id convention used by the reference deck.
      face_ids: ``(n_bfaces,)`` int32 boundary labels.
    """

    dim: int
    vertices: np.ndarray
    cells: np.ndarray
    face_cells: np.ndarray
    face_local: np.ndarray
    face_ids: np.ndarray

    @property
    def n_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def n_boundary_faces(self) -> int:
        return self.face_cells.shape[0]


@dataclasses.dataclass(frozen=True)
class FESpace:
    """Scalar Q_degree nodal space on a :class:`Mesh`.

    The deal.II ``DoFHandler`` analogue: global node coordinates plus the
    cell -> global-node connectivity used by every gather/scatter.  A vector
    space with ``dim`` components interleaves dofs as ``node*dim + comp``;
    helpers below produce the vector connectivity from the scalar one.
    """

    mesh: Mesh
    degree: int
    node_coords: np.ndarray   # (n_nodes, dim) float64
    cell_nodes: np.ndarray    # (n_cells, (degree+1)**dim) int32

    @property
    def n_nodes(self) -> int:
        return self.node_coords.shape[0]

    @property
    def nodes_per_cell(self) -> int:
        return self.cell_nodes.shape[1]

    def vector_cell_dofs(self, n_comp: int) -> np.ndarray:
        """Cell -> global dof ids for the n_comp-vector version of the space.

        Local ordering interleaves components (local dof = node*n_comp+comp),
        the analogue of deal.II's ``FESystem(FE_Q(k), dim)`` component
        interleaving via ``system_to_component_index``
        (``PoroElasticDisplacementSolver.h:216-218``).
        """
        cn = self.cell_nodes.astype(np.int64)
        dofs = cn[:, :, None] * n_comp + np.arange(n_comp)[None, None, :]
        return dofs.reshape(self.mesh.n_cells, -1).astype(np.int32)

    @property
    def n_vector_dofs(self) -> int:
        return self.n_nodes * self.mesh.dim
