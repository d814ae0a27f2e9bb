"""Boundary and source vectors of the discrete problem, host numpy (port of
``poroelasticity_dealii_tpu/solvers/discretization.py:137-312``): the Neumann
traction and body-force vectors, the Dirichlet (node, component) pinning of
the displacement and the drainage pinning of the pressure, and the well
source."""

from __future__ import annotations

import numpy as np

from ..config import InputData
from ..mesh.core import FESpace, Mesh
from ..ops.quadrature import gauss_tensor
from ..ops.shape import face_lattice_indices, shape_tables


def _embedded_face_points(local_face: int, pts_f: np.ndarray, dim: int):
    """Map (dim-1)-dimensional face quad points into cell reference coords."""
    d, side = divmod(local_face, 2)
    other = [a for a in range(dim) if a != d]
    n = pts_f.shape[0] if pts_f.ndim else 1
    out = np.zeros((max(n, 1), dim))
    out[:, d] = -1.0 if side == 0 else 1.0
    for k, a in enumerate(other):
        out[:, a] = pts_f[:, k]
    return out


def _neumann_vector(mesh: Mesh, u_space: FESpace, data: InputData) -> np.ndarray:
    """Assemble ∫_face phi_n * value * n_comp ds over all stress boundaries.

    Semantics match the reference exactly: the applied traction on component
    c is ``value * n_c`` (normal-component-scaled scalar, not a raw traction
    vector — quirk documented in SURVEY §2.1.11;
    PoroElasticDisplacementSolver.h:263-273).
    """
    dim = mesh.dim
    ku = u_space.degree
    n_udofs = u_space.n_nodes * dim
    f = np.zeros(n_udofs)
    if not data.stress_boundary_labels:
        return f
    pts_f, wts_f = gauss_tensor(ku + 1, dim - 1)
    corner_xyz = mesh.vertices[mesh.cells]

    for local_face in range(2 * dim):
        sel = mesh.face_local == local_face
        if not sel.any():
            continue
        cells_f = mesh.face_cells[sel]
        ids_f = mesh.face_ids[sel]
        d, side = divmod(local_face, 2)
        ref_pts = _embedded_face_points(local_face, pts_f, dim)
        # geometry at embedded points
        _, dn1 = shape_tables(1, dim, ref_pts)
        xc = corner_xyz[cells_f]                          # (F, 2^d, dim)
        jac = np.einsum("fvi,qvj->fqij", xc, dn1)         # (F, Q, dim, dim)
        other = [a for a in range(dim) if a != d]
        if dim == 2:
            t = jac[:, :, :, other[0]]
            area = np.linalg.norm(t, axis=-1)
        else:
            t1 = jac[:, :, :, other[0]]
            t2 = jac[:, :, :, other[1]]
            area = np.linalg.norm(np.cross(t1, t2), axis=-1)
        jxw_f = area * wts_f[None, :]
        # unit outward normal ∝ ± row d of J^{-1}
        jinv = np.linalg.inv(jac)
        ndir = jinv[:, :, d, :] * (1.0 if side == 1 else -1.0)
        normal = ndir / np.linalg.norm(ndir, axis=-1, keepdims=True)
        # displacement shape values at the embedded points
        phi_u, _ = shape_tables(ku, dim, ref_pts)          # (Q, Nnodes)
        cell_nodes_f = u_space.cell_nodes[cells_f]         # (F, Nnodes)
        for lbl, comp, val in zip(data.stress_boundary_labels,
                                  data.stress_boundary_components,
                                  data.stress_boundary_values):
            m = ids_f == lbl
            if not m.any():
                continue
            contrib = np.einsum("fq,qn->fn",
                                val * normal[m][:, :, comp] * jxw_f[m], phi_u)
            dofs = cell_nodes_f[m] * dim + comp
            np.add.at(f, dofs.reshape(-1), contrib.reshape(-1))
    return f


def _pressure_dirichlet(mesh: Mesh, p_space: FESpace, data: InputData):
    """First-wins (node) pinning for drainage boundaries (our extension)."""
    n = p_space.n_nodes
    free = np.ones(n, dtype=bool)
    values = np.zeros(n)
    faces_lat = face_lattice_indices(p_space.degree, mesh.dim)
    for lbl, val in zip(data.pressure_boundary_labels,
                        data.pressure_boundary_values):
        sel = mesh.face_ids == lbl
        if not sel.any():
            continue
        for local_face in np.unique(mesh.face_local[sel]):
            m = sel & (mesh.face_local == local_face)
            nodes = np.unique(
                p_space.cell_nodes[mesh.face_cells[m]][:, faces_lat[local_face]])
            newly = free[nodes]
            values[nodes[newly]] = val
            free[nodes[newly]] = False
    return free, values


def _dirichlet_constraints(mesh: Mesh, u_space: FESpace, data: InputData):
    """First-condition-wins Dirichlet (node, component) pinning, matching
    deal.II interpolate_boundary_values into a ConstraintMatrix
    (PoroElasticDisplacementSolver.h:117-134)."""
    dim = mesh.dim
    n_udofs = u_space.n_nodes * dim
    free = np.ones(n_udofs, dtype=bool)
    values = np.zeros(n_udofs)
    faces_lat = face_lattice_indices(u_space.degree, dim)
    for lbl, comp, val in zip(data.displacement_boundary_labels,
                              data.displacement_boundary_components,
                              data.displacement_boundary_values):
        sel = mesh.face_ids == lbl
        if not sel.any():
            continue
        for local_face in np.unique(mesh.face_local[sel]):
            m = sel & (mesh.face_local == local_face)
            nodes = u_space.cell_nodes[mesh.face_cells[m]][:, faces_lat[local_face]]
            dofs = np.unique(nodes.astype(np.int64) * dim + comp)
            newly = free[dofs]
            values[dofs[newly]] = val
            free[dofs[newly]] = False
    return free, values


def _body_force_vector(u_space: FESpace, data: InputData,
                       jxw_u: np.ndarray, psi_u: np.ndarray) -> np.ndarray:
    """Gravity body-force RHS: f[(n,c)] = ∫ phi_n * rho * g_c dx.

    The reference's BodyForces (right_hand_side.h:47-84) is effectively a
    no-op (SURVEY §2.1.2): default direction 3 fails the ``<= dim`` guard in
    2D and would be out of bounds in 3D.  Our default (-1) replicates the
    no-op; setting ``TPU / Gravity direction`` to a valid axis enables the
    intended -9.81*rho load."""
    dim = u_space.mesh.dim
    n_udofs = u_space.n_nodes * dim
    f = np.zeros(n_udofs)
    d = data.gravity_direction
    if d < 0 or d >= dim:
        return f
    fe = np.einsum("eq,qn->en", jxw_u, psi_u) * (-9.81 * data.bulk_density)
    dofs = u_space.cell_nodes.astype(np.int64) * dim + d
    np.add.at(f, dofs.reshape(-1), fe.reshape(-1))
    return f


def _well_vector(p_space: FESpace, data: InputData,
                 jxw_p: np.ndarray, psi_p: np.ndarray,
                 x_q: np.ndarray) -> np.ndarray:
    """FEM RHS of the disc-shaped well source (right_hand_side.h:99-116):
    q(x) = -Q/(pi r²) where x²+y² <= r², else 0.  In 3D the radial distance
    uses the first two coordinates (a vertical line well through the origin);
    the reference asserts dim == 2 and never defines a 3D well."""
    r2 = x_q[..., 0] ** 2 + (x_q[..., 1] ** 2 if x_q.shape[-1] > 1 else 0.0)
    src = np.where(r2 <= data.r_well ** 2,
                   -data.flow_rate / (np.pi * data.r_well ** 2), 0.0)
    fe = np.einsum("eq,qi->ei", jxw_p * src, psi_p)
    f = np.zeros(p_space.n_nodes)
    np.add.at(f, p_space.cell_nodes.reshape(-1), fe.reshape(-1))
    return f
