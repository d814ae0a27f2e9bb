"""The generic (unstructured) discretization of the Q2/Q1 problem on any
conforming quad or hex mesh, and the boundary and source vectors every
discretization shares (port of
``poroelasticity_dealii_tpu/solvers/discretization.py``).

:func:`build_discretization` does its set-up on the host in numpy, as the
reference does: the FE spaces, the per-cell Jacobian factors at the
quadrature points, the well source, the Neumann traction and body-force
vectors, the Dirichlet (node, component) pinning of the displacement and
the drainage pinning of the pressure, and the Jacobi diagonals.  It then
moves everything the step reads onto one device, cells-last, with a
:class:`..ops.operators.ScatterPlan` per connectivity.  The reference
computes the operators with XLA gathers, einsums and ``segment_sum``,
outside any Pallas kernel.  Here the mass, Laplace and elasticity applies
(and the pressure Jacobian ``alpha M + beta L`` in one call) dispatch on
the input tensor's device: on a CUDA tensor they launch the hand-written
kernels of :mod:`..ops.generic_apply` (``csrc/generic.cu``); on a CPU
tensor they run the plain gather, shape-table product and plan-scatter
applies of :mod:`..ops.operators`.  Degrees other than Q2 displacements
and Q1 pressures always run the plain applies (``generic_apply.takes_*``).
The coupling and projection right-hand sides are plain torch on every
device.

The hanging-node constraints ``hc_p`` and ``hc_u``
(:class:`..amr.constraints.HangingConstraints`) belong to adaptive meshes:
:func:`..amr.driver.build_amr_discretization` installs them on the forest's
mesh, and :class:`..amr.bucketing` may pad the tensors.  A conforming mesh
has none (None; ``_hcp`` and ``_hcu`` are then empty tables, whose methods
return their input untouched).  ``elasticity_constrained`` and the
fixed-stress solver's generic branches go through them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..amr.constraints import HangingConstraints, empty_constraints
from ..config import InputData
from ..mesh.core import FESpace, Mesh
from ..mesh.qk import build_fe_space
from ..ops import generic_apply as ga
from ..ops import operators as ops
from ..ops.geometry import corner_offsets, geometry_factors, map_tables
from ..ops.quadrature import gauss_tensor
from ..ops.shape import face_lattice_indices, shape_tables


@dataclasses.dataclass
class Discretization:
    """Everything the fixed-stress step reads on a generic mesh, as tensors
    on one device (shapes as the reference's; E = cells)."""

    dim: int
    dtype: torch.dtype
    device: torch.device
    pressure_space: FESpace
    displacement_space: FESpace
    conn_p: torch.Tensor           # (Np, E) int32
    conn_u: torch.Tensor           # (Nu*dim, E) int32, interleaved comps
    plan_p: ops.ScatterPlan        # scatter of conn_p
    plan_u: ops.ScatterPlan        # scatter of conn_u
    psi_p_at_pq: torch.Tensor      # (Qp, Np)
    dref_p_at_pq: torch.Tensor     # (Qp, Np, dim)
    psi_p_at_uq: torch.Tensor      # (Qu, Np)
    dref_u_at_uq: torch.Tensor     # (Qu, Nud, dim)
    dref_u_at_pq: torch.Tensor     # (Qp, Nud, dim)
    jinv_u: torch.Tensor           # (Qu, dim, dim, E)
    jxw_u: torch.Tensor            # (Qu, E)
    jinv_p: torch.Tensor           # (Qp, dim, dim, E)
    jxw_p: torch.Tensor            # (Qp, E)
    # X_n - X_0 per corner n >= 1 (ops/geometry.py::corner_offsets): the
    # generic kernels rebuild the Q1 map's J^-1 and JxW from these
    cell_offsets: torch.Tensor     # (2^dim - 1, dim, E)
    free_mask_u: torch.Tensor      # (n_udofs,) 1 free / 0 Dirichlet
    dirichlet_values: torch.Tensor  # (n_udofs,) 0 on free dofs
    f_neumann: torch.Tensor        # (n_udofs,) traction + body force
    f_well: torch.Tensor           # (n_pdofs,)
    free_mask_p: torch.Tensor      # (n_pdofs,) drainage pinning
    dirichlet_values_p: torch.Tensor
    diag_mass: torch.Tensor
    diag_laplace: torch.Tensor
    diag_elasticity: torch.Tensor  # (n_udofs,) Jacobi, 1 on Dirichlet
    lam: float
    mu: float
    # no mechanics kit and no elasticity V-cycle: the fixed-stress solver
    # takes its flat Jacobi-CG branches
    row_ops: None = None
    gmg_precond: Optional[Callable] = None
    gmg_precond_rows: Optional[Callable] = None
    # hanging-node constraints (AMR meshes only; None = conforming mesh)
    hc_p: Optional[HangingConstraints] = None
    hc_u: Optional[HangingConstraints] = None

    # Sizes derive from the tensors, not the FE spaces: AMR bucketing
    # (amr/bucketing.py) pads cells and dofs, while host consumers (VTK,
    # transfer, Kelly) read the spaces' real node counts.
    @property
    def n_pdofs(self) -> int:
        return self.free_mask_p.shape[0]

    @property
    def n_udofs(self) -> int:
        return self.free_mask_u.shape[0]

    @property
    def n_cells(self) -> int:
        return self.conn_p.shape[-1]

    # The kernels' operand records, made (and checked, on the first
    # launch) once per instance: a copy (``.to()``, ``dataclasses.replace``,
    # a shard) makes its own.  None: a degree the kernel does not take.
    @functools.cached_property
    def q1_operands(self) -> Optional[ga.Q1Operands]:
        if not ga.takes_q1(self.psi_p_at_pq, self.dref_p_at_pq, self.dim):
            return None
        return ga.Q1Operands(self.conn_p, self.psi_p_at_pq,
                             self.dref_p_at_pq, self.jinv_p, self.jxw_p,
                             self.cell_offsets, self.plan_p)

    @functools.cached_property
    def elasticity_operands(self) -> Optional[ga.ElasticityOperands]:
        if not ga.takes_elasticity(self.dref_u_at_uq, self.dim):
            return None
        # the Q1 map's gradients and the weights at the Q2 Gauss points
        dn1, weights = (torch.as_tensor(a, dtype=self.dtype,
                                        device=self.device)
                        for a in map_tables(self.dim, 3))
        return ga.ElasticityOperands(self.conn_u, self.dref_u_at_uq,
                                     self.jinv_u, self.jxw_u,
                                     self.cell_offsets, dn1, weights,
                                     self.lam, self.mu, self.plan_u)

    def _q1(self, x, alpha, beta):
        """``alpha M x + beta L x`` through the Q1 kernel wrapper (which
        takes the plain twin for a CPU tensor), or the plain twin itself
        for a pressure degree the kernel does not take."""
        op = self.q1_operands
        if op is None:
            return ga.generic_q1_apply_plain(
                x, self.conn_p, self.psi_p_at_pq, self.dref_p_at_pq,
                self.jinv_p, self.jxw_p, alpha, beta, self.plan_p)
        return ga.generic_q1_apply(x.contiguous(), op, alpha, beta)

    def mass(self, p):
        return self._q1(p, 1.0, 0.0)

    def laplace(self, p):
        return self._q1(p, 0.0, 1.0)

    def pressure_operator(self, x, alpha, beta):
        """``alpha M x + beta L x`` (the generic pressure Jacobian): one
        kernel launch on the card; the plain form is ``alpha * mass(x) +
        beta * laplace(x)`` in that order, through this class's own
        applies (never ``self.mass``: the psum form sums its applies and
        the ghost form halos them, each once, around this method)."""
        return self._q1(x, alpha, beta)

    def elasticity(self, u):
        op = self.elasticity_operands
        if op is None:
            return ga.generic_elasticity_apply_plain(
                u, self.conn_u, self.dref_u_at_uq, self.jinv_u, self.jxw_u,
                self.lam, self.mu, self.plan_u)
        return ga.generic_elasticity_apply(u.contiguous(), op)

    # ---- constraint helpers (no-ops on conforming meshes) ----------------
    @property
    def _hcp(self) -> HangingConstraints:
        if self.hc_p is None:
            self.hc_p = empty_constraints(self.dtype, self.device)
        return self.hc_p

    @property
    def _hcu(self) -> HangingConstraints:
        if self.hc_u is None:
            self.hc_u = empty_constraints(self.dtype, self.device)
        return self.hc_u

    def elasticity_constrained(self, u):
        """Hanging-node and Dirichlet constrained elasticity
        ``m Â(m u) + (1 - m) u``, ``Â = hc_u.constrained(A)``."""
        return ops.constrained_apply(self._hcu.constrained(self.elasticity),
                                     self.free_mask_u)(u)

    def to(self, device) -> "Discretization":
        """A copy with every tensor, plan and constraint table on
        ``device`` (the FE spaces stay on the host)."""
        device = resolve_device(device)
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                moved[f.name] = v.to(device)
            elif isinstance(v, ops.ScatterPlan):
                moved[f.name] = ops.ScatterPlan(v.table.to(device),
                                                v.n_values)
            elif isinstance(v, HangingConstraints):
                moved[f.name] = v.to(device)
        return dataclasses.replace(self, device=device, **moved)

    def coupling_rhs(self, p, biot_coef):
        return ops.coupling_rhs(p, self.conn_p, self.plan_u,
                                self.psi_p_at_uq, self.dref_u_at_uq,
                                self.jinv_u, self.jxw_u, biot_coef)

    def strain_projection_rhs(self, u):
        return ops.strain_projection_rhs(u, self.conn_u, self.plan_p,
                                         self.psi_p_at_pq, self.dref_u_at_pq,
                                         self.jinv_p, self.jxw_p)


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


def build_discretization(mesh: Mesh, data: InputData,
                         pressure_degree: int = 1,
                         displacement_degree: int = 2,
                         dtype=None, device="cuda") -> Discretization:
    """The Q2/Q1 problem on ``mesh`` (2D quads or 3D hexes, any
    straight-edged shape) on ``device`` (default the card; raises without
    one, pass ``device="cpu"`` for the CPU).  ``dtype`` defaults to the
    deck's."""
    dim = mesh.dim
    if dim not in (2, 3):
        raise NotImplementedError(f"the torch port runs 2D and 3D meshes; "
                                  f"got dim={dim}")
    if dtype is None:
        dtype = torch.float64 if data.dtype == "float64" else torch.float32
    device = resolve_device(device)

    p_space = build_fe_space(mesh, pressure_degree)
    u_space = build_fe_space(mesh, displacement_degree)

    # quadratures: QGauss(fe.degree + 1) per space
    pq_pts, pq_wts = gauss_tensor(pressure_degree + 1, dim)
    uq_pts, uq_wts = gauss_tensor(displacement_degree + 1, dim)
    corner_xyz = mesh.vertices[mesh.cells]
    jinv_p, jxw_p = geometry_factors(corner_xyz, pq_pts, pq_wts)
    jinv_u, jxw_u = geometry_factors(corner_xyz, uq_pts, uq_wts)

    psi_p_at_pq, dref_p_at_pq = shape_tables(pressure_degree, dim, pq_pts)
    psi_p_at_uq, _ = shape_tables(pressure_degree, dim, uq_pts)
    psi_u_at_uq, dref_u_at_uq = shape_tables(displacement_degree, dim,
                                             uq_pts)
    _, dref_u_at_pq = shape_tables(displacement_degree, dim, pq_pts)

    # cells-last layouts
    conn_p = np.ascontiguousarray(p_space.cell_nodes.T)
    conn_u = np.ascontiguousarray(u_space.vector_cell_dofs(dim).T)
    t_jinv = lambda a: np.ascontiguousarray(  # noqa: E731
        np.transpose(a, (1, 2, 3, 0)))       # (E,Q,m,d) -> (Q,m,d,E)
    t_jxw = lambda a: np.ascontiguousarray(a.T)  # noqa: E731

    # physical coordinates of the pressure quadrature points (the well)
    n1_at_pq, _ = shape_tables(1, dim, pq_pts)
    x_q = np.einsum("qv,evd->eqd", n1_at_pq, corner_xyz)

    f_well = _well_vector(p_space, data, jxw_p, psi_p_at_pq, x_q)
    f_neumann = _neumann_vector(mesh, u_space, data) \
        + _body_force_vector(u_space, data, jxw_u, psi_u_at_uq)
    free_np, dirichlet_np = _dirichlet_constraints(mesh, u_space, data)
    free_p_np, dirichlet_p_np = _pressure_dirichlet(mesh, p_space, data)

    lam, mu = data.lame_constant, data.shear_modulus
    n_pdofs = p_space.n_nodes
    n_udofs = u_space.n_nodes * dim
    jinv_p_cl, jxw_p_cl = t_jinv(jinv_p), t_jxw(jxw_p)
    jinv_u_cl, jxw_u_cl = t_jinv(jinv_u), t_jxw(jxw_u)
    diag_mass = ops.mass_diagonal(conn_p, psi_p_at_pq, jxw_p_cl, n_pdofs)
    diag_lap = ops.laplace_diagonal(conn_p, dref_p_at_pq, jinv_p_cl,
                                    jxw_p_cl, n_pdofs)
    diag_el = ops.elasticity_diagonal(conn_u, dref_u_at_uq, jinv_u_cl,
                                      jxw_u_cl, lam, mu, n_udofs)
    diag_el = np.where(free_np, diag_el, 1.0)

    dev = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float64), dtype=dtype, device=device)
    idx = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.int32), device=device)
    return Discretization(
        dim=dim, dtype=dtype, device=device,
        pressure_space=p_space, displacement_space=u_space,
        conn_p=idx(conn_p), conn_u=idx(conn_u),
        plan_p=ops.scatter_plan(conn_p, n_pdofs, device),
        plan_u=ops.scatter_plan(conn_u, n_udofs, device),
        psi_p_at_pq=dev(psi_p_at_pq), dref_p_at_pq=dev(dref_p_at_pq),
        psi_p_at_uq=dev(psi_p_at_uq), dref_u_at_uq=dev(dref_u_at_uq),
        dref_u_at_pq=dev(dref_u_at_pq),
        jinv_u=dev(jinv_u_cl), jxw_u=dev(jxw_u_cl),
        jinv_p=dev(jinv_p_cl), jxw_p=dev(jxw_p_cl),
        cell_offsets=dev(corner_offsets(corner_xyz)),
        free_mask_u=dev(free_np), dirichlet_values=dev(dirichlet_np),
        f_neumann=dev(f_neumann), f_well=dev(f_well),
        free_mask_p=dev(free_p_np), dirichlet_values_p=dev(dirichlet_p_np),
        diag_mass=dev(diag_mass), diag_laplace=dev(diag_lap),
        diag_elasticity=dev(diag_el), lam=lam, mu=mu)
