"""Independent assembled-sparse re-execution of the reference algorithm.

Non-circular cross-validation oracle for the golden FSS convergence
history: this module re-implements the reference's *exact* algorithm with
explicitly assembled scipy.sparse matrices and scipy CG — the way the
C++/deal.II code actually executes — sharing NOTHING with the production
solver stack (no jax, no ops/operators.py, no solvers/fss.py; only the
quadrature/shape-table/geometry primitives, which are unit-tested against
closed forms, and the deck parser / BC identification).

Reference map (every step cites the C++ it re-executes):

* mass & Laplace matrices on the Q1 pressure space, QGauss(degree+1) —
  ``PoroElasticPressureSolver.h:96-101`` (MatrixCreator);
* Q2 vector elasticity stiffness ``eps(phi_i) : C : eps(phi_j)`` and the
  pressure-coupling RHS ``b p tr(eps(phi_i))`` —
  ``PoroElasticDisplacementSolver.h:216-246``; Dirichlet constraints via
  free/constrained splitting (the algebraic equivalent of deal.II's
  ``distribute_local_to_global`` elimination, ``:279-290``);
* strain projection: pressure mass matrix + per-component RHS
  ``int psi_i eps_c(u)`` — ``StrainProjector.h:101-198``;
* the well source FEM RHS — ``right_hand_side.h:99-116`` via
  ``PoroElasticPressureSolver.h:142-148``;
* Neumann traction faces with the reference's ``value * n_c`` semantics —
  ``PoroElasticDisplacementSolver.h:249-277`` (SURVEY §2.1.11);
* the FSS loop structure, including the quirks: eps_v evolves ONLY through
  the predictor ``eps_v += (b/K) du`` applied at the TOP of each inner
  iteration (``PoroelasticityFSS.h:358-384``,
  ``PoroElasticPressureSolver.h:187-194``), eps_v never resynced from the
  displacement (``PoroelasticityFSS.h:399`` commented out), reference
  strain fixed at t=0 (``:316-317``), solution_update reset once per FSS
  iteration (``:356``);
* CG tolerances: pressure/projection relative 1e-8
  (``PoroElasticPressureSolver.h:175``, ``StrainProjector.h:209``),
  mechanics absolute 1e-12 (``PoroElasticDisplacementSolver.h:298``),
  1000 iterations.  SSOR preconditioning is a CPU-sequential detail that
  changes CG iteration counts, not converged solutions; scipy's plain CG
  at the same tolerances produces the same FSS-level history.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import scipy.sparse as sparse
import scipy.sparse.linalg as spla

from .config import InputData
from .mesh.generator import hyper_rectangle
from .mesh.qk import build_fe_space
from .ops.geometry import geometry_factors
from .ops.operators import VOIGT_PAIRS, VOLUMETRIC_ENTRIES
from .ops.quadrature import gauss_tensor
from .ops.shape import shape_tables
from .solvers.discretization import (_dirichlet_constraints, _neumann_vector,
                                     _well_vector)


def _assemble(element_matrices, rows_conn, cols_conn, n_rows, n_cols):
    """COO assembly of per-cell dense blocks."""
    E, NR, NC = element_matrices.shape
    r = np.repeat(rows_conn, NC, axis=1).reshape(-1)
    c = np.tile(cols_conn, (1, NR)).reshape(-1)
    return sparse.coo_matrix(
        (element_matrices.reshape(-1), (r, c)),
        shape=(n_rows, n_cols)).tocsr()


def _cg(A, b, x0, rtol, atol, maxiter=1000):
    """scipy CG with an iteration counter (SolverControl analogue)."""
    count = [0]

    def cb(_):
        count[0] += 1

    x, info = spla.cg(A, b, x0=x0, rtol=rtol, atol=atol, maxiter=maxiter,
                      callback=cb)
    return x, count[0], info == 0


def _constraint_matrix(hc, n: int) -> sparse.csr_matrix:
    """Sparse 'distribute' matrix C of a HangingConstraints table: identity
    on non-hanging dofs; row h of a hanging dof holds its master weights
    (deal.II's ConstraintMatrix as an explicit matrix).  Cᵀ r is exactly
    ``condense_vec`` (hanging entries land on masters and zero out, since
    column h is empty), Cᵀ A C + I_hh the condensed SPD operator."""
    C = sparse.identity(n, format="lil")
    if hc is not None and not getattr(hc, "empty", True):
        h = np.asarray(hc.hanging)
        m = np.asarray(hc.masters)
        w = np.asarray(hc.weights, dtype=np.float64)
        for i, hi in enumerate(h):
            C[int(hi), int(hi)] = 0.0
            for mj, wj in zip(m[i], w[i]):
                if wj != 0.0:
                    C[int(hi), int(mj)] += float(wj)
    return C.tocsr()


class ReferenceRerun:
    """Assembled-matrix re-execution of ``PoroElasticProblem::run()``.

    Uniform box mesh by default; pass ``forest`` (an amr.QuadForest) to
    assemble on its current 1-irregular mesh with hanging-node constraints
    condensed exactly the way deal.II's ``ConstraintMatrix`` does
    (``DoFTools::make_hanging_node_constraints`` +
    ``constraints.condense``, ``PoroElasticPressureSolver.h:71-78`` /
    ``PoroElasticDisplacementSolver.h:109-137``): Ā = CᵀAC with identity
    on the hanging block, RHS/residual condensed as Cᵀr, solutions
    distributed as C x.  The constraint TABLES come from the explicit 2D
    edge builder (geometric interpolation facts, unit-tested against the
    dim-generic Lagrange-trace builder); all matrices/solves here remain
    scipy-assembled and independent of the production jax stack."""

    def __init__(self, data: InputData, forest=None):
        dim = data.dim
        self.data = data
        if forest is not None:
            mesh = forest.to_mesh()
        else:
            mesh = hyper_rectangle(data.domain_size,
                                   data.initial_refinement_level)
        self.mesh = mesh
        sp_p = build_fe_space(mesh, 1)
        sp_u = build_fe_space(mesh, 2)
        self.sp_p, self.sp_u = sp_p, sp_u
        n_p = sp_p.n_nodes
        n_u = sp_u.n_nodes * dim
        corner = mesh.vertices[mesh.cells]

        # --- pressure-space matrices, QGauss(2)  (MatrixCreator, :96-101)
        pq, pw = gauss_tensor(2, dim)
        jinv_p, jxw_p = (np.asarray(a) for a in
                         geometry_factors(corner, pq, pw))
        psi_p, dpsi_p = shape_tables(1, dim, pq)            # (Q,Np),(Q,Np,d)
        conn_p = sp_p.cell_nodes.astype(np.int64)
        me = np.einsum("eq,qi,qj->eij", jxw_p, psi_p, psi_p)
        # physical grads: dpsi[q,i,:] @ jinv[e,q] (ref-dim rows, phys cols)
        g_p = np.einsum("qid,eqdm->eqim", dpsi_p, jinv_p)
        le = np.einsum("eq,eqim,eqjm->eij", jxw_p, g_p, g_p)
        self.M = _assemble(me, conn_p, conn_p, n_p, n_p)
        self.L = _assemble(le, conn_p, conn_p, n_p, n_p)

        # --- displacement-space matrices, QGauss(3)  (:159-246)
        uq, uw = gauss_tensor(3, dim)
        jinv_u, jxw_u = (np.asarray(a) for a in
                         geometry_factors(corner, uq, uw))
        phi_u, dphi_u = shape_tables(2, dim, uq)            # scalar Q2
        psi_p_uq, _ = shape_tables(1, dim, uq)
        g_u = np.einsum("qnd,eqdm->eqnm", dphi_u, jinv_u)   # phys grads
        lam, mu = data.lame_constant, data.shear_modulus
        # vector dof (n, c): eps(phi_{nc})_ab = 0.5 (d_ac g_b + d_bc g_a)
        # K[(n,c),(m,e)] = lam tr_i tr_j + 2 mu eps_i : eps_j, with
        # tr(eps(phi_{nc})) = g_c and
        # eps_i : eps_j = 0.5 (d_ce g.g + g_e g'_c)  (standard identity)
        Nn = phi_u.shape[1]
        ke = np.zeros((mesh.n_cells, Nn * dim, Nn * dim))
        gg = np.einsum("eq,eqnm,eqom->eno", jxw_u, g_u, g_u)   # grad.grad
        for c in range(dim):
            for e in range(dim):
                blk = lam * np.einsum("eq,eqn,eqo->eno", jxw_u,
                                      g_u[:, :, :, c], g_u[:, :, :, e]) \
                    + mu * np.einsum("eq,eqn,eqo->eno", jxw_u,
                                     g_u[:, :, :, e], g_u[:, :, :, c])
                if c == e:
                    blk = blk + mu * gg
                ke[:, c::dim, e::dim] = blk
        conn_u = sp_u.vector_cell_dofs(dim).astype(np.int64)
        self.K = _assemble(ke, conn_u, conn_u, n_u, n_u)

        # coupling operator C[(n,c), m] = b int psi_m d phi_n/dx_c
        # (PoroElasticDisplacementSolver.h:227-234)
        ce = data.biot_coef * np.einsum("eq,qm,eqnc->enmc", jxw_u,
                                        psi_p_uq, g_u)
        ce2 = np.zeros((mesh.n_cells, Nn * dim, psi_p_uq.shape[1]))
        for c in range(dim):
            ce2[:, c::dim, :] = ce[:, :, :, c]
        self.C = _assemble(ce2, conn_u, conn_p, n_u, n_p)

        # projection RHS operators P_c[i, (n,e)] = int psi_i eps_c(phi_ne)
        # on the PRESSURE quadrature QGauss(2) (StrainProjector.h:126)
        _, dphi_u_pq = shape_tables(2, dim, pq)
        g_u_pq = np.einsum("qnd,eqdm->eqnm", dphi_u_pq, jinv_p)
        psi_p_pq = psi_p
        self.P = []
        for (a, b) in VOIGT_PAIRS[dim]:
            pe = np.zeros((mesh.n_cells, psi_p_pq.shape[1], Nn * dim))
            # eps_ab(phi_ne) = 0.5 (d_ae g_b + d_be g_a)
            pe[:, :, a::dim] += 0.5 * np.einsum(
                "eq,qi,eqn->ein", jxw_p, psi_p_pq, g_u_pq[:, :, :, b])
            pe[:, :, b::dim] += 0.5 * np.einsum(
                "eq,qi,eqn->ein", jxw_p, psi_p_pq, g_u_pq[:, :, :, a])
            self.P.append(_assemble(pe, conn_p, conn_u, n_p, n_u))

        # well source (right_hand_side.h:99-116)
        n1, _ = shape_tables(1, dim, pq)
        x_q = np.einsum("qv,evd->eqd", n1, corner)
        self.f_well = _well_vector(sp_p, data, jxw_p, psi_p, x_q)

        # traction faces (PoroElasticDisplacementSolver.h:249-277; the
        # value*n_c semantics of SURVEY §2.1.11) — host-side setup vector
        # from the same unit-tested primitive family as the well/BC
        # identification shared above
        self.f_neumann = _neumann_vector(mesh, sp_u, data)

        # hanging-node condensation (identity Cs on conforming meshes)
        if forest is not None:
            from .amr.constraints import build_hanging_constraints
            hc_p, hc_u = build_hanging_constraints(forest, mesh, sp_p, sp_u,
                                                   np.float64)
        else:
            hc_p = hc_u = None
        self.Cp = _constraint_matrix(hc_p, n_p)
        self.Cu = _constraint_matrix(hc_u, n_u)
        self.hang_p = np.zeros(n_p, bool)
        self.hang_u = np.zeros(n_u, bool)
        if hc_p is not None and not hc_p.empty:
            self.hang_p[np.asarray(hc_p.hanging)] = True
        if hc_u is not None and not hc_u.empty:
            self.hang_u[np.asarray(hc_u.hanging)] = True
        Ihp = sparse.diags(self.hang_p.astype(np.float64))
        self.Mc = (self.Cp.T @ self.M @ self.Cp).tocsr()
        self.Lc = (self.Cp.T @ self.L @ self.Cp).tocsr()
        self.Mbar = (self.Mc + Ihp).tocsr()
        self.Ihp = Ihp
        Kbar = (self.Cu.T @ self.K @ self.Cu
                + sparse.diags(self.hang_u.astype(np.float64))).tocsr()

        # Dirichlet split (PoroElasticDisplacementSolver.h:117-137) on the
        # condensed operator; hanging dofs are excluded from the free set
        # (their identity rows drive them to 0; distribute fills them)
        free, vals = _dirichlet_constraints(mesh, sp_u, data)
        free = free & ~self.hang_u
        self.free = free
        self.g = np.where(free | self.hang_u, 0.0, vals)
        self.Kff = Kbar[free][:, free]
        self.K_lift = Kbar[free][:, ~free] @ self.g[~free]

        self.n_p, self.n_u = n_p, n_u

    # ---- the three solves -------------------------------------------------
    def solve_mechanics(self, p, u_warm):
        """CG abs tol 1e-12 (PoroElasticDisplacementSolver.h:294-307), on
        the hanging-condensed + Dirichlet-split operator."""
        rhs = self.Cu.T @ ((self.C @ p) + self.f_neumann)
        b = rhs[self.free] - self.K_lift
        x, it, ok = _cg(self.Kff, b, u_warm[self.free], rtol=0.0,
                        atol=1e-12)
        u = self.g.copy()
        u[self.free] = x
        return self.Cu @ u, it, ok          # distribute hanging values

    def project(self, u, entries, strains):
        """Mass solves, rel tol 1e-8 (StrainProjector.h:201-232)."""
        total = 0
        for c in entries:
            b = self.Cp.T @ (self.P[c] @ u)
            x0 = np.where(self.hang_p, 0.0, strains[c])
            x, it, ok = _cg(self.Mbar, b, x0, rtol=1e-8, atol=0.0)
            strains[c] = self.Cp @ x
            total += it
        return total

    def residual(self, p, p_old, eps_v, eps_v0, dt):
        """Negated, condensed flow residual
        (PoroElasticPressureSolver.h:113-155 + constraints.condense)."""
        d = self.data
        acc = (d.biot_coef / dt) * (eps_v - eps_v0) \
            + (p - p_old) / (d.m_modulus * dt)
        r = self.M @ acc + (d.perm / d.visc) * (self.L @ p) + self.f_well
        return self.Cp.T @ (-r)

    def jacobian(self, dt):
        """Condensed pressure Jacobian (PoroElasticPressureSolver.h:158-169)."""
        d = self.data
        return (self.Mc / (d.m_modulus * dt)
                + (d.perm / d.visc) * self.Lc + self.Ihp).tocsr()

    # ---- one reference time step (the FSS loop of :347-407) --------------
    def initial_fields(self):
        """The reference's initialization (:311-317)."""
        d = self.data
        vol = VOLUMETRIC_ENTRIES[d.dim]
        p = np.full(self.n_p, d.p_init)
        u = np.zeros(self.n_u)
        u, _, _ = self.solve_mechanics(p, u)
        strains = [np.zeros(self.n_p) for _ in VOIGT_PAIRS[d.dim]]
        self.project(u, vol, strains)
        eps_v = sum(strains[c] for c in vol)
        return p, u, eps_v, eps_v.copy(), strains

    def step(self, p, u, eps_v, eps_v0, strains, time):
        """One time step; mutates nothing, returns updated fields + the
        history record (loop body of PoroelasticityFSS.h:327-413)."""
        d = self.data
        dt = d.time_step
        vol = VOLUMETRIC_ENTRIES[d.dim]
        J = self.jacobian(dt)
        p_old = p.copy()
        err = 2.0 * d.pressure_tol                        # (:345)
        fss = 0
        press_total = 0
        err_hist = []
        while fss < d.max_fss_iterations and err > d.fss_tol:
            fss += 1
            du = np.zeros(self.n_p)                       # (:356)
            p_iter = 0
            while p_iter < d.max_pressure_iterations:
                p_iter += 1
                eps_v = eps_v + (d.biot_coef / d.bulk_modulus) * du
                r = self.residual(p, p_old, eps_v, eps_v0, dt)
                err = np.linalg.norm(r)
                if err < d.pressure_tol:
                    break
                x0 = np.where(self.hang_p, 0.0, du)
                x, _, _ = _cg(J, r, x0, rtol=1e-8, atol=0.0)
                du = self.Cp @ x                          # distribute
                p = p + du
                press_total += 1
            u, _, _ = self.solve_mechanics(p, u)
            strains = [s.copy() for s in strains]
            self.project(u, vol, strains)
            # eps_v NOT resynced (:399 commented out in the reference)
            r = self.residual(p, p_old, eps_v, eps_v0, dt)
            err = np.linalg.norm(r)
            err_hist.append(float(err))
        record = {
            "time": time,
            "n_cells": self.mesh.n_cells,
            "n_pdofs": self.n_p,
            "fss_iterations": fss,
            "pressure_iterations": press_total,
            "pressure_error": float(err),
            "fss_error_history": err_hist,
        }
        return p, u, eps_v, strains, record

    # ---- the reference run loop (PoroelasticityFSS.h:295-415, no AMR) ----
    def run(self, n_steps: Optional[int] = None) -> List[dict]:
        d = self.data
        p, u, eps_v, eps_v0, strains = self.initial_fields()
        history = []
        time, step = 0.0, 0
        while time < d.t_max and (n_steps is None or step < n_steps):
            time += d.time_step
            step += 1
            p, u, eps_v, strains, rec = self.step(p, u, eps_v, eps_v0,
                                                  strains, time)
            history.append(rec)
        return history


def run_reference_algorithm(data: InputData,
                            n_steps: Optional[int] = None) -> List[dict]:
    return ReferenceRerun(data).run(n_steps)


def run_adaptive_reference_algorithm(data: InputData,
                                     n_steps: Optional[int] = None
                                     ) -> List[dict]:
    """Assembled-scipy re-execution of the reference's ADAPTIVE golden run:
    the time loop of ``PoroelasticityFSS.h:327-413`` including the
    every-``refine_every``-th-step Kelly refine/coarsen + SolutionTransfer
    (``:333-340`` + ``:448-498``), with hanging-node constraints condensed
    per :class:`ReferenceRerun`.

    The mesh-adaptation choices (Kelly indicator, fixed-fraction marks,
    forest refine/coarsen, nodal transfer) are the shared host-side numpy
    primitives also used by the production AMR driver — they are
    geometric/marking facts, unit-tested in isolation (tests/test_amr.py),
    and identical inputs must yield identical meshes for the history
    comparison to be about the SOLVER.  Every matrix, residual, and CG
    solve between remeshes remains independently assembled scipy."""
    from .amr.forest import QuadForest
    from .amr.kelly import fixed_fraction_marks, kelly_estimate
    from .amr.transfer import transfer_nodal

    d = data
    if d.dim != 2:
        raise NotImplementedError("adaptive oracle is 2D")
    size = np.asarray(d.domain_size[:2], float)
    forest = QuadForest.uniform(-size / 2, size / 2,
                                d.initial_refinement_level)
    rerun = ReferenceRerun(d, forest=forest)
    p, u, eps_v, eps_v0, strains = rerun.initial_fields()

    history: List[dict] = []
    time, step = 0.0, 0
    while time < d.t_max and (n_steps is None or step < n_steps):
        time += d.time_step
        step += 1
        if d.refine_every and step % d.refine_every == 0:
            mesh_old = rerun.mesh
            forest_old = QuadForest(forest.lower, forest.upper,
                                    set(forest.leaves))
            eta = kelly_estimate(forest, mesh_old, p)
            refine, coarsen = fixed_fraction_marks(
                forest, eta, 0.6, 0.4,
                min_level=d.initial_refinement_level,
                max_level=d.max_refinement_level)
            forest.refine_and_coarsen(refine, coarsen)
            rerun = ReferenceRerun(d, forest=forest)
            new_pts = rerun.sp_p.node_coords
            fields = np.concatenate([np.stack([p, eps_v, eps_v0]),
                                     np.asarray(strains)])
            moved = transfer_nodal(forest_old, mesh_old, fields, new_pts)
            n_voigt = len(VOIGT_PAIRS[2])
            p, eps_v, eps_v0 = moved[0], moved[1], moved[2]
            strains = [moved[3 + c] for c in range(n_voigt)]
            u_vert = u.reshape(-1, 2)[:mesh_old.n_vertices].T
            u = transfer_nodal(forest_old, mesh_old, u_vert,
                               rerun.sp_u.node_coords).T.reshape(-1)
        p, u, eps_v, strains, rec = rerun.step(p, u, eps_v, eps_v0,
                                               strains, time)
        history.append(rec)
    return history
