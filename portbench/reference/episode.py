"""A plain fixed-stress episode on :class:`.fem.Problem`: the reference put
in the program's place.

The deck's scheme (deal.II's ``PoroelasticityFSS``): each time step runs
fixed-stress iterations of a pressure inner loop (solve the flow
Jacobian ``M / (M_b dt) + (k / mu) L`` against the flow residual, move
the volumetric strain by the predictor ``(b / K) dp``, until the residual
is under the pressure tolerance), a mechanics solve at the new pressure
and the projection of the normal strains, until the flow residual is
under the FSS tolerance; then the shear strains are projected.  The
volumetric strain moves only through the predictor, and the flow
equation compares it with the t = 0 strain.  Every solve is Jacobi-
preconditioned CG.  The benchmark's own runs never call this module: the
CPU tests hold the program's episode to it.
"""

from __future__ import annotations

import dataclasses

import torch

from .fem import SHEAR, VOLUMETRIC, Problem


@dataclasses.dataclass
class RefState:
    p: torch.Tensor
    u: torch.Tensor
    eps_v: torch.Tensor
    eps_v0: torch.Tensor
    strains: torch.Tensor        # (6, n_p)


def pcg(apply, b, x0, diag, tol, max_iter: int):
    """Jacobi-preconditioned CG, one system per row of ``b`` (or a single
    vector); each stops once its residual norm is at most its ``tol``.
    Returns (x, iterations of the slowest row, every row converged)."""
    x = x0.clone()
    r = b - apply(x)
    z = r / diag
    d = z.clone()
    rz = (r * z).sum(-1, keepdim=True)
    tol = torch.as_tensor(tol, dtype=b.dtype, device=b.device)
    if tol.dim() < rz.dim():
        tol = tol.reshape(rz.shape)
    k = 0
    while True:
        active = torch.linalg.norm(r, dim=-1, keepdim=True) > tol
        if not bool(active.any()) or k >= max_iter:
            return x, k, not bool(active.any())
        ad = apply(d)
        alpha = torch.where(active, rz / (d * ad).sum(-1, keepdim=True),
                            torch.zeros_like(rz))
        x = x + alpha * d
        r = r - alpha * ad
        z = r / diag
        rz_new = (r * z).sum(-1, keepdim=True)
        beta = torch.where(active, rz_new / rz, torch.zeros_like(rz))
        d = z + beta * d
        rz = torch.where(active, rz_new, rz)
        k += 1


class Episode:
    """The deck's time steps on problem ``P``."""

    def __init__(self, P: Problem):
        self.P, self.ph = P, P.phys
        m = P.free_u
        self._diag_u = torch.where(m > 0, P.diag_elasticity,
                                   torch.ones_like(m))
        ph = self.ph
        self._alpha = 1.0 / (ph.biot_modulus * ph.dt)
        self._beta = ph.perm / ph.visc
        self._diag_p = self._alpha * P.diag_mass \
            + self._beta * P.diag_laplace

    def _jacobian(self, x):
        P = self.P
        return self._alpha * P.mass(x) + self._beta * P.laplace(x)

    def mechanics(self, p, u_warm, bc: float):
        """u on the free dofs from K u = b int p div v, bc * the Dirichlet
        values on the others."""
        P, ph, m = self.P, self.ph, self.P.free_u
        g = bc * P.dirichlet_u
        b = m * (P.coupling(p) - P.elasticity(g)) + (1.0 - m) * g
        tol = ph.mech_cg_tol * (torch.linalg.norm(b)
                                if ph.mech_cg_relative else 1.0)

        def apply(x):
            return m * P.elasticity(m * x) + (1.0 - m) * x
        x0 = m * u_warm + (1.0 - m) * g
        return pcg(apply, b, x0, self._diag_u, tol, ph.cg_max)[0]

    def project(self, u, lanes, warm):
        """The L2 projection of the strain components ``lanes`` of u."""
        P, ph = self.P, self.ph
        rhs = P.projection_rhs(u)[list(lanes)]
        tol = ph.projection_cg_tol * torch.linalg.norm(rhs, dim=-1)
        return pcg(P.mass, rhs, warm, P.diag_mass.expand_as(rhs), tol,
                   ph.cg_max)[0]

    def initial_state(self, bc: float = 1.0) -> RefState:
        P, ph = self.P, self.ph
        p = torch.full((P.n_p,), ph.p_init, dtype=P.dtype, device=P.device)
        u = self.mechanics(p, torch.zeros(P.n_u, dtype=P.dtype,
                                          device=P.device), bc)
        strains = torch.zeros((6, P.n_p), dtype=P.dtype, device=P.device)
        strains[list(VOLUMETRIC)] = self.project(
            u, VOLUMETRIC, strains[list(VOLUMETRIC)])
        eps_v = strains[list(VOLUMETRIC)].sum(0)
        return RefState(p, u, eps_v, eps_v.clone(), strains)

    def step(self, s: RefState, bc: float) -> RefState:
        P, ph = self.P, self.ph
        p_old, p, eps_v, u = s.p, s.p, s.eps_v, s.u
        strains = s.strains.clone()
        err, it = 2.0 * ph.pressure_tol, 0
        while it < ph.max_fss and err > ph.fss_tol:
            r = P.flow_residual(p, p_old, eps_v, s.eps_v0)
            k = 0
            while k < ph.max_pressure and \
                    float(torch.linalg.norm(r)) > ph.pressure_tol:
                dp = pcg(self._jacobian, r, torch.zeros_like(r),
                         self._diag_p, ph.pressure_cg_tol
                         * torch.linalg.norm(r), ph.cg_max)[0]
                p = p + dp
                eps_v = eps_v + (ph.biot / ph.bulk) * dp
                r = P.flow_residual(p, p_old, eps_v, s.eps_v0)
                k += 1
            u = self.mechanics(p, u, bc)
            strains[list(VOLUMETRIC)] = self.project(
                u, VOLUMETRIC, strains[list(VOLUMETRIC)])
            err = float(torch.linalg.norm(
                P.flow_residual(p, p_old, eps_v, s.eps_v0)))
            it += 1
        strains[list(SHEAR)] = self.project(u, SHEAR, strains[list(SHEAR)])
        return RefState(p, u, eps_v, s.eps_v0, strains)

    def run(self, steps: int) -> list:
        """The start state and one state per step, at the deck's load."""
        states = [self.initial_state()]
        for _ in range(steps):
            states.append(self.step(states[-1], 1.0))
        return states
