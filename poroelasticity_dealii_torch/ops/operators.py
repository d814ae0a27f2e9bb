"""Matrix-free FEM operator applies of the generic (unstructured) path, the
Voigt bookkeeping, host diagonals and the Dirichlet wrapper (port of
``poroelasticity_dealii_tpu/ops/operators.py``).

Per apply: gather the cells' dof values (``x[conn]``), contract with the
shared shape tables (``torch.einsum``, matrix products), apply the
pointwise geometric factors, contract back, and sum every dof's cell
contributions (:func:`scatter_sum`).  Every per-cell array is cells-last,
as in the reference: connectivity ``(n_local, E)``, Jacobian factors
``(Q, dim, dim, E)``, weights ``(Q, E)``.

The scatter uses no float atomics: a :class:`ScatterPlan`, built once per
connectivity on the host, lists each dof's entries of the flattened cell
values in a fixed order (padded with an index of an appended zero), and
the sum runs over that list.  The result is bitwise repeatable, which the
fixed-stress solver's skip-if-unchanged rule needs (a bitwise-equal
mechanics RHS reuses the last solution).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# unique symmetric tensor components, the reference's TensorIndexer order
#   2D: xx, xy, yy       3D: xx, xy, xz, yy, yz, zz
VOIGT_PAIRS = {
    1: [(0, 0)],
    2: [(0, 0), (0, 1), (1, 1)],
    3: [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)],
}
VOLUMETRIC_ENTRIES = {1: [0], 2: [0, 2], 3: [0, 3, 5]}
SHEAR_ENTRIES = {1: [], 2: [1], 3: [1, 2, 4]}


# --------------------------------------------------------------------------
# deterministic scatter
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """Dof-major incidence of a connectivity ``conn (N, E)``: row ``i`` of
    ``table (n_dofs, V)`` holds the flat indices ``n * E + e`` of every
    entry of ``conn`` equal to ``i``, ascending, padded to the largest
    valence ``V`` with ``n_values`` (the index of a zero appended to the
    values)."""
    table: torch.Tensor
    n_values: int


def scatter_plan(conn: np.ndarray, n_dofs: int, device) -> ScatterPlan:
    """The :class:`ScatterPlan` of ``conn`` (host numpy), on ``device``;
    int32 indices.  Negative entries of ``conn`` are left out of the plan
    (the phantom cells of AMR bucketing, the zero-weight entries of a
    hanging-node table): their values are never read."""
    flat = np.asarray(conn).reshape(-1)
    live = np.flatnonzero(flat >= 0)
    order = live[np.argsort(flat[live], kind="stable")]  # by dof, then index
    counts = np.bincount(flat[live], minlength=n_dofs)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    dofs = flat[order]
    table = np.full((n_dofs, max(int(counts.max(initial=0)), 1)), flat.size,
                    dtype=np.int32)
    table[dofs, np.arange(order.size) - start[dofs]] = order
    return ScatterPlan(table=torch.as_tensor(table, device=device),
                       n_values=flat.size)


def scatter_sum(values: torch.Tensor, plan: ScatterPlan) -> torch.Tensor:
    """Sum per-cell values into dof vectors: ``values (..., N, E)`` with
    the plan's connectivity shape in its last two axes -> ``(..., n_dofs)``;
    each dof's entries summed in the plan's fixed order."""
    lead = values.shape[:-2]
    flat = torch.nn.functional.pad(values.reshape(*lead, plan.n_values),
                                   (0, 1))
    return flat[..., plan.table].sum(-1)


def _host_scatter_sum(values, conn, n_dofs):
    """Host (numpy) twin of :func:`scatter_sum` for set-up assembly."""
    out = np.zeros(n_dofs, dtype=np.asarray(values).dtype)
    np.add.at(out, np.asarray(conn).reshape(-1),
              np.ascontiguousarray(values).reshape(-1))
    return out


# --------------------------------------------------------------------------
# compute cores: local dof values in, local contributions out, cells in the
# trailing axis; the jinv contractions unrolled over the (small) dim
# --------------------------------------------------------------------------

def _apply_jinv(r, jinv):
    """h[q,i,j,E] = sum_m r[q,m,i,E] * jinv[q,m,j,E]."""
    h = r[:, 0, :, None, :] * jinv[:, 0, None, :, :]
    for m in range(1, jinv.shape[1]):
        h = h + r[:, m, :, None, :] * jinv[:, m, None, :, :]
    return h


def _apply_jinv_T(s, jinv):
    """t[q,m,i,E] = sum_j s[q,i,j,E] * jinv[q,m,j,E]."""
    t = s[:, None, :, 0, :] * jinv[:, :, None, 0, :]
    for j in range(1, jinv.shape[1]):
        t = t + s[:, None, :, j, :] * jinv[:, :, None, j, :]
    return t


def mass_core(pe, psi, jxw):
    """pe (..., N, E) -> M_e pe (..., N, E)."""
    v = torch.einsum("qn,...nE->...qE", psi, pe)
    return torch.einsum("qn,...qE->...nE", psi, jxw * v)


def laplace_core(pe, dref, jinv, jxw):
    """pe (..., N, E) -> L_e pe (..., N, E)."""
    dim = jinv.shape[1]
    r = torch.einsum("qnm,...nE->...qmE", dref, pe)      # ref gradients
    g = r[..., :, 0, None, :] * jinv[:, 0, :, :]         # (..., q, d, E)
    for m in range(1, dim):
        g = g + r[..., :, m, None, :] * jinv[:, m, :, :]
    gw = g * jxw[:, None, :]
    t = gw[..., :, None, 0, :] * jinv[:, :, 0, :]        # (..., q, m, E)
    for d in range(1, dim):
        t = t + gw[..., :, None, d, :] * jinv[:, :, d, :]
    return torch.einsum("qnm,...qmE->...nE", dref, t)


def elasticity_core(ue, dref, jinv, jxw, lam, mu):
    """ue (N, dim, E) -> K_e ue (N*dim, E) for isotropic elasticity:
    sigma = lam tr(grad u) I + mu (grad u + grad u^T)."""
    N, dim = dref.shape[1], dref.shape[2]
    E = ue.shape[-1]
    r = torch.einsum("qnm,niE->qmiE", dref, ue)
    h = _apply_jinv(r, jinv)                             # grad u (Q,i,j,E)
    tr = h[:, 0, 0]
    for i in range(1, dim):
        tr = tr + h[:, i, i]
    sig = mu * (h + h.transpose(1, 2))
    eye = torch.eye(dim, dtype=ue.dtype, device=ue.device)[None, :, :, None]
    sig = sig + (lam * tr)[:, None, None, :] * eye
    s = sig * jxw[:, None, None, :]
    t = _apply_jinv_T(s, jinv)
    ye = torch.einsum("qnm,qmiE->niE", dref, t)
    return ye.reshape(N * dim, E)


def coupling_core(pe, psi_p_at_uq, dref_u, jinv_u, jxw_u, biot_coef):
    """pe (Np, E) -> coupling RHS contribution (Nu*dim, E):
    f[(n,i)] = int b p d phi_n / d x_i dx."""
    N, dim = dref_u.shape[1], dref_u.shape[2]
    pv = torch.einsum("qj,jE->qE", psi_p_at_uq, pe)     # p at disp q-pts
    w = biot_coef * jxw_u * pv
    t = w[:, None, None, :] * jinv_u                     # (Q, m, c, E)
    ye = torch.einsum("qnm,qmcE->ncE", dref_u, t)
    return ye.reshape(N * dim, -1)


def projection_core(ue, psi_p, dref_u_at_pq, jinv_p, jxw_p):
    """ue (Nu, dim, E) -> per-cell projection RHS (Np, C, E):
    rhs[c][i] = int psi_i eps_c(u) dx."""
    pairs = VOIGT_PAIRS[dref_u_at_pq.shape[2]]
    r = torch.einsum("qnm,niE->qmiE", dref_u_at_pq, ue)
    h = _apply_jinv(r, jinv_p)                           # grad u, p q-pts
    eps = 0.5 * (h + h.transpose(1, 2))
    comps = torch.stack([eps[:, a, b] for (a, b) in pairs], dim=1)
    return torch.einsum("qi,qcE->icE", psi_p, comps * jxw_p[:, None, :])


# --------------------------------------------------------------------------
# generic wrappers: conn (N, E) gather, plan scatter
# --------------------------------------------------------------------------

def apply_mass(p, conn, plan, psi, jxw):
    """y = M p; ``p (..., n_dofs)``, leading axes batched."""
    return scatter_sum(mass_core(p[..., conn], psi, jxw), plan)


def apply_laplace(p, conn, plan, dref, jinv, jxw):
    """y = L p; ``p (..., n_dofs)``, leading axes batched."""
    return scatter_sum(laplace_core(p[..., conn], dref, jinv, jxw), plan)


def apply_elasticity(u, conn_u, plan_u, dref, jinv, jxw, lam, mu):
    """y = K u for isotropic linear elasticity (see elasticity_core)."""
    N, dim = dref.shape[1], dref.shape[2]
    ue = u[conn_u].reshape(N, dim, conn_u.shape[-1])
    return scatter_sum(elasticity_core(ue, dref, jinv, jxw, lam, mu), plan_u)


def coupling_rhs(p, conn_p, plan_u, psi_p_at_uq, dref_u, jinv_u, jxw_u,
                 biot_coef):
    return scatter_sum(coupling_core(p[conn_p], psi_p_at_uq, dref_u, jinv_u,
                                     jxw_u, biot_coef), plan_u)


def strain_projection_rhs(u, conn_u, plan_p, psi_p, dref_u_at_pq, jinv_p,
                          jxw_p):
    """All unique strain components in one sweep: (n_voigt, n_pdofs)."""
    N, dim = dref_u_at_pq.shape[1], dref_u_at_pq.shape[2]
    ue = u[conn_u].reshape(N, dim, conn_u.shape[-1])
    ye = projection_core(ue, psi_p, dref_u_at_pq, jinv_p, jxw_p)
    return scatter_sum(ye.transpose(0, 1), plan_p)


# --------------------------------------------------------------------------
# diagonals (Jacobi preconditioning), host numpy
# --------------------------------------------------------------------------

def mass_diagonal(conn, psi, jxw, n_dofs):
    """Diagonal of the assembled mass matrix; cells-last ``conn (N, E)``
    and ``jxw (Q, E)`` (E may be 1 on uniform grids)."""
    de = np.einsum("qE,qn->nE", jxw, psi * psi)
    return _host_scatter_sum(np.broadcast_to(de, conn.shape), conn, n_dofs)


def laplace_diagonal(conn, dref, jinv, jxw, n_dofs):
    g = np.einsum("qnm,qmdE->qndE", dref, jinv)
    de = np.einsum("qE,qndE->nE", jxw, g * g)
    return _host_scatter_sum(np.broadcast_to(de, conn.shape), conn, n_dofs)


def elasticity_diagonal(conn_u, dref, jinv, jxw, lam, mu, n_udofs):
    """diag K[(n,c)] = sum_q jxw [lam G_nc^2 + mu (sum_j G_nj^2 + G_nc^2)]."""
    Q, N, dim = dref.shape
    g = np.einsum("qnm,qmdE->qndE", dref, jinv)     # physical gradients
    g2 = g * g
    sum_g2 = np.sum(g2, axis=2, keepdims=True)
    de = np.einsum("qE,qncE->ncE", jxw, (lam + mu) * g2 + mu * sum_g2)
    de = np.broadcast_to(de.reshape(N * dim, -1), conn_u.shape)
    return _host_scatter_sum(de, conn_u, n_udofs)


def constrained_apply(apply_fn, free_mask):
    """Restrict an SPD operator to the free-dof subspace: constrained rows
    and columns are replaced by the identity."""
    def apply(x):
        y = apply_fn(x * free_mask)
        return y * free_mask + x * (1.0 - free_mask)
    return apply
