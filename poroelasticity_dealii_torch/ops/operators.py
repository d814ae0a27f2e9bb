"""Voigt bookkeeping, host diagonals and the Dirichlet wrapper (port of
``poroelasticity_dealii_tpu/ops/operators.py:35-42, 202-252``)."""

from __future__ import annotations

import numpy as np

# unique symmetric tensor components, the reference's TensorIndexer order
#   2D: xx, xy, yy       3D: xx, xy, xz, yy, yz, zz
VOIGT_PAIRS = {
    1: [(0, 0)],
    2: [(0, 0), (0, 1), (1, 1)],
    3: [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)],
}
VOLUMETRIC_ENTRIES = {1: [0], 2: [0, 2], 3: [0, 3, 5]}
SHEAR_ENTRIES = {1: [], 2: [1], 3: [1, 2, 4]}


def _scatter_add(values, conn, n_dofs):
    out = np.zeros(n_dofs, dtype=np.asarray(values).dtype)
    np.add.at(out, np.asarray(conn).reshape(-1),
              np.ascontiguousarray(values).reshape(-1))
    return out


def mass_diagonal(conn, psi, jxw, n_dofs):
    """Diagonal of the assembled mass matrix; cells-last ``conn (N, E)``
    and ``jxw (Q, E)`` (E may be 1 on uniform grids)."""
    de = np.einsum("qE,qn->nE", jxw, psi * psi)
    return _scatter_add(np.broadcast_to(de, conn.shape), conn, n_dofs)


def laplace_diagonal(conn, dref, jinv, jxw, n_dofs):
    g = np.einsum("qnm,qmdE->qndE", dref, jinv)
    de = np.einsum("qE,qndE->nE", jxw, g * g)
    return _scatter_add(np.broadcast_to(de, conn.shape), conn, n_dofs)


def elasticity_diagonal(conn_u, dref, jinv, jxw, lam, mu, n_udofs):
    """diag K[(n,c)] = sum_q jxw [lam G_nc^2 + mu (sum_j G_nj^2 + G_nc^2)]."""
    Q, N, dim = dref.shape
    g = np.einsum("qnm,qmdE->qndE", dref, jinv)     # physical gradients
    g2 = g * g
    sum_g2 = np.sum(g2, axis=2, keepdims=True)
    de = np.einsum("qE,qncE->ncE", jxw, (lam + mu) * g2 + mu * sum_g2)
    de = np.broadcast_to(de.reshape(N * dim, -1), conn_u.shape)
    return _scatter_add(de, conn_u, n_udofs)


def constrained_apply(apply_fn, free_mask):
    """Restrict an SPD operator to the free-dof subspace: constrained rows
    and columns are replaced by the identity."""
    def apply(x):
        y = apply_fn(x * free_mask)
        return y * free_mask + x * (1.0 - free_mask)
    return apply
