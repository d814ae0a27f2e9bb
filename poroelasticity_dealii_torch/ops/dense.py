"""Element matrices and scipy global assembly, host numpy (port of
``poroelasticity_dealii_tpu/ops/dense.py``): the uniform-grid element
matrices the stencils and kernels fold in, and the dense coarse-grid
operator of the pressure multigrid."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..mesh.core import FESpace
from .quadrature import gauss_tensor
from .shape import shape_tables
from .geometry import geometry_factors


def _geo(space: FESpace, n_q1d: int):
    mesh = space.mesh
    pts, wts = gauss_tensor(n_q1d, mesh.dim)
    jinv, jxw = geometry_factors(mesh.vertices[mesh.cells], pts, wts)
    return jinv, jxw, pts


def mass_element_matrices(space: FESpace, n_q1d=None):
    n_q1d = n_q1d or (space.degree + 1)
    jinv, jxw, pts = _geo(space, n_q1d)
    psi, _ = shape_tables(space.degree, space.mesh.dim, pts)
    return np.einsum("eq,qi,qj->eij", jxw, psi, psi)


def laplace_element_matrices(space: FESpace, n_q1d=None):
    n_q1d = n_q1d or (space.degree + 1)
    jinv, jxw, pts = _geo(space, n_q1d)
    _, dpsi = shape_tables(space.degree, space.mesh.dim, pts)
    g = np.einsum("qnm,eqmd->eqnd", dpsi, jinv)
    return np.einsum("eq,eqnd,eqjd->enj", jxw, g, g)


def elasticity_element_matrices(space: FESpace, lam, mu, n_q1d=None):
    """K_e over interleaved vector dofs ((node, comp) -> node*dim + comp)."""
    dim = space.mesh.dim
    n_q1d = n_q1d or (space.degree + 1)
    jinv, jxw, pts = _geo(space, n_q1d)
    _, dpsi = shape_tables(space.degree, dim, pts)
    g = np.einsum("qnm,eqmd->eqnd", dpsi, jinv)      # (E,Q,N,dim)
    # lam * div(phi_nc) div(phi_md) + mu * (delta_cd grad.grad + G_nd G_mc)
    a = np.einsum("eq,eqnc,eqmd->encmd", jxw, g, g)
    gg = np.einsum("eq,eqnj,eqmj->enm", jxw, g, g)
    E, _, N, _ = g.shape
    K = lam * a + mu * a.transpose(0, 1, 4, 3, 2)
    K = K + mu * gg[:, :, None, :, None] * np.eye(dim)[None, None, :, None, :]
    return K.reshape(E, N * dim, N * dim)


def assemble_global(element_matrices, conn, n_dofs):
    """COO scatter of element matrices into a scipy CSR matrix."""
    E, N, _ = element_matrices.shape
    rows = np.repeat(conn, N, axis=1).reshape(-1)
    cols = np.tile(conn, (1, N)).reshape(-1)
    return sp.coo_matrix(
        (element_matrices.reshape(-1), (rows, cols)),
        shape=(n_dofs, n_dofs)).tocsr()
