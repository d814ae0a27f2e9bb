"""Geometric multigrid for the scalar Q1 pressure Jacobian (port of
``poroelasticity_dealii_tpu/solvers/multigrid.py:51-69, 172-233, 266-534,
582-607`` for the flat scalar Q1 case).

* level operators: the Q1 slice stencil of that level's uniform element
  matrix, Dirichlet-masked;
* smoothers: Chebyshev-accelerated Jacobi, a fixed polynomial, with a
  Gershgorin upper bound on lmax(D^{-1}A) built on the host (no random
  numbers);
* transfers: exact Q1 nodal interpolation and its exact transpose, as
  per-axis copy/average sweeps;
* coarsest level: a dense inverse built on the host in float64, applied
  as one matrix-vector product.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import numpy as np
import torch

from ..config import InputData
from ..mesh.generator import hyper_rectangle
from ..mesh.qk import build_fe_space
from ..mesh.structured import build_structured_space, structured_mesh
from ..ops import dense
from ..ops.operators import constrained_apply
from ..ops.stencil import make_q1_slices_apply
from .discretization import _pressure_dirichlet


def chebyshev_smooth(apply_a: Callable, inv_diag, b, degree: int,
                     lmax: float, lmin: float):
    """Degree-``degree`` Chebyshev polynomial of the Jacobi-preconditioned
    operator targeting [lmin, lmax] of D^{-1}A, applied to b from x = 0."""
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    x = inv_diag * b / theta
    r = b - apply_a(x)
    p = x
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        p = (rho_new * rho) * p + (2.0 * rho_new / delta) * (inv_diag * r)
        x = x + p
        r = b - apply_a(x)
        rho = rho_new
    return x


def _q1_interp_axis(A: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-axis Q1 embedding: size m+1 -> 2m+1 (even = copy, odd = mean)."""
    m1 = A.shape[axis]
    head = A.narrow(axis, 0, m1 - 1)
    mid = 0.5 * (head + A.narrow(axis, 1, m1 - 1))
    B = torch.stack([head, mid], dim=axis + 1)
    shp = list(A.shape)
    shp[axis] = 2 * (m1 - 1)
    return torch.cat([B.reshape(shp), A.narrow(axis, m1 - 1, 1)], dim=axis)


def _q1_restrict_axis(A: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact transpose of :func:`_q1_interp_axis`: size 2m+1 -> m+1,
    rc[i] = ev[i] + (od[i-1] + od[i]) / 2."""
    m = (A.shape[axis] - 1) // 2
    shp = list(A.shape)
    shp[axis:axis + 1] = [m, 2]
    pairs = A.narrow(axis, 0, 2 * m).reshape(shp)
    ev = torch.cat([pairs.select(axis + 1, 0), A.narrow(axis, 2 * m, 1)],
                   dim=axis)
    od = pairs.select(axis + 1, 1)
    zero = torch.zeros_like(od.narrow(axis, 0, 1))
    od_lo = torch.cat([zero, od], dim=axis)
    od_hi = torch.cat([od, zero], dim=axis)
    return ev + 0.5 * (od_lo + od_hi)


def _q1_direct_transfers(dim: int, nc: int):
    """(raw_prolong, raw_restrict) of the scalar Q1 space on an
    nc-cells-per-axis coarse grid (flat vectors in and out)."""
    gc = nc + 1

    def raw_p(xc):
        X = xc.reshape((gc,) * dim)
        for a in range(dim):
            X = _q1_interp_axis(X, a)
        return X.reshape(-1)

    def raw_r(yf):
        Y = yf.reshape((2 * nc + 1,) * dim)
        for a in range(dim):
            Y = _q1_restrict_axis(Y, a)
        return Y.reshape(-1)

    return raw_p, raw_r


SMOOTHER_DEGREE = 3   # Chebyshev degree of both smoother sweeps


@dataclasses.dataclass
class _Level:
    apply: Callable            # Dirichlet-masked operator apply
    inv_diag: torch.Tensor
    free_mask: torch.Tensor
    lmax: float
    prolong: Callable = None   # from the next-coarser level to this one
    restrict: Callable = None  # from this level to the next-coarser one


def build_gmg(data: InputData, n_fine: int, n_levels: int, dtype, device,
              element_matrix_fn: Callable[[int], np.ndarray],
              free_mask_fn: Callable, lower=None, upper=None):
    """V-cycle preconditioner for a scalar Q1 operator on an
    ``n_fine``-cells-per-axis structured grid.

    ``element_matrix_fn``: cells per axis -> uniform (2^dim, 2^dim) cell
    matrix; ``free_mask_fn``: (mesh, space) -> bool free-dof mask.
    Returns ``(precond, levels)``."""
    dim = data.dim
    sizes = [n_fine // (2 ** lv) for lv in range(n_levels)]
    for lv, s in enumerate(sizes[1:], 1):
        if s * (2 ** lv) != n_fine:
            raise ValueError(f"n_fine={n_fine} not divisible for level {lv}")
    host = lambda a: torch.as_tensor(np.asarray(a, np.float64),  # noqa: E731
                                     dtype=dtype, device=device)

    levels: List[_Level] = []
    for lv, n in enumerate(sizes):
        mesh = structured_mesh(data.domain_size[:dim], n, lower=lower,
                               upper=upper)
        space, _ = build_structured_space(mesh, n, 1)
        free_np = free_mask_fn(mesh, space)
        free = host(free_np)
        Ke = element_matrix_fn(n)
        apply = constrained_apply(
            make_q1_slices_apply(Ke, dim, (n,) * dim, dtype, device), free)
        conn = space.cell_nodes.astype(np.int64).reshape(-1)
        n_loc = Ke.shape[0]
        diag_np = np.zeros(space.n_nodes)
        np.add.at(diag_np, conn, np.tile(np.diag(Ke), conn.size // n_loc))
        diag_np = np.where(free_np, diag_np, 1.0)
        # Gershgorin bound on lmax(D^{-1} A): an underestimate makes the
        # Chebyshev smoother amplify the top modes
        rowsum_np = np.zeros(space.n_nodes)
        np.add.at(rowsum_np, conn,
                  np.tile(np.abs(Ke).sum(axis=1), conn.size // n_loc))
        lmax = float(np.max(np.where(free_np, rowsum_np / diag_np, 1.0)))
        levels.append(_Level(apply=apply,
                             inv_diag=host(1.0 / diag_np), free_mask=free,
                             lmax=lmax))
        if lv > 0:
            raw_p, raw_r = _q1_direct_transfers(dim, n)
            ff, cf = levels[lv - 1].free_mask, free

            def prolong(xc, _rp=raw_p, _ff=ff, _cf=cf):
                return _rp(xc * _cf) * _ff

            def restrict(rf, _rr=raw_r, _ff=ff, _cf=cf):
                return _rr(rf * _ff) * _cf

            levels[lv - 1].prolong = prolong
            levels[lv - 1].restrict = restrict

    # coarsest: dense inverse of the masked operator (host, float64)
    n_c = sizes[-1]
    if (n_c + 1) ** dim > 20_000:
        raise ValueError(f"coarsest level has {(n_c + 1) ** dim} dofs — too "
                         "large for a dense inverse; use more levels")
    mesh_c = structured_mesh(data.domain_size[:dim], n_c, lower=lower,
                             upper=upper)
    space_c, _ = build_structured_space(mesh_c, n_c, 1)
    Ke_c = element_matrix_fn(n_c)
    Kg = dense.assemble_global(
        np.broadcast_to(Ke_c, (mesh_c.n_cells,) + Ke_c.shape),
        space_c.cell_nodes, space_c.n_nodes).toarray()
    free_c = free_mask_fn(mesh_c, space_c)
    Kg[~free_c, :] = 0.0
    Kg[:, ~free_c] = 0.0
    Kg[np.ix_(~free_c, ~free_c)] = np.eye((~free_c).sum())
    coarse_inv = host(np.linalg.inv(Kg))

    deg = SMOOTHER_DEGREE

    def vcycle(lv, r):
        lev = levels[lv]
        if lv == len(levels) - 1:
            return coarse_inv @ r
        lmin = lev.lmax / 8.0   # smooth the upper spectrum only
        x = chebyshev_smooth(lev.apply, lev.inv_diag, r, deg, lev.lmax, lmin)
        x = x + lev.prolong(vcycle(lv + 1, lev.restrict(r - lev.apply(x))))
        return x + chebyshev_smooth(lev.apply, lev.inv_diag,
                                    r - lev.apply(x), deg, lev.lmax, lmin)

    def precond(r):
        return vcycle(0, r)

    return precond, levels


def _uniform_cell_space(data: InputData, n: int, degree: int,
                        lower=None, upper=None):
    """1-cell space with the level's cell size (from the grid bounds when
    given, else from ``domain_size``)."""
    dim = data.dim
    if lower is not None and upper is not None:
        span = np.asarray(upper, float) - np.asarray(lower, float)
    else:
        span = np.asarray(data.domain_size[:dim], float)
    h = [span[d] / n for d in range(dim)]
    return build_fe_space(hyper_rectangle(h, cells_per_axis=1), degree)


def build_gmg_pressure(data: InputData, n_fine: int, n_levels: int, dtype,
                       device, dt: float, lower=None, upper=None):
    """V-cycle for the Q1 pressure Jacobian mass/(M dt) + (k/mu) L."""
    def emat(n):
        sp1 = _uniform_cell_space(data, n, 1, lower, upper)
        Me = dense.mass_element_matrices(sp1)[0]
        Le = dense.laplace_element_matrices(sp1)[0]
        return Me / (data.m_modulus * dt) + (data.perm / data.visc) * Le

    def fmask(mesh, space):
        free, _ = _pressure_dirichlet(mesh, space, data)
        return free

    return build_gmg(data, n_fine, n_levels, dtype, device, emat, fmask,
                     lower=lower, upper=upper)
