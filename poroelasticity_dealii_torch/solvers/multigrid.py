"""Geometric multigrid on structured grids (port of
``poroelasticity_dealii_tpu/solvers/multigrid.py:51-69, 98-233, 266-607``),
for the scalar Q_kp pressure Jacobian and the Q2 vector elasticity
operator, in 2D and 3D.

* level operators: that level's uniform element matrix as a stencil (the
  Q1 slice stencil for a scalar Q1 operator, the cell gather / product /
  slice-add stencil otherwise; on the card the 3D Q2 elasticity levels
  above the coarsest use the flat kernel instead), Dirichlet-masked;
* smoothers: Chebyshev-accelerated Jacobi, a fixed polynomial, with a
  Gershgorin upper bound on lmax(D^{-1}A) built on the host (no random
  numbers, no host read in a V-cycle);
* transfers: exact Q1 nodal interpolation and its exact transpose, as
  per-axis copy/average sweeps, for scalar Q1; for Q_k vector fields the
  Q_k embedding split by fine-cell parity, ``P = diag(ff/mult) raw_p
  diag(cf)`` and ``R = P^T`` exactly, with the multiplicity ``mult`` built
  on the host;
* 2D Q2 with ``parity_layout``: every level but the coarsest smooths in
  the parity layout (:mod:`..ops.parity2d`), and the transfers between two
  parity levels run in it too, so a V-cycle entered in parity layout
  (``precond.rows``) leaves it only at the coarsest level;
* coarsest level: a dense inverse built on the host in float64, applied
  as one matrix-vector product in the working type (full float32: TF32 is
  off).
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
from ..ops.elasticity import make_grid_elasticity
from ..ops.operators import constrained_apply
from ..ops.parity2d import (from_parity, make_apply_parity,
                            make_parity_transfers, to_parity, to_parity_np)
from ..ops.shape import node_lattice, shape_tables
from ..ops.stencil import (cell_gather, cell_scatter, make_q1_slices_apply,
                           make_stencil_apply)
from .discretization import _dirichlet_constraints, _pressure_dirichlet


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


def _parity_embedding_matrices(dim: int, degree: int, n_comp: int):
    """Q_degree embedding split per fine-subcell parity: (2^dim, NL, NL)
    with NL = (degree+1)^dim * n_comp (interleaved node*n_comp + comp)."""
    lat = node_lattice(degree, dim).astype(np.float64) / degree  # in [0,1]
    mats = []
    for s in range(2 ** dim):
        bits = [(s >> d) & 1 for d in range(dim)]
        pts = np.stack([(bits[d] + lat[:, d]) / 2.0 for d in range(dim)],
                       axis=-1) * 2.0 - 1.0
        phi, _ = shape_tables(degree, dim, pts)
        nf, nc = phi.shape
        E = np.zeros((nf * n_comp, nc * n_comp))
        for i in range(n_comp):
            E[i::n_comp, i::n_comp] = phi
        mats.append(E)
    return np.stack(mats)


def _prolong_multiplicity_np(E: np.ndarray, fine_conn: np.ndarray,
                             nf: int, dim: int, n_comp: int,
                             n_fine_dofs: int) -> np.ndarray:
    """``raw_p(ones)``, the per-fine-dof prolongation multiplicity, on the
    host: the row sums of the parity embedding matrices scattered through
    the fine space's connectivity (fine cells x-fastest; parity bit d of a
    fine cell is its coordinate along axis d modulo 2, x = bit 0)."""
    rowsum = E.sum(axis=2)                        # (2^dim, n_local)
    e = np.arange(nf ** dim)
    s = np.zeros(nf ** dim, dtype=np.int64)
    for d in range(dim):
        s |= ((e // nf ** d) % 2) << d
    out = np.zeros(n_fine_dofs)
    np.add.at(out, fine_conn.astype(np.int64).reshape(-1),
              rowsum[s].reshape(-1))
    return out


def _deinterleave_parities(v: torch.Tensor, dim: int,
                           nc: int) -> torch.Tensor:
    """(CH, (2nc)^dim) fine-cell tensor -> (2^dim, CH, nc^dim) per parity
    (parity index s = sum of bit d << d, x = bit 0)."""
    ch = v.shape[0]
    w = v.reshape((ch,) + tuple(x for _ in range(dim) for x in (nc, 2)))
    perm = [2 * d + 2 for d in range(dim)] + [0] \
        + [2 * d + 1 for d in range(dim)]
    return w.permute(perm).reshape(2 ** dim, ch, nc ** dim)


def _interleave_parities(vals: torch.Tensor, dim: int,
                         nc: int) -> torch.Tensor:
    """(2^dim, CH, nc^dim) per-parity cell tensors -> (CH, (2nc)^dim)."""
    ch = vals.shape[1]
    v = vals.reshape((2,) * dim + (ch,) + (nc,) * dim)
    perm = [dim]
    for d in range(dim):
        perm += [dim + 1 + d, d]
    return v.permute(perm).reshape(ch, (2 * nc) ** dim)


def _qk_transfers(E: np.ndarray, degree: int, dim: int, n_comp: int,
                  nc: int, dtype, device):
    """(raw_prolong, raw_restrict) of the Q_degree n_comp-vector space
    between an nc- and a 2nc-cells-per-axis grid, on flat vectors: the
    coarse cells' local values, one product with the parity embedding
    matrices, the fine cells placed by parity, and the slice-add scatter;
    ``raw_restrict`` is the exact transpose."""
    S, NL = E.shape[0], E.shape[1]
    Ecat = torch.as_tensor(E.reshape(S * NL, NL), dtype=dtype,
                           device=device)             # rows (s, a), cols b
    EcatT = Ecat.T.contiguous()
    cs, fs = (nc,) * dim, (2 * nc,) * dim

    def raw_p(xc):
        uc = cell_gather(xc, degree, cs, n_comp)      # (cells_c, NL)
        ye = (uc @ EcatT).reshape(-1, S, NL).permute(1, 2, 0)
        yf = _interleave_parities(ye, dim, nc)        # (NL, cells_f)
        return cell_scatter(yf.T, degree, fs, n_comp)

    def raw_r(yf):
        ye = _deinterleave_parities(cell_gather(yf, degree, fs, n_comp).T,
                                    dim, nc)          # (S, NL, cells_c)
        zc = ye.permute(2, 0, 1).reshape(-1, S * NL) @ Ecat
        return cell_scatter(zc, degree, cs, n_comp)

    return raw_p, raw_r


@dataclasses.dataclass
class _Level:
    apply: Callable            # Dirichlet-masked operator apply
    inv_diag: torch.Tensor
    free_mask: torch.Tensor
    lmax: float
    prolong: Callable = None   # from the next-coarser level to this one
    restrict: Callable = None  # from this level to the next-coarser one
    # the 2D parity layout (levels above the coarsest, parity_layout=True):
    # the smoother sweeps run in it, and the transfers too when the next
    # level is in it
    lto: Callable = None       # flat -> layout
    lfrom: Callable = None     # layout -> flat
    apply_l: Callable = None   # Dirichlet-masked apply, layout -> layout
    inv_diag_l: torch.Tensor = None
    prolong_l: Callable = None   # next-coarser layout -> this layout
    restrict_l: Callable = None  # this layout -> next-coarser layout


def build_gmg(data: InputData, n_fine: int, n_levels: int, dtype, device,
              element_matrix_fn: Callable[[int], np.ndarray],
              free_mask_fn: Callable, degree: int = 1, n_comp: int = 1,
              lower=None, upper=None, parity_layout: bool = False,
              level_apply_fn: Callable = None):
    """V-cycle preconditioner for a Q_degree operator on n_comp-vector
    fields on an ``n_fine``-cells-per-axis structured grid.

    ``element_matrix_fn``: cells per axis -> uniform (NL, NL) cell matrix
    (NL = (degree+1)^dim * n_comp, interleaved node*n_comp + comp);
    ``free_mask_fn``: (mesh, space) -> bool free-dof mask;
    ``parity_layout``: the 2D Q2 parity-resident levels, and
    ``precond.rows``, the V-cycle from and to the parity layout;
    ``level_apply_fn``: (element matrix, cells per axis) -> a level's
    unmasked operator apply (default the stencil).
    Returns ``(precond, levels)``."""
    dim = data.dim
    sizes = [n_fine // (2 ** lv) for lv in range(n_levels)]
    for lv, s in enumerate(sizes[1:], 1):
        if s * (2 ** lv) != n_fine:
            raise ValueError(f"n_fine={n_fine} not divisible for level {lv}")
    if parity_layout and (dim, degree) != (2, 2):
        raise NotImplementedError("parity_layout is 2D Q2 only; got "
                                  f"dim={dim}, degree={degree}")
    host = lambda a: torch.as_tensor(np.asarray(a, np.float64),  # noqa: E731
                                     dtype=dtype, device=device)
    scalar_q1 = degree == 1 and n_comp == 1
    E = None if scalar_q1 else _parity_embedding_matrices(dim, degree,
                                                          n_comp)

    levels: List[_Level] = []
    prev_conn = prev_free_np = None
    for lv, n in enumerate(sizes):
        mesh = structured_mesh(data.domain_size[:dim], n, lower=lower,
                               upper=upper)
        space, _ = build_structured_space(mesh, n, degree)
        free_np = free_mask_fn(mesh, space)
        free = host(free_np)
        Ke = element_matrix_fn(n)
        if level_apply_fn is not None:
            raw = level_apply_fn(Ke, n)
        elif scalar_q1:
            raw = make_q1_slices_apply(Ke, dim, (n,) * dim, dtype, device)
        else:
            raw = make_stencil_apply(Ke, degree, degree, n_comp, n_comp,
                                     dim, n, dtype, device)
        apply = constrained_apply(raw, free)
        conn2d = space.vector_cell_dofs(n_comp) if n_comp > 1 \
            else space.cell_nodes
        conn = conn2d.astype(np.int64).reshape(-1)
        n_loc = Ke.shape[0]
        diag_np = np.zeros(space.n_nodes * n_comp)
        np.add.at(diag_np, conn, np.tile(np.diag(Ke), conn.size // n_loc))
        diag_np = np.where(free_np, diag_np, 1.0)
        # Gershgorin bound on lmax(D^{-1} A): an underestimate makes the
        # Chebyshev smoother amplify the top modes
        rowsum_np = np.zeros(space.n_nodes * n_comp)
        np.add.at(rowsum_np, conn,
                  np.tile(np.abs(Ke).sum(axis=1), conn.size // n_loc))
        lmax = float(np.max(np.where(free_np, rowsum_np / diag_np, 1.0)))
        lev = _Level(apply=apply, inv_diag=host(1.0 / diag_np),
                     free_mask=free, lmax=lmax)
        if parity_layout and lv < len(sizes) - 1:
            # the coarsest level keeps the flat dense solve
            raw_l = make_apply_parity(Ke, n, n_comp, dtype, device)
            mask_l = host(to_parity_np(free_np, n, n_comp))

            def apply_l(xp, _r=raw_l, _m=mask_l):
                return _m * _r(xp * _m) + (1.0 - _m) * xp

            lev.apply_l = apply_l
            lev.inv_diag_l = host(to_parity_np(1.0 / diag_np, n, n_comp))
            lev.lto = lambda v, _n=n: to_parity(v, _n, n_comp)
            lev.lfrom = lambda v, _n=n: from_parity(v, _n, n_comp)
        levels.append(lev)
        if lv > 0:
            fine = levels[lv - 1]
            ff, cf = fine.free_mask, free
            if scalar_q1:
                raw_p, raw_r = _q1_direct_transfers(dim, n)

                def prolong(xc, _rp=raw_p, _ff=ff, _cf=cf):
                    return _rp(xc * _cf) * _ff

                def restrict(rf, _rr=raw_r, _ff=ff, _cf=cf):
                    return _rr(rf * _ff) * _cf
            else:
                raw_p, raw_r = _qk_transfers(E, degree, dim, n_comp, n,
                                             dtype, device)
                im = host(1.0 / _prolong_multiplicity_np(
                    E, prev_conn, 2 * n, dim, n_comp, ff.shape[0]))

                def prolong(xc, _rp=raw_p, _im=im, _ff=ff, _cf=cf):
                    return _rp(xc * _cf) * _im * _ff

                def restrict(rf, _rr=raw_r, _im=im, _ff=ff, _cf=cf):
                    return _rr(rf * _im * _ff) * _cf
            fine.prolong, fine.restrict = prolong, restrict
            if fine.apply_l is not None and lev.apply_l is not None:
                # both ends in the parity layout: the same P and R without
                # leaving it
                raw_pp, raw_rp, mult_p = make_parity_transfers(
                    n, n_comp, dtype, device)
                ffp = to_parity_np(prev_free_np, 2 * n, n_comp)
                wp = host(np.where(mult_p > 0,
                                   ffp / np.maximum(mult_p, 1.0), 0.0))
                cfp = host(to_parity_np(free_np, n, n_comp))

                def prolong_l(xc, _p=raw_pp, _w=wp, _cf=cfp):
                    return _p(xc * _cf) * _w

                def restrict_l(rf, _r=raw_rp, _w=wp, _cf=cfp):
                    return _r(rf * _w) * _cf

                fine.prolong_l, fine.restrict_l = prolong_l, restrict_l
        prev_conn, prev_free_np = conn2d, free_np.astype(np.float64)

    # coarsest: dense inverse of the masked operator (host, float64)
    n_c = sizes[-1]
    n_coarse_dofs = n_comp * (degree * n_c + 1) ** dim
    if n_coarse_dofs > 20_000:
        raise ValueError(f"coarsest level has {n_coarse_dofs} dofs — too "
                         "large for a dense inverse; use more levels")
    mesh_c = structured_mesh(data.domain_size[:dim], n_c, lower=lower,
                             upper=upper)
    space_c, _ = build_structured_space(mesh_c, n_c, degree)
    conn_c = space_c.vector_cell_dofs(n_comp) if n_comp > 1 \
        else space_c.cell_nodes
    Ke_c = element_matrix_fn(n_c)
    Kg = dense.assemble_global(
        np.broadcast_to(Ke_c, (mesh_c.n_cells,) + Ke_c.shape), conn_c,
        space_c.n_nodes * n_comp).toarray()
    free_c = free_mask_fn(mesh_c, space_c)
    Kg[~free_c, :] = 0.0
    Kg[:, ~free_c] = 0.0
    Kg[np.ix_(~free_c, ~free_c)] = np.eye((~free_c).sum())
    coarse_inv = host(np.linalg.inv(Kg))

    deg = SMOOTHER_DEGREE

    def vcycle(lv, r, in_layout=False):
        lev = levels[lv]
        if lv == len(levels) - 1:
            return coarse_inv @ r
        lmin = lev.lmax / 8.0   # smooth the upper spectrum only
        if lev.apply_l is None:
            x = chebyshev_smooth(lev.apply, lev.inv_diag, r, deg, lev.lmax,
                                 lmin)
            x = x + lev.prolong(vcycle(lv + 1,
                                       lev.restrict(r - lev.apply(x))))
            return x + chebyshev_smooth(lev.apply, lev.inv_diag,
                                        r - lev.apply(x), deg, lev.lmax,
                                        lmin)
        # parity-resident level: both sweeps and their residuals in the
        # layout, and the recursion too while the next level is in it
        rp = r if in_layout else lev.lto(r)
        x = chebyshev_smooth(lev.apply_l, lev.inv_diag_l, rp, deg, lev.lmax,
                             lmin)
        res = rp - lev.apply_l(x)
        if lev.restrict_l is not None:
            x = x + lev.prolong_l(vcycle(lv + 1, lev.restrict_l(res),
                                         in_layout=True))
        else:
            x = x + lev.lto(lev.prolong(vcycle(
                lv + 1, lev.restrict(lev.lfrom(res)))))
        x = x + chebyshev_smooth(lev.apply_l, lev.inv_diag_l,
                                 rp - lev.apply_l(x), deg, lev.lmax, lmin)
        return x if in_layout else lev.lfrom(x)

    def precond(r):
        return vcycle(0, r)

    if levels[0].apply_l is not None:
        def precond_rows(rp):
            return vcycle(0, rp, in_layout=True)

        precond.rows = precond_rows

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
                       device, dt: float, pressure_degree: int = 1,
                       lower=None, upper=None):
    """V-cycle for the Q_kp pressure Jacobian mass/(M dt) + (k/mu) L."""
    def emat(n):
        sp1 = _uniform_cell_space(data, n, pressure_degree, lower, upper)
        Me = dense.mass_element_matrices(sp1)[0]
        Le = dense.laplace_element_matrices(sp1)[0]
        return Me / (data.m_modulus * dt) + (data.perm / data.visc) * Le

    def fmask(mesh, space):
        free, _ = _pressure_dirichlet(mesh, space, data)
        return free

    return build_gmg(data, n_fine, n_levels, dtype, device, emat, fmask,
                     degree=pressure_degree, lower=lower, upper=upper)


def build_gmg_elasticity(data: InputData, n_fine: int, n_levels: int,
                         dtype, device, displacement_degree: int = 2,
                         lower=None, upper=None, parity_layout: bool = False,
                         kernels: str = "auto"):
    """V-cycle for the Dirichlet-masked Q2 elasticity operator; with
    ``parity_layout`` (2D) the returned preconditioner has ``.rows``, the
    V-cycle from and to the parity layout.  In 3D on a CUDA device with
    ``kernels="auto"`` every level above the coarsest applies its operator
    through the flat kernel (:func:`..ops.elasticity.make_grid_elasticity`,
    the conv backend's fine operator); on the CPU, or with ``"plain"``, the
    stencil."""
    if displacement_degree != 2:
        raise NotImplementedError("GMG transfer assumes Q2 displacement")
    lam, mu = data.lame_constant, data.shear_modulus
    level_apply = None
    if data.dim == 3 and torch.device(device).type == "cuda" \
            and kernels == "auto":
        def level_apply(Ke, n):
            return make_grid_elasticity(Ke, n, dtype, device)

    def emat(n):
        su1 = _uniform_cell_space(data, n, 2, lower, upper)
        return dense.elasticity_element_matrices(su1, lam, mu)[0]

    def fmask(mesh, space):
        free, _ = _dirichlet_constraints(mesh, space, data)
        return free

    return build_gmg(data, n_fine, n_levels, dtype, device, emat, fmask,
                     degree=2, n_comp=data.dim, lower=lower, upper=upper,
                     parity_layout=parity_layout, level_apply_fn=level_apply)
