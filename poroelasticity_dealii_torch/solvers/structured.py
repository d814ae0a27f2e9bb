"""Structured-grid discretization in 2D and 3D (port of
``poroelasticity_dealii_tpu/solvers/structured.py:77-120, 123-184,
186-455``): Q_ku displacement and Q_kp pressure (Q2/Q1 by default) on a
uniform grid of any cells per axis.

On a uniform grid every cell has the same element matrices, built once on
the host in float64.  Every operator is a stencil (:mod:`..ops.stencil`:
the Q1 slice stencil for a scalar Q1 operator, else cell gather, one
product, slice-add scatter).  The mechanics backend is chosen by
``elasticity_backend`` (or the deck's ``TPU / Elasticity backend``), by
the JAX package's rules:

* 3D ``auto``/``pallas`` on a Q2/Q1 grid with equal cells per axis
  (rows): the mechanics runs in the comp-major row layout through
  :class:`..ops.comp_major.ElasticityRowOps`, whose elasticity, coupling
  and projection operators are the hand-written CUDA kernels on a CUDA
  device;
* 2D ``parity``, and 2D ``auto`` from :data:`PARITY_AUTO_MIN_UDOFS`
  displacement dofs, on a Q2/Q1 grid with equal cells per axis: the
  mechanics runs in the parity layout through
  :class:`..ops.parity2d.ElasticityParityOps` (plain torch products, as
  the JAX package's XLA einsums);
* ``conv`` (flat), and ``auto`` elsewhere (anisotropic grids, other
  degrees, small 2D grids): the mechanics runs on flat dof vectors, JAX's
  ``ConvGridDiscretization``: on the 3D Q2 grid with equal counts the
  elasticity apply is the hand-written flat CUDA kernel
  (``make_grid_elasticity``) on a CUDA device, and otherwise the
  plain-torch stencil.  In 3D ``auto`` resolves to it in the JAX package
  on every device but a TPU; in the port it must be asked for (a
  deliberate deviation: ``auto`` means rows at any dtype).

Every backend keeps the stencils (``elasticity``, ``coupling_rhs``,
``strain_projection_rhs``), as JAX's conv discretization does under its
rows kit.  Elasticity multigrid (:func:`..solvers.multigrid.
build_gmg_elasticity`, Q2 only) is built where JAX builds it, on equal
cells per axis: ``gmg_precond`` on flat vectors (in 3D its level operators
are the flat kernel on the card), and ``gmg_precond_rows`` on the parity
kit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from .. import resolve_device
from ..config import InputData
from ..mesh.core import FESpace
from ..mesh.generator import hyper_rectangle, normalize_cells_per_axis
from ..mesh.qk import build_fe_space
from ..mesh.structured import (GridInfo, build_structured_space,
                               structured_mesh)
from ..ops.quadrature import gauss_tensor
from ..ops.shape import shape_tables
from ..ops import dense
from ..ops import operators as ops
from ..ops.comp_major import ElasticityRowOps, make_row_ops
from ..ops.elasticity import make_grid_elasticity
from ..ops.geometry import geometry_factors
from ..ops.parity2d import ElasticityParityOps, make_parity_ops
from ..ops.stencil import make_stencil_apply
from ..ops.structured import uniform_geometry_factors
from .multigrid import build_gmg_elasticity
from .discretization import (_body_force_vector, _dirichlet_constraints,
                             _neumann_vector, _pressure_dirichlet,
                             _well_vector)


@dataclasses.dataclass
class GridDiscretization:
    """Everything the fixed-stress step reads, as tensors on one device."""

    dim: int
    dtype: torch.dtype
    device: torch.device
    pressure_space: FESpace
    displacement_space: FESpace
    info_p: GridInfo
    info_u: GridInfo
    free_mask_u: torch.Tensor       # (n_udofs,) 1 free / 0 Dirichlet
    dirichlet_values: torch.Tensor  # (n_udofs,) 0 on free dofs
    f_neumann: torch.Tensor         # (n_udofs,) traction + body force
    f_well: torch.Tensor            # (n_pdofs,)
    free_mask_p: torch.Tensor       # (n_pdofs,) drainage pinning
    dirichlet_values_p: torch.Tensor
    diag_mass: torch.Tensor
    diag_laplace: torch.Tensor
    lam: float
    mu: float
    diag_elasticity: torch.Tensor   # (n_udofs,) Jacobi, 1 on Dirichlet
    mass: Callable                  # pressure mass apply
    laplace: Callable               # pressure Laplace apply
    stencil_elasticity: Callable    # flat elasticity apply (3D Q2: kernel
                                    # on a CUDA device unless "plain")
    stencil_coupling: Callable      # flat p -> u-space RHS, Biot folded in
    stencil_projection: Callable    # flat u -> (C, n_pdofs) strain RHS
    # the mechanics kit: rows (3D), parity (2D), None on flat vectors
    row_ops: Optional[Union[ElasticityRowOps, ElasticityParityOps]]
    element_ke: np.ndarray          # (81, 81) elasticity, float64 (3D Q2;
    element_ce: np.ndarray          # 18 x 18 in 2D); (81, 8) coupling, Biot
    element_pe: np.ndarray          # folded in; (48, 81) strain projection
    # elasticity GMG V-cycle on flat vectors, and from/to the parity
    # layout on the parity kit (None where none is built)
    gmg_precond: Optional[Callable] = None
    gmg_precond_rows: Optional[Callable] = None
    gmg_setup_s: float = 0.0        # host seconds of the elasticity GMG build
    gmg_levels: int = 0             # its levels (0: none built)
    kernels: str = "auto"           # the build's ``kernels`` setting
    # a hook wrapping stencils built after construction (the solver's
    # per-dt fused pressure Jacobian): the gspmd slabs
    # (parallel/sharding.py) install it to compute those on slabs too
    wrap_pressure_stencil: Optional[Callable] = None
    # the process group of a sharded discretization (gspmd, production)
    slab_group: Optional[object] = None

    @property
    def n_pdofs(self) -> int:
        return self.free_mask_p.shape[0]

    @property
    def n_udofs(self) -> int:
        return self.free_mask_u.shape[0]

    @property
    def n_cells(self) -> int:
        return self.pressure_space.mesh.n_cells

    def elasticity(self, u):
        return self.stencil_elasticity(u)

    def elasticity_constrained(self, u):
        """Dirichlet-constrained elasticity ``m A(m u) + (1 - m) u`` (the
        reference's hanging-node wrap is the identity on structured
        grids)."""
        return ops.constrained_apply(self.stencil_elasticity,
                                     self.free_mask_u)(u)

    def coupling_rhs(self, p, biot_coef=None):
        # biot_coef is folded into the stencil at build time
        return self.stencil_coupling(p)

    def strain_projection_rhs(self, u):
        return self.stencil_projection(u)


def _single_cell_spaces(data: InputData, cells_per_axis,
                        pressure_degree: int, displacement_degree: int,
                        span=None):
    """1-cell mesh with the uniform grid's cell size, for element matrices;
    ``span`` is the physical extent per axis (default ``domain_size``)."""
    dim = data.dim
    ns = normalize_cells_per_axis(cells_per_axis, dim)
    if span is None:
        span = data.domain_size
    h = [span[d] / ns[d] for d in range(dim)]
    cell_mesh = hyper_rectangle(h, cells_per_axis=1)
    return (cell_mesh, build_fe_space(cell_mesh, pressure_degree),
            build_fe_space(cell_mesh, displacement_degree))


def _coupling_element_matrix(cell_mesh, su1, sp1, biot_coef):
    """C_e[(n,i), m] = b * int psi_m d phi_n / d x_i dx on the one cell."""
    dim = cell_mesh.dim
    pts, wts = gauss_tensor(su1.degree + 1, dim)
    jinv, jxw = geometry_factors(cell_mesh.vertices[cell_mesh.cells],
                                 pts, wts)
    jinv, jxw = jinv[0], jxw[0]                            # (Q,m,d), (Q,)
    _, dref_u = shape_tables(su1.degree, dim, pts)
    psi_p, _ = shape_tables(sp1.degree, dim, pts)
    g = np.einsum("qnm,qmd->qnd", dref_u, jinv)            # phys grads
    ce = biot_coef * np.einsum("q,qm,qnd->ndm", jxw, psi_p, g)
    return ce.reshape(dref_u.shape[1] * dim, psi_p.shape[1])


def _projection_element_matrix(cell_mesh, su1, sp1):
    """P_e[(i_p * C + c), (m, j)] = int psi_i eps_c(phi_mj) dx."""
    dim = cell_mesh.dim
    pts, wts = gauss_tensor(sp1.degree + 1, dim)
    jinv, jxw = geometry_factors(cell_mesh.vertices[cell_mesh.cells],
                                 pts, wts)
    jinv, jxw = jinv[0], jxw[0]
    _, dref_u = shape_tables(su1.degree, dim, pts)
    psi_p, _ = shape_tables(sp1.degree, dim, pts)
    g = np.einsum("qnm,qmd->qnd", dref_u, jinv)
    pairs = ops.VOIGT_PAIRS[dim]
    Np, Nu, C = psi_p.shape[1], dref_u.shape[1], len(pairs)
    P = np.zeros((Np * C, Nu * dim))
    for c, (a, b) in enumerate(pairs):
        # eps_c(phi_mj) = 0.5 (delta_ja G[m,b] + delta_jb G[m,a])
        B = np.zeros((len(wts), Nu, dim))
        B[:, :, a] += 0.5 * g[:, :, b]
        B[:, :, b] += 0.5 * g[:, :, a]
        P[c::C, :] = np.einsum("q,qi,qmj->imj", jxw, psi_p,
                               B).reshape(Np, Nu * dim)
    return P


def build_grid_discretization(data: InputData,
                              cells_per_axis: Optional[int] = None,
                              pressure_degree: int = 1,
                              displacement_degree: int = 2,
                              dtype=None, lower=None, upper=None,
                              multigrid: str = "auto",
                              elasticity_backend: Optional[str] = None,
                              device="cuda",
                              kernels: str = "auto") -> GridDiscretization:
    """The Q_ku / Q_kp discretization (2D or 3D, any cells per axis) on
    ``device`` (default the card; raises without one, pass
    ``device="cpu"`` for the CPU).

    ``elasticity_backend`` (default: the deck's): ``auto``, ``pallas``,
    ``parity`` or ``conv``, resolved as the module docstring says; the rows
    and parity kits need equal cells per axis and Q2/Q1 (the JAX package's
    errors).  ``kernels="auto"`` sends each row-layout operator, and on a
    CUDA device the 3D Q2 flat elasticity apply (``stencil_elasticity``,
    the conv backend's mechanics operator, and each level operator of the
    elasticity V-cycle) through its kernel wrapper (CUDA kernel on a CUDA
    device, plain twin on the CPU); ``kernels="plain"`` forces the plain
    twins and the plain stencil on any device, for comparing a run against
    the kernels.  ``multigrid``: elasticity GMG, ``auto`` (from 150,000
    displacement dofs, and never on the 3D rows backend), ``on`` or
    ``off``, JAX's rule; it is built on equal cells per axis only, and
    ``on`` raises on an anisotropic grid."""
    dim = data.dim
    if cells_per_axis is None:
        cells_per_axis = getattr(data, "cells_per_axis", None) \
            or 2 ** data.initial_refinement_level
    cells_per_axis = normalize_cells_per_axis(cells_per_axis, dim)
    if dim not in (2, 3):
        raise NotImplementedError(f"structured grids are 2D or 3D; got "
                                  f"dim={dim}")
    isotropic = len(set(cells_per_axis)) == 1
    kp, ku = pressure_degree, displacement_degree
    eb = elasticity_backend or data.elasticity_backend
    if eb not in ("auto", "pallas", "parity", "conv"):
        raise ValueError(f"unknown elasticity backend {eb!r}")
    # the JAX package's kit rules (structured.py:317-376): the parity kit
    # for 2D Q2/Q1 on equal counts, the rows kit for 3D Q2 on equal counts;
    # the rows kernels take Q1 pressure, so the port asks for it too
    eligible2d = dim == 2 and (ku, kp) == (2, 1) and isotropic
    eligible3d = dim == 3 and (ku, kp) == (2, 1) and isotropic
    if eb == "parity" and not eligible2d:
        raise NotImplementedError(
            "parity elasticity backend needs a 2D Q2/Q1 space with equal "
            f"cells per axis; got dim={dim}, degree={ku}/{kp}, "
            f"cells={cells_per_axis}")
    if eb == "pallas" and not eligible3d:
        raise NotImplementedError(
            "Pallas elasticity backend needs a 3D Q2 space with equal "
            f"cells per axis; got dim={dim}, degree={ku}/{kp}, "
            f"cells={cells_per_axis}")
    if multigrid not in ("auto", "on", "off", "false", False, None):
        raise ValueError(f"unknown multigrid setting {multigrid!r}")
    if kernels not in ("auto", "plain"):
        raise ValueError(f"kernels must be 'auto' or 'plain', got {kernels!r}")
    if dtype is None:
        dtype = torch.float64 if data.dtype == "float64" else torch.float32
    device = resolve_device(device)

    mesh = structured_mesh(data.domain_size[:dim], cells_per_axis,
                           lower=lower, upper=upper)
    p_space, info_p = build_structured_space(mesh, cells_per_axis, kp)
    u_space, info_u = build_structured_space(mesh, cells_per_axis, ku)
    pq_pts, pq_wts = gauss_tensor(kp + 1, dim)
    uq_pts, uq_wts = gauss_tensor(ku + 1, dim)
    jinv_p, jxw_p = uniform_geometry_factors(mesh.vertices, cells_per_axis,
                                             pq_pts, pq_wts)
    jinv_u, jxw_u = uniform_geometry_factors(mesh.vertices, cells_per_axis,
                                             uq_pts, uq_wts)
    psi_p_at_pq, dref_p_at_pq = shape_tables(kp, dim, pq_pts)
    psi_u_at_uq, dref_u_at_uq = shape_tables(ku, dim, uq_pts)
    conn_p = np.ascontiguousarray(p_space.cell_nodes.T)
    conn_u = np.ascontiguousarray(u_space.vector_cell_dofs(dim).T)

    # physical coordinates of the pressure quadrature points (the well)
    n1_at_pq, _ = shape_tables(1, dim, pq_pts)
    x_q = np.einsum("qv,evd->eqd", n1_at_pq, mesh.vertices[mesh.cells])
    jxw_p_full = np.broadcast_to(jxw_p.T, (mesh.n_cells, jxw_p.shape[0]))
    jxw_u_full = np.broadcast_to(jxw_u.T, (mesh.n_cells, jxw_u.shape[0]))
    f_well = _well_vector(p_space, data, jxw_p_full, psi_p_at_pq, x_q)
    f_neumann = _neumann_vector(mesh, u_space, data) \
        + _body_force_vector(u_space, data, jxw_u_full, psi_u_at_uq)
    free_np, dirichlet_np = _dirichlet_constraints(mesh, u_space, data)
    free_p_np, dirichlet_p_np = _pressure_dirichlet(mesh, p_space, data)

    lam, mu = data.lame_constant, data.shear_modulus
    n_pdofs, n_udofs = p_space.n_nodes, u_space.n_nodes * dim
    diag_mass = ops.mass_diagonal(conn_p, psi_p_at_pq, jxw_p, n_pdofs)
    diag_lap = ops.laplace_diagonal(conn_p, dref_p_at_pq, jinv_p, jxw_p,
                                    n_pdofs)
    diag_el = ops.elasticity_diagonal(conn_u, dref_u_at_uq, jinv_u, jxw_u,
                                      lam, mu, n_udofs)
    diag_el = np.where(free_np, diag_el, 1.0)

    span = mesh.vertices.max(axis=0) - mesh.vertices.min(axis=0)
    cell_mesh, sp1, su1 = _single_cell_spaces(data, cells_per_axis, kp, ku,
                                              span=span)
    Me = dense.mass_element_matrices(sp1)[0]
    Le = dense.laplace_element_matrices(sp1)[0]
    Ke = dense.elasticity_element_matrices(su1, lam, mu)[0]
    Ce = _coupling_element_matrix(cell_mesh, su1, sp1, data.biot_coef)
    Pe = _projection_element_matrix(cell_mesh, su1, sp1)
    n = cells_per_axis[0]
    if eb == "parity" or (eb == "auto" and eligible2d
                          and n_udofs >= PARITY_AUTO_MIN_UDOFS):
        kit = "parity"
    elif eligible3d and eb != "conv":
        kit = "rows"      # 3D 'auto' means rows here, at any dtype
    else:
        kit = "conv"
    # elasticity GMG where JAX builds it: never on the 3D rows kit with
    # 'auto'; on equal counts _gmg_levels decides; 'on' with unequal ones
    # raises (structured.py:391-411)
    if kit == "rows" and multigrid == "auto":
        n_levels = 1
    elif isotropic:
        n_levels = _gmg_levels(n, dim, n_udofs, multigrid)
    elif multigrid == "on":
        raise NotImplementedError("elasticity GMG needs equal cells per "
                                  f"axis; got {cells_per_axis}")
    else:
        n_levels = 1
    C = len(ops.VOIGT_PAIRS[dim])
    mk = lambda M, kin, kout, ci, co: make_stencil_apply(  # noqa: E731
        M, kin, kout, ci, co, dim, cells_per_axis, dtype, device)
    proj_raw = mk(Pe, ku, kp, dim, C)

    def st_proj(u):
        return proj_raw(u).reshape(-1, C).T         # (C, n_pdofs)

    st_proj.raw = proj_raw          # the node-grid apply the gspmd slabs take

    # the flat kernel takes the 3D Q2 grid with equal counts
    flat_kernel = (dim == 3 and ku == 2 and isotropic
                   and device.type == "cuda" and kernels == "auto")
    if flat_kernel:
        st_el = make_grid_elasticity(Ke, n, dtype, device)
    else:
        st_el = mk(Ke, ku, ku, dim, dim)

    if kit == "rows":
        row_ops = make_row_ops(Ke, n, free_np, diag_el, Ce, Pe, dtype,
                               device, plain=kernels == "plain")
    elif kit == "parity":
        row_ops = make_parity_ops(Ke, n, free_np, diag_el, Ce, Pe, dtype,
                                  device)
    else:
        row_ops = None
    gmg = gmg_rows = None
    gmg_setup_s = 0.0
    if n_levels >= 2:
        t0 = time.perf_counter()
        gmg, _ = build_gmg_elasticity(
            data, n_fine=n, n_levels=n_levels, dtype=dtype, device=device,
            displacement_degree=ku, lower=mesh.vertices.min(axis=0),
            upper=mesh.vertices.max(axis=0), parity_layout=kit == "parity",
            kernels=kernels)
        gmg_rows = getattr(gmg, "rows", None)
        gmg_setup_s = time.perf_counter() - t0

    dev = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float64), dtype=dtype, device=device)
    return GridDiscretization(
        dim=dim, dtype=dtype, device=device,
        pressure_space=p_space, displacement_space=u_space,
        info_p=info_p, info_u=info_u,
        free_mask_u=dev(free_np), dirichlet_values=dev(dirichlet_np),
        f_neumann=dev(f_neumann), f_well=dev(f_well),
        free_mask_p=dev(free_p_np), dirichlet_values_p=dev(dirichlet_p_np),
        diag_mass=dev(diag_mass), diag_laplace=dev(diag_lap),
        diag_elasticity=dev(diag_el), lam=lam, mu=mu,
        mass=mk(Me, kp, kp, 1, 1), laplace=mk(Le, kp, kp, 1, 1),
        stencil_elasticity=st_el, stencil_coupling=mk(Ce, kp, ku, 1, dim),
        stencil_projection=st_proj,
        row_ops=row_ops, element_ke=Ke, element_ce=Ce, element_pe=Pe,
        gmg_precond=gmg, gmg_precond_rows=gmg_rows, gmg_setup_s=gmg_setup_s,
        gmg_levels=n_levels if gmg is not None else 0, kernels=kernels)


# 'auto' switches the 2D mechanics to the parity layout from this many
# displacement dofs; below it, small decks (the pinned golden history among
# them) keep the flat path, as in the JAX package
PARITY_AUTO_MIN_UDOFS = 150_000


def _gmg_levels(n: int, dim: int, n_dofs: int, multigrid: str,
                auto_threshold: int = 150_000, degree: int = 2,
                n_comp: int = None) -> int:
    """V-cycle depth: the shallowest hierarchy (divisible cell counts,
    coarse grid >= 4 cells) whose coarsest level is dense-invertible
    (<= 8000 dofs); 'auto' enables multigrid only from ``auto_threshold``
    dofs."""
    if multigrid in ("off", "false", False, None):
        return 1
    if multigrid == "auto" and n_dofs < auto_threshold:
        return 1
    if n_comp is None:
        n_comp = dim
    best = 1
    L = 1
    while True:
        L += 1
        if n % (2 ** (L - 1)) != 0:
            break
        nc = n // (2 ** (L - 1))
        if nc < 4:
            break
        if n_comp * (degree * nc + 1) ** dim <= 8000:
            best = L
            break
    return best
