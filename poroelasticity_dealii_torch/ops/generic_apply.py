"""Kernel wrappers of the generic path's operator applies
(``csrc/generic.cu``) and their launch plans.

* :func:`generic_elasticity_apply` -- ``y = K u``, isotropic elasticity with
  Q2 displacements in 2D and 3D: the counterpart of the JAX package's
  ``apply_elasticity`` (``poroelasticity_dealii_tpu/ops/operators.py:171``).
* :func:`generic_q1_apply` -- ``y = alpha M x + beta L x`` for a Q1 scalar
  field, ``x`` of shape ``(n,)`` or ``(B, n)`` with ``B <= MAX_LANES``: the
  counterpart of ``apply_mass`` (``:158``) and ``apply_laplace``
  (``:164``); the mass is the call with ``beta = 0``, the Laplacian the
  call with ``alpha = 0``, the generic pressure Jacobian one call.

Both keep the JAX layout at their interface: cells-last connectivity and
geometry (a geometry cell axis of 1 is shared by every cell), the dof-major
:class:`.operators.ScatterPlan` of the connectivity (its row count is the
output length, which may differ from the input length: ghost windows), and
any input length (the kernels read the input at the connectivity's indices
only).  A discretization hands them over once as an operand record
(:class:`ElasticityOperands`, :class:`Q1Operands`), which checks them on
its first launch; each call checks only its input vector.  On a CPU
tensor each wrapper returns its plain twin
(:func:`generic_elasticity_apply_plain`, :func:`generic_q1_apply_plain`:
the :mod:`.operators` applies, unchanged); on a CUDA tensor it launches
its kernel (two CUDA launches, a cell product pass into a scratch and an
ordered plan sum) and counts one launch in ``launches``, or raises on
what the kernel does not take.

:func:`takes_elasticity` and :func:`takes_q1` are the degree rule: the
kernels take Q2 displacements and Q1 pressures (2D or 3D) at the
reference's quadrature, QGauss(degree + 1); every other pair of degrees
runs the plain twins (``solvers/discretization.py``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from . import _cuda
from . import operators as ops
from .cell_products import sm_count

MAX_LANES = 6          # lanes of one Q1 apply (kMaxLanes)
Q1_THREADS = 128       # generic_q1_products_kernel's blocks (kQ1Threads)

# The elasticity product pass's tiles (GenericTile<T, DIM> in the source),
# by (value type, dimension): cells per tile, threads per block and resident
# blocks per SM (its __launch_bounds__).
ELASTICITY_TILE = {
    (torch.float32, 3): {"cells": 32, "threads": 256, "blocks_per_sm": 2},
    (torch.float64, 3): {"cells": 16, "threads": 128, "blocks_per_sm": 2},
    (torch.float32, 2): {"cells": 64, "threads": 128, "blocks_per_sm": 4},
    (torch.float64, 2): {"cells": 32, "threads": 128, "blocks_per_sm": 4},
}


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def elasticity_smem_bytes(dtype: torch.dtype, dim: int) -> int:
    """Dynamic shared memory of the elasticity product pass
    (``ElasticityShape<T, DIM>::kSmemBytes``): the reference gradients
    D1 (and, in float32, their transpose), the gathered values U, the
    gradients R, the tile's Jacobian factors and weights."""
    cells = ELASTICITY_TILE[(dtype, dim)]["cells"]
    nq = 3 ** dim
    qm_pad, n_pad = _round_up(nq * dim, 8), _round_up(nq, 8)
    ldx = dim * cells + 8
    elems = (qm_pad * (n_pad + 4)
             + (n_pad * (qm_pad + 4) if dtype == torch.float32 else 0)
             + n_pad * ldx + qm_pad * ldx
             + nq * dim * dim * cells + nq * cells)
    return elems * torch.tensor([], dtype=dtype).element_size()


@dataclasses.dataclass(frozen=True)
class GenericApplyPlan:
    """Launch plan of one generic apply's product pass: ``grid`` blocks
    with ``smem_bytes`` of dynamic shared memory (0: static only), writing
    a scratch of ``scratch_numel`` values (the plan sum's grid follows
    from the output length in the source)."""
    grid: int
    smem_bytes: int
    scratch_numel: int


@functools.lru_cache(maxsize=256)
def elasticity_plan(cells: int, dtype: torch.dtype, dim: int,
                    sms: int) -> GenericApplyPlan:
    """The elasticity apply's plan for ``cells`` cells on a card with
    ``sms`` multiprocessors: a persistent grid of at most one resident
    wave over tiles of cells."""
    t = ELASTICITY_TILE[(dtype, dim)]
    tiles = -(-cells // t["cells"])
    return GenericApplyPlan(
        grid=min(tiles, sms * t["blocks_per_sm"]),
        smem_bytes=elasticity_smem_bytes(dtype, dim),
        scratch_numel=dim * 3 ** dim * cells)


@functools.lru_cache(maxsize=256)
def q1_plan(cells: int, dim: int, lanes: int) -> GenericApplyPlan:
    """The Q1 apply's plan: one thread per cell, all lanes in it."""
    return GenericApplyPlan(grid=-(-cells // Q1_THREADS), smem_bytes=0,
                            scratch_numel=lanes * 2 ** dim * cells)


def takes_elasticity(dref_u, dim: int) -> bool:
    """Whether the elasticity kernel takes these displacement shape tables:
    Q2 at QGauss(3) in 2D or 3D (``dref_u`` of shape (3^dim, 3^dim,
    dim))."""
    return dim in (2, 3) and tuple(dref_u.shape) == (3 ** dim, 3 ** dim,
                                                     dim)


def takes_q1(psi_p, dref_p, dim: int) -> bool:
    """Whether the Q1 kernel takes these pressure shape tables: Q1 at
    QGauss(2) in 2D or 3D."""
    n = 2 ** dim
    return dim in (2, 3) and tuple(psi_p.shape) == (n, n) and \
        tuple(dref_p.shape) == (n, n, dim)


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def generic_elasticity_apply_plain(u, conn_u, dref, jinv, jxw, lam, mu,
                                   plan: ops.ScatterPlan):
    """Plain twin of :func:`generic_elasticity_apply`."""
    return ops.apply_elasticity(u, conn_u, plan, dref, jinv, jxw, lam, mu)


def generic_q1_apply_plain(x, conn_p, psi, dref, jinv, jxw, alpha, beta,
                           plan: ops.ScatterPlan):
    """Plain twin of :func:`generic_q1_apply`: ``alpha * M x + beta * L x``
    in that order, a zero coefficient leaving its operator out (the mass
    alone and the Laplacian alone are the unscaled applies at 1)."""
    if beta == 0:
        y = ops.apply_mass(x, conn_p, plan, psi, jxw)
        return y if alpha == 1 else alpha * y
    lap = ops.apply_laplace(x, conn_p, plan, dref, jinv, jxw)
    if alpha == 0:
        return lap if beta == 1 else beta * lap
    return alpha * ops.apply_mass(x, conn_p, plan, psi, jxw) + beta * lap


# ---------------------------------------------------------------------------
# operands: the geometry of a discretization's applies, checked once
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ElasticityOperands:
    """The elasticity apply's operands: ``conn`` (dim*3^dim, E) int32 with
    interleaved components, ``dref`` (3^dim, 3^dim, dim), ``jinv``
    (3^dim, dim, dim, Eg), ``jxw`` (3^dim, Eg), Eg = E or 1, ``lam``,
    ``mu`` and ``plan`` the scatter plan of ``conn``.  :attr:`checked`
    checks them once, on the first launch."""
    conn: torch.Tensor
    dref: torch.Tensor
    jinv: torch.Tensor
    jxw: torch.Tensor
    lam: float
    mu: float
    plan: ops.ScatterPlan

    @functools.cached_property
    def checked(self) -> tuple:
        """(dim, E, Eg, n_out, V) after the checks the kernel needs; raises
        on what it does not take."""
        dref = self.dref
        _cuda.require_cuda(dref)
        dim = dref.shape[-1] if dref.dim() == 3 else 0
        if not takes_elasticity(dref, dim):
            raise ValueError(f"the elasticity kernel takes Q2 shape tables "
                             f"(3^dim, 3^dim, dim); got {tuple(dref.shape)}")
        nq = 3 ** dim
        _cuda.check("dref", dref, (nq, nq, dim), dref.dtype, dref.device)
        E, Eg = _check_cells("conn_u", self.conn, nq * dim, self.jinv,
                             self.plan, dref)
        _cuda.check("jinv", self.jinv, (nq, dim, dim, Eg), dref.dtype,
                    dref.device)
        _cuda.check("jxw", self.jxw, (nq, Eg), dref.dtype, dref.device)
        return (dim, E, Eg) + tuple(self.plan.table.shape)


@dataclasses.dataclass(frozen=True, eq=False)
class Q1Operands:
    """The Q1 apply's operands: ``conn`` (2^dim, E) int32, ``psi`` (2^dim,
    2^dim), ``dref`` (2^dim, 2^dim, dim), ``jinv`` (2^dim, dim, dim, Eg),
    ``jxw`` (2^dim, Eg), Eg = E or 1, and ``plan`` the scatter plan of
    ``conn``.  :attr:`checked` checks them once, on the first launch."""
    conn: torch.Tensor
    psi: torch.Tensor
    dref: torch.Tensor
    jinv: torch.Tensor
    jxw: torch.Tensor
    plan: ops.ScatterPlan

    @functools.cached_property
    def checked(self) -> tuple:
        """(dim, E, Eg, n_out, V) after the checks the kernel needs; raises
        on what it does not take."""
        psi, dref = self.psi, self.dref
        _cuda.require_cuda(dref)
        dim = dref.shape[-1] if dref.dim() == 3 else 0
        if not takes_q1(psi, dref, dim):
            raise ValueError(f"the Q1 kernel takes Q1 shape tables; got psi "
                             f"{tuple(psi.shape)}, dref {tuple(dref.shape)}")
        npe = 2 ** dim
        _cuda.check("psi", psi, (npe, npe), dref.dtype, dref.device)
        _cuda.check("dref", dref, (npe, npe, dim), dref.dtype, dref.device)
        E, Eg = _check_cells("conn_p", self.conn, npe, self.jinv, self.plan,
                             dref)
        _cuda.check("jinv", self.jinv, (npe, dim, dim, Eg), dref.dtype,
                    dref.device)
        _cuda.check("jxw", self.jxw, (npe, Eg), dref.dtype, dref.device)
        return (dim, E, Eg) + tuple(self.plan.table.shape)


def _check_cells(name, conn, n_local, geo, plan, x):
    """Connectivity (n_local, E) int32, geometry cell axis E or 1, the plan
    of this connectivity; returns (E, Eg)."""
    _cuda.check(name, conn, (n_local, conn.shape[-1]), torch.int32,
                x.device)
    E = conn.shape[-1]
    Eg = geo.shape[-1]
    if Eg not in (E, 1):
        raise ValueError(f"geometry has {Eg} cells, connectivity {E}")
    if plan.n_values != n_local * E:
        raise ValueError(f"plan sums {plan.n_values} values, the "
                         f"connectivity has {n_local * E}")
    table = plan.table
    if table.dim() != 2 or table.numel() >= 2 ** 31:
        raise ValueError(f"plan table of shape {tuple(table.shape)}")
    _cuda.check("plan table", table, tuple(table.shape), torch.int32,
                x.device)
    return E, Eg


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def generic_elasticity_apply(u, op: ElasticityOperands):
    """``y = K u``: ``u`` (n_in,) on the operands' device and dtype;
    ``y`` (plan rows,)."""
    if u.device.type == "cpu":
        return generic_elasticity_apply_plain(u, op.conn, op.dref, op.jinv,
                                              op.jxw, op.lam, op.mu, op.plan)
    _cuda.require_cuda(u)
    if u.dim() != 1:
        raise ValueError(f"u must be one vector, got shape "
                         f"{tuple(u.shape)}")
    dim, E, Eg, n_out, V = op.checked
    _cuda.check("u", u, u.shape, op.dref.dtype, op.dref.device)
    p = elasticity_plan(E, u.dtype, dim, sm_count(u.device))
    y = torch.empty(n_out, dtype=u.dtype, device=u.device)
    ye = torch.empty(p.scratch_numel, dtype=u.dtype, device=u.device)
    _cuda.launch("generic_elasticity_apply", u, u, op.conn, op.dref, op.jinv,
                 op.jxw, op.plan.table, y, ye, float(op.lam), float(op.mu),
                 dim, E, Eg, V, n_out, p.grid, p.smem_bytes)
    generic_elasticity_apply.launches += 1
    return y


def generic_q1_apply(x, op: Q1Operands, alpha, beta):
    """``y = alpha M x + beta L x``: ``x`` (n_in,) or (B, n_in) with
    B <= :data:`MAX_LANES`, on the operands' device and dtype; ``y``
    (plan rows,) or (B, plan rows).  A zero coefficient leaves its
    operator out."""
    if x.device.type == "cpu":
        return generic_q1_apply_plain(x, op.conn, op.psi, op.dref, op.jinv,
                                      op.jxw, alpha, beta, op.plan)
    _cuda.require_cuda(x)
    if x.dim() not in (1, 2) or (x.dim() == 2
                                 and not 1 <= x.shape[0] <= MAX_LANES):
        raise ValueError(f"x must be (n,) or (B, n) with 1 <= B <= "
                         f"{MAX_LANES}; got shape {tuple(x.shape)}")
    dim, E, Eg, n_out, V = op.checked
    _cuda.check("x", x, x.shape, op.dref.dtype, op.dref.device)
    lanes = x.shape[0] if x.dim() == 2 else 1
    p = q1_plan(E, dim, lanes)
    y = torch.empty(x.shape[:-1] + (n_out,), dtype=x.dtype, device=x.device)
    ye = torch.empty(p.scratch_numel, dtype=x.dtype, device=x.device)
    _cuda.launch("generic_q1_apply", x, x, op.conn, op.psi, op.dref, op.jinv,
                 op.jxw, op.plan.table, y, ye, float(alpha), float(beta),
                 dim, lanes, x.shape[-1], E, Eg, V, n_out, p.grid)
    generic_q1_apply.launches += 1
    return y


generic_elasticity_apply.launches = 0
generic_q1_apply.launches = 0
