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
its first launch; each call checks only its input vector.  The kernels
read no stored Jacobian factors: they rebuild the Q1 cell map's J^-1 and
JxW at their quadrature points from each cell's corner offsets
(``cell_offsets``, :func:`.geometry.corner_offsets`): the elasticity
kernel from the map's shape gradients and weights there
(:func:`.geometry.map_factors` is its plain form), the Q1 kernel in
tensor-product form (:func:`.geometry.q1_tensor_map`), and read the
connectivity and offsets tiles by TMA through two tensor maps the record
encodes on its first launch.  On a CPU tensor each
wrapper returns its plain twin (:func:`generic_elasticity_apply_plain`,
:func:`generic_q1_apply_plain`: the :mod:`.operators` applies on the
stored ``jinv``/``jxw``, unchanged); on a CUDA tensor it launches its
kernel (two CUDA launches, a cell product pass into a scratch and an
ordered plan sum) and counts one launch (:func:`.comp_major.launch_counts`),
or raises on what the kernel does not take.

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
from .quadrature import gauss_tensor
from .shape import shape_tables
from ..utils.profiling import count

MAX_LANES = 6          # lanes of one Q1 apply (kMaxLanes)
Q1_CELLS = 32          # cells of a Q1 product block (kQ1Cells)
Q1_GROUP = 2           # threads of a cell there, half its points each
ELASTICITY_STAGES = 2  # the elasticity product pass's ring (kStages)
CELL_ALIGN = 4         # the tensor maps' row stride: whole 16 bytes

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


def _item(dtype: torch.dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def elasticity_smem_bytes(dtype: torch.dtype, dim: int) -> int:
    """Dynamic shared memory of the elasticity product pass
    (``ElasticityShape<T, DIM>::kSmemBytes``): float32 the sum
    factorisation's intermediates, float64 the reference gradients D1;
    the gradients R, the ring's stages of gathered values U, the map's
    gradients and weights; then, in 128-byte aligned regions, the ring's
    connectivity and offsets boxes and one mbarrier a stage."""
    cells = ELASTICITY_TILE[(dtype, dim)]["cells"]
    f32, item = dtype == torch.float32, _item(dtype)
    nq, nv1 = 3 ** dim, 2 ** dim
    qm_pad, n_pad = _round_up(nq * dim, 8), _round_up(nq, 8)
    ldx = dim * cells + 8
    first = 2 * nq * ldx if f32 else qm_pad * (n_pad + 4)
    r_rows, u_rows = (nq * dim, nq) if f32 else (qm_pad, n_pad)
    values = (first + r_rows * ldx + ELASTICITY_STAGES * u_rows * ldx
              + nq * nv1 * dim + nq)
    (conn_rows, _), (off_rows, _) = tma_boxes("elasticity", dtype, dim)
    boxes = (_round_up(conn_rows * cells * 4, 128)
             + _round_up(off_rows * cells * item, 128))
    return _round_up(values * item, 128) + ELASTICITY_STAGES * (boxes + 8)


def tma_boxes(kernel: str, dtype: torch.dtype, dim: int) -> tuple:
    """((rows, cells) of the connectivity box, (rows, cells) of the
    offsets box) that ``kernel`` ("elasticity" or "q1") loads per tile."""
    off_rows = (2 ** dim - 1) * dim
    if kernel == "elasticity":
        cells = ELASTICITY_TILE[(dtype, dim)]["cells"]
        return (dim * 3 ** dim, cells), (off_rows, cells)
    return (2 ** dim, Q1_CELLS), (off_rows, Q1_CELLS)


def q1_threads(dim: int) -> int:
    """Threads of a Q1 product block (``Q1Shape<T, DIM>::kThreads``): a
    pair of threads per cell, each half of the cell's quadrature
    points."""
    return Q1_CELLS * Q1_GROUP


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
    """The Q1 apply's plan: a block of :func:`q1_threads` threads per
    :data:`Q1_CELLS` cells, all lanes in it (static shared memory)."""
    return GenericApplyPlan(grid=-(-cells // Q1_CELLS), smem_bytes=0,
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

@dataclasses.dataclass(frozen=True)
class KernelOperands:
    """What a record hands its kernel at every launch, made once:
    ``dim``, cells ``E``, output length ``n_out``, plan width ``V``,
    ``maps`` (the host address of the two encoded tensor maps), ``tables``
    (the device addresses of the kernel's tables, in its argument order),
    ``plan`` (the plan table's address), ``copied_bytes`` (device bytes of
    the padded copies of conn and offsets the maps read, 0 where the
    record's own tensors serve) and ``keep`` (the staged tensors and the
    maps' buffer, held alive)."""
    dim: int
    E: int
    n_out: int
    V: int
    maps: int
    tables: tuple
    plan: int
    copied_bytes: int
    keep: tuple


def _staged(a: torch.Tensor, E: int, Ep: int) -> torch.Tensor:
    """``a`` (rows, E or 1) as a tensor map reads it: contiguous rows of
    stride ``Ep`` at a 16-byte aligned base; a zero-padded copy (a cell
    axis of 1 broadcast) where ``a`` is not that already."""
    if a.shape[-1] == Ep and a.is_contiguous() and a.data_ptr() % 16 == 0:
        return a
    out = torch.zeros(a.shape[0], Ep, dtype=a.dtype, device=a.device)
    out[:, :E] = a
    return out


def _kernel_operands(kernel: int, conn, offsets, dim, E, plan, tables):
    """The :class:`KernelOperands` of a checked record: conn and offsets
    staged for TMA (:func:`_staged`), their tensor maps encoded once
    (``kernel``: 0 elasticity, 1 Q1)."""
    off = offsets.reshape((2 ** dim - 1) * dim, offsets.shape[-1])
    keep, maps, copied = (), 0, 0
    if E > 0:
        Ep = _round_up(E, CELL_ALIGN)
        conn_k, off_k = _staged(conn, E, Ep), _staged(off, E, Ep)
        copied = sum(b.numel() * b.element_size()
                     for a, b in ((conn, conn_k), (off, off_k)) if b is not a)
        buf = torch.empty(2 * _cuda.MAP_BYTES, dtype=torch.uint8)
        with torch.cuda.device(conn.device):
            _cuda.library().encode_maps(
                buf.data_ptr(), conn_k.data_ptr(), off_k.data_ptr(), kernel,
                off_k.element_size(), dim, E, Ep)
        keep, maps = (conn_k, off_k, buf), buf.data_ptr()
    return KernelOperands(dim, E, *plan.table.shape, maps,
                          tuple(t.data_ptr() for t in tables),
                          plan.table.data_ptr(), copied, keep)


@dataclasses.dataclass(frozen=True, eq=False)
class ElasticityOperands:
    """The elasticity apply's operands: ``conn`` (dim*3^dim, E) int32 with
    interleaved components, ``dref`` (3^dim, 3^dim, dim), ``jinv``
    (3^dim, dim, dim, Eg) and ``jxw`` (3^dim, Eg) for the plain twin,
    ``offsets`` (2^dim - 1, dim, Eg) the cells' corner offsets, ``dn1``
    (3^dim, 2^dim, dim) and ``weights`` (3^dim,) the Q1 map's gradients
    and the weights at the Q2 Gauss points, Eg = E or 1, ``lam``, ``mu``
    and ``plan`` the scatter plan of ``conn``.  The float32 kernel holds
    the Q2 element's 1D values at the 3-point Gauss rule as constants (its
    products sum-factorised), so :attr:`checked` also checks that
    ``dref`` is that rule's; it checks them once, on the first launch,
    and stages them for the kernel (:class:`KernelOperands`)."""
    conn: torch.Tensor
    dref: torch.Tensor
    jinv: torch.Tensor
    jxw: torch.Tensor
    offsets: torch.Tensor
    dn1: torch.Tensor
    weights: torch.Tensor
    lam: float
    mu: float
    plan: ops.ScatterPlan

    @functools.cached_property
    def checked(self) -> KernelOperands:
        """The kernel's operands after the checks it needs; raises on what
        it does not take."""
        dref = self.dref
        _cuda.require_cuda(dref)
        dim = dref.shape[-1] if dref.dim() == 3 else 0
        if not takes_elasticity(dref, dim):
            raise ValueError(f"the elasticity kernel takes Q2 shape tables "
                             f"(3^dim, 3^dim, dim); got {tuple(dref.shape)}")
        nq = 3 ** dim
        _cuda.check("dref", dref, (nq, nq, dim), dref.dtype, dref.device)
        _check_rule("dref", dref, shape_tables(
            2, dim, gauss_tensor(3, dim)[0])[1], "3-point Gauss rule")
        E, Eg = _check_cells("conn_u", self.conn, nq * dim, self.offsets,
                             self.plan, dref)
        _check_offsets(self.offsets, dim, Eg, dref)
        _cuda.check("dn1", self.dn1, (nq, 2 ** dim, dim), dref.dtype,
                    dref.device)
        _cuda.check("weights", self.weights, (nq,), dref.dtype, dref.device)
        return _kernel_operands(0, self.conn, self.offsets, dim, E,
                                self.plan, (dref, self.dn1, self.weights))


@dataclasses.dataclass(frozen=True, eq=False)
class Q1Operands:
    """The Q1 apply's operands: ``conn`` (2^dim, E) int32, ``psi`` (2^dim,
    2^dim), ``dref`` (2^dim, 2^dim, dim) (also the Q1 map's gradients at
    its points), ``jinv`` (2^dim, dim, dim, Eg) and ``jxw`` (2^dim, Eg)
    for the plain twin, ``offsets`` (2^dim - 1, dim, Eg) the cells' corner
    offsets, Eg = E or 1, and ``plan`` the scatter plan of ``conn``.  The
    kernel evaluates the element in tensor-product form with the 2-point
    Gauss rule's 1D values (and weights 1) as constants, so
    :attr:`checked` also checks that ``psi`` and ``dref`` are that
    rule's; it checks them once, on the first launch, and stages them for
    the kernel (:class:`KernelOperands`)."""
    conn: torch.Tensor
    psi: torch.Tensor
    dref: torch.Tensor
    jinv: torch.Tensor
    jxw: torch.Tensor
    offsets: torch.Tensor
    plan: ops.ScatterPlan

    @functools.cached_property
    def checked(self) -> KernelOperands:
        """The kernel's operands after the checks it needs; raises on what
        it does not take."""
        psi, dref = self.psi, self.dref
        _cuda.require_cuda(dref)
        dim = dref.shape[-1] if dref.dim() == 3 else 0
        if not takes_q1(psi, dref, dim):
            raise ValueError(f"the Q1 kernel takes Q1 shape tables; got psi "
                             f"{tuple(psi.shape)}, dref {tuple(dref.shape)}")
        npe = 2 ** dim
        _cuda.check("psi", psi, (npe, npe), dref.dtype, dref.device)
        _cuda.check("dref", dref, (npe, npe, dim), dref.dtype, dref.device)
        E, Eg = _check_cells("conn_p", self.conn, npe, self.offsets,
                             self.plan, dref)
        _check_offsets(self.offsets, dim, Eg, dref)
        psi1, dref1 = shape_tables(1, dim, gauss_tensor(2, dim)[0])
        _check_rule("psi", psi, psi1, "2-point Gauss rule")
        _check_rule("dref", dref, dref1, "2-point Gauss rule")
        return _kernel_operands(1, self.conn, self.offsets, dim, E,
                                self.plan, ())


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


def _check_rule(name, got, want, rule):
    """The kernels hold their elements' 1D values at their Gauss rule as
    constants: a shape table must be that rule's."""
    want = torch.as_tensor(want, dtype=got.dtype, device=got.device)
    if not torch.allclose(got, want, rtol=1e-6, atol=1e-7):
        raise ValueError(f"the kernel takes the {rule}; {name} is another")


def _check_offsets(offsets, dim, Eg, x):
    """The corner offsets (2^dim - 1, dim, Eg) on ``x``'s device and
    dtype."""
    _cuda.check("offsets", offsets, (2 ** dim - 1, dim, Eg), x.dtype,
                x.device)


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
    k = op.checked
    _cuda.check("u", u, u.shape, op.dref.dtype, op.dref.device)
    p = elasticity_plan(k.E, u.dtype, k.dim, sm_count(u.device))
    y = torch.empty(k.n_out, dtype=u.dtype, device=u.device)
    ye = torch.empty(p.scratch_numel, dtype=u.dtype, device=u.device)
    _cuda.launch("generic_elasticity_apply", u, u, k.maps, *k.tables, k.plan,
                 y, ye, float(op.lam), float(op.mu), k.dim, k.E, k.V,
                 k.n_out, p.grid, p.smem_bytes)
    count("launches", "generic_elasticity_apply")
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
    k = op.checked
    _cuda.check("x", x, x.shape, op.dref.dtype, op.dref.device)
    lanes = x.shape[0] if x.dim() == 2 else 1
    p = q1_plan(k.E, k.dim, lanes)
    y = torch.empty(x.shape[:-1] + (k.n_out,), dtype=x.dtype, device=x.device)
    ye = torch.empty(p.scratch_numel, dtype=x.dtype, device=x.device)
    _cuda.launch("generic_q1_apply", x, x, k.maps, k.plan, y, ye,
                 float(alpha), float(beta), k.dim, lanes, x.shape[-1], k.E,
                 k.V, k.n_out, p.grid)
    count("launches", "generic_q1_apply")
    return y
