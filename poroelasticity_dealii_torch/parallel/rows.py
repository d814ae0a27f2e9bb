"""Sharded forms of the production mechanics (port of
``poroelasticity_dealii_tpu/parallel/rows.py:57-304``) over
``torch.distributed``: one process per device, each running the same
program on its slab.

3D, the z-slab row layout.  The row layout is z-half-major, so a z-slab of
the displacement grid is a contiguous row range: rank d of ``n_dev`` holds
``Lz = ceil((n+1)/n_dev)`` z-half layers (``Lz*24`` rows) of every
mechanics row-layout vector, and the mechanics CG's axpys and masks run on
those slabs unchanged.  The global padded shape is ``(n_dev*Lz*24, W)``.

2D, the y-slab parity layout (:class:`ShardedParityOps`): parity tensors
``(nc, 2, 2, n+1, n+1)`` split along iy, rank d holding ``Ly =
ceil((n+1)/n_dev)`` iy-rows ``(nc, 2, 2, Ly, n+1)``; the global padded
shape has ``n_dev*Ly`` rows.

In both, padding carries ``free_mask = 0`` and ``diag = 1``, so the solver
treats it as constrained dofs with zero value and it stays exactly zero.
Collectives, one for one with JAX's:

* one elasticity apply: the rank's slab plus one halo band from rank d+1
  (24 rows in 3D, one iy-row of ``nc*2*2*(n+1)`` values in 2D) goes through
  the slab apply (3D: the slab form of the row-layout kernel,
  :func:`..ops.comp_major.elasticity_rows_apply` with ``nz=Lz`` and the
  rank's count ``nv`` of real cell layers; 2D:
  :func:`..ops.parity2d.make_apply_parity_local`), and its last band goes
  back to rank d+1, added into that rank's first layer: one
  ``dist.batch_isend_irecv`` per direction, each message one band;
* a CG dot or norm: ``dist.all_reduce`` of the local partial;
* ``from_rows`` and the projection right-hand side: ``dist.all_gather`` of
  the slabs (once per solve boundary and per FSS iteration);
* ``to_rows`` and the coupling right-hand side: computed whole on every rank
  from the replicated input, then sliced;
* the node-block Jacobi preconditioner (3D ``Mechanics preconditioner =
  block``): nodewise on the slab, no collective;
* the 2D parity V-cycle (``gmg_precond_rows``): the slabs gathered, the
  unpadded V-cycle run whole on every rank, the correction sliced back.

Each kit counts what it sends (:class:`CommCounter`, ``kit.comm``).
:func:`shard_production_discretization` puts the kit on top of the gspmd
discretization (:func:`.sharding.shard_grid_discretization`), so the
pressure stencils and the fused pressure Jacobian run on node-plane slabs
too.  Every rank takes the same branch at every loop test, because each
test reads a replicated or all-reduced value.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..ops.comp_major import (UNMASKED, coupling_rows, coupling_rows_plain,
                              elasticity_rows_apply,
                              elasticity_rows_apply_plain, from_rows,
                              lazy_block_precond, projection_rows,
                              projection_rows_plain, to_rows, to_rows_np)
from ..ops.parity2d import (from_parity, make_apply_parity_local,
                            make_coupling_parity, make_projection_parity,
                            to_parity, to_parity_np)
from .sharding import SlabGroup, shard_grid_discretization


def slab_layers(n: int, n_dev: int) -> int:
    """Z-half layers owned per rank (the grid has n+1 of them)."""
    return math.ceil((n + 1) / n_dev)


def real_layers(n: int, n_dev: int, rank: int) -> int:
    """Real cell layers of rank ``rank``'s slab (tail ranks own padding)."""
    Lz = slab_layers(n, n_dev)
    return min(max(n - rank * Lz, 0), Lz)


@dataclasses.dataclass
class CommCounter:
    """What a sharded kit sent, by kind (``"p2p"``, ``"all_reduce"``,
    ``"all_gather"``): messages, bytes and the largest message's values."""
    messages: dict = dataclasses.field(default_factory=dict)
    bytes: dict = dataclasses.field(default_factory=dict)
    largest: dict = dataclasses.field(default_factory=dict)

    def record(self, kind: str, t: torch.Tensor) -> None:
        self.messages[kind] = self.messages.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) \
            + t.numel() * t.element_size()
        self.largest[kind] = max(self.largest.get(kind, 0), t.numel())

    def reset(self) -> None:
        self.messages.clear()
        self.bytes.clear()
        self.largest.clear()


class ShardedKit:
    """The collectives of a sharded kit over ``self.group`` (a
    :class:`.sharding.SlabGroup`), each counted in ``self.comm``: the
    halo exchange, the gather of slabs along ``self.slab_axis``, and the
    reductions the fixed-stress solver takes from the kit (``dot``,
    ``norm``, ``all_equal``, ``lane_dot``, ``lane_norm``: those of
    :class:`..solvers.cg.LocalReductions`, across the group).  A subclass
    sets ``group``, ``comm`` and ``slab_axis`` (a mechanics slab kit also
    its layout's ``local_rows``; :class:`.ghost.GhostKit` is the ghost
    form's)."""

    def _p2p(self, send, to: int, recv, frm: int) -> None:
        """Send ``send`` to rank ``to`` and receive ``recv`` from rank
        ``frm`` (either may be None) in one batch; wait for both."""
        ops = []
        if send is not None:
            self.comm.record("p2p", send)
            ops.append(dist.P2POp(dist.isend, send, to, self.group.group))
        if recv is not None:
            ops.append(dist.P2POp(dist.irecv, recv, frm, self.group.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()

    def _halo_apply(self, x, band: int, apply_ext):
        """One sharded apply: ``x``'s slab extended by ``band`` layers
        along the slab axis from rank d+1 (zeros past the last rank),
        ``apply_ext`` on it, and the result's last ``band`` layers returned
        to rank d+1 and added into its first ones."""
        g, ax = self.group, self.slab_axis
        L = x.shape[ax]
        first, last = g.rank == 0, g.rank == g.size - 1
        shape = list(x.shape)
        shape[ax] = band
        halo = x.new_zeros(shape) if last else x.new_empty(shape)
        # the last rank's halo is never read: its layers past nv
        self._p2p(None if first else x.narrow(ax, 0, band).contiguous(),
                  g.rank - 1, None if last else halo, g.rank + 1)
        y = apply_ext(torch.cat([x, halo], dim=ax))
        ret = None if first else x.new_empty(shape)
        self._p2p(None if last else y.narrow(ax, L, band).contiguous(),
                  g.rank + 1, ret, g.rank - 1)
        if ret is not None:
            y.narrow(ax, 0, band).add_(ret)
        return y.narrow(ax, 0, L).contiguous()

    def gather_rows(self, R):
        """The whole padded tensor from every rank's slab ``R``, on every
        rank."""
        g = self.group
        if g.group is None:
            return R
        R = R.contiguous()
        self.comm.record("all_gather", R)
        parts = [torch.empty_like(R) for _ in range(g.size)]
        dist.all_gather(parts, R, group=g.group)
        return torch.cat(parts, dim=self.slab_axis)

    def _all_reduce(self, t, op=dist.ReduceOp.SUM):
        if self.group.group is not None:
            self.comm.record("all_reduce", t)
            dist.all_reduce(t, op=op, group=self.group.group)
        return t

    def dot(self, a, b):
        return self._all_reduce(torch.dot(a.reshape(-1), b.reshape(-1)))

    def norm(self, x):
        return torch.sqrt(self.dot(x, x))

    def all_equal(self, a, b) -> torch.Tensor:
        """Whether every rank's slabs are equal, as a 0-d bool device
        tensor (the same on all ranks): the all-reduced MIN of each rank's
        ``(a == b).all()``, with no host read."""
        flag = (a == b).all().to(torch.int32)
        return self._all_reduce(flag, dist.ReduceOp.MIN).bool()

    def lane_dot(self, a, b):
        """One inner product per lane of the last axis (a batch's)."""
        return self._all_reduce((a * b).sum(-1))

    def lane_norm(self, x):
        return torch.sqrt(self.lane_dot(x, x))

    def _check_agreement(self, *shape) -> None:
        """Every rank of the group builds the same kit: the group's first
        collective, which every rank joins."""
        if self.group.group is None:
            return
        mine = torch.tensor([*shape, self.group.size], dtype=torch.float64,
                            device=self.group.device)
        lo = self._all_reduce(mine.clone(), dist.ReduceOp.MIN)
        hi = self._all_reduce(mine.clone(), dist.ReduceOp.MAX)
        if not (torch.equal(lo, mine) and torch.equal(hi, mine)):
            raise ValueError(f"ranks disagree on the slab kit "
                             f"({type(self).__name__} shape, size): min "
                             f"{lo.tolist()}, max {hi.tolist()}")


@dataclasses.dataclass(frozen=True)
class ShardedRowOps(ShardedKit):
    """The row-layout mechanics kit on one rank's z-slab: the methods of
    :class:`..ops.comp_major.ElasticityRowOps` on ``(Lz*24, W)`` slabs,
    with the reductions taken across the group.  ``plain=True`` routes the
    operators to their plain twins (comparison runs only)."""
    n: int
    group: SlabGroup
    ke: torch.Tensor              # (81, 81)
    ce: torch.Tensor              # (81, 8)
    pe: torch.Tensor              # (48, 81)
    free_mask_rows: torch.Tensor  # the rank's slab (Lz*24, W), padding 0
    diag_rows: torch.Tensor       # the rank's slab, padding 1
    plain: bool = False
    # node-block Jacobi on the rank's slab (nodewise: no collective)
    block_precond: Callable = None
    comm: CommCounter = dataclasses.field(default_factory=CommCounter)
    slab_axis = 0

    @property
    def Lz(self) -> int:
        return slab_layers(self.n, self.group.size)

    @property
    def nv(self) -> int:
        return real_layers(self.n, self.group.size, self.group.rank)

    # ---------------- layout ------------------------------------------------

    def local_rows(self, R):
        """The rank's slab of full rows ``R`` ((n+1)*24, W): zero-padded to
        the global shape, then sliced."""
        L = self.Lz * 24
        r0 = self.group.rank * L
        out = torch.zeros((L, R.shape[1]), dtype=R.dtype, device=R.device)
        real = max(0, min(L, R.shape[0] - r0))
        out[:real] = R[r0:r0 + real]
        return out

    def to_rows(self, u_flat):
        return self.local_rows(to_rows(u_flat, self.n))

    def from_rows(self, R):
        return from_rows(self.gather_rows(R)[:(self.n + 1) * 24], self.n)

    # ---------------- operators ---------------------------------------------

    def apply_rows(self, x):
        """Unconstrained ``A x`` on the slab: the halo band (rank d+1's
        first z-half layer) in, the slab kernel over ``Lz`` cell layers of
        which ``nv`` are real, the returned band (this slab's last cell
        layer's share of rank d+1's first z-half layer) out."""
        fn = elasticity_rows_apply_plain if self.plain \
            else elasticity_rows_apply
        return self._halo_apply(x, 24, lambda xe: fn(
            xe, None, self.ke, self.n, UNMASKED, nz=self.Lz, nv=self.nv))

    def constrained_apply(self, x):
        """``m * A(m x) + (1 - m) x``, the masks outside the kernel (JAX's
        sharded kit has no fused masked kernels either)."""
        m = self.free_mask_rows
        return self.apply_rows(x * m) * m + x * (1.0 - m)

    def free_apply(self, x):
        """``m * A x`` for x in the free subspace."""
        return self.apply_rows(x) * self.free_mask_rows

    def coupling_rows(self, p):
        """The coupling RHS computed whole from the replicated p, sliced."""
        fn = coupling_rows_plain if self.plain else coupling_rows
        return self.local_rows(fn(p, self.ce, self.n))

    def projection_rows(self, x):
        """The strain-projection RHS on the gathered rows (replicated)."""
        fn = projection_rows_plain if self.plain else projection_rows
        return fn(self.gather_rows(x)[:(self.n + 1) * 24], self.pe, self.n)


def make_row_ops_sharded(element_matrix: np.ndarray, n: int, free_mask_u,
                         diag_elasticity, group: SlabGroup,
                         coupling_matrix: np.ndarray,
                         projection_matrix: np.ndarray,
                         dtype: torch.dtype, plain: bool = False
                         ) -> ShardedRowOps:
    """The z-slab kit on ``group.device``: constants built in numpy, full
    rows padded (mask 0, diagonal 1) and sliced to the rank's slab."""
    dev = lambda a: torch.as_tensor(np.asarray(a, np.float64),  # noqa: E731
                                    dtype=dtype,
                                    device=group.device).contiguous()
    Lz = slab_layers(n, group.size)
    rows = slice(group.rank * Lz * 24, (group.rank + 1) * Lz * 24)

    def slab_np(v, fill):
        full = to_rows_np(v, n, fill=fill)
        pad = group.size * Lz * 24 - full.shape[0]
        return np.pad(full, ((0, pad), (0, 0)), constant_values=fill)[rows]

    ro = ShardedRowOps(
        n=n, group=group, ke=dev(element_matrix), ce=dev(coupling_matrix),
        pe=dev(projection_matrix),
        free_mask_rows=dev(slab_np(free_mask_u, 0.0)),
        diag_rows=dev(slab_np(diag_elasticity, 1.0)), plain=plain,
        # identity blocks on the padding layers, as JAX's nz_pad planes
        block_precond=lazy_block_precond(
            element_matrix, n, free_mask_u, dtype, group.device,
            nz_pad=group.size * Lz,
            layers=slice(group.rank * Lz, (group.rank + 1) * Lz)))
    ro._check_agreement(n, Lz)
    return ro


@dataclasses.dataclass(frozen=True)
class ShardedParityOps(ShardedKit):
    """The 2D parity mechanics kit on one rank's y-slab
    ``(nc, 2, 2, Ly, n+1)``: the methods of
    :class:`..ops.parity2d.ElasticityParityOps` with the reductions taken
    across the group (the 2D twin of :class:`ShardedRowOps`)."""
    n: int
    nc: int
    group: SlabGroup
    apply_local: Callable          # (xl (..., Ly+1, n+1), nv) -> same
    coupling_whole: Callable       # flat p -> whole parity RHS
    projection_whole: Callable     # whole parity u -> (C, n_pdofs)
    free_mask_rows: torch.Tensor   # the rank's slab, padding 0
    diag_rows: torch.Tensor        # the rank's slab, padding 1
    block_precond: Callable = None  # none in 2D (JAX's parity kit has none)
    comm: CommCounter = dataclasses.field(default_factory=CommCounter)
    slab_axis = 3

    @property
    def Ly(self) -> int:
        return slab_layers(self.n, self.group.size)

    @property
    def nv(self) -> int:
        return real_layers(self.n, self.group.size, self.group.rank)

    def local_rows(self, R):
        """The rank's slab of a whole parity tensor ``R``: zero-padded to
        ``n_dev*Ly`` iy-rows, then sliced."""
        Ly = self.Ly
        r0 = self.group.rank * Ly
        out = R.new_zeros(R.shape[:3] + (Ly, R.shape[4]))
        real = max(0, min(Ly, R.shape[3] - r0))
        out[:, :, :, :real] = R[:, :, :, r0:r0 + real]
        return out

    def whole(self, R):
        """The whole unpadded parity tensor from every rank's slab."""
        return self.gather_rows(R)[:, :, :, :self.n + 1]

    def to_rows(self, u_flat):
        return self.local_rows(to_parity(u_flat, self.n, self.nc))

    def from_rows(self, R):
        return from_parity(self.whole(R), self.n, self.nc)

    def apply_rows(self, x):
        """Unconstrained ``A x`` on the slab: one halo iy-row in, the slab
        apply over ``nv`` real cell rows, one band row back."""
        return self._halo_apply(x, 1, lambda xe: self.apply_local(xe,
                                                                  self.nv))

    def constrained_apply(self, x):
        m = self.free_mask_rows
        return self.apply_rows(x * m) * m + x * (1.0 - m)

    def free_apply(self, x):
        return self.apply_rows(x) * self.free_mask_rows

    def coupling_rows(self, p):
        """The coupling RHS computed whole from the replicated p, sliced."""
        return self.local_rows(self.coupling_whole(p))

    def projection_rows(self, x):
        """The strain-projection RHS on the gathered slabs (replicated)."""
        return self.projection_whole(self.whole(x))


def make_parity_ops_sharded(element_matrix: np.ndarray, n: int, free_mask_u,
                            diag_elasticity, group: SlabGroup,
                            coupling_matrix: np.ndarray,
                            projection_matrix: np.ndarray,
                            dtype: torch.dtype, nc: int = 2
                            ) -> ShardedParityOps:
    """The y-slab parity kit on ``group.device``: constants built in numpy,
    whole parity tensors padded (mask 0, diagonal 1) and sliced to the
    rank's slab (``make_parity_ops_sharded`` of the reference)."""
    dev = group.device
    Ly = slab_layers(n, group.size)
    rows = slice(group.rank * Ly, (group.rank + 1) * Ly)
    pad = ((0, 0),) * 3 + ((0, group.size * Ly - (n + 1)), (0, 0))
    free_np = np.asarray(free_mask_u, np.float64)
    ones_p = to_parity_np(np.ones_like(free_np), n, nc)
    diag_p = to_parity_np(diag_elasticity, n, nc) + (1.0 - ones_p)

    def slab(a, fill):
        a = np.pad(a, pad, constant_values=fill)[:, :, :, rows]
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    ko = ShardedParityOps(
        n=n, nc=nc, group=group,
        apply_local=make_apply_parity_local(element_matrix, n, Ly, nc, dtype,
                                            dev),
        coupling_whole=make_coupling_parity(coupling_matrix, n, nc, dtype,
                                            dev),
        projection_whole=make_projection_parity(projection_matrix, n, nc,
                                                dtype, dev),
        free_mask_rows=slab(to_parity_np(free_np, n, nc), 0.0),
        diag_rows=slab(diag_p, 1.0))
    ko._check_agreement(n, Ly)
    return ko


def _sharded_parity_gmg(kit: ShardedParityOps, gmg_rows: Callable):
    """The parity V-cycle on y-slabs: the slabs gathered and unpadded, the
    V-cycle run whole on every rank (it is the per-FSS-iteration
    preconditioner, not on the per-CG-iteration halo path), the correction
    padded (zero: the padding rows are constrained dofs) and sliced back
    to the rank's slab."""
    def gmg_rows_sharded(r):
        return kit.local_rows(gmg_rows(kit.whole(r)))
    return gmg_rows_sharded


def shard_production_discretization(disc, group: SlabGroup):
    """The production discretization over ``group``: the gspmd slabs of
    the structured stencils and the fused pressure Jacobian
    (:func:`.sharding.shard_grid_discretization`), plus the mechanics kit
    on slabs: the z-slab rows kit in 3D, the y-slab parity kit in 2D (with
    the parity V-cycle on gathered slabs when the discretization has one).
    Needs the rows or parity kit (an equal-axis Q2/Q1 grid on the rows or
    parity backend) and a discretization on the group's device."""
    if getattr(disc, "row_ops", None) is None:
        raise ValueError("production sharding needs the rows kit in 3D or "
                         "the parity kit in 2D (equal-axis Q2 grid, "
                         "elasticity backend auto/pallas in 3D, parity (or "
                         "auto at size) in 2D)")
    if disc.device != group.device:
        raise ValueError(f"discretization on {disc.device}, slab group on "
                         f"{group.device}")
    base = shard_grid_discretization(disc, group)
    n = disc.info_u.cells_per_axis[0]
    if disc.dim == 2:
        kit = make_parity_ops_sharded(
            disc.element_ke, n, disc.free_mask_u.cpu().numpy(),
            disc.diag_elasticity.cpu().numpy(), group,
            coupling_matrix=disc.element_ce,
            projection_matrix=disc.element_pe, dtype=disc.dtype,
            nc=disc.row_ops.nc)
        gmg = disc.gmg_precond_rows
        return dataclasses.replace(
            base, row_ops=kit, gmg_precond=None,
            gmg_precond_rows=None if gmg is None
            else _sharded_parity_gmg(kit, gmg))
    row_ops = make_row_ops_sharded(
        disc.element_ke, n, disc.free_mask_u.cpu().numpy(),
        disc.diag_elasticity.cpu().numpy(), group,
        coupling_matrix=disc.element_ce, projection_matrix=disc.element_pe,
        dtype=disc.dtype, plain=disc.row_ops.plain)
    return dataclasses.replace(base, row_ops=row_ops)
