"""Z-slab sharded form of the production mechanics (port of
``poroelasticity_dealii_tpu/parallel/rows.py:57-144, 249-304``) over
``torch.distributed``: one process per device, each running the same
program on its slab.

The row layout is z-half-major, so a z-slab of the displacement grid is a
contiguous row range: rank d of ``n_dev`` holds ``Lz = ceil((n+1)/n_dev)``
z-half layers (``Lz*24`` rows) of every mechanics row-layout vector, and
the mechanics CG's axpys and masks run on those slabs unchanged.  The
global padded shape is ``(n_dev*Lz*24, W)``; padding rows carry
``free_mask = 0`` and ``diag = 1``, so the solver treats them as
constrained dofs with zero value and they stay exactly zero.

Collectives, one for one with JAX's:

* one elasticity apply: the rank's slab plus one 24-row halo band from rank
  d+1 goes through the slab form of the row-layout kernel
  (:func:`..ops.comp_major.elasticity_rows_apply` with ``nz=Lz`` and the
  rank's count ``nv`` of real cell layers), and its last 24 rows go back to
  rank d+1, added into that rank's first z-half layer: one
  ``dist.batch_isend_irecv`` per direction, each message one band;
* a CG dot or norm: ``dist.all_reduce`` of the local partial;
* ``from_rows`` and the projection right-hand side: ``dist.all_gather`` of
  the slabs (once per solve boundary and per FSS iteration);
* ``to_rows`` and the coupling right-hand side: computed whole on every rank
  from the replicated input, then sliced;
* the node-block Jacobi preconditioner (``Mechanics preconditioner =
  block``): nodewise on the slab, no collective.

The pressure side is not sharded: every rank computes the whole pressure
solve identically (JAX partitions its stencils with GSPMD, which torch does
not have).  Every rank takes the same branch at every loop test, because
each test reads a replicated or all-reduced value.
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
from .sharding import SlabGroup


def slab_layers(n: int, n_dev: int) -> int:
    """Z-half layers owned per rank (the grid has n+1 of them)."""
    return math.ceil((n + 1) / n_dev)


def real_layers(n: int, n_dev: int, rank: int) -> int:
    """Real cell layers of rank ``rank``'s slab (tail ranks own padding)."""
    Lz = slab_layers(n, n_dev)
    return min(max(n - rank * Lz, 0), Lz)


@dataclasses.dataclass(frozen=True)
class ShardedRowOps:
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

    def gather_rows(self, R):
        """The whole padded rows ``(n_dev*Lz*24, W)`` from every rank's
        slab ``R``, on every rank."""
        g = self.group
        if g.group is None:
            return R
        parts = [torch.empty_like(R) for _ in range(g.size)]
        dist.all_gather(parts, R.contiguous(), group=g.group)
        return torch.cat(parts)

    def to_rows(self, u_flat):
        return self.local_rows(to_rows(u_flat, self.n))

    def from_rows(self, R):
        return from_rows(self.gather_rows(R)[:(self.n + 1) * 24], self.n)

    # ---------------- operators ---------------------------------------------

    def _p2p(self, send, to: int, recv, frm: int) -> None:
        """Send ``send`` to rank ``to`` and receive ``recv`` from rank
        ``frm`` (either may be None) in one batch; wait for both."""
        ops = []
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send, to, self.group.group))
        if recv is not None:
            ops.append(dist.P2POp(dist.irecv, recv, frm, self.group.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()

    def apply_rows(self, x):
        """Unconstrained ``A x`` on the slab: the halo band (rank d+1's
        first z-half layer) in, the slab kernel over ``Lz`` cell layers of
        which ``nv`` are real, the returned band (this slab's last cell
        layer's share of rank d+1's first z-half layer) out."""
        g = self.group
        L = self.Lz * 24
        first, last = g.rank == 0, g.rank == g.size - 1
        xe = torch.empty((L + 24, x.shape[1]), dtype=x.dtype, device=x.device)
        xe[:L] = x
        if last:
            xe[L:].zero_()                  # never read: layers past nv
        self._p2p(None if first else x[:24].contiguous(), g.rank - 1,
                  None if last else xe[L:], g.rank + 1)
        fn = elasticity_rows_apply_plain if self.plain \
            else elasticity_rows_apply
        y = fn(xe, None, self.ke, self.n, UNMASKED, nz=self.Lz, nv=self.nv)
        ret = None if first else torch.empty_like(y[L:])
        self._p2p(None if last else y[L:], g.rank + 1, ret, g.rank - 1)
        if ret is not None:
            y[:24] += ret
        return y[:L]

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

    # ---------------- reductions --------------------------------------------

    def _all_reduce(self, t, op=dist.ReduceOp.SUM):
        if self.group.group is not None:
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
    _check_agreement(ro)
    return ro


def _check_agreement(ro: ShardedRowOps) -> None:
    """Every rank of the group builds the same kit: the group's first
    collective, which every rank joins."""
    if ro.group.group is None:
        return
    mine = torch.tensor([ro.n, ro.Lz, ro.group.size], dtype=torch.float64,
                        device=ro.group.device)
    lo = ro._all_reduce(mine.clone(), dist.ReduceOp.MIN)
    hi = ro._all_reduce(mine.clone(), dist.ReduceOp.MAX)
    if not (torch.equal(lo, mine) and torch.equal(hi, mine)):
        raise ValueError(f"ranks disagree on the slab kit (n, Lz, size): "
                         f"min {lo.tolist()}, max {hi.tolist()}")


def shard_production_discretization(disc, group: SlabGroup):
    """The production discretization with its rows kit replaced by the
    z-slab kit over ``group``; the pressure side stays as it is
    (replicated).  Needs the rows kit (a 3D equal-axis Q2 grid on the rows
    backend) and a discretization on the group's device."""
    if getattr(disc, "row_ops", None) is None:
        raise ValueError("production sharding needs the rows kit (3D "
                         "equal-axis Q2 grid, elasticity backend "
                         "auto/pallas)")
    if disc.device != group.device:
        raise ValueError(f"discretization on {disc.device}, slab group on "
                         f"{group.device}")
    n = disc.info_u.cells_per_axis[0]
    row_ops = make_row_ops_sharded(
        disc.element_ke, n, disc.free_mask_u.cpu().numpy(),
        disc.diag_elasticity.cpu().numpy(), group,
        coupling_matrix=disc.element_ce, projection_matrix=disc.element_pe,
        dtype=disc.dtype, plain=disc.row_ops.plain)
    return dataclasses.replace(disc, row_ops=row_ops)
