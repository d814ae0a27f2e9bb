"""The device group of the sharded paths and the two sharded forms that
keep every solver vector whole (port of
``poroelasticity_dealii_tpu/parallel/sharding.py``).

JAX runs one controller over a 1D device mesh; the port runs one process
per device in a ``torch.distributed`` process group (NCCL on the card,
gloo on the CPU).  :class:`SlabGroup` is the counterpart of
``make_device_mesh``: a rank's place in the group and its device.

* **psum** (:func:`shard_discretization`, :class:`ShardedDiscretization`):
  on a generic discretization each rank keeps a contiguous chunk of the
  cells (connectivity, Jacobian factors, its own scatter plan) and every
  operator apply computes the rank's cells, then sums across the group
  with one ``all_reduce``.  The dof vectors, diagonals, masks and
  hanging-node tables stay replicated, so the constraint hooks and the
  solver run unchanged, adaptive meshes included.
* **gspmd** (:func:`shard_grid_discretization`): on a structured grid each
  wrapped stencil (:class:`SlabStencil`) computes only the rank's slab of
  output node planes along the slowest axis (z in 3D, y in 2D), from the
  replicated input on the sub-grid of cells that touch those planes, and
  ``all_gather``s the equal-size slabs, so its output is whole again on
  every rank.  Every node sums the same cells in the same order as on the
  whole grid: in float64 on the CPU, and wherever a cell's product does
  not depend on how many cells are multiplied together, the result equals
  the whole-grid stencil's bit for bit.  JAX reaches the same split with
  GSPMD sharding constraints, which torch does not have.

In both forms the CG dots act on identical replicated vectors, so no other
collective enters the solver loops.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..ops.operators import ScatterPlan, scatter_plan
from ..solvers.discretization import Discretization
from ..solvers.structured import GridDiscretization


@dataclasses.dataclass(frozen=True)
class SlabGroup:
    """Rank ``rank`` of ``size`` in the default process group ``group``
    (None: one process and no group), computing on ``device``."""
    rank: int
    size: int
    group: Optional[object]
    device: torch.device


def make_slab_group(device="cuda") -> SlabGroup:
    """The slab group over the default process group when one is
    initialised, else one process (``size=1``, no group)."""
    device = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        return SlabGroup(0, 1, None, device)
    return SlabGroup(dist.get_rank(), dist.get_world_size(), dist.group.WORLD,
                     device)


def init_from_env(device="cuda") -> tuple:
    """``(slab group, created)`` for a process started by ``torchrun``.

    An initialised default group is taken as it is.  Otherwise, when the
    environment names a world (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as ``torchrun`` sets them), the default group is
    initialised from it: NCCL on CUDA, each rank on ``cuda:{LOCAL_RANK}``,
    gloo on the CPU; ``created`` says so, and the caller destroys the group
    at the end.  Without either, one process: ``size=1``, no group."""
    dev = resolve_device(device)
    created = False
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
        created = True
    return make_slab_group(dev), created


def _require_device(disc, group: SlabGroup) -> None:
    if disc.device != group.device:
        raise ValueError(f"discretization on {disc.device}, slab group on "
                         f"{group.device}")


# ---------------------------------------------------------------------------
# gspmd: structured stencils on node-plane slabs
# ---------------------------------------------------------------------------

class SlabStencil:
    """One rank's slab of a structured stencil apply, gathered whole.

    The output node grid's slowest axis has ``G = k_out * n + 1`` planes;
    rank d owns planes ``[d*P, min((d+1)*P, G))``, ``P = ceil(G / size)``.
    Its slab is computed by the same operator (``spec.on_cells``) on the
    sub-grid of the cells that touch those planes, from the matching input
    planes of the replicated input; the slabs, padded to ``P`` planes, are
    ``all_gather``ed and cut back to ``G``.  Leading batch dimensions of
    the input are kept (the batched projection solves).  ``calls`` counts
    the applies by name, over all instances."""

    calls = collections.Counter()

    def __init__(self, spec, group: SlabGroup, name: str):
        self.name, self.group = name, group
        k_in, k_out, n = spec.k_in, spec.k_out, spec.ns[-1]
        rev = tuple(reversed(spec.ns))
        self.grid_in = tuple(k_in * c + 1 for c in rev) + (spec.n_comp_in,)
        self.grid_out = tuple(k_out * c + 1 for c in rev) \
            + (spec.n_comp_out,)
        G = self.grid_out[0]
        self.P = math.ceil(G / group.size)
        self.Z0 = min(G, group.rank * self.P)
        self.Z1 = min(G, self.Z0 + self.P)
        self.sub = None
        if self.Z1 > self.Z0:
            # cells c touch output planes k_out*c .. k_out*(c+1)
            c0 = max(0, -(-(self.Z0 - k_out) // k_out))
            c1 = min(n, (self.Z1 - 1) // k_out + 1)
            self.sub = spec.on_cells(tuple(spec.ns[:-1]) + (c1 - c0,))
            self.in0, self.n_in = k_in * c0, k_in * (c1 - c0) + 1
            self.out0 = self.Z0 - k_out * c0
            self.sub_grid = (k_out * (c1 - c0) + 1,) + self.grid_out[1:]

    def __call__(self, x):
        SlabStencil.calls[self.name] += 1
        batch = tuple(x.shape[:-1])
        b = len(batch)
        slab = x.new_zeros(batch + (self.P,) + self.grid_out[1:])
        if self.sub is not None:
            xs = x.reshape(batch + self.grid_in).narrow(b, self.in0,
                                                        self.n_in)
            ys = self.sub(xs.reshape(batch + (-1,)))
            slab.narrow(b, 0, self.Z1 - self.Z0).copy_(
                ys.reshape(batch + self.sub_grid).narrow(
                    b, self.out0, self.Z1 - self.Z0))
        g = self.group
        if g.group is not None:
            slab = slab.movedim(b, 0).contiguous()
            parts = [torch.empty_like(slab) for _ in range(g.size)]
            dist.all_gather(parts, slab, group=g.group)
            slab = torch.cat(parts).movedim(0, b)
        return slab.narrow(b, 0, self.grid_out[0]).reshape(batch + (-1,))


def shard_grid_discretization(disc, group: SlabGroup):
    """The structured discretization with its stencils on node-plane slabs
    over ``group`` (JAX's ``shard_grid_discretization``): the mass,
    Laplace, elasticity (so its constrained form too), coupling and
    projection applies, and through ``wrap_pressure_stencil`` the solver's
    fused pressure Jacobian.  The mechanics kit is dropped (``row_ops =
    None``: flat vectors, as in JAX; :func:`.rows.
    shard_production_discretization` puts a slab kit back).  Nothing else
    is sharded: the pressure and elasticity V-cycles, the diagonals and
    the lifts stay whole.  Raises ``TypeError`` on a discretization that
    is not a structured grid."""
    if not isinstance(disc, GridDiscretization):
        raise TypeError("spatial sharding requires the conv-stencil backend "
                        "(a structured grid discretization)")
    _require_device(disc, group)

    def wrap(st, name):
        return SlabStencil(st.spec, group, name)

    proj = wrap(disc.stencil_projection.raw, "projection")
    C = proj.grid_out[-1]

    def stencil_projection(u):
        return proj(u).reshape(-1, C).T             # (C, n_pdofs)

    return dataclasses.replace(
        disc, mass=wrap(disc.mass, "mass"),
        laplace=wrap(disc.laplace, "laplace"),
        stencil_elasticity=wrap(disc.stencil_elasticity, "elasticity"),
        stencil_coupling=wrap(disc.stencil_coupling, "coupling"),
        stencil_projection=stencil_projection,
        wrap_pressure_stencil=lambda st: wrap(st, "jacobian"),
        row_ops=None, slab_group=group)


# ---------------------------------------------------------------------------
# psum: cells chunked, one all-reduce per apply
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedDiscretization(Discretization):
    """A generic discretization whose cell arrays (``conn_*``, ``jinv_*``,
    ``jxw_*``, ``cell_offsets``, the scatter plans) hold one rank's
    contiguous chunk of the cells; every apply sums its chunk's
    contributions across ``slab_group`` with one ``all_reduce`` (JAX's
    ``psum``).  Everything else is the source discretization's,
    replicated.  ``n_cells`` is the rank's chunk; ``cells`` the chunk's
    range in the whole mesh."""
    slab_group: SlabGroup = None
    cells: tuple = (0, 0)

    def _sum(self, y):
        g = self.slab_group
        if g is not None and g.group is not None:
            dist.all_reduce(y, group=g.group)
        return y

    def mass(self, p):
        return self._sum(super().mass(p))

    def laplace(self, p):
        return self._sum(super().laplace(p))

    def pressure_operator(self, x, alpha, beta):
        return self._sum(super().pressure_operator(x, alpha, beta))

    def elasticity(self, u):
        return self._sum(super().elasticity(u))

    def coupling_rhs(self, p, biot_coef):
        return self._sum(super().coupling_rhs(p, biot_coef))

    def strain_projection_rhs(self, u):
        return self._sum(super().strain_projection_rhs(u))


def shard_discretization(disc, group: SlabGroup) -> ShardedDiscretization:
    """The generic discretization with rank ``group.rank``'s contiguous
    chunk of the cells (chunks as even as the count allows; AMR
    bucketing's phantom cells, zero weights and out of the scatter plan,
    stay inert in whichever chunk they fall).  Uniform-geometry arrays
    (trailing cell axis of 1) are kept as they are.  Raises ``TypeError``
    on a structured grid discretization, which has no cell arrays."""
    if not isinstance(disc, Discretization):
        raise TypeError("psum sharding needs the generic discretization "
                        "(cell arrays); got " + type(disc).__name__)
    _require_device(disc, group)
    E = disc.n_cells
    c0, c1 = group.rank * E // group.size, (group.rank + 1) * E // group.size

    def chunk(a):
        if a.shape[-1] == 1 and E > 1:         # broadcast over the cells
            return a
        return a[..., c0:c1].contiguous()

    def plan(conn, whole: ScatterPlan):
        """The chunk's plan: the entries of ``conn`` the whole plan sums
        (bucketing's phantom cells hold dof 0 in ``conn`` but are out of
        its plan), in the whole plan's order."""
        live = np.zeros(whole.n_values + 1, bool)
        live[whole.table.cpu().numpy().reshape(-1)] = True
        c = conn.cpu().numpy()
        c = np.where(live[:whole.n_values].reshape(c.shape), c, -1)
        return scatter_plan(c[:, c0:c1], whole.table.shape[0], disc.device)

    fields = {f.name: getattr(disc, f.name)
              for f in dataclasses.fields(disc)}
    fields.update(
        conn_p=chunk(disc.conn_p), conn_u=chunk(disc.conn_u),
        plan_p=plan(disc.conn_p, disc.plan_p),
        plan_u=plan(disc.conn_u, disc.plan_u), jinv_u=chunk(disc.jinv_u),
        jxw_u=chunk(disc.jxw_u), jinv_p=chunk(disc.jinv_p),
        jxw_p=chunk(disc.jxw_p), cell_offsets=chunk(disc.cell_offsets),
        hc_p=disc._hcp, hc_u=disc._hcu,
        slab_group=group, cells=(c0, c1))
    return ShardedDiscretization(**fields)
