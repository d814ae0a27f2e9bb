"""The interface-scaled sharded form, ``Sharding = ghost`` (port of
``poroelasticity_dealii_tpu/parallel/ghost.py``): every dof vector of the
solver sharded, halos exchanged per apply.

* The cells keep their (spatially sorted) order and split into ``size``
  contiguous chunks of ``E_per = ceil(E / size)`` cells: a slab domain
  decomposition.
* The dofs are renumbered by the first cell that touches them
  (:func:`first_touch_order`, deal.II's ``DoFRenumbering::subdomain_wise``
  analogue), so each chunk touches one contiguous band of dofs; rank d
  owns the equal chunk ``[d*C, (d+1)*C)`` of every renumbered vector,
  padded to ``C`` on the last ranks (mask 0, diagonal 1, value 0).
* One apply pulls the ``H`` dofs on each side of the rank's chunk from
  its neighbours into a window of ``C + 2H`` values
  (:func:`halo_window`), runs the generic apply of
  :mod:`..ops.operators` on the rank's cells through window-local
  connectivity and a window-local scatter plan (no float atomics; the
  last chunks' padding cells are left out), and returns the window's halo
  contributions to their owners (:func:`halo_return`): 4H exchanged
  values per rank and apply, whatever the interior size.  When ``H > C``
  (small meshes on many ranks) the window takes ``D = ceil(H / C)``
  rounds of whole chunks per side.
* Every reduction of the solver is a local partial and one
  ``all_reduce`` (:class:`GhostKit`, the reductions of
  :class:`.rows.ShardedKit`), so every rank takes the same branch.

The window and return arithmetic is apart from the transport: both take a
``shift(x, k)`` callable that gives the value of ``x`` on rank d-k (zeros
past the group's ends).  On a group it is one ``dist.batch_isend_irecv``
(:meth:`GhostKit.shift`); :class:`StackedShift` runs the same code in one
process over all ranks' chunks stacked on a leading axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..ops.operators import ScatterPlan, scatter_plan
from ..solvers.discretization import Discretization
from .rows import CommCounter, ShardedKit
from .sharding import SlabGroup, _require_device


# ---------------------------------------------------------------------------
# dof renumbering (host side)
# ---------------------------------------------------------------------------

def first_touch_order(cell_nodes: np.ndarray, n_nodes: int) -> np.ndarray:
    """Old node ids sorted by the first cell whose closure contains them
    (``old_order[new_id] = old_id``).  Cells are assumed spatially sorted,
    as ``hyper_rectangle`` and the forests give them: a contiguous range
    of cells then touches a contiguous band of nodes plus a one-cell-deep
    halo."""
    first = np.full(n_nodes, cell_nodes.shape[0], dtype=np.int64)
    cells_rep = np.repeat(np.arange(cell_nodes.shape[0], dtype=np.int64),
                          cell_nodes.shape[1])
    np.minimum.at(first, cell_nodes.astype(np.int64).reshape(-1), cells_rep)
    return np.argsort(first, kind="stable")


def _renumber_space(space, old_order: np.ndarray):
    new_of_old = np.empty_like(old_order)
    new_of_old[old_order] = np.arange(old_order.shape[0])
    return dataclasses.replace(
        space,
        node_coords=space.node_coords[old_order],
        cell_nodes=new_of_old[space.cell_nodes.astype(np.int64)].astype(
            space.cell_nodes.dtype)), new_of_old


def renumber_discretization(disc: Discretization
                            ) -> Tuple[Discretization, np.ndarray, np.ndarray]:
    """First-touch renumbering of both spaces of a conforming generic
    discretization: ``(new_disc, order_p, order_udof)``, where
    ``x_new = x_old[order]`` maps vectors into the new numbering.  The
    scatter plans are the old ones with their rows permuted, so every
    renumbered apply sums the same values in the same order as before.
    Raises ``NotImplementedError`` on hanging-node constraints."""
    if any(hc is not None and not hc.empty for hc in (disc.hc_p, disc.hc_u)):
        raise NotImplementedError(
            "ghost sharding on AMR meshes — use shard_discretization "
            "(psum mode), which supports hanging-node constraints")
    dim = disc.dim
    sp, su = disc.pressure_space, disc.displacement_space
    order_p = first_touch_order(sp.cell_nodes, sp.n_nodes)
    order_u = first_touch_order(su.cell_nodes, su.n_nodes)
    sp2, new_p = _renumber_space(sp, order_p)
    su2, new_u = _renumber_space(su, order_u)
    # interleaved vector dofs follow the node permutation
    order_udof = (order_u[:, None] * dim + np.arange(dim)[None, :]).reshape(-1)
    new_udof = (new_u[:, None] * dim + np.arange(dim)[None, :]).reshape(-1)
    dev = disc.device

    def conn(c, new):
        return torch.as_tensor(new[c.cpu().numpy().astype(np.int64)]
                               .astype(np.int32), device=dev)

    op = torch.as_tensor(order_p, device=dev)
    ou = torch.as_tensor(order_udof, device=dev)
    new_disc = dataclasses.replace(
        disc, pressure_space=sp2, displacement_space=su2,
        conn_p=conn(disc.conn_p, new_p), conn_u=conn(disc.conn_u, new_udof),
        plan_p=ScatterPlan(disc.plan_p.table[op], disc.plan_p.n_values),
        plan_u=ScatterPlan(disc.plan_u.table[ou], disc.plan_u.n_values),
        free_mask_u=disc.free_mask_u[ou],
        dirichlet_values=disc.dirichlet_values[ou],
        f_neumann=disc.f_neumann[ou],
        diag_elasticity=disc.diag_elasticity[ou], f_well=disc.f_well[op],
        free_mask_p=disc.free_mask_p[op],
        dirichlet_values_p=disc.dirichlet_values_p[op],
        diag_mass=disc.diag_mass[op], diag_laplace=disc.diag_laplace[op])
    return new_disc, order_p, order_udof


# ---------------------------------------------------------------------------
# halo windows: the arithmetic, apart from the transport
# ---------------------------------------------------------------------------

def halo_window(x, C: int, H: int, shift):
    """Owned chunk ``(..., C)`` -> window ``(..., C + 2H)``: the H values
    before the chunk from the ranks below, the chunk, the H values after
    it from the ranks above (zeros past the group's ends, never read).
    ``H <= C``: one H-sized message per side; else ``D = ceil(H/C)``
    whole chunks per side."""
    if H == 0:
        return x
    if H <= C:
        pre = shift(x[..., -H:].contiguous(), 1)
        post = shift(x[..., :H].contiguous(), -1)
        return torch.cat([pre, x, post], dim=-1)
    D = -(-H // C)
    pre = torch.cat([shift(x, k) for k in range(D, 0, -1)], dim=-1)
    post = torch.cat([shift(x, -k) for k in range(1, D + 1)], dim=-1)
    return torch.cat([pre[..., -H:], x, post[..., :H]], dim=-1)


def halo_return(y_win, C: int, H: int, shift):
    """Window contributions ``(..., C + 2H)`` -> owned chunk ``(..., C)``:
    the halo parts sent back to their owners and added, the one from the
    rank above into the chunk's tail first, then the one from the rank
    below into its head (the reference's order: f64 results then equal
    its own to rounding)."""
    if H == 0:
        return y_win
    if H <= C:
        to_tail = shift(y_win[..., :H].contiguous(), -1)
        to_head = shift(y_win[..., C + H:].contiguous(), 1)
        y = y_win[..., H:H + C].clone()
        y[..., C - H:] += to_tail
        y[..., :H] += to_head
        return y
    D = -(-H // C)
    zpad = y_win.new_zeros(y_win.shape[:-1] + (D * C - H,))
    pre = torch.cat([zpad, y_win[..., :H]], dim=-1)
    post = torch.cat([y_win[..., C + H:], zpad], dim=-1)
    y = y_win[..., H:H + C]
    for k in range(1, D + 1):
        # pre block D-k holds contributions to the dofs of rank d-k:
        # shifted by -k, rank d receives those of its own chunk
        y = y + shift(pre[..., (D - k) * C:(D - k + 1) * C].contiguous(), -k)
        y = y + shift(post[..., (k - 1) * C:k * C].contiguous(), k)
    return y


class StackedShift:
    """The transport in one process: every rank's value stacked on a
    leading axis of ``size`` ranks, ``shift(x, k)`` the stack moved by k
    ranks with zeros past the ends.  ``values`` counts the values the
    ranks would send to each other."""

    def __init__(self):
        self.values = 0

    def __call__(self, x, k: int):
        n = x.shape[0]
        out = torch.zeros_like(x)
        if abs(k) < n:
            self.values += (n - abs(k)) * x[0].numel()
            if k > 0:
                out[k:] = x[:n - k]
            else:
                out[:n + k] = x[-k:]
        return out


def split_apply(ranks: list, name: str, x, *args) -> tuple:
    """Apply ``name`` of a split computed in one process: ``ranks`` every
    rank's :class:`GhostShardedDiscretization` of one split, ``x`` the
    whole renumbered input ``(..., n)``.  Each rank's chunk is cut from
    ``x`` as the exchange would deliver it, the windows and the returns go
    through :class:`StackedShift`, and the chunks are stitched:
    ``(the whole output, the values the ranks would exchange)``."""
    r0, k = ranks[0], len(ranks)
    kin, kout = WINDOW_APPLIES[name]
    (Ci, Hi), (Co, Ho) = r0._CH(kin), r0._CH(kout)
    X = torch.nn.functional.pad(x, (0, k * Ci - x.shape[-1]))
    X = X.reshape(*x.shape[:-1], k, Ci).movedim(-2, 0)
    shift = StackedShift()
    W = halo_window(X, Ci, Hi, shift)
    Y = torch.stack([r.window_apply(name, W[d], *args)
                     for d, r in enumerate(ranks)])
    y = halo_return(Y, Co, Ho, shift).movedim(0, -2)
    return y.reshape(*y.shape[:-2], -1)[..., :r0._length(kout)], \
        shift.values


# ---------------------------------------------------------------------------
# the group's transport and reductions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GhostKit(ShardedKit):
    """The collectives of a ghost discretization over ``group``, counted
    in ``comm``: the halo transport (:meth:`shift`), the gather of chunks
    into whole vectors (``gather_rows`` along the last axis) and the
    solver's reductions (``dot``, ``norm``, ``all_equal``, ``lane_dot``,
    ``lane_norm`` of :class:`.rows.ShardedKit`)."""
    group: SlabGroup
    comm: CommCounter = dataclasses.field(default_factory=CommCounter)
    slab_axis = -1

    def shift(self, x, k: int):
        """``x`` of rank d-k (zeros where d-k is outside the group): one
        ``batch_isend_irecv`` that sends ``x`` to rank d+k and receives
        from rank d-k."""
        d, n = self.group.rank, self.group.size
        out = torch.zeros_like(x)
        self._p2p(x if 0 <= d + k < n else None, d + k,
                  out if 0 <= d - k < n else None, d - k)
        return out


# ---------------------------------------------------------------------------
# the sharded discretization
# ---------------------------------------------------------------------------

def _owned(x, rank: int, C: int, fill: float = 0.0):
    """Rank ``rank``'s chunk ``(..., C)`` of a whole vector ``(..., n)``,
    padded with ``fill`` past ``n``."""
    r0 = rank * C
    out = x.new_full(x.shape[:-1] + (C,), fill)
    real = max(0, min(C, x.shape[-1] - r0))
    out[..., :real] = x[..., r0:r0 + real]
    return out


# apply -> (its input's space, its output's space)
WINDOW_APPLIES = {"mass": ("p", "p"), "laplace": ("p", "p"),
                  "pressure_operator": ("p", "p"),
                  "elasticity": ("u", "u"), "coupling_rhs": ("p", "u"),
                  "strain_projection_rhs": ("u", "p")}


@dataclasses.dataclass
class GhostShardedDiscretization(Discretization):
    """Rank ``slab_group.rank``'s part of a first-touch renumbered
    generic discretization.

    The cell arrays (``conn_*`` window-local, ``jinv_*``, ``jxw_*``,
    ``cell_offsets``, the window-local plans ``plan_*`` over ``C + 2H``
    values) hold the rank's cell chunk ``cells``; the dof vectors (masks,
    Dirichlet values, diagonals, ``f_well``, ``f_neumann``) its owned
    chunk, padded to ``C_*``, so ``n_pdofs`` and ``n_udofs`` are the
    chunk lengths.  The
    FE spaces are the whole renumbered ones (output).  ``order_p`` /
    ``order_udof`` map vectors of the source numbering in
    (``x_new = x[order]``); :meth:`whole_state` and :meth:`owned_state`
    move a state between chunks and whole renumbered vectors."""
    slab_group: SlabGroup = None
    kit: GhostKit = None
    C_p: int = 0
    H_p: int = 0
    C_u: int = 0
    H_u: int = 0
    order_p: np.ndarray = None
    order_udof: np.ndarray = None
    cells: tuple = (0, 0)

    def _CH(self, space: str) -> tuple:
        return (self.C_p, self.H_p) if space == "p" else (self.C_u, self.H_u)

    def window_apply(self, name: str, win, *args):
        """The rank's part of apply ``name`` on its input window: the
        generic apply on the window-local tables, window out."""
        return getattr(Discretization, name)(self, win, *args)

    def _sharded(self, name: str, x, *args):
        kin, kout = WINDOW_APPLIES[name]
        win = halo_window(x, *self._CH(kin), self.kit.shift)
        return halo_return(self.window_apply(name, win, *args),
                           *self._CH(kout), self.kit.shift)

    def mass(self, p):
        return self._sharded("mass", p)

    def laplace(self, p):
        return self._sharded("laplace", p)

    def pressure_operator(self, x, alpha, beta):
        return self._sharded("pressure_operator", x, alpha, beta)

    def elasticity(self, u):
        return self._sharded("elasticity", u)

    def coupling_rhs(self, p, biot_coef):
        return self._sharded("coupling_rhs", p, biot_coef)

    def strain_projection_rhs(self, u):
        return self._sharded("strain_projection_rhs", u)

    # ---- chunks and whole vectors ----------------------------------------
    def _length(self, space: str) -> int:
        if space == "p":
            return self.pressure_space.n_nodes
        return self.displacement_space.n_nodes * self.dim

    def owned(self, x, space: str):
        """The rank's chunk ``(..., C)`` of a whole renumbered vector
        ``(..., n)``, zero-padded."""
        return _owned(x, self.slab_group.rank, self._CH(space)[0])

    def whole(self, x, space: str):
        """The whole renumbered vector ``(..., n)`` from every rank's
        chunk ``x``, on every rank (one ``all_gather``)."""
        return self.kit.gather_rows(x.contiguous())[..., :self._length(space)]

    def whole_state(self, state):
        """The :class:`..solvers.fss.State` of whole renumbered vectors
        (the reference's ghost ``State``) from the rank's chunks, on every
        rank; the caches are dropped."""
        return dataclasses.replace(
            state, p=self.whole(state.p, "p"), u=self.whole(state.u, "u"),
            eps_v=self.whole(state.eps_v, "p"),
            eps_v0=self.whole(state.eps_v0, "p"),
            strains=self.whole(state.strains, "p"), u_rows=None, mech_b=None)

    def owned_state(self, state):
        """The rank's chunks of a state of whole renumbered vectors (the
        mechanics RHS cache ``mech_b`` too, when present)."""
        return dataclasses.replace(
            state, p=self.owned(state.p, "p"), u=self.owned(state.u, "u"),
            eps_v=self.owned(state.eps_v, "p"),
            eps_v0=self.owned(state.eps_v0, "p"),
            strains=self.owned(state.strains, "p"), u_rows=None,
            mech_b=None if state.mech_b is None
            else self.owned(state.mech_b, "u"))


def _chunk_windows(conn: np.ndarray, cells_per_dev: int, n_dev: int,
                   n_real_cells: int, C: int) -> int:
    """Smallest H with every chunk's touched dofs inside
    ``[d*C - H, d*C + C + H)``."""
    H = 0
    for d in range(n_dev):
        lo_c = d * cells_per_dev
        hi_c = min((d + 1) * cells_per_dev, n_real_cells)
        if lo_c >= hi_c:
            continue
        sub = conn[:, lo_c:hi_c]
        H = max(H, d * C - int(sub.min()),
                int(sub.max()) + 1 - (d + 1) * C, 0)
    return H


def _check_halo(n_dev: int, C_p: int, H_p: int, C_u: int, H_u: int):
    """The reference's guard against a halo that spans all ranks, with its
    words.  Windows from :func:`_chunk_windows` never do (any chunk's dofs
    lie in ``[0, n)``, ``n <= n_dev * C``, so ``H <= (n_dev - 1) * C``):
    kept as the reference keeps it."""
    if H_p > (n_dev - 1) * C_p or H_u > (n_dev - 1) * C_u:
        raise ValueError(
            f"halo spans all devices (H_p={H_p}/C_p={C_p}, "
            f"H_u={H_u}/C_u={C_u}): cell order is not spatially coherent "
            "enough for ghost sharding; use shard_discretization (psum mode)")


def shard_renumbered(renumbered: tuple,
                     group: SlabGroup) -> GhostShardedDiscretization:
    """Rank ``group.rank``'s :class:`GhostShardedDiscretization` of
    ``renumbered = renumber_discretization(disc)`` over ``group`` (no
    collective when ``group.group`` is None: then it is one rank of a
    split computed in one process).  A cell order that is not spatially
    coherent gives wide halos (up to ``H = (size - 1) * C``), not an
    error."""
    rdisc, order_p, order_udof = renumbered
    _require_device(rdisc, group)
    n_dev, d = group.size, group.rank
    E = rdisc.n_cells
    E_per = math.ceil(E / n_dev)
    conn_p = rdisc.conn_p.cpu().numpy().astype(np.int64)
    conn_u = rdisc.conn_u.cpu().numpy().astype(np.int64)
    C_p = math.ceil(rdisc.n_pdofs / n_dev)
    C_u = math.ceil(rdisc.n_udofs / n_dev)
    H_p = _chunk_windows(conn_p, E_per, n_dev, E, C_p)
    H_u = _chunk_windows(conn_u, E_per, n_dev, E, C_u)
    _check_halo(n_dev, C_p, H_p, C_u, H_u)
    c0, c1 = min(d * E_per, E), min((d + 1) * E_per, E)
    dev = rdisc.device

    def localize(conn, C, H):
        return conn[:, c0:c1] - d * C + H

    def chunk(a):
        if a.shape[-1] == 1 and E > 1:         # broadcast over the cells
            return a
        return a[..., c0:c1].contiguous()

    loc_p, loc_u = localize(conn_p, C_p, H_p), localize(conn_u, C_u, H_u)
    fields = {f.name: getattr(rdisc, f.name)
              for f in dataclasses.fields(Discretization)}
    fields.update(
        conn_p=torch.as_tensor(loc_p.astype(np.int32), device=dev),
        conn_u=torch.as_tensor(loc_u.astype(np.int32), device=dev),
        plan_p=scatter_plan(loc_p, C_p + 2 * H_p, dev),
        plan_u=scatter_plan(loc_u, C_u + 2 * H_u, dev),
        jinv_u=chunk(rdisc.jinv_u), jxw_u=chunk(rdisc.jxw_u),
        jinv_p=chunk(rdisc.jinv_p), jxw_p=chunk(rdisc.jxw_p),
        cell_offsets=chunk(rdisc.cell_offsets),
        free_mask_u=_owned(rdisc.free_mask_u, d, C_u),
        dirichlet_values=_owned(rdisc.dirichlet_values, d, C_u),
        f_neumann=_owned(rdisc.f_neumann, d, C_u),
        diag_elasticity=_owned(rdisc.diag_elasticity, d, C_u, 1.0),
        f_well=_owned(rdisc.f_well, d, C_p),
        free_mask_p=_owned(rdisc.free_mask_p, d, C_p),
        dirichlet_values_p=_owned(rdisc.dirichlet_values_p, d, C_p),
        diag_mass=_owned(rdisc.diag_mass, d, C_p, 1.0),
        diag_laplace=_owned(rdisc.diag_laplace, d, C_p, 1.0))
    kit = GhostKit(group=group)
    kit._check_agreement(rdisc.n_pdofs, rdisc.n_udofs, E)
    return GhostShardedDiscretization(
        **fields, slab_group=group, kit=kit, C_p=C_p, H_p=H_p, C_u=C_u,
        H_u=H_u, order_p=order_p, order_udof=order_udof, cells=(c0, c1))


def shard_discretization_ghost(disc: Discretization,
                               group: SlabGroup
                               ) -> GhostShardedDiscretization:
    """The ghost form of the generic discretization ``disc`` over
    ``group``: :func:`renumber_discretization`, then the rank's part
    (:func:`shard_renumbered`).  The cell order must be spatially coherent,
    as ``hyper_rectangle`` and the forests give it.  Raises ``TypeError``
    on a structured grid discretization, which has no cell arrays."""
    if not isinstance(disc, Discretization):
        raise TypeError("ghost sharding needs the generic discretization "
                        "(cell arrays); got " + type(disc).__name__)
    return shard_renumbered(renumber_discretization(disc), group)
