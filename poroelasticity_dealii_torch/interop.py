"""Carry solver state between the JAX package and this port.

The discretization is rebuilt by each package from the same parsed deck,
so a :class:`~.solvers.fss.State` is all that crosses: as numpy arrays in
the JAX ``State`` field names (``p``, ``u``, ``eps_v``, ``eps_v0``,
``strains``, and optionally the derived caches ``u_rows`` and ``mech_b``,
which both packages keep in the same layout: the comp-major row layout of
the 3D rows kit, the parity layout of the 2D parity kit).  For a sharded
discretization the caller passes its rows kit, and the caches become the
rank's slabs (the other fields stay whole, as the solver replicates them).
A ghost discretization (:class:`.parallel.ghost.GhostShardedDiscretization`)
shards every vector: the fields cross as whole vectors in its first-touch
renumbered order (what the reference's ghost ``State`` holds), and each
rank takes its chunks, or gathers them back.

An adaptive run also carries its mesh: :func:`forest_from_fields` rebuilds
the port's forest from a reference forest's fields, and
:func:`constraints_from_numpy` the port's hanging-node constraints from the
reference's tables, so both packages can run on one mesh and one state.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from . import resolve_device
from .amr.constraints import HangingConstraints
from .amr.forest import QuadForest
from .amr.multiroot import MultiRootQuadForest
from .amr.multiroot3d import MultiRootOctForest
from .amr.octforest import OctForest
from .solvers.fss import State

FIELDS = ("p", "u", "eps_v", "eps_v0", "strains")
CACHES = ("u_rows", "mech_b")


def state_from_numpy(fields: Mapping[str, np.ndarray], device="cuda",
                     dtype: torch.dtype = None, row_ops=None,
                     ghost=None) -> State:
    """Port ``State`` on ``device`` (default the card; raises without one)
    from numpy arrays keyed by field name (a missing or None cache is left
    None).

    ``row_ops``: the discretization's rows kit (3D rows or 2D parity):
    ``u_rows`` is built from ``u`` in its layout.  With the slab kit of a
    sharded discretization (:class:`..parallel.rows.ShardedKit`: z-slab
    rows, y-slab parity), ``u_rows`` is the rank's slab of the whole ``u`` (the kit's
    ``to_rows``) and ``mech_b`` the rank's slab of the whole rows.
    ``ghost``: a ghost discretization; the fields (and ``mech_b``) are
    whole vectors in its renumbered order, and the state is the rank's
    chunks of them."""
    device = resolve_device(device)
    def conv(a):
        if a is None:
            return None
        t = torch.tensor(np.asarray(a), device=device)
        return t if dtype is None else t.to(dtype)
    kw = {k: conv(fields[k]) for k in FIELDS}
    kw.update({k: conv(fields.get(k)) for k in CACHES})
    if row_ops is not None:
        kw["u_rows"] = row_ops.to_rows(kw["u"])
        if kw["mech_b"] is not None:
            kw["mech_b"] = row_ops.local_rows(kw["mech_b"])
    if ghost is not None:
        return ghost.owned_state(State(**kw))
    return State(**kw)


def fields_to_host(state: State) -> dict:
    """The restart fields (:data:`FIELDS`) of ``state`` as numpy arrays,
    brought to the host in one device-to-host copy."""
    tensors = [getattr(state, k) for k in FIELDS]
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    parts = np.split(flat, np.cumsum([t.numel() for t in tensors])[:-1])
    return {k: a.reshape(t.shape) for k, a, t in zip(FIELDS, parts, tensors)}


def state_to_numpy(state: State, ghost=None) -> dict:
    """The inverse of :func:`state_from_numpy`: field name -> numpy array
    (None where the state holds None).  ``ghost``: a ghost
    discretization, whose ranks' chunks are gathered into whole vectors
    in its renumbered order (a collective: every rank calls it; the
    caches are dropped)."""
    if ghost is not None:
        state = ghost.whole_state(state)
    return {k: (None if getattr(state, k) is None
                else getattr(state, k).detach().cpu().numpy())
            for k in FIELDS + CACHES}


def forest_from_fields(fields: Mapping):
    """The port's forest from a reference forest's fields (e.g. ``vars()``
    of one): a box forest from ``lower``, ``upper`` and ``leaves``
    (:class:`.amr.forest.QuadForest` in 2D,
    :class:`.amr.octforest.OctForest` in 3D); a gmsh-rooted forest from
    ``root_cells``, ``root_coords``, ``boundary_ids`` and ``leaves``
    (quads: :class:`.amr.multiroot.MultiRootQuadForest`, hexes:
    :class:`.amr.multiroot3d.MultiRootOctForest`)."""
    leaves = set(tuple(int(i) for i in leaf) for leaf in fields["leaves"])
    if "root_cells" in fields:
        cells = np.asarray(fields["root_cells"])
        cls = MultiRootQuadForest if cells.shape[1] == 4 \
            else MultiRootOctForest
        return cls(root_cells=cells,
                   root_coords=np.asarray(fields["root_coords"]),
                   boundary_ids=dict(fields["boundary_ids"]), leaves=leaves)
    lower = np.asarray(fields["lower"], float)
    cls = QuadForest if lower.shape[0] == 2 else OctForest
    return cls(lower=lower, upper=np.asarray(fields["upper"], float),
               leaves=leaves)


def constraints_from_numpy(hanging, masters, weights, device="cuda",
                           dtype: torch.dtype = torch.float64
                           ) -> HangingConstraints:
    """The port's :class:`.amr.constraints.HangingConstraints` on
    ``device`` (default the card; raises without one) from the
    reference's tables: ``hanging (H,)``, ``masters (H, W)`` and
    ``weights (H, W)``, as numpy arrays."""
    return HangingConstraints.from_tables(
        np.asarray(hanging), np.asarray(masters), np.asarray(weights),
        dtype, resolve_device(device))
