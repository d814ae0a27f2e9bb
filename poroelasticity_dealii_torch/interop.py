"""Carry solver state between the JAX package and this port.

The discretization is rebuilt by each package from the same parsed deck,
so a :class:`~.solvers.fss.State` is all that crosses: as numpy arrays in
the JAX ``State`` field names (``p``, ``u``, ``eps_v``, ``eps_v0``,
``strains``, and optionally the derived caches ``u_rows`` and ``mech_b``,
which both packages keep in the same layout: the comp-major row layout of
the 3D rows kit, the parity layout of the 2D parity kit).  For a sharded
discretization the caller passes its rows kit, and the caches become the
rank's slabs (the other fields stay whole, as the solver replicates them).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from . import resolve_device
from .solvers.fss import State

FIELDS = ("p", "u", "eps_v", "eps_v0", "strains")
CACHES = ("u_rows", "mech_b")


def state_from_numpy(fields: Mapping[str, np.ndarray], device="cuda",
                     dtype: torch.dtype = None, row_ops=None) -> State:
    """Port ``State`` on ``device`` (default the card; raises without one)
    from numpy arrays keyed by field name (a missing or None cache is left
    None).

    ``row_ops``: the discretization's rows kit (3D rows or 2D parity):
    ``u_rows`` is built from ``u`` in its layout.  With the z-slab kit of a
    sharded discretization (:class:`..parallel.rows.ShardedRowOps`),
    ``u_rows`` is the rank's slab of the whole ``u`` (the kit's
    ``to_rows``) and ``mech_b`` the rank's slab of the whole rows."""
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
    return State(**kw)


def state_to_numpy(state: State) -> dict:
    """The inverse of :func:`state_from_numpy`: field name -> numpy array
    (None where the state holds None)."""
    return {k: (None if getattr(state, k) is None
                else getattr(state, k).detach().cpu().numpy())
            for k in FIELDS + CACHES}
