"""Checkpoint / resume (port of
``poroelasticity_dealii_tpu/utils/checkpoint.py``, its ``.npz`` form).

The reference has no restart capability (state lives in memory only;
SURVEY §5).  The minimal restart vector is exactly what its
``SolutionTransfer`` carries across mesh changes — {p, eps_v, eps_v0} —
plus u, strains, time and step (``PoroelasticityFSS.h:474-497``).  The
derived caches ``State.u_rows`` and ``State.mech_b`` are not part of it.

The file is the JAX package's, key for key (``version``, ``p``, ``u``,
``eps_v``, ``eps_v0``, ``strains``, ``time``, ``step``, the adaptive
run's ``forest_*`` arrays and ``meta_*``), so either package resumes from
the other's files.  The JAX package's second backend, orbax, is refused:
the port reads and writes ``.npz`` only and takes on no orbax dependency.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from .. import resolve_device
from ..interop import FIELDS, fields_to_host, forest_from_fields
from ..solvers.fss import State

FORMAT_VERSION = 1


def refuse_orbax(what: str) -> None:
    raise NotImplementedError(
        f"{what}: the torch port reads and writes .npz checkpoints only "
        "(the JAX package's format, key for key) and takes on no orbax "
        "dependency")


def _forest_payload(forest) -> dict:
    """Persistable arrays for any forest type (box quad/oct forests carry
    lower/upper; multi-root forests carry the coarse-mesh arrays)."""
    extra = {"forest_leaves": np.asarray(sorted(forest.leaves),
                                         dtype=np.int64)}
    if hasattr(forest, "root_cells"):       # MultiRootQuadForest
        extra["forest_mr_cells"] = np.asarray(forest.root_cells, np.int64)
        extra["forest_mr_coords"] = np.asarray(forest.root_coords, float)
        bids = sorted(forest.boundary_ids.items())
        extra["forest_mr_bids"] = np.asarray(
            [(r, s, i) for (r, s), i in bids], np.int64).reshape(-1, 3)
    else:
        extra["forest_lower"] = np.asarray(forest.lower)
        extra["forest_upper"] = np.asarray(forest.upper)
    return extra


def _forest_from_payload(z):
    """The forest of :func:`_forest_payload`'s arrays (its class from the
    arrays, :func:`..interop.forest_from_fields`)."""
    fields = {"leaves": np.asarray(z["forest_leaves"])}
    if "forest_mr_cells" in z:
        fields.update(
            root_cells=z["forest_mr_cells"], root_coords=z["forest_mr_coords"],
            boundary_ids={(int(r), int(s)): int(i)
                          for r, s, i in np.asarray(z["forest_mr_bids"])})
    else:
        fields.update(lower=z["forest_lower"], upper=z["forest_upper"])
    return forest_from_fields(fields)


def save_checkpoint(path: str, state: State, time_: float, step: int,
                    meta: dict | None = None, forest=None):
    """Write ``path`` (``.npz``).  ``state.u`` must be materialised
    (:meth:`..solvers.fss.FixedStressSolver.materialize_u`).  ``forest``
    (optional): an amr forest whose structure is persisted so adaptive
    runs resume on the refined mesh.  The fields come to the host in one
    copy."""
    if state.u is None:
        raise ValueError("save_checkpoint needs state.u: call "
                         "FixedStressSolver.materialize_u first")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    extra = _forest_payload(forest) if forest is not None else {}
    np.savez(
        path,
        version=FORMAT_VERSION,
        **fields_to_host(state),
        time=time_, step=step,
        **extra,
        **({f"meta_{k}": v for k, v in (meta or {}).items()}),
    )


def load_checkpoint(path: str, dtype: torch.dtype = None,
                    device="cuda") -> Tuple[State, float, int]:
    """``(state, time, step)`` from an ``.npz`` checkpoint, the fields on
    ``device`` (default the card) in ``dtype`` (default the file's); a
    path that does not end in ``.npz`` (an orbax directory) raises
    ``NotImplementedError``."""
    if not str(path).endswith(".npz"):
        refuse_orbax(f"checkpoint {path!r} is not an .npz file")
    device = resolve_device(device)
    with np.load(path) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {z['version']}")
        state = State(**{k: torch.as_tensor(z[k]).to(device=device,
                                                      dtype=dtype)
                         for k in FIELDS})
        return state, float(z["time"]), int(z["step"])


def load_checkpoint_forest(path: str):
    """Restore the persisted forest of an adaptive run (QuadForest for 2D,
    OctForest for 3D — distinguished by the leaf-tuple width — or a
    multi-root forest when coarse-mesh arrays are present), or None."""
    if not str(path).endswith(".npz"):
        refuse_orbax(f"checkpoint {path!r} is not an .npz file")
    with np.load(path) as z:
        if "forest_leaves" not in z:
            return None
        return _forest_from_payload(z)
