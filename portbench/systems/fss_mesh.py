"""A hex mesh handed to the program: the deck's box with
``cells_per_axis`` cells per axis, every interior vertex moved by up to
``distortion`` of its cell along each axis (drawn from ``mesh_seed``, so
that every run measures the same mesh), through ``build_discretization``,
the path of ``GridIn::read_msh`` meshes."""

from __future__ import annotations

import numpy as np

from .. import meshes
from . import _fss


def inputs(cfg: dict, deck: dict):
    """The mesh both sides build on and its Q2 output order."""
    box = meshes.box(_fss.domain(deck), int(cfg["cells_per_axis"]))
    rng = np.random.default_rng(int(cfg["mesh_seed"]))
    return meshes.distort(box, float(cfg["distortion"]), rng), "entities"


def build(cfg: dict, deck: dict, device) -> _fss.System:
    from poroelasticity_dealii_torch.mesh.core import Mesh
    from poroelasticity_dealii_torch.solvers.discretization import \
        build_discretization
    hm, order = inputs(cfg, deck)
    data = _fss.program_data(deck)
    mesh = Mesh(3, hm.vertices, hm.cells, hm.face_cells, hm.face_local,
                hm.face_ids)
    disc = build_discretization(mesh, data, device=device)
    return _fss.System(_fss.solver(disc, data), data.time_step, hm, order,
                       data.dtype)
