"""The structured box: ``build_grid_discretization`` on the deck's box
with ``cells_per_axis`` cells per axis; the configuration's ``multigrid``
and ``elasticity_backend`` go to it as they stand."""

from __future__ import annotations

from .. import meshes
from . import _fss


def inputs(cfg: dict, deck: dict):
    """The mesh the reference builds on (the program builds its own from
    the same deck values) and its Q2 output order."""
    return meshes.box(_fss.domain(deck), int(cfg["cells_per_axis"])), \
        "lattice"


def build(cfg: dict, deck: dict, device) -> _fss.System:
    from poroelasticity_dealii_torch.solvers.structured import \
        build_grid_discretization
    box, order = inputs(cfg, deck)
    data = _fss.program_data(deck)
    disc = build_grid_discretization(
        data, cells_per_axis=box.n, multigrid=cfg["multigrid"],
        elasticity_backend=cfg["elasticity_backend"], device=device)
    return _fss.System(_fss.solver(disc, data), data.time_step, box, order,
                       data.dtype)
