"""The port's Python entry points run on the card unless the caller asks
for the CPU: without a CUDA device they raise (they never fall back to the
CPU), and with ``device="cpu"`` they run.  Imports nothing of JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from poroelasticity_dealii_torch import read_input_file
from poroelasticity_dealii_torch.amr.driver import AMRSimulationRunner
from poroelasticity_dealii_torch.interop import state_from_numpy
from poroelasticity_dealii_torch.mesh import read_msh
from poroelasticity_dealii_torch.models.runner import (SimulationRunner,
                                                       run_from_data)
from poroelasticity_dealii_torch.solvers.discretization import \
    build_discretization
from poroelasticity_dealii_torch.solvers.structured import \
    build_grid_discretization

DECK = "configs/consolidation_3d.data"
MSH_3D = "configs/irregular_3d.msh"


def _data(tmp_path):
    """The 3D deck at 2^3 cells, one step, no VTK, output under tmp_path."""
    data = read_input_file(DECK)
    return dataclasses.replace(
        data, initial_refinement_level=1, t_max=data.time_step,
        output_vtk=False, output_directory=str(tmp_path))


def _fields():
    rng = np.random.default_rng(0)
    return {"p": rng.standard_normal(27), "u": rng.standard_normal(375),
            "eps_v": rng.standard_normal(27),
            "eps_v0": rng.standard_normal(27),
            "strains": rng.standard_normal((6, 27))}


ENTRY_POINTS = {
    "build_grid_discretization":
        lambda data, **kw: build_grid_discretization(data, **kw),
    "build_discretization": lambda data, **kw: build_discretization(
        read_msh(MSH_3D, dim=3), data, **kw),
    "SimulationRunner": lambda data, **kw: SimulationRunner(data, **kw),
    "SimulationRunner[mesh file]": lambda data, **kw: SimulationRunner(
        dataclasses.replace(data, mesh_file=MSH_3D), **kw),
    "AMRSimulationRunner": lambda data, **kw: AMRSimulationRunner(
        dataclasses.replace(data, amr=True), **kw),
    "run_from_data": lambda data, **kw: run_from_data(data, **kw),
    "state_from_numpy": lambda data, **kw: state_from_numpy(_fields(), **kw),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry](_data(tmp_path))


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_cpu_when_asked(entry, tmp_path):
    out = ENTRY_POINTS[entry](_data(tmp_path), device="cpu")
    tensors = {
        "build_grid_discretization": lambda d: [d.row_ops.ke],
        "build_discretization": lambda d: [d.jinv_u, d.conn_u,
                                           d.plan_u.table],
        "SimulationRunner": lambda r: [r.disc.row_ops.ke],
        "SimulationRunner[mesh file]": lambda r: [r.disc.jinv_u,
                                                  r.disc.plan_p.table],
        "AMRSimulationRunner": lambda r: [r.disc.jinv_u, r.disc.hc_u.weights,
                                          r.disc.plan_u.table],
        "run_from_data": lambda s: [s.p, s.u],
        "state_from_numpy": lambda s: [s.p, s.u, s.strains],
    }[entry](out)
    assert all(t.device.type == "cpu" for t in tensors)
    if entry == "run_from_data":
        assert bool(torch.isfinite(out.p).all())
