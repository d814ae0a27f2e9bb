"""The torch port against its own copy of the scipy assembled-sparse oracle
of the reference algorithm (``poroelasticity_dealii_torch/validation.py``),
in float64 on the CPU with the decks' own tolerances:

* ``run_reference_algorithm`` on the 3D deck at level 3 (the pattern of
  tests/test_history_3d.py::test_oracle_vs_production_3d_live);
* ``run_adaptive_reference_algorithm`` against the port's golden adaptive
  run, over the 9-step prefix that
  tests/test_adaptive_history.py::test_oracle_adaptive_run_matches_pin_prefix
  holds against the pin: mesh sizes and FSS and pressure counts exact, the
  residuals within 1e-6.

Imports nothing of JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from poroelasticity_dealii_torch.amr.driver import AMRSimulationRunner
from poroelasticity_dealii_torch.config import read_input_file
from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver
from poroelasticity_dealii_torch.solvers.structured import \
    build_grid_discretization
from poroelasticity_dealii_torch.validation import (
    run_adaptive_reference_algorithm, run_reference_algorithm)

DECK = "configs/consolidation_3d.data"
GOLDEN = "configs/golden_2d.data"


@pytest.fixture
def one_torch_thread():
    """One intra-op thread: beside busy test workers, torch's default
    OpenMP pool oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_counts_match_scipy_oracle_3d():
    data = read_input_file(DECK)
    assert data.initial_refinement_level == 3
    oracle = run_reference_algorithm(data, n_steps=3)
    solver = FixedStressSolver(build_grid_discretization(data, device="cpu"),
                               data)
    state = solver.initial_state()
    for o in oracle:
        state, s = solver.time_step(state, data.time_step)
        assert s.fss_iterations == o["fss_iterations"]
        assert s.pressure_iterations == o["pressure_iterations"]
        assert s.cg_converged
        np.testing.assert_allclose(s.pressure_error, o["pressure_error"],
                                   rtol=1e-6)


def test_adaptive_run_matches_scipy_oracle_prefix(one_torch_thread):
    data = dataclasses.replace(read_input_file(GOLDEN), amr=True,
                               output_vtk=False)
    oracle = run_adaptive_reference_algorithm(data, n_steps=9)
    got = []
    for kind, _, info in AMRSimulationRunner(data, device="cpu").steps(9):
        if kind == "after":
            got.extend(info)
    assert len(oracle) == len(got) == 9
    assert len({o["n_cells"] for o in oracle}) == 2     # one remesh
    for o, (rec, stats) in zip(oracle, got):
        assert rec["n_cells"] == o["n_cells"], rec["step"]
        assert rec["fss"] == o["fss_iterations"], rec["step"]
        assert rec["press"] == o["pressure_iterations"], rec["step"]
        np.testing.assert_allclose(rec["err"], o["pressure_error"],
                                   rtol=1e-6)
        hist = np.asarray(stats.fss_error_history)
        np.testing.assert_allclose(hist[hist >= 0], o["fss_error_history"],
                                   rtol=1e-6)
