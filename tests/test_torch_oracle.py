"""The torch port against the scipy assembled-sparse oracle of the
reference algorithm (validation.run_reference_algorithm) on the 3D deck at
level 3, float64, the deck's own tolerances: the pattern of
tests/test_history_3d.py::test_oracle_vs_production_3d_live."""

import numpy as np
import pytest

pytest.importorskip("jax")

from poroelasticity_dealii_tpu.config import read_input_file  # noqa: E402
from poroelasticity_dealii_tpu.validation import \
    run_reference_algorithm  # noqa: E402

from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver  # noqa: E402
from poroelasticity_dealii_torch.solvers.structured import \
    build_grid_discretization  # noqa: E402

DECK = "configs/consolidation_3d.data"


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
