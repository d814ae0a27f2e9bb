"""Host setup of the torch port against the JAX package: element matrices,
masks, diagonals, boundary and source vectors, and the row layout."""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from poroelasticity_dealii_tpu.config import read_input_file  # noqa: E402
from poroelasticity_dealii_tpu.ops import pallas_comp_major as jcm  # noqa: E402
from poroelasticity_dealii_tpu.solvers import structured as jst  # noqa: E402

from poroelasticity_dealii_torch.ops import comp_major as cm  # noqa: E402
from poroelasticity_dealii_torch.solvers import structured as tst  # noqa: E402

DECK = "configs/consolidation_3d.data"


def _deck(variant):
    data = read_input_file(DECK)
    if variant == "loaded":
        # traction on the top face, gravity, a drained bottom face: every
        # boundary/source vector non-trivial
        data = dataclasses.replace(
            data, stress_boundary_labels=(5, 1),
            stress_boundary_components=(2, 0),
            stress_boundary_values=(-2e6, 3e5), gravity_direction=2,
            pressure_boundary_labels=(4,), pressure_boundary_values=(5e6,),
            displacement_boundary_labels=(0, 2, 4),
            displacement_boundary_components=(0, 1, 2),
            displacement_boundary_values=(0.0, 0.0, -1e-5))
    return data


def _close(a, b, rtol=1e-14):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= rtol * scale, np.abs(a - b).max() / scale


@pytest.mark.parametrize("variant", ["deck", "loaded"])
@pytest.mark.parametrize("n", [2, 3])
def test_setup_arrays_match_jax(variant, n):
    data = _deck(variant)
    j = jst.build_grid_discretization(data, cells_per_axis=n,
                                      multigrid="off",
                                      elasticity_backend="pallas")
    t = tst.build_grid_discretization(data, cells_per_axis=n, device="cpu")
    for name in ("element_ke", "element_ce", "element_pe"):
        _close(getattr(t, name), getattr(j, name))
    for name in ("free_mask_u", "dirichlet_values", "f_neumann", "f_well",
                 "free_mask_p", "dirichlet_values_p", "diag_mass",
                 "diag_laplace"):
        _close(getattr(t, name), getattr(j, name))
    _close(t.row_ops.free_mask_rows, j.row_ops.free_mask_rows)
    _close(t.row_ops.diag_rows, j.row_ops.diag_rows)
    if variant == "loaded":
        assert np.abs(np.asarray(j.f_neumann)).max() > 0
        assert np.asarray(j.free_mask_p).min() == 0.0


@pytest.mark.parametrize("n", [2, 3])
def test_pressure_operators_match_jax(n):
    """Q1 slice mass/Laplace applies and the pressure Jacobian pieces."""
    from poroelasticity_dealii_tpu.solvers import FixedStressSolver as JF
    from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver
    data = _deck("loaded")
    j = jst.build_grid_discretization(data, cells_per_axis=n,
                                      multigrid="off",
                                      elasticity_backend="pallas")
    t = tst.build_grid_discretization(data, cells_per_axis=n, device="cpu")
    rng = np.random.default_rng(n)
    x = rng.standard_normal(t.n_pdofs)
    xt = torch.as_tensor(x)
    _close(t.mass(xt), j.mass(x), 1e-13)
    _close(t.laplace(xt), j.laplace(x), 1e-13)
    js, ts = JF(j, data), FixedStressSolver(t, data)
    dt = data.time_step
    _close(ts._pressure_jacobian_apply(xt, dt),
           js._pressure_jacobian_apply(x, dt), 1e-13)
    _close(ts._pressure_jacobian_diag(dt), js._pressure_jacobian_diag(dt))
    e = rng.standard_normal(t.n_pdofs)
    _close(ts._pressure_residual(xt, 2 * xt, torch.as_tensor(e), 0.5 *
                                 torch.as_tensor(e), dt),
           js._pressure_residual(x, 2 * x, e, 0.5 * e, dt), 1e-13)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6])
def test_rows_roundtrip_bitwise(n):
    rng = np.random.default_rng(n)
    u = rng.standard_normal((2 * n + 1) ** 3 * 3)
    R = cm.to_rows(torch.as_tensor(u), n)
    assert R.shape == ((n + 1) * 24, cm._width(n))
    assert torch.equal(cm.from_rows(R, n), torch.as_tensor(u))
    assert np.array_equal(R.numpy(), np.asarray(jcm.to_rows(u, n)))
    assert np.array_equal(cm.to_rows_np(u, n), R.numpy())
    # padding lanes are zero; phantom nodes (past 2n) of real lanes too
    assert not R.numpy()[:, (n + 1) ** 2:].any()
    assert int((R != 0).sum()) == u.size
