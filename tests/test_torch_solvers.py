"""CG and pressure multigrid of the torch port against the JAX package."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from poroelasticity_dealii_tpu.config import read_input_file  # noqa: E402
from poroelasticity_dealii_tpu.solvers import cg as jcg  # noqa: E402
from poroelasticity_dealii_tpu.solvers import multigrid as jmg  # noqa: E402

from poroelasticity_dealii_torch.solvers import cg as tcg  # noqa: E402
from poroelasticity_dealii_torch.solvers import multigrid as tmg  # noqa: E402

DECK = "configs/consolidation_3d.data"


def _spd(n, seed=0, cond=1e3):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * np.geomspace(1.0, cond, n)) @ q.T


def _both(a, b, x0, diag, tol, max_iter, precond=None):
    a, b, x0, diag = (np.array(v) for v in (a, b, x0, diag))
    aj, at = jnp.asarray(a), torch.as_tensor(a)
    pj = pt = None
    if precond is not None:
        pj = lambda r: jnp.asarray(precond) @ r            # noqa: E731
        pt = lambda r: torch.as_tensor(precond) @ r        # noqa: E731
    rj = jcg.cg_solve(lambda x: aj @ x, jnp.asarray(b), jnp.asarray(x0),
                      jnp.asarray(diag), tol=tol, max_iter=max_iter,
                      precond=pj)
    rt = tcg.cg_solve(lambda x: at @ x, torch.as_tensor(b),
                      torch.as_tensor(x0), torch.as_tensor(diag), tol=tol,
                      max_iter=max_iter, precond=pt)
    return rj, rt


@pytest.mark.parametrize("case", ["direct", "warm", "cap", "jacobi",
                                  "flexible"])
def test_cg_counts_match_jax(case):
    """The tests/test_cg.py cases: equal iteration counts and solutions."""
    if case == "direct":
        n = 64
        a, b = _spd(n), np.random.default_rng(1).standard_normal(n)
        args = (a, b, np.zeros(n), np.diag(a), 1e-10 * np.linalg.norm(b),
                1000)
    elif case == "warm":
        n = 32
        a, b = _spd(n, 2), np.random.default_rng(3).standard_normal(n)
        args = (a, b, np.linalg.solve(a, b), np.diag(a),
                1e-6 * np.linalg.norm(b), 100)
    elif case == "cap":
        n = 48
        args = (_spd(n, 4, 1e8), np.ones(n), np.zeros(n), np.ones(n),
                1e-300, 5)
    else:
        n = 96
        d = np.geomspace(1, 1e6, n)
        a = np.diag(d) + 0.1 * _spd(n, 7, 10)
        b = np.random.default_rng(8).standard_normal(n)
        args = (a, b, np.zeros(n), np.diag(a), 1e-8 * np.linalg.norm(b),
                10000)
    pre = np.diag(1.0 / np.diag(args[0])) if case == "flexible" else None
    rj, rt = _both(*args, precond=pre)
    assert rt.iterations == int(rj.iterations)
    assert rt.converged == bool(rj.converged)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-9,
                               atol=1e-12 * np.abs(np.asarray(rj.x)).max())
    if case == "warm":
        assert rt.iterations == 0
    if case == "jacobi":     # Jacobi beats no preconditioner (test_cg.py)
        a, b, x0, _, tol, cap = args
        r_id = tcg.cg_solve(lambda x: torch.as_tensor(a) @ x,
                            torch.as_tensor(b), torch.as_tensor(x0),
                            torch.ones(len(b), dtype=torch.float64), tol, cap)
        assert r_id.converged and rt.iterations < r_id.iterations


def test_batched_cg_lanes_match_jax():
    """Each lane stops at its own tolerance with its own count (the vmap
    lane semantics), lanes of very different scales."""
    n, k = 40, 3
    a = _spd(n, seed=5)
    rng = np.random.default_rng(6)
    b = rng.standard_normal((k, n))
    b[1] *= 1e6
    tol = 1e-9 * np.linalg.norm(b, axis=1)
    tol[2] = 1e-6 * np.linalg.norm(b[2])        # one lane stops early
    aj, at = jnp.asarray(a), torch.as_tensor(a)
    rj = jcg.cg_solve_batched(lambda x: aj @ x, jnp.asarray(b),
                              jnp.zeros((k, n)), jnp.asarray(np.diag(a)),
                              jnp.asarray(tol), max_iter=1000)
    rt = tcg.cg_solve_batched(lambda x: x @ at.T, torch.as_tensor(b),
                              torch.zeros((k, n), dtype=torch.float64),
                              torch.as_tensor(np.diag(a).copy()), tol,
                              max_iter=1000)
    np.testing.assert_array_equal(rt.iterations, np.asarray(rj.iterations))
    assert len(set(rt.iterations.tolist())) > 1
    np.testing.assert_array_equal(rt.converged, np.asarray(rj.converged))
    # CG roundoff differs between the two batched BLAS orders
    xj = np.asarray(rj.x)
    assert (np.abs(rt.x.numpy() - xj).max(axis=1)
            <= 1e-6 * np.abs(xj).max(axis=1)).all()


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_q1_transfer_axes_match_jax(axis):
    A = np.random.default_rng(axis).standard_normal((5, 7, 9))
    np.testing.assert_array_equal(
        tmg._q1_interp_axis(torch.as_tensor(A), axis).numpy(),
        np.asarray(jmg._q1_interp_axis(jnp.asarray(A), axis)))
    np.testing.assert_array_equal(
        tmg._q1_restrict_axis(torch.as_tensor(A), axis).numpy(),
        np.asarray(jmg._q1_restrict_axis(jnp.asarray(A), axis)))


@pytest.mark.parametrize("n,levels", [(8, 2), (16, 3)])
def test_pressure_vcycle_matches_jax_f64(n, levels):
    """The pressure GMG V-cycle output equals JAX's to 1e-12 (f64)."""
    data = read_input_file(DECK)
    lo, hi = np.zeros(3), np.asarray(data.domain_size, float)
    pj, lj = jmg.build_gmg_pressure(data, n_fine=n, n_levels=levels,
                                    dtype=jnp.float64, dt=data.time_step,
                                    lower=lo, upper=hi)
    pt, lt = tmg.build_gmg_pressure(data, n_fine=n, n_levels=levels,
                                    dtype=torch.float64, device="cpu",
                                    dt=data.time_step, lower=lo, upper=hi)
    assert [lv.lmax for lv in lt] == [lv.lmax for lv in lj]
    r = np.random.default_rng(n).standard_normal((n + 1) ** 3)
    ref = np.asarray(pj(jnp.asarray(r)))
    got = pt(torch.as_tensor(r)).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_pressure_gmg_cuts_cg_iterations():
    """GMG-preconditioned CG on the pressure Jacobian needs far fewer
    iterations than Jacobi-CG, with the same count as JAX."""
    from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver
    from poroelasticity_dealii_torch.solvers.structured import \
        build_grid_discretization
    data = read_input_file(DECK)
    n, dt = 16, data.time_step
    d = build_grid_discretization(data, cells_per_axis=n, device="cpu")
    s = FixedStressSolver(d, data)
    pre, _ = tmg.build_gmg_pressure(data, n_fine=n, n_levels=3,
                                    dtype=torch.float64, device="cpu", dt=dt)
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(d.n_pdofs))
    diag = s._pressure_jacobian_diag(dt)
    tol = 1e-8 * float(torch.linalg.norm(b))

    def jac(x):
        return s._pressure_jacobian_apply(x, dt)
    r_gmg = tcg.cg_solve(jac, b, torch.zeros_like(b), diag, tol=tol,
                         max_iter=1000, precond=pre)
    r_jac = tcg.cg_solve(jac, b, torch.zeros_like(b), diag, tol=tol,
                         max_iter=1000)
    assert r_gmg.converged and r_jac.converged
    assert 3 * r_gmg.iterations < r_jac.iterations
