"""The whole fixed-stress slice of the torch port against the JAX rows path
(``elasticity_backend="pallas"``, interpret mode on the CPU) in float64 at
n = 8 with pressure multigrid on, and the state carried across packages.

Both packages' ``_gmg_levels`` are patched to a low dof threshold, so the
pressure GMG V-cycle is on the path at this small size.  The mechanics
tolerance is relative (1e-10): the deck's absolute 1e-12 lies below the
float64 roundoff of its ~1e7-scale right-hand side, where CG counts are set
by roundoff (the JAX conv and rows paths differ by 3-4 iterations there).
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from poroelasticity_dealii_tpu.config import read_input_file  # noqa: E402
from poroelasticity_dealii_tpu.solvers import FixedStressSolver as JF  # noqa: E402
from poroelasticity_dealii_tpu.solvers import structured as jst  # noqa: E402

from poroelasticity_dealii_torch.interop import (state_from_numpy,  # noqa: E402
                                                 state_to_numpy)
from poroelasticity_dealii_torch.solvers import structured as tst  # noqa: E402
from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver  # noqa: E402

DECK = "configs/consolidation_3d.data"
N = 8
BC = [(1.05, 1.0), (1.1, 1.05)]     # (bc_scale, bc_scale_prev) per step
FIELDS = ("p", "u", "strains")


def _low_threshold(orig):
    def levels(*args, **kw):
        return orig(*args, **{**kw, "auto_threshold": 100})
    return levels


@pytest.fixture(scope="module")
def gmg_on():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jst, tst):
            mp.setattr(mod, "_gmg_levels", _low_threshold(mod._gmg_levels))
        yield


@pytest.fixture(scope="module")
def data():
    return dataclasses.replace(read_input_file(DECK), mech_cg_relative=True,
                               mech_cg_tol=1e-10)


@pytest.fixture(scope="module")
def jax_run(gmg_on, data):
    """JAX states (numpy) after initial_state and each step, and stats."""
    d = jst.build_grid_discretization(data, cells_per_axis=N,
                                      multigrid="off",
                                      elasticity_backend="pallas")
    s = JF(d, data)
    st = s.initial_state()
    states, stats = [st], []
    for bc, prev in BC:
        st, ss = s.time_step(st, data.time_step, bc, bc_scale_prev=prev)
        states.append(st)
        stats.append(ss)
    as_np = [{k: (None if getattr(x, k) is None else np.asarray(
        getattr(x, k))) for k in x._fields} for x in states]
    return as_np, stats


def _port(data):
    return FixedStressSolver(tst.build_grid_discretization(
        data, cells_per_axis=N, device="cpu"), data)


def _assert_fields(state, ref, rtol):
    for k in FIELDS:
        got, want = getattr(state, k).numpy(), ref[k]
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= rtol, (k, err)


def _assert_counts(got, want, slack=2):
    assert got.fss_iterations == int(want.fss_iterations)
    assert got.pressure_iterations == int(want.pressure_iterations)
    for f in ("pressure_cg_iterations", "mech_cg_iterations",
              "projection_cg_iterations"):
        assert abs(getattr(got, f) - int(getattr(want, f))) <= slack, f
    assert got.cg_converged and bool(want.cg_converged)
    np.testing.assert_allclose(got.pressure_error,
                               float(want.pressure_error), rtol=1e-6)


def test_pressure_gmg_on_the_path(gmg_on, data):
    s = _port(data)
    assert s._pressure_precond(data.time_step) is not None


def test_whole_slice_f64_matches_jax(gmg_on, data, jax_run):
    ref_states, ref_stats = jax_run
    s = _port(data)
    st = s.initial_state()
    eps_v0 = st.eps_v0
    _assert_fields(st, ref_states[0], 1e-8)
    for k, (bc, prev) in enumerate(BC):
        st, stats = s.time_step(st, data.time_step, bc, bc_scale_prev=prev)
        _assert_counts(stats, ref_stats[k])
        _assert_fields(st, ref_states[k + 1], 1e-8)
        np.testing.assert_allclose(st.eps_v.numpy(),
                                   ref_states[k + 1]["eps_v"], rtol=1e-8,
                                   atol=1e-8 * np.abs(
                                       ref_states[k + 1]["eps_v"]).max())
        assert torch.equal(st.eps_v0, eps_v0)   # the t = 0 strain, always


def test_state_carry_over_from_jax(gmg_on, data, jax_run):
    """JAX's state after step 1 -> port -> step 2 == JAX's step 2."""
    ref_states, ref_stats = jax_run
    st = state_from_numpy(ref_states[1], device="cpu")
    assert st.u_rows is not None and st.mech_b is not None
    back = state_to_numpy(st)
    for k, v in ref_states[1].items():
        assert np.array_equal(back[k], v)
    bc, prev = BC[1]
    st2, stats = _port(data).time_step(st, data.time_step, bc,
                                       bc_scale_prev=prev)
    _assert_counts(stats, ref_stats[1])
    _assert_fields(st2, ref_states[2], 1e-8)


def test_skip_if_unchanged_is_bitwise(data):
    """A repeated RHS skips the mechanics solve: 0 CG iterations and the
    warm start returned unchanged."""
    s = _port(data)
    st = s.initial_state()
    # a non-uniform pressure: a new RHS the first solve must iterate on
    # (a uniform one only loads the fully constrained boundary normals)
    rng = np.random.default_rng(0)
    p = st.p * torch.as_tensor(1.0 + 0.01 * rng.random(st.p.shape[0]))
    u1, it1, ok1, _, b1 = s._mechanics_solve(p, st.u_rows)
    assert it1 > 0 and ok1
    u2, it2, ok2, _, b2 = s._mechanics_solve(p, u1, b_prev=b1)
    assert torch.equal(b1, b2)
    assert it2 == 0 and ok2 and torch.equal(u2, u1)
