"""The torch port's 2D structured path against the JAX package and the
repo's own 2D checks, in float64 on the CPU:

* whole fixed-stress steps at n = 8 on the parity kit with the
  parity-resident elasticity GMG (GMG-CG in f64), on flat vectors with the
  flat elasticity GMG, and on flat vectors with Jacobi-CG, against JAX's
  same build (both packages' ``_gmg_levels`` patched to a low threshold,
  so the pressure GMG and the flat path's ``auto`` elasticity GMG are on
  at this size): FSS and pressure counts exact, the other CG counts
  within 2, p, u and strains to 1e-9 of their max;
* the state carried from JAX's parity run into the port
  (``state_from_numpy(..., row_ops=parity_kit)``);
* the golden deck through the port's structured f64 path against
  ``tests/data/golden_history.json`` (17 steps, FSS and pressure counts
  exact, residuals to 1e-6), and through the CLI, its VTK output against
  JAX's runner;
* Terzaghi against the analytic series and Mandel against its series, as
  JAX's ``tests/test_terzaghi.py`` and ``tests/test_mandel.py`` check them,
  on the port's structured grid with the same tolerances;
* the runner's stagnation warning.

Captured against eager on the card is in ``tests/test_torch_multi_step.py``
(this module imports jax, which the GPU machine does not have)."""

import dataclasses
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from poroelasticity_dealii_tpu.config import read_input_file  # noqa: E402
from poroelasticity_dealii_tpu.models.runner import \
    run_from_data as jrun  # noqa: E402
from poroelasticity_dealii_tpu.solvers import FixedStressSolver as JF  # noqa: E402
from poroelasticity_dealii_tpu.solvers import structured as jst  # noqa: E402

from poroelasticity_dealii_torch.cli import main as cli_main  # noqa: E402
from poroelasticity_dealii_torch.interop import (state_from_numpy,  # noqa: E402
                                                 state_to_numpy)
from poroelasticity_dealii_torch.models import mandel as tmandel  # noqa: E402
from poroelasticity_dealii_torch.models import terzaghi as tterz  # noqa: E402
from poroelasticity_dealii_torch.models.runner import \
    SimulationRunner  # noqa: E402
from poroelasticity_dealii_torch.ops.parity2d import \
    ElasticityParityOps  # noqa: E402
from poroelasticity_dealii_torch.solvers import structured as tst  # noqa: E402
from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver  # noqa: E402

GOLDEN = "configs/golden_2d.data"
REPO_DECK = Path(__file__).resolve().parent.parent / GOLDEN
HISTORY = "tests/data/golden_history.json"
N = 8
BC = [(1.05, 1.0), (1.1, 1.05)]     # (bc_scale, bc_scale_prev) per step
FIELDS = ("p", "u", "strains")
FIELD_TOL = 1e-9
CG_SLACK = 2
# (elasticity backend, multigrid): the parity kit with parity-resident
# GMG, flat vectors with the flat GMG ('auto' at the patched threshold),
# flat Jacobi-CG
PATHS = [("parity", "on"), ("conv", "auto"), ("conv", "off")]


def _low_threshold(orig):
    def levels(*args, **kw):
        return orig(*args, **{**kw, "auto_threshold": 100})
    return levels


@pytest.fixture
def gmg_on(monkeypatch):
    """The port's ``_gmg_levels`` at the low threshold, for one test."""
    monkeypatch.setattr(tst, "_gmg_levels", _low_threshold(tst._gmg_levels))


@pytest.fixture(scope="module")
def data():
    """The golden deck with a relative mechanics tolerance (its absolute
    1e-12 lies below the f64 roundoff of its right-hand side, where counts
    follow the summation order)."""
    return dataclasses.replace(read_input_file(GOLDEN),
                               mech_cg_relative=True, mech_cg_tol=1e-10)


def _np(state):
    return {k: (None if getattr(state, k) is None else
                np.asarray(getattr(state, k))) for k in state._fields}


@pytest.fixture(scope="module")
def jax_runs(data):
    """Per path: JAX states (numpy) after initial_state and each step, and
    the step stats, JAX's ``_gmg_levels`` at the low threshold."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jst, "_gmg_levels", _low_threshold(jst._gmg_levels))
        return _jax_runs(data)


def _jax_runs(data):
    out = {}
    for eb, mg in PATHS:
        d = jst.build_grid_discretization(data, cells_per_axis=N,
                                          multigrid=mg, elasticity_backend=eb)
        s = JF(d, data)
        st = s.initial_state()
        states, stats = [_np(st)], []
        for bc, prev in BC:
            st, ss = s.time_step(st, data.time_step, bc, bc_scale_prev=prev)
            states.append(_np(st))
            stats.append(ss)
        out[(eb, mg)] = (states, stats)
    return out


def _port(data, eb, mg):
    return FixedStressSolver(tst.build_grid_discretization(
        data, cells_per_axis=N, multigrid=mg, elasticity_backend=eb,
        device="cpu"), data)


def _assert_fields(state, ref):
    for k in FIELDS:
        got, want = getattr(state, k).numpy(), ref[k]
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= FIELD_TOL, (k, err)


def _assert_counts(got, want):
    assert got.fss_iterations == int(want.fss_iterations)
    assert got.pressure_iterations == int(want.pressure_iterations)
    for f in ("pressure_cg_iterations", "mech_cg_iterations",
              "projection_cg_iterations"):
        assert abs(getattr(got, f) - int(getattr(want, f))) <= CG_SLACK, f
    assert got.cg_converged == bool(want.cg_converged)
    assert got.cg_stalled == bool(want.cg_stalled)
    np.testing.assert_allclose(got.pressure_error,
                               float(want.pressure_error), rtol=1e-6)


@pytest.mark.parametrize("eb,mg", PATHS)
def test_2d_path_selection(gmg_on, data, eb, mg):
    d = _port(data, eb, mg).disc
    assert isinstance(d.row_ops, ElasticityParityOps) == (eb == "parity")
    assert (d.gmg_precond is not None) == (mg != "off")
    assert (d.gmg_precond_rows is not None) == (eb == "parity")
    # 'auto' at the real threshold: flat below 150,000 displacement dofs
    # (the golden deck), the parity kit from it (bench.py::build_2d's 512^2)
    assert tst.build_grid_discretization(
        data, device="cpu").row_ops is None


@pytest.mark.parametrize("eb,mg", PATHS)
def test_2d_steps_match_jax(gmg_on, data, jax_runs, eb, mg):
    ref_states, ref_stats = jax_runs[(eb, mg)]
    s = _port(data, eb, mg)
    st = s.initial_state()
    _assert_fields(st, ref_states[0])
    for k, (bc, prev) in enumerate(BC):
        st, stats = s.time_step(st, data.time_step, bc, bc_scale_prev=prev)
        _assert_counts(stats, ref_stats[k])
        _assert_fields(st, ref_states[k + 1])
        assert stats.mech_cg_iterations > 0


def test_parity_state_carries_over_from_jax(gmg_on, data, jax_runs):
    """JAX's parity state after step 1 (``u_rows`` and ``mech_b`` in the
    parity layout) -> port -> step 2 == JAX's step 2."""
    ref_states, ref_stats = jax_runs[("parity", "on")]
    s = _port(data, "parity", "on")
    kit = s.disc.row_ops
    st = state_from_numpy(ref_states[1], device="cpu", row_ops=kit)
    assert st.u_rows.shape == (2, 2, 2, N + 1, N + 1)
    assert np.array_equal(st.u_rows.numpy(), ref_states[1]["u_rows"])
    assert np.array_equal(st.mech_b.numpy(), ref_states[1]["mech_b"])
    back = state_to_numpy(st)
    for k in ("p", "u", "eps_v", "eps_v0", "strains"):
        assert np.array_equal(back[k], ref_states[1][k])
    bc, prev = BC[1]
    st2, stats = s.time_step(st, data.time_step, bc, bc_scale_prev=prev)
    _assert_counts(stats, ref_stats[1])
    _assert_fields(st2, ref_states[2])


def test_skip_if_unchanged_fires_on_the_parity_path(gmg_on, data):
    """A repeated right-hand side is bitwise equal on the parity kit: the
    second GMG solve takes 0 iterations and returns its warm start."""
    s = _port(data, "parity", "on")
    st = s.initial_state()
    rng = np.random.default_rng(0)
    p = st.p * torch.as_tensor(1.0 + 0.01 * rng.random(st.p.shape[0]))
    u1, it1, ok1, _, b1 = s._mechanics_solve(p, st.u_rows)
    u2, it2, ok2, _, b2 = s._mechanics_solve(p, u1, b_prev=b1)
    assert it1 > 0 and ok1 and torch.equal(b1, b2)
    assert it2 == 0 and ok2 and torch.equal(u2, u1)


def test_golden_history_structured_f64():
    """The port's structured golden run reproduces the pinned history."""
    with open(HISTORY) as fh:
        recorded = json.load(fh)
    data = read_input_file(GOLDEN)
    disc = tst.build_grid_discretization(data, device="cpu")
    assert disc.row_ops is None and disc.dtype == torch.float64
    assert disc.gmg_precond is None          # the flat Jacobi-CG path
    solver = FixedStressSolver(disc, data)
    assert solver._pressure_precond(data.time_step) is None
    state = solver.initial_state()
    t = 0.0
    for rec in recorded:
        t += data.time_step
        state, s = solver.time_step(state, data.time_step)
        assert s.fss_iterations == rec["fss_iterations"], t
        assert s.pressure_iterations == rec["pressure_iterations"], t
        np.testing.assert_allclose(s.pressure_error, rec["pressure_error"],
                                   rtol=1e-6)
        hist = [float(x) for x in s.fss_error_history if x >= 0]
        np.testing.assert_allclose(hist, rec["fss_error_history"],
                                   rtol=1e-6)
    assert abs(t - 1020.0) < 1e-9
    assert len(recorded) == 17


def _vtk(path):
    """(n points, {scalar name: values}) of a legacy ASCII VTK file."""
    lines = path.read_text().splitlines()
    n = next(int(ln.split()[1]) for ln in lines if ln.startswith("POINTS"))
    out = {ln.split()[1]: np.array([float(v) for v in lines[i + 2:i + 2 + n]])
           for i, ln in enumerate(lines) if ln.startswith("SCALARS")}
    return n, out


def test_cli_golden_run_and_vtk_match_jax(tmp_path, monkeypatch):
    """``run configs/golden_2d.data --device cpu``: 17 steps (fss = 1,
    pressure 5 -> 0) and 18 VTK files; the last one's fields equal JAX's
    runner's to 1e-6 of their max, 289 points, sigma_yy != sigma_xx."""
    monkeypatch.chdir(tmp_path)
    assert cli_main(["run", str(REPO_DECK), "--device", "cpu"]) == 0
    log = [json.loads(ln) for ln in (tmp_path / "solution" /
                                     "run_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == list(range(1, 18))
    assert all(r["fss_iterations"] == 1 for r in log)
    assert log[0]["pressure_iterations"] == 5
    assert log[-1]["pressure_iterations"] == 0
    vtks = sorted((tmp_path / "solution").glob("solution-*.vtk"))
    assert len(vtks) == 18
    jdir = tmp_path / "jax"
    jrun(dataclasses.replace(read_input_file(str(REPO_DECK)),
                             output_directory=str(jdir)))
    n_t, got = _vtk(vtks[-1])
    n_j, want = _vtk(jdir / "solution-0017.vtk")
    assert n_t == n_j == 289
    assert set(got) == set(want)
    for name, v in want.items():
        scale = max(np.abs(v).max(), 1e-300)
        assert np.abs(got[name] - v).max() <= 1e-6 * scale, name
    assert np.any(got["sigma_yy"] != got["sigma_xx"])


def test_cli_runs_the_terzaghi_deck(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    text = (REPO_DECK.parent / "terzaghi_2d.data").read_text()
    deck = tmp_path / "terzaghi.data"
    deck.write_text(text + "\nsubsection TPU\n  set Output VTK = false\nend\n")
    assert cli_main(["run", str(deck), "--device", "cpu"]) == 0
    log = [json.loads(ln) for ln in (tmp_path / "solution" /
                                     "run_log.jsonl").read_text().splitlines()]
    assert len(log) == 10 and all(r["fss_iterations"] >= 1 for r in log)


# ---------------------------------------------------------------------------
# analytic checks on the port's structured grid (JAX's tolerances)
# ---------------------------------------------------------------------------

H, P0 = 10.0, 1e5


def test_terzaghi_corrected_mode_matches_analytical_series():
    data = tterz.terzaghi_config(level=4, dt=25.0, resync=True)
    cv = tterz.consolidation_coefficient(data)
    disc = tst.build_grid_discretization(data, device="cpu")
    solver = FixedStressSolver(disc, data)
    st = solver.initial_state()
    for _ in range(10):
        st, _ = solver.time_step(st, data.time_step)
    z = H / 2 - disc.pressure_space.node_coords[:, 1]
    p_ana = tterz.terzaghi_pressure(z, 250.0, cv, H, P0)
    err = np.linalg.norm(st.p.numpy() - p_ana) / np.linalg.norm(p_ana)
    assert err < 0.03, err               # backward-Euler-dominated


A_M, FORCE = 10.0, 7.2e6


@pytest.fixture(scope="module")
def mandel_run():
    data = tmandel.mandel_config(a=A_M, level=4, dt=5.0)
    mp = tmandel.mandel_params(data, a=A_M, b=A_M, force=FORCE)
    p0 = FORCE * mp.skempton * (1 + mp.nu_u) / (3 * A_M)
    data = dataclasses.replace(data, p_init=float(p0))
    disc = tst.build_grid_discretization(data, lower=[0.0, 0.0],
                                         upper=[A_M, A_M], device="cpu")
    solver = FixedStressSolver(disc, data)
    st = solver.initial_state(
        bc_scale=tmandel.mandel_plate_displacement(0.0, mp))
    coords = disc.pressure_space.node_coords
    center = np.argmin(np.linalg.norm(coords, axis=1))
    t, p_center, snapshots = 0.0, [], {}
    for step in range(40):
        t += data.time_step
        st, _ = solver.time_step(
            st, data.time_step,
            bc_scale=tmandel.mandel_plate_displacement(t, mp))
        p_center.append(float(st.p[center]))
        if step in (9, 19, 39):
            snapshots[t] = st.p.numpy().copy()
    return mp, coords, p0, p_center, snapshots


def test_mandel_pressure_field_matches_series(mandel_run):
    mp, coords, _, _, snapshots = mandel_run
    for t, p_num in snapshots.items():
        p_ana = tmandel.mandel_pressure(coords[:, 0], t, mp)
        err = np.linalg.norm(p_num - p_ana) / np.linalg.norm(p_ana)
        assert err < 0.06, (t, err)      # backward-Euler dominated, O(dt)


def test_mandel_cryer_effect_and_drainage(mandel_run):
    _, coords, p0, p_center, snapshots = mandel_run
    peak = max(p_center)
    assert peak > 1.005 * p0, (peak, p0)
    assert p_center[-1] < peak
    p_last = snapshots[max(snapshots)]
    assert p_last[np.isclose(coords[:, 1], A_M)].min() >= -1e-6 * p0
    np.testing.assert_allclose(p_last[np.isclose(coords[:, 0], A_M)], 0.0,
                               atol=1e-9 * p0)


# ---------------------------------------------------------------------------
# the runner's stagnation warning
# ---------------------------------------------------------------------------

def test_runner_warns_on_a_stalled_mechanics_solve(tmp_path):
    """bench.py::build_2d's f32 tolerances at 64^2: the GMG-Richardson
    mechanics solve stops at the f32 floor of its true residual (above
    1e-5 relative), as in the JAX package, and the runner says so."""
    from poroelasticity_dealii_torch.tools.profile_step import data_2d
    data = dataclasses.replace(
        data_2d(), cells_per_axis=(64, 64), elasticity_backend="parity",
        t_max=60.0, output_vtk=False, output_directory=str(tmp_path))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tst, "_gmg_levels", _low_threshold(tst._gmg_levels))
        runner = SimulationRunner(data, device="cpu")
        assert runner.disc.gmg_precond_rows is not None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        runner.run()
    assert any("stagnated" in str(w.message) for w in caught), \
        [str(w.message) for w in caught]
