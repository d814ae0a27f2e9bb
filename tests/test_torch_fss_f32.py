"""The torch port's fixed-stress step in float32 (the bench tolerances)
against the JAX rows path at n = 4, the degenerate first-iteration rule,
and the runner."""

import dataclasses
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from poroelasticity_dealii_tpu.config import read_input_file  # noqa: E402
from poroelasticity_dealii_tpu.solvers import FixedStressSolver as JF  # noqa: E402
from poroelasticity_dealii_tpu.solvers import structured as jst  # noqa: E402

from poroelasticity_dealii_torch.models.runner import SimulationRunner  # noqa: E402
from poroelasticity_dealii_torch.solvers import structured as tst  # noqa: E402
from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver  # noqa: E402

DECK = "configs/consolidation_3d.data"


def _bench_data():
    """bench.py::build's overrides of the 3D deck."""
    return dataclasses.replace(
        read_input_file(DECK), dtype="float32", flow_rate=1e-2,
        fss_tol=2e-5, pressure_tol=2e-5, mech_cg_tol=1e-5,
        mech_cg_relative=True, pressure_cg_tol=1e-5, projection_cg_tol=1e-5)


def _pair(data, n):
    j = JF(jst.build_grid_discretization(data, cells_per_axis=n,
                                         multigrid="off",
                                         elasticity_backend="pallas"), data)
    t = FixedStressSolver(tst.build_grid_discretization(
        data, cells_per_axis=n, device="cpu"), data)
    return j, t


def test_whole_slice_f32_matches_jax():
    """Two evolving steps: fields within 2e-5 of their max (the
    tests/test_pallas.py f32 tolerance), equal FSS/pressure counts."""
    data = _bench_data()
    js, ts = _pair(data, 4)
    jst_, tst_ = js.initial_state(), ts.initial_state()
    assert tst_.p.dtype == torch.float32
    for bc, prev in ((1.05, 1.0), (1.1, 1.05)):
        jst_, jstats = js.time_step(jst_, data.time_step, bc,
                                    bc_scale_prev=prev)
        tst_, tstats = ts.time_step(tst_, data.time_step, bc,
                                    bc_scale_prev=prev)
        assert tstats.fss_iterations == int(jstats.fss_iterations)
        assert tstats.pressure_iterations == int(jstats.pressure_iterations)
        assert tstats.cg_converged and tstats.mech_cg_iterations > 0
        for k in ("p", "u", "strains"):
            got = getattr(tst_, k).double().numpy()
            want = np.asarray(getattr(jst_, k), np.float64)
            assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max(), k


def test_zero_fss_iterations_keep_shear_strains():
    """fss_tol >= 2 pressure_tol: the FSS loop may run no iteration, and
    the shear projection must then use the real RHS (as in JAX)."""
    data = dataclasses.replace(read_input_file(DECK), fss_tol=1e-1,
                               pressure_tol=1e-3)
    js, ts = _pair(data, 3)
    jst_, jstats = js.time_step(js.initial_state(), data.time_step)
    tst_, tstats = ts.time_step(ts.initial_state(), data.time_step)
    assert tstats.fss_iterations == int(jstats.fss_iterations) == 0
    ref = np.asarray(jst_.strains)
    assert np.abs(ref[[1, 2, 4]]).max() > 0
    np.testing.assert_allclose(tst_.strains.numpy(), ref, rtol=1e-8,
                               atol=1e-10 * np.abs(ref).max())


def test_runner_writes_vtk_and_run_log(tmp_path):
    data = dataclasses.replace(read_input_file(DECK), cells_per_axis=(3,) * 3,
                               t_max=120.0,
                               output_directory=str(tmp_path / "out"))
    state = SimulationRunner(data, device="cpu").run()
    assert state.u is not None and bool(torch.isfinite(state.u).all())
    vtks = sorted((tmp_path / "out").glob("solution-*.vtk"))
    assert [v.name for v in vtks] == ["solution-0000.vtk",
                                      "solution-0001.vtk",
                                      "solution-0002.vtk"]
    assert "POINTS 64 double" in vtks[-1].read_text()
    recs = [json.loads(line) for line in
            (tmp_path / "out" / "run_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(r["fss_iterations"] >= 1 for r in recs)


@pytest.mark.parametrize("field,value", [("amr", True),
                                         ("sharding", "ghost")])
def test_runner_rejects_unported_features(field, value):
    # AMR runs (tests/test_torch_amr.py), with psum too, and ghost runs
    # (tests/test_torch_ghost.py); AMR with ghost keeps JAX's refusal, and
    # a ghost deck with orbax checkpoints (the port's asynchronous
    # directories) builds: on one process unsharded, with the warning
    from poroelasticity_dealii_torch.amr.driver import AMRSimulationRunner
    data = dataclasses.replace(read_input_file(DECK),
                               **{"sharding": "ghost", field: value})
    if field == "amr":
        with pytest.raises(NotImplementedError,
                           match="only 'psum' supports hanging-node"):
            AMRSimulationRunner(data, device="cpu")
        return
    data = dataclasses.replace(data, checkpoint_format="orbax")
    with pytest.warns(RuntimeWarning, match="single process"):
        runner = SimulationRunner(data, device="cpu")
    assert runner.data.checkpoint_format == "orbax"
    assert type(runner.disc).__name__ == "Discretization"


def test_unported_discretizations_raise():
    """Anisotropic grids build in 2D and 3D as JAX's conv backend does
    (mass and elasticity applies against JAX's to 1e-12); the parity
    backend stays 2D only (JAX's error)."""
    data = read_input_file("configs/golden_2d.data")
    assert tst.build_grid_discretization(data, device="cpu").dim == 2
    data3 = read_input_file(DECK)
    rng = np.random.default_rng(0)
    for d, ns in ((data, (4, 8)), (data3, (2, 2, 3))):
        td = tst.build_grid_discretization(d, cells_per_axis=ns,
                                           device="cpu")
        jd = jst.build_grid_discretization(d, cells_per_axis=ns)
        assert td.info_u.cells_per_axis == ns and td.row_ops is None
        p = rng.standard_normal(td.n_pdofs)
        u = rng.standard_normal(td.n_udofs)
        for got, want in ((td.mass(torch.tensor(p)), jd.mass(p)),
                          (td.elasticity(torch.tensor(u)),
                           jd.elasticity(u))):
            want = np.asarray(want)
            assert np.abs(got.numpy() - want).max() \
                <= 1e-12 * np.abs(want).max()
    # the conv backend is ported; the parity backend is 2D only
    assert tst.build_grid_discretization(
        data3, elasticity_backend="conv", device="cpu").row_ops is None
    with pytest.raises(NotImplementedError, match="needs a 2D"):
        tst.build_grid_discretization(data3, elasticity_backend="parity",
                                      device="cpu")
