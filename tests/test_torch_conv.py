"""The conv (flat-vector) backend of the port's 3D structured
discretization and its flat fixed-stress branches against the JAX
package's conv backend (``elasticity_backend="conv"``), in float64 on the
CPU.

* Operators at n = 3, 4 to 1e-12 of max |y|.
* Three FSS steps at n = 4: FSS, pressure and all CG counts exact,
  ``pressure_error`` to rtol 1e-6, fields to 1e-8 of max.  The mechanics
  tolerance is relative (1e-10): the deck's absolute 1e-12 lies below the
  float64 roundoff of its ~1e7-scale right-hand side, where CG counts are
  set by roundoff and summation order.
* The deck as written (8^3, absolute 1e-12) for 2 steps: FSS and pressure
  counts exact, ``pressure_error`` to rtol 1e-6, fields to 1e-8 of max,
  mechanics CG counts within 8 of JAX's and the other CG counts within 2
  (the roundoff regime above: the JAX rows and conv backends themselves
  differ by a few iterations there).
* The bitwise skip-if-unchanged rule on flat vectors, a JAX flat state
  carried into the port, and the CLI on a deck that asks for ``conv``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from poroelasticity_dealii_tpu.config import read_input_file as jread  # noqa: E402
from poroelasticity_dealii_tpu.solvers import FixedStressSolver as JF  # noqa: E402
from poroelasticity_dealii_tpu.solvers import structured as jst  # noqa: E402

from poroelasticity_dealii_torch.cli import main as cli_main  # noqa: E402
from poroelasticity_dealii_torch.config import read_input_file  # noqa: E402
from poroelasticity_dealii_torch.interop import state_from_numpy  # noqa: E402
from poroelasticity_dealii_torch.solvers import structured as tst  # noqa: E402
from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver  # noqa: E402

DECK = "configs/consolidation_3d.data"
BC = [(1.05, 1.0), (1.1, 1.05), (1.1, 1.1)]  # (bc_scale, prev) per step
FIELDS = ("p", "u", "strains", "eps_v")


def _rel_mech(data):
    return dataclasses.replace(data, mech_cg_relative=True, mech_cg_tol=1e-10)


def _jax_disc(data, n):
    return jst.build_grid_discretization(data, cells_per_axis=n,
                                         multigrid="off",
                                         elasticity_backend="conv")


def _port_disc(data, n):
    return tst.build_grid_discretization(data, cells_per_axis=n,
                                         multigrid="off",
                                         elasticity_backend="conv",
                                         device="cpu")


def _np_state(st):
    return {k: (None if getattr(st, k) is None else np.asarray(getattr(st, k)))
            for k in st._fields}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _assert_fields(state, ref, tol=1e-8):
    for k in FIELDS:
        assert _rel(getattr(state, k), ref[k]) <= tol, k


def _assert_counts(got, want, slack_mech=0, slack=0):
    assert got.fss_iterations == int(want.fss_iterations)
    assert got.pressure_iterations == int(want.pressure_iterations)
    assert abs(got.mech_cg_iterations - int(want.mech_cg_iterations)) \
        <= slack_mech
    for f in ("pressure_cg_iterations", "projection_cg_iterations"):
        assert abs(getattr(got, f) - int(getattr(want, f))) <= slack, f
    assert got.cg_converged and bool(want.cg_converged)
    np.testing.assert_allclose(got.pressure_error,
                               float(want.pressure_error), rtol=1e-6)


@pytest.mark.parametrize("n", [3, 4])
def test_conv_operators_match_jax(n):
    data = read_input_file(DECK)
    j, t = _jax_disc(jread(DECK), n), _port_disc(data, n)
    assert t.row_ops is None and t.dtype == torch.float64
    rng = np.random.default_rng(n)
    u = rng.standard_normal(t.n_udofs)
    p = rng.standard_normal(t.n_pdofs)
    ut, pt = torch.as_tensor(u), torch.as_tensor(p)
    pairs = [
        (t.elasticity(ut), j.elasticity(u)),
        (t.elasticity_constrained(ut), j.elasticity_constrained(u)),
        (t.coupling_rhs(pt, data.biot_coef), j.coupling_rhs(p,
                                                            data.biot_coef)),
        (t.strain_projection_rhs(ut), j.strain_projection_rhs(u)),
        (t.mass(pt), j.mass(p)),
        (t.laplace(pt), j.laplace(p)),
        (t.diag_elasticity, j.diag_elasticity),
    ]
    for got, want in pairs:
        assert tuple(got.shape) == tuple(np.shape(want))
        assert _rel(got, want) <= 1e-12
    assert tuple(t.strain_projection_rhs(ut).shape) == (6, t.n_pdofs)


@pytest.mark.parametrize("kernels", ["auto", "plain"])
def test_conv_elasticity_on_cpu_is_the_plain_stencil(kernels):
    """On the CPU the conv backend's elasticity apply stays the plain
    stencil (``make_stencil_apply``), bit for bit, with either ``kernels``
    setting; only a CUDA device with ``kernels="auto"`` takes the flat
    kernel."""
    from poroelasticity_dealii_torch.ops.stencil import make_stencil_apply
    data = read_input_file(DECK)
    n = 3
    d = tst.build_grid_discretization(data, cells_per_axis=n,
                                      multigrid="off",
                                      elasticity_backend="conv",
                                      device="cpu", kernels=kernels)
    ref = make_stencil_apply(d.element_ke, 2, 2, 3, 3, 3, n, d.dtype, "cpu")
    u = torch.as_tensor(np.random.default_rng(7).standard_normal(d.n_udofs))
    assert torch.equal(d.stencil_elasticity(u), ref(u))
    assert torch.equal(d.elasticity(u), ref(u))


@pytest.fixture(scope="module")
def jax_n4():
    """JAX conv states (numpy) after initial_state and each step, and
    stats, at n = 4 with the relative mechanics tolerance."""
    data = _rel_mech(jread(DECK))
    s = JF(_jax_disc(data, 4), data)
    st = s.initial_state()
    states, stats = [_np_state(st)], []
    for bc, prev in BC:
        st, ss = s.time_step(st, data.time_step, bc, bc_scale_prev=prev)
        states.append(_np_state(st))
        stats.append(ss)
    return states, stats


def test_three_fss_steps_match_jax_conv(jax_n4):
    ref_states, ref_stats = jax_n4
    data = _rel_mech(read_input_file(DECK))
    s = FixedStressSolver(_port_disc(data, 4), data)
    st = s.initial_state()
    assert st.u_rows is None and st.mech_b.shape == st.u.shape
    _assert_fields(st, ref_states[0])
    for k, (bc, prev) in enumerate(BC):
        st, stats = s.time_step(st, data.time_step, bc, bc_scale_prev=prev,
                                want_u=False)       # no-op on flat vectors
        assert st.u is not None and st.u_rows is None
        _assert_counts(stats, ref_stats[k])
        _assert_fields(st, ref_states[k + 1])
        assert _rel(st.eps_v0, ref_states[0]["eps_v0"]) <= 1e-8


def test_jax_flat_state_carries_over(jax_n4):
    """JAX's flat state after step 1 (u_rows None) -> port -> step 2 ==
    JAX's step 2."""
    ref_states, ref_stats = jax_n4
    assert ref_states[1]["u_rows"] is None
    data = _rel_mech(read_input_file(DECK))
    st = state_from_numpy(ref_states[1], device="cpu")
    assert st.u_rows is None and st.mech_b is not None
    bc, prev = BC[1]
    st2, stats = FixedStressSolver(_port_disc(data, 4), data).time_step(
        st, data.time_step, bc, bc_scale_prev=prev)
    _assert_counts(stats, ref_stats[1])
    _assert_fields(st2, ref_states[2])


def test_deck_as_written_matches_jax():
    """8^3, float64, the deck's absolute mechanics tolerance, 2 steps:
    what the JAX package runs for this deck on the CPU (its
    ``Elasticity backend = auto`` resolves to conv off a TPU)."""
    jdata = jread(DECK)
    jd = jst.build_grid_discretization(jdata)
    assert getattr(jd, "row_ops", None) is None
    js = JF(jd, jdata)
    data = read_input_file(DECK)
    ts = FixedStressSolver(tst.build_grid_discretization(
        data, elasticity_backend="conv", device="cpu"), data)
    sj, st = js.initial_state(), ts.initial_state()
    _assert_fields(st, _np_state(sj))
    for _ in range(2):
        sj, aj = js.time_step(sj, jdata.time_step)
        st, at = ts.time_step(st, data.time_step)
        _assert_counts(at, aj, slack_mech=8, slack=2)
        _assert_fields(st, _np_state(sj))


def test_skip_if_unchanged_is_bitwise_on_flat_vectors():
    data = read_input_file(DECK)
    s = FixedStressSolver(_port_disc(data, 4), data)
    st = s.initial_state()
    rng = np.random.default_rng(0)
    p = st.p * torch.as_tensor(1.0 + 0.01 * rng.random(st.p.shape[0]))
    u1, it1, ok1, _, b1 = s._mechanics_solve(p, st.u)
    assert it1 > 0 and ok1 and u1.shape == st.u.shape
    u2, it2, ok2, _, b2 = s._mechanics_solve(p, u1, b_prev=b1)
    assert torch.equal(b1, b2)
    assert it2 == 0 and ok2 and torch.equal(u2, u1)


def test_conv_multigrid_auto_refused_where_jax_builds_gmg(monkeypatch):
    """Where JAX's 'auto' builds elasticity GMG on the 3D conv backend
    (the level rule patched to 2 levels at n = 4 in both packages), the
    port builds the same hierarchy: the two V-cycles agree to 1e-12 on a
    seeded free vector.  The rows backend builds none on 'auto' (as JAX);
    the parity backend is 2D only."""
    data = read_input_file(DECK)
    for mod in (tst, jst):
        monkeypatch.setattr(mod, "_gmg_levels", lambda *a, **k: 2)
    td = tst.build_grid_discretization(data, cells_per_axis=4,
                                       elasticity_backend="conv",
                                       device="cpu")
    jd = jst.build_grid_discretization(jread(DECK), cells_per_axis=4,
                                       elasticity_backend="conv")
    assert td.gmg_precond is not None and jd.gmg_precond is not None
    r = np.random.default_rng(4).standard_normal(td.n_udofs) \
        * td.free_mask_u.numpy()
    want = np.asarray(jd.gmg_precond(r))
    got = td.gmg_precond(torch.tensor(r)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    # the rows backend builds no elasticity GMG on 'auto' (as JAX)
    rows = tst.build_grid_discretization(data, cells_per_axis=4,
                                         device="cpu")
    assert rows.row_ops is not None and rows.gmg_precond is None
    with pytest.raises(NotImplementedError, match="needs a 2D"):
        tst.build_grid_discretization(data, cells_per_axis=4,
                                      elasticity_backend="parity",
                                      device="cpu")


def test_cli_runs_a_conv_deck_on_cpu(tmp_path, monkeypatch):
    text = open(DECK).read() + ("\nsubsection TPU\n"
                                "  set Elasticity backend = conv\n"
                                "  set Output VTK = false\nend\n")
    deck = tmp_path / "conv.data"
    deck.write_text(text.replace("set Time max   = 360",
                                 "set Time max   = 120"))
    monkeypatch.chdir(tmp_path)
    assert cli_main(["run", str(deck), "--device", "cpu"]) == 0
    log = [json.loads(line) for line in
           (tmp_path / "solution" / "run_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == [1, 2]
    assert all(r["fss_iterations"] >= 1 for r in log)
