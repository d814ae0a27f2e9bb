"""The port's ``multi_step`` and the runner's ``Steps per dispatch`` /
``Sync every``.

* ``multi_step`` against K ``time_step`` calls of the port, float64 at
  n = 8 with a Dirichlet ramp and ``bc_scale_prev``: the block runs the
  same device-resident steps, so states and stacked stats must be equal
  bit for bit.
* ``multi_step`` against the JAX package's ``multi_step`` (rows backend,
  Pallas in interpret mode) from the same start state, carried across by
  ``interop.py``, with pressure multigrid on (the low-threshold patch of
  ``tests/test_torch_fss.py``).
* the runner with blocks and deferred syncs against its default run.
* on the card: the captured CUDA-graph chunks against the eager chunks,
  on the 3D deck and on the 2D golden deck's parity and flat paths with
  the elasticity GMG (GMG-CG in float64, GMG-Richardson in float32).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from poroelasticity_dealii_torch import read_input_file
from poroelasticity_dealii_torch.interop import state_from_numpy
from poroelasticity_dealii_torch.models.runner import SimulationRunner
from poroelasticity_dealii_torch.solvers import structured as tst
from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver, \
    StepStats

DECK = "configs/consolidation_3d.data"
N = 8
RAMP = [1.05, 1.1, 1.1]           # two evolving steps, then a steady one
STATE_FIELDS = ("p", "u", "eps_v", "eps_v0", "strains", "u_rows", "mech_b")
COUNTS = ("fss_iterations", "pressure_iterations", "pressure_cg_iterations",
          "mech_cg_iterations", "projection_cg_iterations")


def _low_threshold(orig):
    def levels(*args, **kw):
        return orig(*args, **{**kw, "auto_threshold": 100})
    return levels


@pytest.fixture(scope="module")
def data():
    """The deck with the relative mechanics tolerance of
    ``tests/test_torch_fss.py`` (the deck's absolute 1e-12 lies below the
    float64 roundoff of its right-hand side)."""
    return dataclasses.replace(read_input_file(DECK), mech_cg_relative=True,
                               mech_cg_tol=1e-10)


def _port(data, backend="auto", n=N, device="cpu", **kw):
    return FixedStressSolver(tst.build_grid_discretization(
        data, cells_per_axis=n, device=device, elasticity_backend=backend),
        data, **kw)


def _assert_states_equal(a, b):
    for k in STATE_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert torch.equal(x, y), k


@pytest.mark.parametrize("backend", ["auto", "conv"])
def test_multi_step_equals_time_steps(data, backend):
    s = _port(data, backend)
    st0 = s.initial_state()
    st, prev, seq = st0, 1.0, []
    for bc in RAMP:
        st, stats = s.time_step(st, data.time_step, bc, bc_scale_prev=prev)
        seq.append(stats)
        prev = bc
    blk, stacked = s.multi_step(st0, data.time_step, bc_scales=RAMP,
                                bc_scale_prev=1.0, want_u=True)
    _assert_states_equal(blk, st)
    for f in dataclasses.fields(StepStats):
        got = getattr(stacked, f.name)
        assert got.shape[0] == len(RAMP), f.name
        want = np.stack([getattr(x, f.name) for x in seq])
        assert np.array_equal(got, want), f.name
    assert stacked.mech_cg_iterations.min() > 0


def test_multi_step_defaults(data):
    """``n_steps`` alone: K steps at scale 1 (no superposition), equal to
    K plain ``time_step`` calls; u left in rows unless asked for."""
    s = _port(data, n=4)
    st0 = s.initial_state()
    st, seq = st0, []
    for _ in range(2):
        st, stats = s.time_step(st, data.time_step, want_u=False)
        seq.append(stats.pressure_iterations)
    blk, stacked = s.multi_step(st0, data.time_step, n_steps=2)
    assert blk.u is None and blk.u_rows is not None
    _assert_states_equal(blk, st)
    assert stacked.pressure_iterations.tolist() == seq
    with pytest.raises(ValueError, match="n_steps or bc_scales"):
        s.multi_step(st0, data.time_step)


# ---------------------------------------------------------------------------
# against the JAX package's multi_step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_block(data):
    """The JAX start state (numpy) and the block run from it, with the
    pressure multigrid patched on in both packages for the module."""
    jax = pytest.importorskip("jax")
    from poroelasticity_dealii_tpu.solvers import FixedStressSolver as JF
    from poroelasticity_dealii_tpu.solvers import structured as jst
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jst, tst):
            mp.setattr(mod, "_gmg_levels", _low_threshold(mod._gmg_levels))
        s = JF(jst.build_grid_discretization(data, cells_per_axis=N,
                                             multigrid="off",
                                             elasticity_backend="pallas"),
               data)
        st0 = s.initial_state()
        start = {k: (None if getattr(st0, k) is None
                     else np.asarray(getattr(st0, k))) for k in st0._fields}
        st, stats = s.multi_step(st0, data.time_step, bc_scales=RAMP,
                                 bc_scale_prev=1.0, want_u=True)
        jax.block_until_ready(st.p)
        end = {k: np.asarray(getattr(st, k)) for k in ("p", "u", "strains")}
        yield start, end, stats


def test_multi_step_matches_jax_multi_step(data, jax_block):
    """FSS and pressure counts exact; CG counts within 2 and fields within
    1e-8 of their max, pressure_error within 1e-6 relative, as
    ``tests/test_torch_fss.py`` holds one step: the two packages sum their
    dots and stencils in different orders, which moves float64 CG
    residuals in the last digits, and a mechanics or projection solve
    whose residual lands next to its tolerance may take one iteration more
    or less."""
    start, end, jstats = jax_block
    s = _port(data)
    assert s._pressure_precond(data.time_step) is not None   # GMG on
    st = state_from_numpy(start, device="cpu")
    st, stats = s.multi_step(st, data.time_step, bc_scales=RAMP,
                             bc_scale_prev=1.0, want_u=True)
    for f in ("fss_iterations", "pressure_iterations"):
        assert getattr(stats, f).tolist() == \
            np.asarray(getattr(jstats, f)).tolist(), f
    for f in ("pressure_cg_iterations", "mech_cg_iterations",
              "projection_cg_iterations"):
        diff = getattr(stats, f) - np.asarray(getattr(jstats, f))
        assert np.abs(diff).max() <= 2, f
    assert stats.cg_converged.all() and np.asarray(jstats.cg_converged).all()
    np.testing.assert_allclose(stats.pressure_error,
                               np.asarray(jstats.pressure_error), rtol=1e-6)
    for k, want in end.items():
        got = getattr(st, k).numpy()
        assert np.abs(got - want).max() <= 1e-8 * np.abs(want).max(), k


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def _run(tmp, **kw):
    data = dataclasses.replace(read_input_file(DECK), cells_per_axis=(3,) * 3,
                               t_max=5 * 60.0, output_directory=str(tmp),
                               **kw)
    state = SimulationRunner(data, device="cpu").run()
    recs = [json.loads(line)
            for line in (tmp / "run_log.jsonl").read_text().splitlines()]
    for r in recs:
        r.pop("wall_s")
    return state, recs, sorted(v.name for v in tmp.glob("solution-*.vtk"))


@pytest.mark.parametrize("output_vtk", [False, True])
def test_runner_blocks_and_deferred_syncs_match_default(tmp_path,
                                                        output_vtk):
    """``Steps per dispatch = 3``, ``Sync every = 2`` over 5 steps: blocks
    of 3 and 2 steps without VTK output; with it every step's state is
    read, so every block is one step, flushed every 2 steps.  The run log
    equals the default run's but for the wall times (the same steps, bit
    for bit), and VTK files are written exactly at the steps the runner's
    ``_needed`` names (all of them, or none)."""
    st_ref, ref, vtk_ref = _run(tmp_path / "default", output_vtk=output_vtk)
    st, recs, vtk = _run(tmp_path / "blocks", output_vtk=output_vtk,
                         steps_per_dispatch=3, sync_every=2)
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 5]
    assert recs == ref
    assert vtk == vtk_ref == ([f"solution-{k:04d}.vtk" for k in range(6)]
                              if output_vtk else [])
    assert torch.equal(st.p, st_ref.p) and torch.equal(st.u, st_ref.u)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have "
                    "no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["auto", "conv"])
def test_captured_chunks_equal_eager_on_card(cuda_dev, data, backend):
    """n = 7, float64: two evolving steps and a steady one with every CG
    chunk a captured graph, against the same steps with the chunks run
    eagerly: equal counts, p and u bitwise (the same kernels in the same
    order), and the block equal to the steps; each site captured once per
    chunk length and replayed after that."""
    runs = {}
    for graphs in (True, False):
        s = _port(data, backend, n=7, device=cuda_dev, cuda_graphs=graphs)
        assert (s.graphs is not None) == graphs
        st0 = s.initial_state()
        st, prev, stats = st0, 1.0, []
        for bc in RAMP:
            st, ss = s.time_step(st, data.time_step, bc, bc_scale_prev=prev)
            stats.append([getattr(ss, f) for f in COUNTS])
            prev = bc
        blk, stacked = s.multi_step(st0, data.time_step, bc_scales=RAMP,
                                    bc_scale_prev=1.0, want_u=True)
        _assert_states_equal(blk, st)
        runs[graphs] = (st, stats, s.graphs)
    (st_g, stats_g, g), (st_e, stats_e, _) = runs[True], runs[False]
    assert stats_g == stats_e
    assert torch.equal(st_g.p, st_e.p) and torch.equal(st_g.u, st_e.u)
    assert set(g.captures) >= {"mechanics", "pressure", "projection",
                               "bc_response"}
    assert all(g.replays[k] > g.captures[k] for k in ("mechanics",
                                                      "projection"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("backend", ["parity", "conv"])
def test_captured_chunks_equal_eager_on_card_2d(cuda_dev, backend, dtype):
    """The golden 2D deck at n = 16 with the elasticity GMG on (the
    parity-resident V-cycle on the parity kit, the flat one on flat
    vectors): two evolving steps and a steady one, captured against eager,
    equal counts and p, u bitwise; the mechanics solves run under their
    own graphs."""
    data = dataclasses.replace(read_input_file("configs/golden_2d.data"),
                               dtype=dtype, mech_cg_relative=True,
                               mech_cg_tol=1e-10 if dtype == "float64"
                               else 1e-5)
    disc = tst.build_grid_discretization(data, cells_per_axis=16,
                                         multigrid="on",
                                         elasticity_backend=backend,
                                         device=cuda_dev)
    assert disc.gmg_precond is not None
    runs = {}
    for graphs in (True, False):
        s = FixedStressSolver(disc, data, cuda_graphs=graphs)
        st, prev, stats = s.initial_state(), 1.0, []
        for bc in RAMP:
            st, ss = s.time_step(st, data.time_step, bc, bc_scale_prev=prev)
            stats.append([getattr(ss, f) for f in COUNTS])
            prev = bc
        runs[graphs] = (st, stats, s.graphs)
    (st_g, stats_g, g), (st_e, stats_e, _) = runs[True], runs[False]
    assert stats_g == stats_e
    assert torch.equal(st_g.p, st_e.p) and torch.equal(st_g.u, st_e.u)
    assert g.replays["mechanics_gmg"] > 0
