"""The torch port's adaptive mesh refinement against the JAX package, in
float64 on the CPU:

* the four hanging-node builders (2D edge tables, the 3D geometric
  Lagrange-trace rule, the gmsh-rooted quad and hex forests' entity
  builders) give JAX's ``hanging``, ``masters`` and ``weights`` exactly,
  the port's forests rebuilt from JAX's fields (``interop``);
* ``distribute``, ``condense_vec``, ``zero_hanging`` and
  ``constrained(elasticity)`` within 1e-12 of JAX's on the same tables,
  batched rows as single ones, and ``condense_vec`` bitwise repeatable;
* the Laplace and mechanics patch tests through the port's constrained
  operators (JAX's ``tests/test_amr.py`` and ``tests/test_amr3d.py``);
* ``build_amr_discretization``, padded and unpadded, within 1e-12 of
  JAX's, and the scatter plans' width unchanged by the padding;
* one ``_remesh`` from the same state: equal forests, transferred fields
  within 1e-12; one time step of both on a hanging 3D mesh from the same
  state: counts exact, fields within 1e-12;
* adaptive runs: the golden adaptive deck's 17 steps against
  ``tests/data/adaptive_golden_history.json`` (rtol 1e-5, JAX's own
  test); the gmsh-rooted 2D run of ``chip_smoke.py`` and a 3D box run
  against JAX's pins (``scripts/torch_amr_pins.py``: counts and mesh
  sizes exact, ``pressure_error`` within 1e-6), and the gmsh-rooted 3D
  run through its first remesh; a padded run against an
  unpadded one; ``Steps per dispatch = 3`` against the per-step run, bit
  for bit;
* the entry points: the CLI on an adaptive deck, an AMR deck with
  ``Sharding = psum`` on one process, and AMR decks with ghost, gspmd or
  production sharding refused with the reference's error.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from poroelasticity_dealii_tpu.amr import constraints as jcons  # noqa: E402
from poroelasticity_dealii_tpu.amr import driver as jdriver  # noqa: E402
from poroelasticity_dealii_tpu.amr.bucketing import \
    pad_amr_discretization as jpad  # noqa: E402
from poroelasticity_dealii_tpu.amr.forest import \
    QuadForest as JQuad  # noqa: E402
from poroelasticity_dealii_tpu.amr.multiroot import \
    MultiRootQuadForest as JMRQuad  # noqa: E402
from poroelasticity_dealii_tpu.amr.multiroot3d import \
    MultiRootOctForest as JMROct  # noqa: E402
from poroelasticity_dealii_tpu.amr.octforest import \
    OctForest as JOct  # noqa: E402
from poroelasticity_dealii_tpu.config import \
    read_input_file as jread  # noqa: E402
from poroelasticity_dealii_tpu.mesh import read_msh as jmsh  # noqa: E402
from poroelasticity_dealii_tpu.mesh.qk import \
    build_fe_space as jspace  # noqa: E402
from poroelasticity_dealii_tpu.solvers.fss import \
    State as JState  # noqa: E402

import chip_smoke  # noqa: E402
from poroelasticity_dealii_torch.amr import constraints as tcons  # noqa: E402
from poroelasticity_dealii_torch.amr.bucketing import \
    pad_amr_discretization  # noqa: E402
from poroelasticity_dealii_torch.amr.driver import (  # noqa: E402
    AMRSimulationRunner, build_amr_discretization)
from poroelasticity_dealii_torch.amr.multiroot import \
    MultiRootQuadForest  # noqa: E402
from poroelasticity_dealii_torch.amr.multiroot3d import \
    MultiRootOctForest  # noqa: E402
from poroelasticity_dealii_torch.cli import main as cli_main  # noqa: E402
from poroelasticity_dealii_torch.config import read_input_file  # noqa: E402
from poroelasticity_dealii_torch.interop import (  # noqa: E402
    constraints_from_numpy, forest_from_fields, state_from_numpy)
from poroelasticity_dealii_torch.mesh.qk import build_fe_space  # noqa: E402
from poroelasticity_dealii_torch.models.runner import \
    run_from_data  # noqa: E402
from poroelasticity_dealii_torch.ops import operators as ops  # noqa: E402
from poroelasticity_dealii_torch.solvers.fss import \
    FixedStressSolver  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
GOLDEN = str(REPO / "configs" / "golden_2d.data")
ADAPTIVE = str(REPO / "configs" / "golden_2d_adaptive.data")
DECK_3D = str(REPO / "configs" / "consolidation_3d.data")
IRREGULAR_2D = str(REPO / "configs" / "irregular_2d.data")
MSH_2D = str(REPO / "configs" / "irregular_2d.msh")
MSH_3D = str(REPO / "configs" / "irregular_3d.msh")
HISTORY = REPO / "tests" / "data" / "adaptive_golden_history.json"

APPLY_TOL = 1e-12      # relative to the JAX result's max
PIN_RTOL = 1e-6        # JAX's pinned adaptive runs
GOLDEN_RTOL = 1e-5     # tests/test_adaptive_history.py's tolerance

# JAX's AMRSimulationRunner on configs/consolidation_3d.data's box, AMR on,
# levels 2 -> 3, refine every 2, 4 steps (float64, the CPU): (n_cells,
# n_pdofs, FSS iterations, pressure iterations, pressure_error) per step;
# printed by scripts/torch_amr_pins.py.
AMR_BOX_3D_PIN = [
    (64, 125, 1, 9, 4.015491057503376e-09),
    (169, 298, 1, 5, 3.5593626326528004e-09),
    (169, 298, 1, 4, 6.8295620758076025e-09),
    (204, 353, 1, 5, 5.673135403790719e-09),
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: beside busy test workers, torch's
    default OpenMP pool oversubscribes the host and its barriers stall the
    many small operators of these runs (minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def _close(got, want, tol=APPLY_TOL):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(initial=0.0), 1e-300)
    assert np.abs(got - want).max(initial=0.0) <= tol * scale


# ---------------------------------------------------------------------------
# forests on the four forms, JAX's and the port's from its fields
# ---------------------------------------------------------------------------

FORMS = ("box_2d", "box_3d", "gmsh_2d", "gmsh_3d")


def _jax_forest(form):
    if form == "box_2d":
        f = JQuad.uniform([-5, -5], [5, 5], 2)
        f.refine_and_coarsen({(2, 0, 0), (2, 2, 1)}, set())
        f.refine_and_coarsen({(3, 1, 1)}, set())
    elif form == "box_3d":
        f = JOct.uniform([-5, -5, -5], [5, 5, 5], 1)
        f.refine_and_coarsen({(1, 0, 0, 0)}, set())
    elif form == "gmsh_2d":
        f = JMRQuad.from_mesh(jmsh(MSH_2D), 0)
        f.refine_and_coarsen({(0, 0, 0, r) for r in (0, 40, 41, 90)}, set())
    else:
        f = JMROct.from_mesh(jmsh(MSH_3D, dim=3), 0)
        f.refine_and_coarsen({(0, 0, 0, 0, r) for r in (0, 77, 150)},
                             set())
    return f


def _forests(form):
    jf = _jax_forest(form)
    tf = forest_from_fields(vars(jf))
    assert type(tf).__name__ == type(jf).__name__
    assert tf.leaves == jf.leaves
    return jf, tf


def _tables(cons, space, forest, dtype):
    """(hc_p, hc_u) of ``forest`` by the builder its form uses, with the
    module ``cons`` (JAX's or the port's)."""
    mesh = forest.to_mesh()
    sp, su = space(mesh, 1), space(mesh, 2)
    if type(forest).__name__ == "MultiRootOctForest":
        return cons.build_hanging_constraints_3d_entities(
            forest.hanging_faces(), forest.hanging_edges(), su, dtype)
    if type(forest).__name__ == "MultiRootQuadForest":
        return cons.build_hanging_constraints_from_edges(
            forest.hanging_edges(), mesh.dim, su, dtype)
    if mesh.dim == 2:
        return cons.build_hanging_constraints(forest, mesh, sp, su, dtype)
    return cons.build_hanging_constraints_geometric(forest, mesh, sp, su,
                                                    dtype)


@pytest.mark.parametrize("form", FORMS)
def test_builders_equal_jax(form):
    jf, tf = _forests(form)
    want = _tables(jcons, jspace, jf, jnp.float64)
    got = _tables(tcons, build_fe_space, tf, torch.float64)
    for j, t in zip(want, got):
        assert not t.empty and t.empty == j.empty
        for name in ("hanging", "masters", "weights"):
            np.testing.assert_array_equal(_np(getattr(t, name)),
                                          _np(getattr(j, name)))
        assert t.hanging.dtype == torch.int64
        assert t.weights.dtype == torch.float64


def _data_for(form):
    deck = GOLDEN if form.endswith("2d") else DECK_3D
    return read_input_file(deck), jread(deck)


@pytest.mark.parametrize("form", FORMS)
def test_constraint_applies_equal_jax(form):
    """On each form's AMR build: the port's applies against JAX's within
    1e-12, the tables carried over by ``constraints_from_numpy`` giving
    the same results, batched rows equal to single ones, and
    ``condense_vec`` bitwise repeatable."""
    jf, tf = _forests(form)
    tdata, jdata = _data_for(form)
    jd = jdriver.build_amr_discretization(jf, jdata)
    td = build_amr_discretization(tf, tdata, device="cpu")
    rng = np.random.default_rng(7)
    for (jhc, thc, n) in ((jd.hc_p, td.hc_p, td.n_pdofs),
                          (jd.hc_u, td.hc_u, td.n_udofs)):
        carried = constraints_from_numpy(jhc.hanging, jhc.masters,
                                         jhc.weights, device="cpu")
        x = rng.standard_normal(n)
        xt = torch.as_tensor(x)
        for name in ("distribute", "condense_vec", "zero_hanging"):
            want = jax.jit(getattr(jhc, name))(jnp.asarray(x))
            got = getattr(thc, name)(xt)
            _close(got, want)
            assert torch.equal(getattr(carried, name)(xt), got)
        once, again = thc.condense_vec(xt), thc.condense_vec(xt.clone())
        assert torch.equal(once, again)
        batch = torch.stack([xt, 2.0 * xt])
        for name in ("distribute", "condense_vec", "zero_hanging"):
            out = getattr(thc, name)(batch)
            assert torch.equal(out[0], getattr(thc, name)(xt))
            assert torch.equal(out[1], getattr(thc, name)(2.0 * xt))
    u = rng.standard_normal(td.n_udofs) * 1e-5
    want = jax.jit(jd.hc_u.constrained(jd.elasticity))(jnp.asarray(u))
    got = td.hc_u.constrained(td.elasticity)(torch.as_tensor(u))
    _close(got, want)
    _close(td.elasticity_constrained(torch.as_tensor(u)),
           jax.jit(jd.elasticity_constrained)(jnp.asarray(u)))


def test_empty_constraints_are_identities():
    hc = tcons.empty_constraints(torch.float64)
    x = torch.randn(5, dtype=torch.float64)
    assert hc.empty
    for name in ("distribute", "condense_vec", "zero_hanging"):
        assert getattr(hc, name)(x) is x
    fn = lambda v: 2.0 * v  # noqa: E731
    assert hc.constrained(fn) is fn


# ---------------------------------------------------------------------------
# patch tests through the constrained operators
# ---------------------------------------------------------------------------

def _patch_problem(dim):
    if dim == 2:
        f = JQuad.uniform([-5, -5], [5, 5], 2)
        f.refine_and_coarsen({(2, 0, 0)}, set())
        data = dataclasses.replace(read_input_file(GOLDEN),
                                   initial_refinement_level=2)
    else:
        f = JOct.uniform([-5, -5, -5], [5, 5, 5], 1)
        f.refine_and_coarsen({(1, 0, 0, 0)}, set())
        data = dataclasses.replace(read_input_file(DECK_3D),
                                   initial_refinement_level=1)
    disc = build_amr_discretization(forest_from_fields(vars(f)), data,
                                    device="cpu")
    return data, disc


@pytest.mark.parametrize("dim", [2, 3])
def test_laplace_patch_test(dim):
    """The constrained Laplace of a linear field vanishes on interior
    master dofs."""
    _, disc = _patch_problem(dim)
    coords = disc.pressure_space.node_coords
    lin = 1.0 + 2.0 * coords[:, 0] - 3.0 * coords[:, 1]
    if dim == 3:
        lin = lin + 0.5 * coords[:, 2]
    p = disc.hc_p.distribute(torch.as_tensor(lin))
    y = disc.hc_p.condense_vec(disc.laplace(p)).numpy()
    interior = np.all(np.abs(coords) < 5 - 1e-9, axis=1)
    interior &= ~np.isin(np.arange(disc.n_pdofs), disc.hc_p.hanging.numpy())
    assert interior.sum() > 0
    np.testing.assert_allclose(y[interior], 0.0,
                               atol=1e-12 if dim == 2 else 1e-11)


@pytest.mark.parametrize("dim", [2, 3])
def test_mechanics_patch_test(dim):
    """The constrained mechanics solve with Dirichlet data from a linear
    displacement field reproduces the field through the hanging edges and
    faces."""
    data, disc = _patch_problem(dim)
    A = np.array([[2e-6, 1e-6], [-5e-7, 3e-6]]) if dim == 2 else np.array(
        [[2e-6, 1e-6, -4e-7], [-5e-7, 3e-6, 2e-7], [8e-7, -1e-6, 1.5e-6]])
    coords = disc.displacement_space.node_coords
    u_exact = (coords @ A.T).reshape(-1)
    on_b = np.any(np.abs(coords) > 5 - 1e-9, axis=1)
    free = np.repeat(~on_b, dim).astype(float)
    vals = np.where(free > 0, 0.0, u_exact)
    free_t = torch.as_tensor(free)
    disc2 = dataclasses.replace(
        disc, free_mask_u=free_t, dirichlet_values=torch.as_tensor(vals),
        diag_elasticity=torch.where(free_t > 0, disc.diag_elasticity,
                                    torch.ones_like(free_t)),
        f_well=disc.f_well * 0.0)
    solver = FixedStressSolver(disc2, dataclasses.replace(data,
                                                          biot_coef=0.1))
    u, _, ok, _, _ = solver._mechanics_solve(
        torch.zeros(disc.n_pdofs, dtype=torch.float64),
        torch.zeros(disc.n_udofs, dtype=torch.float64))
    assert bool(ok)
    np.testing.assert_allclose(u.numpy(), u_exact,
                               rtol=1e-7 if dim == 2 else 1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# the AMR build, padded and unpadded
# ---------------------------------------------------------------------------

FIELDS_EXACT = ("conn_p", "conn_u")
FIELDS_FLOAT = ("jinv_u", "jxw_u", "jinv_p", "jxw_p", "free_mask_u",
                "dirichlet_values", "f_neumann", "f_well", "free_mask_p",
                "dirichlet_values_p", "diag_mass", "diag_laplace",
                "diag_elasticity", "psi_p_at_pq", "dref_p_at_pq",
                "psi_p_at_uq", "dref_u_at_uq", "dref_u_at_pq")


@pytest.mark.parametrize("padded", [False, True])
def test_build_amr_discretization_equals_jax(padded):
    jf, tf = _forests("box_2d")
    tdata, jdata = _data_for("box_2d")
    jd = jdriver.build_amr_discretization(jf, jdata)
    td = build_amr_discretization(tf, tdata, device="cpu")
    if padded:
        jd, td = jpad(jd), pad_amr_discretization(td)
        assert td.n_pdofs > td.pressure_space.n_nodes
    assert (td.n_cells, td.n_pdofs, td.n_udofs) == (jd.n_cells, jd.n_pdofs,
                                                    jd.n_udofs)
    for name in FIELDS_EXACT:
        np.testing.assert_array_equal(_np(getattr(td, name)),
                                      _np(getattr(jd, name)))
    for name in FIELDS_FLOAT:
        _close(getattr(td, name), getattr(jd, name))
    for t, j in ((td.hc_p, jd.hc_p), (td.hc_u, jd.hc_u)):
        for name in ("hanging", "masters", "weights"):
            np.testing.assert_array_equal(_np(getattr(t, name)),
                                          _np(getattr(j, name)))
    rng = np.random.default_rng(3)
    p = rng.standard_normal(td.n_pdofs)
    u = rng.standard_normal(td.n_udofs)
    p[td.pressure_space.n_nodes:] = 0.0
    u[td.pressure_space.mesh.dim * td.displacement_space.n_nodes:] = 0.0
    for name, x in (("mass", p), ("laplace", p), ("elasticity", u)):
        _close(getattr(td, name)(torch.as_tensor(x)),
               jax.jit(getattr(jd, name))(jnp.asarray(x)))


def test_plan_width_unchanged_by_padding():
    """The scatter plans of a padded build come from the real cells alone:
    their width (the largest valence) and the constraint plans' width are
    the unpadded ones, and the padded applies equal the unpadded on the
    real dofs."""
    _, tf = _forests("box_3d")
    data = read_input_file(DECK_3D)
    d = build_amr_discretization(tf, data, device="cpu")
    dp = pad_amr_discretization(d)
    assert dp.n_cells > d.n_cells and dp.n_udofs > d.n_udofs
    assert dp.plan_p.table.shape == (dp.n_pdofs, d.plan_p.table.shape[1])
    assert dp.plan_u.table.shape == (dp.n_udofs, d.plan_u.table.shape[1])
    assert dp.hc_u.plan.table.shape[1] == d.hc_u.plan.table.shape[1]
    assert dp.hc_p.plan.table.shape[1] == d.hc_p.plan.table.shape[1]
    rng = np.random.default_rng(5)
    u = torch.as_tensor(rng.standard_normal(d.n_udofs))
    up = torch.nn.functional.pad(u, (0, dp.n_udofs - d.n_udofs))
    for fn, fnp in ((d.elasticity, dp.elasticity),
                    (d.elasticity_constrained, dp.elasticity_constrained)):
        y, yp = fn(u), fnp(up)
        assert torch.equal(yp[:d.n_udofs], y)
        assert not bool(yp[d.n_udofs:].any())


# ---------------------------------------------------------------------------
# one remesh from the same state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [2, 3])
def test_remesh_equals_jax(dim):
    deck = GOLDEN if dim == 2 else DECK_3D
    level = 3 if dim == 2 else 2
    kw = dict(amr=True, output_vtk=False, initial_refinement_level=level,
              max_refinement_level=level + 1)
    jr = jdriver.AMRSimulationRunner(dataclasses.replace(jread(deck), **kw))
    tr = AMRSimulationRunner(dataclasses.replace(read_input_file(deck),
                                                 **kw), device="cpu")
    assert tr.forest.leaves == jr.forest.leaves
    x = tr.disc.pressure_space.node_coords
    n_p = x.shape[0]
    n_u = dim * tr.disc.displacement_space.n_nodes
    rng = np.random.default_rng(11)
    n_voigt = 3 if dim == 2 else 6
    fields = {"p": 1e7 * (1.0 + 0.2 * np.exp(-(x ** 2).sum(1) / 4.0)),
              "u": 1e-6 * rng.standard_normal(n_u),
              "eps_v": 1e-5 * rng.standard_normal(n_p),
              "eps_v0": 1e-5 * rng.standard_normal(n_p),
              "strains": 1e-5 * rng.standard_normal((n_voigt, n_p))}
    js = jr._padded_state(JState(**{k: jnp.asarray(v)
                                    for k, v in fields.items()}))
    ts = tr._padded_state(state_from_numpy(fields, device="cpu"))
    js2, ts2 = jr._real_state(jr._remesh(js)), tr._real_state(tr._remesh(ts))
    assert tr.forest.leaves == jr.forest.leaves
    assert len(tr.forest.leaves) > 2 ** (dim * level)
    for name in ("p", "u", "eps_v", "eps_v0", "strains"):
        _close(getattr(ts2, name), getattr(js2, name))
    assert ts2.mech_b is None and ts2.u_rows is None
    assert tr.disc.n_pdofs == jr.disc.n_pdofs
    assert set(tr.timings) >= {"kelly_s", "mark_refine_s", "generic_build_s",
                               "constraints_s", "padding_s",
                               "disc_to_device_s", "solver_build_s",
                               "transfer_s", "state_to_device_s"}


def test_step_on_hanging_mesh_equals_jax():
    """One time step of both packages from the same state on a hanging 3D
    box mesh: JAX's run of the 3D deck from level 2 takes one step and
    remeshes to levels 2-3 (both runners refine alike), then each package
    steps from JAX's transferred state, so every hanging-node hook of the
    step (residual condense, constrained Jacobian, mechanics condense,
    warm start and distribute, projection, bc response, pressure update)
    runs in both.  The mechanics and projection tolerances are tight
    (1e-13 relative, 1e-12), so the CG iterates of both reach round-off
    and every field agrees within 1e-12; FSS, pressure, pressure-CG and
    mechanics-CG counts exactly (the batched projection's count may move
    by one at that floor, as on a conforming mesh)."""
    kw = dict(amr=True, output_vtk=False, initial_refinement_level=2,
              max_refinement_level=3, refine_every=2, mech_cg_relative=True,
              mech_cg_tol=1e-13, projection_cg_tol=1e-12)
    jr = jdriver.AMRSimulationRunner(dataclasses.replace(jread(DECK_3D),
                                                         **kw))
    tr = AMRSimulationRunner(dataclasses.replace(read_input_file(DECK_3D),
                                                 **kw), device="cpu")
    names = ("p", "u", "eps_v", "eps_v0", "strains")
    js, _ = jr.solver.time_step(jr.solver.initial_state(),
                                jr.data.time_step)
    tr._remesh(state_from_numpy({k: _np(getattr(js, k)) for k in names},
                                device="cpu"))
    js = jr._remesh(js)
    assert tr.forest.leaves == jr.forest.leaves
    assert not tr.disc.hc_p.empty and not tr.disc.hc_u.empty
    ts = state_from_numpy({k: _np(getattr(js, k)) for k in names},
                          device="cpu")
    # a load change, so the step superposes the bc response
    js, jstats = jr.solver.time_step(js, jr.data.time_step, 1.05, 1.0)
    ts, tstats = tr.solver.time_step(ts, tr.data.time_step, 1.05, 1.0)
    for f in ("fss_iterations", "pressure_iterations",
              "pressure_cg_iterations", "mech_cg_iterations"):
        assert int(getattr(tstats, f)) == int(getattr(jstats, f)), f
    for name in ("p", "u", "eps_v", "strains"):
        _close(getattr(ts, name), getattr(js, name))


# ---------------------------------------------------------------------------
# adaptive runs
# ---------------------------------------------------------------------------

def test_golden_adaptive_deck_matches_pin():
    """``configs/golden_2d_adaptive.data``, 17 steps (256 -> 376 -> 724
    -> 1000 cells), against the pinned history: mesh sizes and counts
    exact, residuals within JAX's own tolerance."""
    rec = json.loads(HISTORY.read_text())
    data = dataclasses.replace(read_input_file(ADAPTIVE), output_vtk=False)
    _, hist = AMRSimulationRunner(data, device="cpu").run()
    assert len(hist) == len(rec) == 17
    for h, r in zip(hist, rec):
        assert (h["n_cells"], h["n_pdofs"], h["fss"], h["press"]) == (
            r["n_cells"], r["n_pdofs"], r["fss_iterations"],
            r["pressure_iterations"]), h["step"]
        assert abs(h["err"] / r["pressure_error"] - 1.0) <= GOLDEN_RTOL
        assert h["cg_converged"]


def _adaptive_data(case):
    if case == "irregular_2d":
        data = read_input_file(IRREGULAR_2D)
        return dataclasses.replace(
            data, amr=True, initial_refinement_level=0,
            max_refinement_level=2, refine_every=2,
            t_max=6 * data.time_step, output_vtk=False), \
            chip_smoke.AMR_IRREGULAR_2D_PIN
    data = read_input_file(DECK_3D)
    if case == "irregular_3d":
        return dataclasses.replace(
            data, amr=True, mesh_file=MSH_3D, initial_refinement_level=0,
            max_refinement_level=1, refine_every=2,
            t_max=4 * data.time_step, output_vtk=False), \
            chip_smoke.AMR_IRREGULAR_3D_PIN
    return dataclasses.replace(
        data, amr=True, initial_refinement_level=2, max_refinement_level=3,
        refine_every=2, t_max=4 * data.time_step, output_vtk=False), \
        AMR_BOX_3D_PIN


@pytest.mark.parametrize("case", ["box_3d", "irregular_2d"])
def test_adaptive_run_matches_jax_pin(case):
    data, pin = _adaptive_data(case)
    r = AMRSimulationRunner(data, device="cpu")
    if case == "irregular_2d":
        assert isinstance(r.forest, MultiRootQuadForest)
    state, hist = r.run()
    assert len(hist) == len(pin)
    assert len({h["n_cells"] for h in hist}) >= 2     # it remeshed
    for h, (cells, pdofs, fss, press, err) in zip(hist, pin):
        assert (h["n_cells"], h["n_pdofs"], h["fss"], h["press"]) == (
            cells, pdofs, fss, press), h
        assert abs(h["err"] / err - 1.0) <= PIN_RTOL, (h, err)
    # the 3D deck's absolute mechanics tolerance 1e-12 lies below the f64
    # floor at its RHS scale: its CG may stop at the cap, in JAX as here
    assert case == "box_3d" or all(h["cg_converged"] for h in hist)
    assert bool(torch.isfinite(state.p).all())
    assert bool(torch.isfinite(state.u).all())


def test_irregular_3d_first_remesh_matches_jax_pin():
    """The gmsh-rooted hex forest's run through its first remesh: step 1
    against the pin, then the remesh to the pin's step-2 mesh (cells and
    pressure dofs) with finite transferred fields.  The steps after it are
    held to the pin on the card (``chip_smoke.py::amr_phase``): here the
    reference multi-root transfer, which inverts every root's map at every
    new node, takes most of a 30 s test budget by itself."""
    data, pin = _adaptive_data("irregular_3d")
    r = AMRSimulationRunner(data, device="cpu")
    assert isinstance(r.forest, MultiRootOctForest)
    state, hist = r.run(n_steps=1)
    (cells, pdofs, fss, press, err), (cells2, pdofs2, *_) = pin[:2]
    h = hist[0]
    assert (h["n_cells"], h["n_pdofs"], h["fss"], h["press"]) == (
        cells, pdofs, fss, press)
    assert abs(h["err"] / err - 1.0) <= PIN_RTOL
    state = r._real_state(r._remesh(state))
    assert (r.disc.pressure_space.mesh.n_cells,
            r.disc.pressure_space.n_nodes) == (cells2, pdofs2)
    assert not r.disc.hc_p.empty and state.p.shape[0] == pdofs2
    for name in ("p", "u", "eps_v", "strains"):
        assert bool(torch.isfinite(getattr(state, name)).all()), name


def _short_adaptive(**kw):
    data = read_input_file(ADAPTIVE)
    return dataclasses.replace(data, output_vtk=False, **kw)


def test_padded_run_equals_unpadded():
    """Bucketing on and off: the same meshes and counts, the fields within
    1e-12 (two steps, a remesh, two steps)."""
    data = _short_adaptive(refine_every=3, t_max=4 * 60.0,
                           initial_refinement_level=3,
                           max_refinement_level=5)
    outs = {}
    for bk in (False, True):
        r = AMRSimulationRunner(dataclasses.replace(data, amr_bucketing=bk),
                                device="cpu")
        assert (r.disc.n_pdofs > r.disc.pressure_space.n_nodes) == bk
        outs[bk] = r.run()
    (s0, h0), (s1, h1) = outs[False], outs[True]
    assert [(h["n_cells"], h["fss"], h["press"]) for h in h0] == \
        [(h["n_cells"], h["fss"], h["press"]) for h in h1]
    assert len({h["n_cells"] for h in h0}) == 2
    for name in ("p", "u", "eps_v", "strains"):
        _close(getattr(s1, name), getattr(s0, name))


def test_steps_per_dispatch_equals_per_step():
    """``Steps per dispatch = 3`` under AMR: blocks of up to 3 steps
    between remesh points through ``multi_step``, bit for bit the
    per-step run."""
    data = _short_adaptive(refine_every=3, t_max=7 * 60.0,
                           initial_refinement_level=3,
                           max_refinement_level=4)
    runs = {}
    for k in (1, 3):
        r = AMRSimulationRunner(dataclasses.replace(
            data, steps_per_dispatch=k), device="cpu")
        assert r._fused == (k > 1)
        if k > 1:
            calls = []
            multi = r.solver.multi_step

            def spy(*a, **kw):
                calls.append(kw.get("n_steps"))
                return multi(*a, **kw)
            r.solver.multi_step = spy
        runs[k] = r.run()
    (s1, h1), (s3, h3) = runs[1], runs[3]
    assert [{k: v for k, v in h.items() if k != "wall_s"} for h in h1] == \
        [{k: v for k, v in h.items() if k != "wall_s"} for h in h3]
    for name in ("p", "u", "eps_v", "strains"):
        assert torch.equal(getattr(s1, name), getattr(s3, name)), name


def test_steps_events_follow_the_run_loop():
    """``AMRSimulationRunner.steps``, the loop :meth:`run` consumes and the
    card tools drive: a start event, then each block's ``before`` (after
    its remesh) and ``after``; with ``Steps per dispatch = 3`` and a remesh
    every 3rd step, 7 steps run as blocks of 2, 3 and 2 from steps 1, 3
    and 6, the mesh changing at 3 and 6, and the records equal
    :meth:`run`'s."""
    data = _short_adaptive(refine_every=3, t_max=7 * 60.0,
                           initial_refinement_level=3,
                           max_refinement_level=4, steps_per_dispatch=3)
    r = AMRSimulationRunner(data, device="cpu")
    events, cells = [], []
    for kind, state, info in r.steps():
        if kind == "after":
            info = [rec["step"] for rec, _ in info]
        elif kind == "before":
            cells.append(r.disc.pressure_space.mesh.n_cells)
        events.append((kind, info))
    assert events == [("start", 0), ("before", 1), ("after", [1, 2]),
                      ("before", 3), ("after", [3, 4, 5]),
                      ("before", 6), ("after", [6, 7])]
    assert cells[0] != cells[1] != cells[2]
    _, hist = AMRSimulationRunner(data, device="cpu").run()
    assert [h["n_cells"] for h in hist] == [cells[0]] * 2 + \
        [cells[1]] * 3 + [cells[2]] * 2


def test_cli_runs_an_adaptive_deck(tmp_path, monkeypatch):
    """The CLI on a copy of the adaptive golden deck cut to 6 steps: one
    remesh (before step 5), the run log's mesh sizes, 7 VTK files whose
    point counts follow the mesh."""
    text = Path(ADAPTIVE).read_text().replace(
        "set Time max   = 1e3", "set Time max   = 360")
    text += "\nsubsection TPU\n  set Output directory = out\nend\n"
    deck = tmp_path / "adaptive.data"
    deck.write_text(text)
    monkeypatch.chdir(tmp_path)
    assert cli_main(["run", str(deck), "--device", "cpu"]) == 0
    log = [json.loads(line) for line in
           (tmp_path / "out" / "run_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == [1, 2, 3, 4, 5, 6]
    assert [r["n_cells"] for r in log] == [256] * 4 + [376] * 2
    assert [r["n_pdofs"] for r in log] == [289] * 4 + [425] * 2
    vtks = sorted((tmp_path / "out").glob("solution-*.vtk"))
    assert len(vtks) == 7
    assert "POINTS 289 double" in vtks[4].read_text()
    assert "POINTS 425 double" in vtks[5].read_text()


@pytest.mark.parametrize("field,value,item", [
    ("sharding", "psum", None),
    ("sharding", "ghost", "only 'psum' supports hanging-node constraints"),
    ("sharding", "gspmd", "only 'psum' supports hanging-node constraints"),
    ("sharding", "production",
     "only 'psum' supports hanging-node constraints")])
def test_adaptive_decks_refuse_unported_options(field, value, item):
    """AMR with psum runs (one process: a warning at each remesh, then
    unsharded); with ghost, gspmd or production both entry points raise
    the reference's ``NotImplementedError``."""
    data = dataclasses.replace(read_input_file(ADAPTIVE), output_vtk=False,
                               **{field: value})
    if item is None:
        data = dataclasses.replace(data, t_max=2 * data.time_step,
                                   refine_every=2)
        with pytest.warns(RuntimeWarning, match="single process"):
            state, hist = AMRSimulationRunner(data, device="cpu").run()
        assert hist[1]["n_cells"] > hist[0]["n_cells"]
        assert bool(torch.isfinite(state.p).all())
        return
    for entry in (lambda: run_from_data(data, device="cpu"),
                  lambda: AMRSimulationRunner(data, device="cpu")):
        with pytest.raises(NotImplementedError, match=item):
            entry()


def test_scatter_plan_leaves_out_negative_entries():
    """A plan never reads the values of ``conn``'s negative entries (the
    phantom cells of bucketing), and equals the plain plan elsewhere."""
    conn = np.array([[0, 1, -1, -1, -1], [1, 2, -1, -1, -1]])
    plan = ops.scatter_plan(conn, 4, "cpu")
    assert plan.table.shape == (4, 2)
    values = torch.arange(10.0).reshape(2, 5)
    values[:, 2:] = float("nan")              # phantom cells never read
    out = ops.scatter_sum(values, plan)
    assert out.tolist() == [0.0, 1.0 + 5.0, 6.0, 0.0]
    real = ops.scatter_plan(conn[:, :2], 4, "cpu")
    assert torch.equal(ops.scatter_sum(values[:, :2], real), out)
