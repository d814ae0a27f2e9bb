"""The torch port's generic (unstructured) path against the JAX package, in
float64 on the CPU unless a test says otherwise:

* every generic apply (mass, Laplace, elasticity, coupling RHS, strain
  projection RHS), the Jacobi diagonals and ``build_discretization``'s
  boundary and source vectors, on distorted meshes (``perturb_interior``:
  2D 6^2, 3D 3^3 and 4^3), on both gmsh assets (``configs/irregular_*.msh``)
  and on Cryer's curved octant mesh (the one with a traction boundary),
  within 1e-12 of their max;
* the plan scatter: equal to an unordered host sum, bitwise repeatable,
  and no accumulating torch scatter (float atomics on the card) in the
  generic modules' sources or in a generic step;
* ``configs/irregular_2d.data`` through the CLI and the runner (17 steps,
  VTK files and run log), ``configs/irregular_3d.msh`` with
  ``configs/consolidation_3d.data`` (2 steps) and Cryer's sphere
  (``cryer_mesh(10, 4)``, 3 steps) against JAX's ``FixedStressSolver``:
  FSS and pressure counts exact, ``pressure_error`` within 1e-6;
* ``chip_smoke.py``'s pin of the irregular 2D run against JAX;
* float32: the applies within 1e-5 of their max, one step's fields within
  1e-4;
* ``Sharding = production`` on a mesh deck: one process warns and runs
  unsharded, more ranks are refused, as in the JAX runner;
* the gmsh deck with ``AMR = true`` runs through ``run_from_data``.
"""

import dataclasses
import json
import re
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from poroelasticity_dealii_tpu.config import \
    read_input_file as jread  # noqa: E402
from poroelasticity_dealii_tpu.mesh import hyper_rectangle as jhr  # noqa: E402
from poroelasticity_dealii_tpu.mesh import read_msh as jmsh  # noqa: E402
from poroelasticity_dealii_tpu.mesh.generator import \
    perturb_interior as jperturb  # noqa: E402
from poroelasticity_dealii_tpu.models import cryer as jcryer  # noqa: E402
from poroelasticity_dealii_tpu.solvers import \
    FixedStressSolver as JF  # noqa: E402
from poroelasticity_dealii_tpu.solvers import \
    build_discretization as jbuild  # noqa: E402

import chip_smoke  # noqa: E402
from poroelasticity_dealii_torch.cli import main as cli_main  # noqa: E402
from poroelasticity_dealii_torch.config import read_input_file  # noqa: E402
from poroelasticity_dealii_torch.mesh import (hyper_rectangle,  # noqa: E402
                                               read_msh)
from poroelasticity_dealii_torch.mesh.generator import \
    perturb_interior  # noqa: E402
from poroelasticity_dealii_torch.models import cryer as tcryer  # noqa: E402
from poroelasticity_dealii_torch.models.runner import (  # noqa: E402
    SimulationRunner, _apply_sharding, run_from_data)
from poroelasticity_dealii_torch.ops import operators as ops  # noqa: E402
from poroelasticity_dealii_torch.solvers.discretization import \
    build_discretization  # noqa: E402
from poroelasticity_dealii_torch.solvers.fss import \
    FixedStressSolver  # noqa: E402
from poroelasticity_dealii_torch.tools.profile_step import \
    bench_data  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
GOLDEN = str(REPO / "configs" / "golden_2d.data")
DECK_3D = str(REPO / "configs" / "consolidation_3d.data")
IRREGULAR_2D = REPO / "configs" / "irregular_2d.data"
MSH_2D = str(REPO / "configs" / "irregular_2d.msh")
MSH_3D = str(REPO / "configs" / "irregular_3d.msh")
TOL = 1e-12            # applies, diagonals, vectors: relative to max |JAX|
F32_TOL = 1e-5         # float32 applies, relative to max |JAX f32|
F32_FIELD_TOL = 1e-4   # float32 step fields, relative to max |field|
RESIDUAL_RTOL = 1e-6   # pressure_error against JAX
PIN_RTOL = 1e-9        # chip_smoke's pin against JAX on this CPU
CRYER_R, CRYER_LOAD = 10.0, 7.2e6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: beside busy test workers, torch's
    default OpenMP pool oversubscribes the host and its barriers stall the
    many small operators of these runs (minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cryer_data(mod):
    data = mod.cryer_config(radius=CRYER_R, load=CRYER_LOAD, dt=1.25)
    cp = mod.cryer_params(data, radius=CRYER_R, load=CRYER_LOAD)
    return dataclasses.replace(data, p_init=float(cp.p0))


# case -> (port deck and mesh, JAX deck and mesh), built on demand
def _case(name):
    if name.startswith("perturbed"):
        dim, n = {"perturbed_2d_6": (2, 6), "perturbed_3d_3": (3, 3),
                  "perturbed_3d_4": (3, 4)}[name]
        deck = GOLDEN if dim == 2 else DECK_3D
        size = [10.0] * dim
        return ((read_input_file(deck),
                 perturb_interior(hyper_rectangle(size, cells_per_axis=n),
                                  0.2, seed=n)),
                (jread(deck), jperturb(jhr(size, cells_per_axis=n), 0.2,
                                       seed=n)))
    if name == "irregular_2d_msh":
        return ((read_input_file(GOLDEN), read_msh(MSH_2D, dim=2)),
                (jread(GOLDEN), jmsh(MSH_2D, dim=2)))
    if name == "irregular_3d_msh":
        return ((read_input_file(DECK_3D), read_msh(MSH_3D, dim=3)),
                (jread(DECK_3D), jmsh(MSH_3D, dim=3)))
    if name == "cryer_3":
        return ((_cryer_data(tcryer), tcryer.cryer_mesh(CRYER_R, 3)),
                (_cryer_data(jcryer), jcryer.cryer_mesh(CRYER_R, 3)))
    raise ValueError(name)


CASES = ("perturbed_2d_6", "perturbed_3d_3", "perturbed_3d_4",
         "irregular_2d_msh", "irregular_3d_msh", "cryer_3")
APPLIES = ("mass", "laplace", "elasticity", "coupling", "projection")
VECTORS = ("diag_mass", "diag_laplace", "diag_elasticity", "f_well",
           "f_neumann", "free_mask_u", "dirichlet_values", "free_mask_p",
           "dirichlet_values_p")
_BUILT = {}


def _built(name, dtype=torch.float64):
    """(port discretization, JAX discretization) of case ``name``."""
    key = (name, dtype)
    if key not in _BUILT:
        (data, mesh), (jdata, jm) = _case(name)
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        _BUILT[key] = (build_discretization(mesh, data, dtype=dtype,
                                            device="cpu"),
                       jbuild(jm, jdata, dtype=np_dtype))
    return _BUILT[key]


def _apply(d, name, x, biot=0.9):
    return {"mass": d.mass, "laplace": d.laplace,
            "elasticity": d.elasticity,
            "coupling": lambda z: d.coupling_rhs(z, biot),
            "projection": d.strain_projection_rhs}[name](x)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    return np.abs(got - want).max() / (scale if scale > 0 else 1.0)


def _input(d, name, dtype=np.float64):
    rng = np.random.default_rng(7)
    n = d.n_udofs if name in ("elasticity", "projection") else d.n_pdofs
    return rng.standard_normal(n).astype(dtype)


@pytest.mark.parametrize("apply", APPLIES)
@pytest.mark.parametrize("case", CASES)
def test_generic_apply_equals_jax(case, apply):
    d, jd = _built(case)
    x = _input(d, apply)
    got = _apply(d, apply, torch.as_tensor(x))
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), _apply(jd, apply, jnp.asarray(x))) <= TOL


@pytest.mark.parametrize("case", CASES)
def test_build_vectors_equal_jax(case):
    d, jd = _built(case)
    assert (d.n_pdofs, d.n_udofs, d.n_cells) == (jd.n_pdofs, jd.n_udofs,
                                                 jd.n_cells)
    for name in VECTORS:
        got, want = getattr(d, name).numpy(), np.asarray(getattr(jd, name))
        assert _rel(got, want) <= TOL, name
    if case == "cryer_3":     # the traction boundary is exercised
        assert np.abs(np.asarray(jd.f_neumann)).max() > 0
    for name in ("conn_p", "conn_u"):
        np.testing.assert_array_equal(getattr(d, name).numpy(),
                                      np.asarray(getattr(jd, name)))


@pytest.mark.parametrize("case", ("perturbed_2d_6", "perturbed_3d_3"))
def test_batched_mass_and_laplace(case):
    """The projection CG applies the mass to (n_rhs, n) blocks: each row
    equals the single apply."""
    d, _ = _built(case)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (3, d.n_pdofs)))
    for op in (d.mass, d.laplace):
        got = op(x)
        for i in range(3):
            assert _rel(got[i].numpy(), op(x[i]).numpy()) <= 1e-14


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_scatter_plan_sums_every_entry_in_a_fixed_order(dtype):
    d, _ = _built("perturbed_3d_3")
    conn = d.conn_u.numpy()
    plan = d.plan_u
    table = plan.table.numpy()
    assert table.dtype == np.int32 and plan.n_values == conn.size
    # every cell entry exactly once, padding only with the zero's index
    real = table[table != plan.n_values]
    np.testing.assert_array_equal(np.sort(real), np.arange(conn.size))
    np.testing.assert_array_equal(conn.reshape(-1)[table[:, 0]],
                                  np.arange(d.n_udofs))
    vals = torch.as_tensor(np.random.default_rng(2).standard_normal(
        conn.shape), dtype=dtype)
    got = ops.scatter_sum(vals, plan)
    want = ops._host_scatter_sum(vals.double().numpy(), conn, d.n_udofs)
    assert _rel(got.double().numpy(), want) <= (
        1e-15 if dtype == torch.float64 else 1e-6)
    assert torch.equal(got, ops.scatter_sum(vals, plan))
    batch = torch.stack([vals, 2 * vals])
    out = ops.scatter_sum(batch, plan)
    assert torch.equal(out[0], got) and torch.equal(out[1],
                                                   ops.scatter_sum(2 * vals,
                                                                   plan))


GENERIC_SOURCES = ("ops/operators.py", "solvers/discretization.py",
                   "solvers/fss.py", "solvers/cg.py",
                   "solvers/cuda_graphs.py", "amr/constraints.py",
                   "amr/bucketing.py", "amr/driver.py")
ATOMIC_CALLS = re.compile(
    r"index_add_?\(|scatter_add_?\(|scatter_reduce_?\(|index_reduce_?\(|"
    r"\.put_\(|index_put_?\(|accumulate\s*=\s*True")


def test_no_float_atomics_in_generic_sources():
    """The generic applies sum through their plans: no torch scatter that
    accumulates with atomics on the card (``index_add_``, ``scatter_add_``,
    ``index_put_(..., accumulate=True)``, ...) in their modules."""
    for rel in GENERIC_SOURCES:
        code = (REPO / "poroelasticity_dealii_torch" / rel).read_text()
        assert not ATOMIC_CALLS.search(code), rel


class _Ops(torch.overrides.TorchFunctionMode):
    """Records the name of every torch function called under it."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        if name == "index_put_" and kwargs.get("accumulate"):
            name = "index_put_(accumulate=True)"
        self.names.add(name)
        return func(*args, **kwargs)


def test_no_accumulating_scatter_runs_in_a_generic_step():
    d, _ = _built("perturbed_3d_3")
    data = read_input_file(DECK_3D)
    s = FixedStressSolver(d, data)
    st = s.initial_state()
    with _Ops() as names:
        _, stats = s.time_step(st, data.time_step, 1.05, bc_scale_prev=1.0)
    assert stats.mech_cg_iterations > 0
    bad = {n for n in names.names if re.search(
        r"index_add|scatter_add|scatter_reduce|index_reduce|put_|"
        r"accumulate", n)}
    assert not bad, bad


# ---------------------------------------------------------------------------
# whole runs against JAX's FixedStressSolver
# ---------------------------------------------------------------------------

def _jax_steps(jdata, jmesh, n_steps):
    js = JF(jbuild(jmesh, jdata), jdata)
    st, out = js.initial_state(), []
    for _ in range(n_steps):
        st, ss = js.time_step(st, jdata.time_step)
        out.append(ss)
    return out


def _assert_steps_match(got, want):
    """got: (fss, pressure, pressure_error) per step; want: JAX stats."""
    assert len(got) == len(want)
    for k, ((fss, press, err), w) in enumerate(zip(got, want), 1):
        assert (fss, press) == (int(w.fss_iterations),
                                int(w.pressure_iterations)), k
        assert abs(err / float(w.pressure_error) - 1.0) <= RESIDUAL_RTOL, k


@pytest.fixture(scope="module")
def jax_irregular_2d():
    jdata = jread(str(IRREGULAR_2D))
    return _jax_steps(jdata, jmsh(MSH_2D, dim=2), 17)


def test_irregular_2d_deck_runs_through_cli(jax_irregular_2d, tmp_path,
                                            monkeypatch):
    """``run configs/irregular_2d.data`` (the gmsh deck, which the port
    refused before): 17 steps, a run log and 18 VTK files, JAX's FSS and
    pressure counts, residuals within 1e-6."""
    deck = tmp_path / "irregular_2d.data"
    deck.write_text(IRREGULAR_2D.read_text()
                    + f"\nsubsection Mesh\n  set Mesh file = {MSH_2D}\nend\n")
    monkeypatch.chdir(tmp_path)
    assert cli_main(["run", str(deck), "--device", "cpu"]) == 0
    log = [json.loads(line) for line in
           (tmp_path / "solution" / "run_log.jsonl").read_text()
           .splitlines()]
    _assert_steps_match([(r["fss_iterations"], r["pressure_iterations"],
                          r["pressure_error"]) for r in log],
                        jax_irregular_2d)
    vtks = sorted((tmp_path / "solution").glob("solution-*.vtk"))
    assert len(vtks) == 18
    n_nodes = read_msh(MSH_2D, dim=2).n_vertices
    assert f"POINTS {n_nodes} double" in vtks[-1].read_text()


def test_irregular_2d_pin_matches_jax(jax_irregular_2d):
    """``chip_smoke.IRREGULAR_2D_PIN`` (what the card's run is held
    against) is JAX's run: counts exact, residuals within 1e-9."""
    pin = chip_smoke.IRREGULAR_2D_PIN
    assert len(pin) == len(jax_irregular_2d)
    for (fss, press, err, hist), w in zip(pin, jax_irregular_2d):
        assert (fss, press) == (int(w.fss_iterations),
                                int(w.pressure_iterations))
        assert abs(err / float(w.pressure_error) - 1.0) <= PIN_RTOL
        jhist = [float(x) for x in np.asarray(w.fss_error_history)
                 if x >= 0]
        assert len(hist) == len(jhist) and all(
            abs(a / b - 1.0) <= PIN_RTOL for a, b in zip(hist, jhist))


def _port_steps(solver, data, n_steps):
    st, out = solver.initial_state(), []
    for _ in range(n_steps):
        st, ss = solver.time_step(st, data.time_step)
        assert ss.cg_converged
        out.append((ss.fss_iterations, ss.pressure_iterations,
                    ss.pressure_error))
    return out


def test_irregular_3d_msh_matches_jax(tmp_path):
    """The 3D gmsh asset with the 3D deck (its ``Mesh file`` set), 2
    steps, through the runner."""
    data = dataclasses.replace(read_input_file(DECK_3D), t_max=120.0,
                               mesh_file=MSH_3D, output_vtk=False,
                               output_directory=str(tmp_path))
    runner = SimulationRunner(data, device="cpu")
    assert runner.disc.n_cells == 210 and runner.disc.row_ops is None
    runner.run()
    log = [json.loads(line) for line in
           (tmp_path / "run_log.jsonl").read_text().splitlines()]
    jdata = dataclasses.replace(jread(DECK_3D), t_max=120.0)
    _assert_steps_match([(r["fss_iterations"], r["pressure_iterations"],
                          r["pressure_error"]) for r in log],
                        _jax_steps(jdata, jmsh(MSH_3D, dim=3), 2))
    assert all(r["pressure_iterations"] > 0 for r in log)


def test_cryer_matches_jax():
    """Cryer's sphere on the curved octant mesh (drainage and traction on
    the curved surface, volumetric-strain resync), 3 steps."""
    data = _cryer_data(tcryer)
    d = build_discretization(tcryer.cryer_mesh(CRYER_R, 4), data,
                             device="cpu")
    got = _port_steps(FixedStressSolver(d, data), data, 3)
    _assert_steps_match(got, _jax_steps(_cryer_data(jcryer),
                                        jcryer.cryer_mesh(CRYER_R, 4), 3))
    assert all(fss > 1 for fss, _, _ in got)


@pytest.mark.parametrize("apply", APPLIES)
def test_float32_applies_equal_jax(apply):
    d, jd = _built("perturbed_3d_4", torch.float32)
    assert d.dtype == torch.float32 and d.jinv_u.dtype == torch.float32
    x = _input(d, apply, np.float32)
    got = _apply(d, apply, torch.as_tensor(x))
    want = _apply(jd, apply, jnp.asarray(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert _rel(got.numpy(), want) <= F32_TOL


def test_float32_step_matches_jax():
    """The bench configuration's float32 step on a distorted 4^3 mesh:
    equal FSS counts, p and u within 1e-4 of their max (float32 reduction
    orders differ, so CG counts are not a contract)."""
    data, jdata = bench_data(DECK_3D), dataclasses.replace(
        jread(DECK_3D), **{k: getattr(bench_data(DECK_3D), k) for k in (
            "dtype", "flow_rate", "fss_tol", "pressure_tol", "mech_cg_tol",
            "mech_cg_relative", "pressure_cg_tol", "projection_cg_tol")})
    mesh = perturb_interior(hyper_rectangle([10.0] * 3, cells_per_axis=4),
                            0.2, seed=0)
    jm = jperturb(jhr([10.0] * 3, cells_per_axis=4), 0.2, seed=0)
    s = FixedStressSolver(build_discretization(mesh, data, device="cpu"),
                          data)
    js = JF(jbuild(jm, jdata), jdata)
    st, jst = s.initial_state(), js.initial_state()
    for bc, prev in ((1.05, 1.0), (1.1, 1.05)):
        st, ss = s.time_step(st, data.time_step, bc, bc_scale_prev=prev)
        jst, jss = js.time_step(jst, jdata.time_step, bc, bc_scale_prev=prev)
        assert st.p.dtype == torch.float32 and ss.cg_converged
        assert ss.fss_iterations == int(jss.fss_iterations)
        for name in ("p", "u"):
            assert _rel(getattr(st, name).numpy(),
                        getattr(jst, name)) <= F32_FIELD_TOL, name


# ---------------------------------------------------------------------------
# the runner on mesh decks: sharding and AMR
# ---------------------------------------------------------------------------

def test_production_sharding_on_a_mesh_deck(tmp_path):
    """One process: a warning and the unsharded generic run (the JAX
    runner on one device); a group of two ranks: refused with
    ``ValueError`` (JAX: production sharding needs row_ops)."""
    data = dataclasses.replace(
        read_input_file(DECK_3D), mesh_file=MSH_3D, sharding="production",
        t_max=60.0, output_vtk=False, output_directory=str(tmp_path))
    with pytest.warns(RuntimeWarning, match="running unsharded"):
        runner = SimulationRunner(data, device="cpu")
    assert runner.disc.row_ops is None and runner.disc.n_cells == 210
    state = runner.run()
    assert bool(torch.isfinite(state.p).all())
    two = types.SimpleNamespace(size=2, rank=0,
                                device=torch.device("cpu"))
    with pytest.raises(ValueError, match="rows kit"):
        _apply_sharding(runner.disc, data, two)


def test_amr_mesh_deck_runs(tmp_path):
    """The gmsh deck with ``AMR = true`` runs through ``run_from_data``
    on the gmsh-rooted forest (levels 0 -> 1, a remesh before step 2),
    with no warning; ``SimulationRunner`` sends such a deck there."""
    data = dataclasses.replace(
        read_input_file(str(IRREGULAR_2D)), amr=True,
        initial_refinement_level=0, max_refinement_level=1, refine_every=2,
        t_max=120.0, output_vtk=False, output_directory=str(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        state = run_from_data(data, device="cpu")
    recs = [json.loads(line) for line in
            (tmp_path / "run_log.jsonl").read_text().splitlines()]
    assert [r["n_cells"] for r in recs] == [143, 176]
    assert state.p.shape[0] == 209 and bool(torch.isfinite(state.u).all())
    with pytest.raises(ValueError, match="run_from_data"):
        SimulationRunner(data, device="cpu")
