"""The runner's deck options in the torch port, against the JAX package, in
float64 on the CPU (golden 2D at level 3, the 3D deck at n = 4 on rows):

* checkpoints cross between the packages both ways, uniform and adaptive:
  a resume from the other package's file gives the counts of that
  package's own resume exactly and its fields within 1e-12; the files
  hold the same keys; a forest payload of each of the four forest types
  written by either package reads back in the other;
* the port's adaptive resume reproduces the uninterrupted run (JAX's
  ``tests/test_amr.py::test_amr_checkpoint_resume``); the adaptive cases
  run with each ``Checkpoint format`` (``orbax``: the port's directory
  checkpoints, JAX's orbax ones; JAX reads the port's ``state.npz``, and
  the port reads JAX's checkpoint through the conversion its refusal
  names, ``tests/test_torch_async_checkpoint.py``), and checkpoint steps
  end blocks of ``Steps per dispatch`` (JAX's ``tests/test_multi_step.py::
  test_runner_steps_per_dispatch_matches_default``);
* ``Nondimensionalize``: JAX's ``tests/test_scaling.py`` on the port (a
  nondimensional run matches the dimensional one, on a structured grid, an
  adaptive one and a gmsh mesh; the VTK output is in SI), and the port's
  nondimensional counts are JAX's;
* ``Debug NaNs``: a NaN deck raises ``FloatingPointError`` in both
  packages, naming the step and the solve in the port; a finite run with
  the option on equals one with it off, bit for bit;
* the adaptive loop on divergence: a step with a non-finite residual is
  logged and the run goes on, in both packages;
* ``utils/profiling.py``'s ``device_trace`` writes a trace, the CLI's
  ``--resume`` and ``--profile``, and ``run_from_deck``.
"""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
from poroelasticity_dealii_tpu.amr.driver import \
    AMRSimulationRunner as JAMRRunner  # noqa: E402
from poroelasticity_dealii_tpu.config import \
    read_input_file as jread  # noqa: E402
from poroelasticity_dealii_tpu.mesh import \
    hyper_rectangle as jhyper  # noqa: E402
from poroelasticity_dealii_tpu.models.runner import \
    SimulationRunner as JRunner  # noqa: E402
from poroelasticity_dealii_tpu.models.scaling import \
    nondimensionalize as jnondim  # noqa: E402
from poroelasticity_dealii_tpu.solvers import \
    FixedStressSolver as JSolver  # noqa: E402
from poroelasticity_dealii_tpu.solvers import \
    build_discretization as jbuild  # noqa: E402
from poroelasticity_dealii_tpu.solvers.fss import State as JState  # noqa: E402
from poroelasticity_dealii_tpu.utils import checkpoint as jckpt  # noqa: E402

from poroelasticity_dealii_torch.amr.driver import \
    AMRSimulationRunner  # noqa: E402
from poroelasticity_dealii_torch.amr.forest import QuadForest  # noqa: E402
from poroelasticity_dealii_torch.amr.multiroot import \
    MultiRootQuadForest  # noqa: E402
from poroelasticity_dealii_torch.amr.multiroot3d import \
    MultiRootOctForest  # noqa: E402
from poroelasticity_dealii_torch.amr.octforest import OctForest  # noqa: E402
from poroelasticity_dealii_torch.cli import main as cli_main  # noqa: E402
from poroelasticity_dealii_torch.config import read_input_file  # noqa: E402
from poroelasticity_dealii_torch.mesh import (hyper_rectangle,  # noqa: E402
                                              read_msh)
from poroelasticity_dealii_torch.models import run_from_deck  # noqa: E402
from poroelasticity_dealii_torch.models.runner import (  # noqa: E402
    SimulationRunner, run_from_data)
from poroelasticity_dealii_torch.models.scaling import \
    nondimensionalize  # noqa: E402
from poroelasticity_dealii_torch.solvers.discretization import \
    build_discretization  # noqa: E402
from poroelasticity_dealii_torch.solvers.fss import (  # noqa: E402
    FixedStressSolver, State)
from poroelasticity_dealii_torch.solvers.structured import \
    build_grid_discretization  # noqa: E402
from poroelasticity_dealii_torch.utils import checkpoint as tckpt  # noqa: E402
from poroelasticity_dealii_torch.utils.profiling import \
    device_trace  # noqa: E402

GOLDEN = "configs/golden_2d.data"
DECK_3D = "configs/consolidation_3d.data"
FIELDS = ("p", "u", "eps_v", "eps_v0", "strains")
FIELD_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: beside busy test workers, torch's
    default OpenMP pool oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Log:
    """A run logger that keeps each step's number, counts and residual."""

    def __init__(self):
        self.steps, self.errors = [], []

    def log_step(self, step, t, stats, wall_s, extra=None):
        self.steps.append((step, int(stats.fss_iterations),
                           int(stats.pressure_iterations),
                           int(stats.pressure_cg_iterations),
                           int(stats.mech_cg_iterations),
                           int(stats.projection_cg_iterations)))
        self.errors.append(float(stats.pressure_error))

    def close(self):
        pass


def _np_fields(state) -> dict:
    return {k: np.asarray(getattr(state, k)) for k in FIELDS}


def _assert_fields_close(got, want, rtol=FIELD_RTOL):
    for k in FIELDS:
        scale = np.abs(want[k]).max()
        err = np.abs(got[k] - want[k]).max() / scale
        assert err <= rtol, (k, err)


def _golden(read, tmp, name, **kw):
    """Golden 2D at level 3, 4 steps, a checkpoint every 2.  The mechanics
    tolerance is relative (1e-12): the deck's absolute 1e-12 lies below
    the float64 roundoff of its right-hand side, where CG counts are set
    by roundoff and differ between any two summation orders."""
    data = read(GOLDEN)
    return dataclasses.replace(
        data, initial_refinement_level=3, t_max=4 * data.time_step,
        output_vtk=False, checkpoint_every=2, mech_cg_relative=True,
        mech_cg_tol=1e-12, checkpoint_directory=str(tmp / name),
        output_directory=str(tmp / f"out_{name}"), **kw)


# ---------------------------------------------------------------------------
# checkpoints across the packages: the uniform runner
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def uniform_runs(tmp_path_factory):
    """Each package's uninterrupted run (writing ckpt-000002.npz) and its
    resumes from both packages' files: {(writer, reader): (log, fields)}."""
    tmp = tmp_path_factory.mktemp("uniform")
    runners = {"jax": JRunner(_golden(jread, tmp, "jax"), logger=_Log()),
               "port": SimulationRunner(_golden(read_input_file, tmp,
                                                "port"),
                                        device="cpu", logger=_Log())}
    out = {}
    for name, r in runners.items():
        out[("full", name)] = (r.logger, _np_fields(r.run()))
    for writer in runners:
        ckpt = str(tmp / writer / "ckpt-000002.npz")
        for name, r in runners.items():
            r.logger = _Log()
            out[(writer, name)] = (r.logger,
                                   _np_fields(r.run(resume_from=ckpt)))
    out["files"] = {w: str(tmp / w / "ckpt-000002.npz") for w in runners}
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_uniform_checkpoint_crosses_packages(uniform_runs, writer):
    """A checkpoint of ``writer`` resumed by the other package gives the
    writer's own resumed run: counts exact, fields within 1e-12."""
    reader = "port" if writer == "jax" else "jax"
    (got_log, got), (want_log, want) = uniform_runs[(writer, reader)], \
        uniform_runs[(writer, writer)]
    assert [s[0] for s in want_log.steps] == [3, 4]
    assert got_log.steps == want_log.steps
    np.testing.assert_allclose(got_log.errors, want_log.errors, rtol=1e-6)
    _assert_fields_close(got, want)


def test_uniform_resume_equals_uninterrupted_run(uniform_runs):
    """The port's resume from its own file reproduces its uninterrupted
    run bit for bit, and both files hold the same keys, shapes and
    dtypes."""
    full_log, full = uniform_runs[("full", "port")]
    log, res = uniform_runs[("port", "port")]
    assert log.steps == full_log.steps[2:]
    for k in FIELDS:
        assert np.array_equal(res[k], full[k]), k
    files = uniform_runs["files"]
    with np.load(files["jax"]) as zj, np.load(files["port"]) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert (zj[k].shape, zj[k].dtype) == (zt[k].shape, zt[k].dtype)
        assert (int(zt["step"]), int(zt["version"])) == (2, 1)


# ---------------------------------------------------------------------------
# checkpoints across the packages: the adaptive runner and the forests
# ---------------------------------------------------------------------------

def _adaptive(read, tmp, name, fmt="npz"):
    """Golden 2D adaptive from level 3 (max 4), a remesh before every 2nd
    step and a checkpoint every 2 in format ``fmt``: ckpt-000002(.npz)
    holds the refined mesh."""
    return dataclasses.replace(_golden(read, tmp, name), amr=True,
                               max_refinement_level=4, refine_every=2,
                               checkpoint_format=fmt)


def _ckpt_name(step, fmt) -> str:
    return f"ckpt-{step:06d}" + (".npz" if fmt == "npz" else "")


def _adaptive_files(tmp, fmt) -> dict:
    """{(writer, reader): the path ``reader`` resumes from}: the writer's
    checkpoint at step 2; in the orbax format JAX reads the port's
    ``state.npz``, and the port the ``.npz`` that JAX's loaders and
    ``save_checkpoint`` make of JAX's orbax directory (the conversion the
    port's refusal names)."""
    files = {(w, r): str(tmp / w / _ckpt_name(2, fmt))
             for w in ("jax", "port") for r in ("jax", "port")}
    if fmt == "orbax":
        files[("port", "jax")] += "/state.npz"
        jdir = files[("jax", "port")]
        st, t, step = jckpt.load_checkpoint_any(jdir)
        jckpt.save_checkpoint(str(tmp / "jax_converted.npz"), st, t, step,
                              forest=jckpt.load_checkpoint_forest_any(jdir))
        files[("jax", "port")] = str(tmp / "jax_converted.npz")
    return files


@pytest.fixture(scope="module", params=["npz", "orbax"])
def adaptive_runs(request, tmp_path_factory):
    """Two steps of each package's adaptive run (one remesh, the checkpoint
    after it) in each checkpoint format, then each package's step 3 from
    both packages' checkpoints: {(writer, reader): (forest leaves, records,
    fields)}."""
    fmt = request.param
    tmp = tmp_path_factory.mktemp(f"adaptive_{fmt}")
    runners = {"jax": JAMRRunner(_adaptive(jread, tmp, "jax", fmt)),
               "port": AMRSimulationRunner(
                   _adaptive(read_input_file, tmp, "port", fmt),
                   device="cpu")}
    for r in runners.values():
        r.run(n_steps=2)
    files = _adaptive_files(tmp, fmt)
    out = {}
    for writer in runners:
        for name, r in runners.items():
            st, hist = r.run(n_steps=3, resume_from=files[(writer, name)])
            out[(writer, name)] = (set(r.forest.leaves), hist,
                                   _np_fields(st))
    out["tmp"], out["format"] = tmp, fmt
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_adaptive_checkpoint_crosses_packages(adaptive_runs, writer):
    reader = "port" if writer == "jax" else "jax"
    (leaves_g, hist_g, got), (leaves_w, hist_w, want) = \
        adaptive_runs[(writer, reader)], adaptive_runs[(writer, writer)]
    assert leaves_g == leaves_w and len(leaves_w) > 64   # refined
    key = ("step", "n_cells", "n_pdofs", "fss", "press")
    assert [[h[k] for k in key] for h in hist_g] == \
        [[h[k] for k in key] for h in hist_w]
    assert [h["step"] for h in hist_w] == [3]
    np.testing.assert_allclose([h["err"] for h in hist_g],
                               [h["err"] for h in hist_w], rtol=1e-6)
    _assert_fields_close(got, want)


def test_adaptive_resume_reproduces_uninterrupted_run(adaptive_runs):
    """JAX's ``test_amr_checkpoint_resume`` on the port, in each checkpoint
    format: the resume restores the refined mesh and the uninterrupted
    run's fields (JAX's tolerances, and bit for bit), and the
    fused-dispatch path stays off with checkpoints, with JAX's warning."""
    fmt = adaptive_runs["format"]
    data = dataclasses.replace(
        _adaptive(read_input_file, adaptive_runs["tmp"], "resume", fmt),
        t_max=480.0, max_refinement_level=5, refine_every=5,
        checkpoint_every=6)
    full_runner = AMRSimulationRunner(data, device="cpu")
    full, hist = full_runner.run()
    ckpt = adaptive_runs["tmp"] / "resume" / _ckpt_name(6, fmt)
    assert ckpt.exists() and len(hist) == 8
    with pytest.warns(RuntimeWarning, match="Checkpoint every = 0"):
        res_runner = AMRSimulationRunner(
            dataclasses.replace(data, steps_per_dispatch=3), device="cpu")
    res, res_hist = res_runner.run(resume_from=str(ckpt))
    assert res_runner.forest.leaves == full_runner.forest.leaves
    assert [h["step"] for h in res_hist] == [7, 8]
    np.testing.assert_allclose(res.p.numpy(), full.p.numpy(), rtol=1e-12)
    np.testing.assert_allclose(res.eps_v.numpy(), full.eps_v.numpy(),
                               rtol=1e-10)
    for k in FIELDS:      # and on the port, bit for bit
        assert torch.equal(getattr(res, k), getattr(full, k)), k


def _forest(kind):
    if kind == "QuadForest":
        f = QuadForest.uniform(np.array([-5.0, -5.0]), np.array([5.0, 5.0]),
                               2)
    elif kind == "OctForest":
        f = OctForest.uniform(-np.ones(3), np.ones(3), 1)
    elif kind == "MultiRootQuadForest":
        f = MultiRootQuadForest.from_mesh(
            read_msh("configs/irregular_2d.msh", dim=2), 0)
    else:
        f = MultiRootOctForest.from_mesh(
            read_msh("configs/irregular_3d.msh", dim=3), 0)
    f.refine_and_coarsen(set(sorted(f.leaves)[:2]), set())
    return f


def _forest_arrays(f) -> dict:
    names = ("root_cells", "root_coords") if hasattr(f, "root_cells") \
        else ("lower", "upper")
    out = {n: np.asarray(getattr(f, n)) for n in names}
    out["leaves"] = sorted(f.leaves)
    if hasattr(f, "boundary_ids"):
        out["boundary_ids"] = dict(f.boundary_ids)
    return out


@pytest.mark.parametrize("kind", ["QuadForest", "OctForest",
                                  "MultiRootQuadForest",
                                  "MultiRootOctForest"])
def test_forest_payload_crosses_packages(kind, tmp_path):
    """The port writes a forest that JAX's ``load_checkpoint_forest`` reads
    to an equal one; JAX writes it back and the port reads it."""
    f = _forest(kind)
    z = torch.zeros(3, dtype=torch.float64)
    tckpt.save_checkpoint(str(tmp_path / "t.npz"),
                          State(p=z, u=z, eps_v=z, eps_v0=z,
                                strains=z[None]), 0.0, 1, forest=f)
    fj = jckpt.load_checkpoint_forest(str(tmp_path / "t.npz"))
    assert type(fj).__name__ == kind
    want = _forest_arrays(f)
    for k, v in _forest_arrays(fj).items():
        assert np.array_equal(v, want[k]) if isinstance(v, np.ndarray) \
            else v == want[k], k
    zj = np.zeros(3)
    jckpt.save_checkpoint(str(tmp_path / "j.npz"),
                          JState(p=zj, u=zj, eps_v=zj, eps_v0=zj,
                                 strains=zj[None]), 0.0, 1, forest=fj)
    ft = tckpt.load_checkpoint_forest(str(tmp_path / "j.npz"))
    assert type(ft) is type(f)
    for k, v in _forest_arrays(ft).items():
        assert np.array_equal(v, want[k]) if isinstance(v, np.ndarray) \
            else v == want[k], k


# ---------------------------------------------------------------------------
# checkpoints end blocks
# ---------------------------------------------------------------------------

def test_checkpoint_steps_end_blocks(tmp_path):
    """``Steps per dispatch = 4`` with a checkpoint every 5 steps: the
    final state of the per-step run, one run-log record per step, and the
    checkpoint at step 5 written (the block ended there)."""
    base = dataclasses.replace(
        read_input_file(GOLDEN), initial_refinement_level=3, t_max=420.0,
        output_vtk=False, output_directory=str(tmp_path / "a"))
    ref = SimulationRunner(base, device="cpu").run()
    fused = dataclasses.replace(
        base, steps_per_dispatch=4, checkpoint_every=5,
        output_directory=str(tmp_path / "b"),
        checkpoint_directory=str(tmp_path / "b_ckpt"))
    runner = SimulationRunner(fused, device="cpu")
    assert [runner._needed(s) for s in range(1, 8)] == \
        [False] * 4 + [True, False, False]
    got = runner.run()
    for k in FIELDS:
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    for d in ("a", "b"):
        recs = [json.loads(line) for line in
                (tmp_path / d / "run_log.jsonl").read_text().splitlines()]
        assert [r["step"] for r in recs] == list(range(1, 8))
    assert sorted(p.name for p in (tmp_path / "b_ckpt").iterdir()) == \
        ["ckpt-000005.npz"]
    st, t, step = tckpt.load_checkpoint(
        str(tmp_path / "b_ckpt" / "ckpt-000005.npz"), device="cpu")
    assert (t, step) == (300.0, 5) and st.p.dtype == torch.float64


# ---------------------------------------------------------------------------
# Nondimensionalize (JAX's tests/test_scaling.py on the port)
# ---------------------------------------------------------------------------

def _counts(stats) -> tuple:
    return (int(stats.fss_iterations), int(stats.pressure_iterations),
            int(stats.pressure_cg_iterations), int(stats.mech_cg_iterations))


def _run3(solver, data):
    st = solver.initial_state()
    hist = []
    for _ in range(3):
        st, stats = solver.time_step(st, data.time_step)
        hist.append(_counts(stats))
    return st, hist


def test_nondimensional_run_matches_dimensional_and_jax():
    data = read_input_file(GOLDEN)
    scaled, sc = nondimensionalize(data)
    assert (scaled.youngs_modulus, max(scaled.domain_size),
            scaled.time_step) == (1.0, 1.0, 1.0)
    runs = {}
    for name, d in (("dim", data), ("nd", scaled)):
        disc = build_discretization(hyper_rectangle(d.domain_size, 3), d,
                                    device="cpu")
        runs[name] = _run3(FixedStressSolver(disc, d), d)
    (st_dim, hist_dim), (st_nd, hist_nd) = runs["dim"], runs["nd"]
    for a, b in zip(hist_dim, hist_nd):
        assert a[:3] == b[:3]
        assert abs(a[3] - b[3]) <= 5, (a, b)
    np.testing.assert_allclose(sc.p(st_nd.p.numpy()), st_dim.p.numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(sc.u(st_nd.u.numpy()), st_dim.u.numpy(),
                               rtol=1e-8, atol=1e-16)
    np.testing.assert_allclose(st_nd.eps_v.numpy(), st_dim.eps_v.numpy(),
                               rtol=1e-8, atol=1e-20)
    # JAX's nondimensional run: the same FSS, pressure and pressure CG
    # counts (mechanics CG within 5: the deck's absolute tolerance)
    jscaled, _ = jnondim(jread(GOLDEN))
    _, hist_j = _run3(JSolver(jbuild(jhyper(jscaled.domain_size, 3),
                                     jscaled), jscaled), jscaled)
    for a, b in zip(hist_nd, hist_j):
        assert a[:3] == b[:3]
        assert abs(a[3] - b[3]) <= 5, (a, b)


def _vtk_p_and_coords(path):
    vtk = path.read_text()
    m = re.search(r"SCALARS p[^\n]*\nLOOKUP_TABLE default\n([\s\S]+?)"
                  r"SCALARS", vtk)
    pts = re.search(r"POINTS \d+ double\n([\s\S]+?)CELLS", vtk).group(1)
    return (np.array([float(v) for v in m.group(1).split()]),
            np.array([float(v) for v in pts.split()]))


@pytest.mark.parametrize("amr", [False, True])
def test_nondimensional_runner_outputs_si(amr, tmp_path):
    """``run_from_data`` with ``Nondimensionalize`` writes SI-valued VTK,
    uniform and adaptive."""
    data = dataclasses.replace(
        read_input_file(GOLDEN), t_max=120.0, nondimensionalize=True,
        output_directory=str(tmp_path))
    if amr:
        data = dataclasses.replace(data, amr=True, initial_refinement_level=3,
                                   max_refinement_level=4, refine_every=2)
    run_from_data(data, device="cpu")
    p, coords = _vtk_p_and_coords(tmp_path / "solution-0002.vtk")
    assert 0.9e7 < p.max() < 1.3e7          # ~p_init scale, Pa
    assert np.isclose(np.abs(coords).max(), 5.0)   # 10 m domain, meters


def test_nondimensional_amr_matches_dimensional(tmp_path):
    """Nondimensionalize composes with AMR (JAX's asymmetric 10 x 14
    domain, which breaks the well's mirror ties in the Kelly marks)."""
    base = dataclasses.replace(
        read_input_file(GOLDEN), amr=True, initial_refinement_level=3,
        max_refinement_level=4, refine_every=3, t_max=300.0,
        output_vtk=False, domain_size=(10.0, 14.0),
        output_directory=str(tmp_path))
    st_dim, hist_dim = AMRSimulationRunner(base, device="cpu").run()
    scaled, sc = nondimensionalize(base)
    st_nd, hist_nd = AMRSimulationRunner(scaled, device="cpu",
                                         scales=sc).run()
    cells = [h["n_cells"] for h in hist_dim]
    assert cells == [h["n_cells"] for h in hist_nd]
    assert cells[0] != cells[-1]                  # the remesh happened
    assert [h["fss"] for h in hist_dim] == [h["fss"] for h in hist_nd]
    np.testing.assert_allclose(sc.p(st_nd.p.numpy()), st_dim.p.numpy(),
                               rtol=1e-9)
    np.testing.assert_allclose(sc.u(st_nd.u.numpy()), st_dim.u.numpy(),
                               rtol=1e-7, atol=1e-16)


def test_nondimensional_gmsh_mesh_matches_dimensional():
    """With a gmsh ``Mesh file`` the runner divides the mesh by the deck's
    length scale: an exact similarity rescale on the irregular mesh."""
    base = dataclasses.replace(read_input_file("configs/irregular_2d.data"),
                               t_max=180.0, output_vtk=False)
    scaled, sc = nondimensionalize(base)
    states = []
    for d, scales in ((base, None), (scaled, sc)):
        r = SimulationRunner(d, device="cpu", scales=scales)
        st = r.solver.initial_state()
        for _ in range(2):
            st, _ = r.solver.time_step(st, d.time_step)
        states.append(st)
    st_dim, st_nd = states
    np.testing.assert_allclose(sc.p(st_nd.p.numpy()), st_dim.p.numpy(),
                               rtol=1e-9)
    np.testing.assert_allclose(sc.u(st_nd.u.numpy()), st_dim.u.numpy(),
                               rtol=1e-7, atol=1e-16)


# ---------------------------------------------------------------------------
# Debug NaNs and the adaptive loop on divergence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["flow_rate", "p_init"])
def test_debug_nans_raises_in_both_packages(field, tmp_path):
    """A NaN flow rate or initial pressure: the port raises naming the step
    and the solve, in one-step and in blocked dispatch; JAX's
    ``jax_debug_nans`` raises too."""
    data = dataclasses.replace(
        read_input_file(GOLDEN), initial_refinement_level=3,
        debug_nans=True, output_vtk=False, output_directory=str(tmp_path),
        **{field: float("nan")})
    for per_dispatch in (1, 2):
        runner = SimulationRunner(dataclasses.replace(
            data, steps_per_dispatch=per_dispatch), device="cpu")
        with pytest.raises(FloatingPointError,
                           match="step 1: Debug NaNs: the pressure "
                                 "residual gave a non-finite result"):
            runner.run()
    if field != "p_init":
        return      # JAX's check, on the deck it flags soonest
    jdata = dataclasses.replace(jread(GOLDEN), p_init=float("nan"))
    old = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        with pytest.raises(FloatingPointError):
            s = JSolver(jbuild(jhyper(jdata.domain_size, 3), jdata), jdata)
            s.time_step(s.initial_state(), jdata.time_step)
    finally:
        jax.config.update("jax_debug_nans", old)


def test_debug_nans_on_equals_off_bitwise():
    """A finite run on the 3D rows kit (n = 4): the option changes no
    count and no bit, in ``time_step`` and in ``multi_step``."""
    runs = {}
    for on in (False, True):
        data = dataclasses.replace(read_input_file(DECK_3D), debug_nans=on)
        s = FixedStressSolver(build_grid_discretization(
            data, cells_per_axis=4, device="cpu"), data)
        assert s.disc.row_ops is not None
        st, one = s.time_step(s.initial_state(), data.time_step, 1.05,
                              bc_scale_prev=1.0)
        st, block = s.multi_step(st, data.time_step, bc_scales=[1.1, 1.1],
                                 bc_scale_prev=1.05, want_u=True)
        runs[on] = (st, one, block)
    (a, one_a, blk_a), (b, one_b, blk_b) = runs[False], runs[True]
    for k in FIELDS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for x, y in ((one_a, one_b), (blk_a, blk_b)):
        for f in dataclasses.fields(x):
            assert np.array_equal(getattr(x, f.name), getattr(y, f.name)), \
                f.name


def test_adaptive_loop_goes_on_after_divergence():
    """Golden adaptive at level 3 with a NaN flow rate, fewer steps than
    ``Refine every``: both packages' adaptive drivers log every step and
    go on, with the residual non-finite at the same steps."""
    hists = []
    for read, runner in ((jread, lambda d: JAMRRunner(d)),
                         (read_input_file,
                          lambda d: AMRSimulationRunner(d, device="cpu"))):
        data = dataclasses.replace(
            read("configs/golden_2d_adaptive.data"),
            initial_refinement_level=3, flow_rate=float("nan"),
            output_vtk=False)
        assert data.amr and data.refine_every > 2 and not data.debug_nans
        _, hist = runner(data).run(n_steps=2)
        hists.append(hist)
    jax_hist, port_hist = hists
    assert len(jax_hist) == len(port_hist) == 2
    assert [np.isfinite(h["err"]) for h in jax_hist] == \
        [np.isfinite(h["err"]) for h in port_hist] == [False] * 2


# ---------------------------------------------------------------------------
# profiling, the CLI and run_from_deck
# ---------------------------------------------------------------------------

def _cli_deck(tmp_path):
    deck = tmp_path / "deck.data"
    deck.write_text(open(GOLDEN).read() + (
        "\nsubsection Mesh\n  set Initial refinement level = 2\nend\n"
        "subsection Solver\n  set Time max = 120\nend\n"
        "subsection TPU\n  set Checkpoint every = 1\n"
        "  set Output VTK = false\nend\n"))
    return deck


def test_cli_resume_profile_and_run_from_deck(tmp_path, monkeypatch):
    """``run`` writes checkpoints; ``run --resume`` continues from one with
    the same run log; ``run --profile`` leaves a trace; ``run_from_deck``
    gives the CLI's state."""
    deck = _cli_deck(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert cli_main(["run", str(deck), "--device", "cpu"]) == 0
    log = (tmp_path / "solution" / "run_log.jsonl").read_text().splitlines()
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == \
        ["ckpt-000001.npz", "ckpt-000002.npz"]
    assert cli_main(["run", str(deck), "--device", "cpu", "--resume",
                     "checkpoints/ckpt-000001.npz", "--profile",
                     "trace"]) == 0
    resumed = (tmp_path / "solution" / "run_log.jsonl").read_text() \
        .splitlines()

    def strip(line):
        rec = json.loads(line)
        rec.pop("wall_s")
        return rec
    assert [strip(r) for r in resumed] == [strip(r) for r in log[1:]]
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    st = run_from_deck(str(deck), device="cpu")
    want, _, _ = tckpt.load_checkpoint("checkpoints/ckpt-000002.npz",
                                       device="cpu")
    for k in FIELDS:
        assert torch.equal(getattr(st, k), getattr(want, k)), k


def test_device_trace_writes_a_trace(tmp_path):
    with device_trace(str(tmp_path / "t")):
        torch.ones(8).sum()
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert any(e.get("name", "").startswith("aten::")
               for e in events["traceEvents"])
