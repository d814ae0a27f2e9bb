"""CPU tests of the port's benchmark: the result line's shape, the names,
the readers, the reference against the program at a small size, the
faults that ``correct`` must catch, the guard against JAX, and a cell
added as new files only.

    python -m pytest portbench/tests -q

The test that needs the card (the control) carries the ``cuda`` marker
and skips without one; on the card:
``python -m pytest --noconftest portbench/tests -m cuda``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, meshes, spec, tracing, work  # noqa: E402
from portbench.reference import episode, fem, judge  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def tiny_root(tmp_path: Path, n: int = 4) -> Path:
    """A checkout holding the benchmark and the program, every
    configuration cut to ``n`` cells per axis."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    (root / "poroelasticity_dealii_torch").symlink_to(
        ROOT / "poroelasticity_dealii_torch")
    for f in (root / "portbench" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["cells_per_axis"] = n
        f.write_text(json.dumps(c))
    return root


# ---------------------------------------------------------------- names

def test_names_units_and_entries_keep_to_the_benchmark_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] \
        + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(name), name
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_finds_its_files_and_every_metric_its_reader():
    for w in BENCH["workloads"]:
        cell = spec.load(ROOT, w["name"])
        assert set(cell.limits) >= set(judge.NUMBERS)
        assert callable(cell.system().build)
        assert cell.per_layer
        for m in cell.per_layer:
            # a reader finds nothing to read in an empty context
            assert cell.reader(m["name"]).read(harness.Context([])) is None


# ------------------------------------------------------------ the yardstick

def test_least_work_of_the_elasticity_kernels_at_40():
    ph = fem.physics_from_deck(json.loads(
        (ROOT / "portbench/configs/cube3d-q2q1-40.json").read_text())["deck"])
    nnz = work.nonzeros(work.element_stiffness(0.25, ph.lam, ph.mu))
    assert nnz == 5619
    # sum-factorised: 9,396 flop a cell against the matrix's 11,238
    for mode in (0, 1, 2):
        assert work.rows_elasticity_ms(40, "float32", mode, nnz) == \
            pytest.approx(0.0089753, rel=1e-4)
    assert work.rows_elasticity_ms(40, "float64", 0, nnz) == \
        pytest.approx(0.0089753, rel=1e-4)
    for mode in (1, 2):           # f64 with the mask: bound by the bytes
        assert work.rows_elasticity_ms(40, "float64", mode, nnz) == \
            pytest.approx(0.011422, rel=1e-4)
    for dtype in ("float32", "float64"):
        assert work.generic_elasticity_ms(64000, 3 * 81 ** 3, dtype) == \
            pytest.approx(0.015655, rel=1e-4)


class _Ev:
    def __init__(self, name, a, b, cuda):
        self.name = name
        self.time_range = type("R", (), {"start": a, "end": b})()
        self.device_type = "DeviceType.CUDA" if cuda else "DeviceType.CPU"


def test_trace_reduction_busy_union_wrappers_and_gaps():
    ev = [_Ev("void rows_products_kernel<float, 81, true, RowLayout>(x)",
              0, 10, True),
          _Ev("elementwise_kernel", 5, 20, True),
          _Ev("void generic_elasticity_products_kernel<float, 3>", 50, 60,
              True),
          _Ev("cudaLaunchKernel", 0, 1, False),
          _Ev("cudaGraphLaunch", 2, 3, False),
          _Ev("cudaStreamSynchronize", 19, 49, False),
          _Ev("aten::item", 18, 50, False)]
    s = tracing.summarize(ev, 100.0, 2)
    assert s["busy_ms"] == pytest.approx(0.030)
    assert s["wrapper_ms"] == {"elasticity_rows_apply": 0.010,
                               "generic_elasticity_apply": 0.010}
    assert s["plain_ms"] == pytest.approx(0.015)
    assert s["runtime"]["cudaStreamSynchronize"] == 1
    b = tracing.breakdown(s)
    assert b["idle_gaps"] == [["cudaStreamSynchronize", 30e-6]]
    assert b["device_ops"][0][0].startswith("torch: elementwise")


# ---------------------------------------------------------- the reference

def _port_ops(kind, n, seed=3):
    from poroelasticity_dealii_torch.mesh.core import Mesh
    from poroelasticity_dealii_torch.solvers.discretization import \
        build_discretization
    from poroelasticity_dealii_torch.solvers.structured import \
        build_grid_discretization
    from portbench.systems import _fss
    cfg = json.loads((ROOT / "portbench/configs"
                      / f"{kind}.json").read_text())
    deck = cfg["deck"]                 # float64, the source's precision
    for sub, entries in cfg["overrides"].items():
        deck.setdefault(sub, {}).update(entries)
    data = _fss.program_data(deck)
    hm = meshes.box(_fss.domain(deck), n)
    if cfg["system"] == "fss_mesh":
        hm = meshes.distort(hm, cfg["distortion"],
                            np.random.default_rng(seed))
        d = build_discretization(Mesh(3, hm.vertices, hm.cells,
                                      hm.face_cells, hm.face_local,
                                      hm.face_ids), data, device="cpu")
        order = "entities"
        ops = (d.elasticity, lambda p: d.coupling_rhs(p, data.biot_coef),
               d.strain_projection_rhs)
    else:
        d = build_grid_discretization(data, cells_per_axis=n,
                                      multigrid="off", device="cpu")
        order = "lattice"
        ops = (d.stencil_elasticity, d.stencil_coupling,
               d.stencil_projection)
    cn, nq = fem.q2_numbering(hm.cells, len(hm.vertices), order, n)
    P = fem.Problem(hm.vertices, hm.cells, cn, nq,
                    fem.physics_from_deck(deck))
    return P, d, ops, data, hm, order


@pytest.mark.parametrize("kind", ["cube3d-q2q1-40", "cube3d-distorted-40"])
def test_reference_operators_equal_the_programs_at_n4(kind):
    P, d, (el, cp, pr), _, _, _ = _port_ops(kind, 4)
    g = torch.Generator().manual_seed(0)
    u = torch.randn(P.n_u, generator=g, dtype=torch.float64)
    p = torch.randn(P.n_p, generator=g, dtype=torch.float64)

    def close(a, b):
        a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
        assert float((a - b).norm() / b.norm()) < 1e-13

    close(P.mass(p), d.mass(p))
    close(P.laplace(p), d.laplace(p))
    close(P.elasticity(u), el(u))
    close(P.coupling(p), cp(p))
    close(P.projection_rhs(u), pr(u))
    close(P.f_well, d.f_well)
    close(P.free_u, d.free_mask_u)
    close(P.dirichlet_u, d.dirichlet_values)
    close(P.diag_mass, d.diag_mass)


@pytest.mark.parametrize("kind", ["cube3d-q2q1-40", "cube3d-distorted-40"])
def test_reference_episode_agrees_with_the_program_at_n4(kind):
    from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver
    P, d, _, data, _, _ = _port_ops(kind, 4)
    ref = episode.Episode(P).run(3)
    solver = FixedStressSolver(d, data)
    state = solver.initial_state()
    for _ in ref[1:]:
        state, _ = solver.time_step(state, data.time_step)
    for name in ("p", "u", "eps_v", "strains"):
        a, b = getattr(state, name), getattr(ref[-1], name)
        assert float((a - b).norm() / b.norm()) < 1e-4, name


# --------------------------------------------------- runs on the CPU

@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload,trace", [("rows40-hold", False),
                                            ("distorted40-hold", True)])
def test_a_tiny_run_prints_a_result_line_of_the_documented_shape(
        checkout, workload, trace):
    res, lines = harness.run(checkout, workload, 2 ** 31 + 7, 0.2, trace,
                             "cpu")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] % 6 == 0 and res["attempted"] >= 6
    cell = spec.load(checkout, workload)
    want = cell.per_layer if trace else cell.end_to_end
    got = res["metrics"]
    for m in want:
        if m["source"] == "device_trace":
            continue          # no device events on the CPU: left out
        assert got[m["name"]]["unit"] == m["unit"]
        assert np.isfinite(got[m["name"]]["value"])
    assert set(res["checks"]) == set(judge.NUMBERS)
    assert len(lines) == len(judge.NUMBERS)
    json.dumps(res)


def test_the_same_seed_draws_the_same_inputs(checkout):
    cell = spec.load(checkout, "distorted40-hold")
    a, b = harness.prepare(cell, 99), harness.prepare(cell, 99)
    assert a.deck == b.deck and a.drawn == b.drawn
    ha, _ = cell.system().inputs(cell.config, a.deck)
    hb, _ = cell.system().inputs(cell.config, b.deck)
    assert np.array_equal(ha.vertices, hb.vertices)
    assert not np.array_equal(ha.vertices, meshes.box((10, 10, 10),
                                                      4).vertices)
    c = harness.prepare(cell, 100)
    assert c.deck != a.deck


def _broken(monkeypatch, fault):
    from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver
    original = FixedStressSolver.time_step

    def time_step(self, state, *args, **kw):
        new, stats = original(self, state, *args, **kw)
        return fault(state, new), stats
    monkeypatch.setattr(FixedStressSolver, "time_step", time_step)


@pytest.mark.parametrize("fault", ["state_unchanged", "pressure_altered",
                                   "displacement_altered",
                                   "strain_not_carried", "predictor_off"])
def test_a_broken_step_reads_not_correct(checkout, monkeypatch, fault):
    def apply(old, new):
        if fault == "state_unchanged":
            return old
        if fault == "pressure_altered":
            return dataclasses.replace(new, p=new.p * (1 + 1e-4))
        if fault == "strain_not_carried":
            # each step's strain moved from t = 0, not from the step before
            return dataclasses.replace(
                new, eps_v=new.eps_v - old.eps_v + old.eps_v0)
        if fault == "predictor_off":
            # the predictor's coefficient 10% high
            return dataclasses.replace(
                new, eps_v=old.eps_v + 1.1 * (new.eps_v - old.eps_v))
        s = new
        if s.u_rows is not None:
            s = dataclasses.replace(s, u_rows=s.u_rows * (1 + 1e-3))
        if s.u is not None:
            s = dataclasses.replace(s, u=s.u * (1 + 1e-3))
        return s
    _broken(monkeypatch, apply)
    res, _ = harness.run(checkout, "rows40-hold", 5, 0.1, False, "cpu")
    assert res["correct"] is False


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    for name in ("poroelasticity_dealii_tpu_extra", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "poroelasticity_dealii_tpu.config", sys)
    assert harness.forbidden_modules() == ["jax.numpy",
                                           "poroelasticity_dealii_tpu.config"]


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "from portbench import harness, control; "
            "import portbench.run; "
            "print(harness.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _run_script(root: Path, workload="rows40-hold"):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=root)


def test_no_card_means_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run_script(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run_script(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_a_new_cell_mix_and_metric_are_new_files_only(tmp_path):
    root = tiny_root(tmp_path, n=3)
    before = {p: p.read_bytes() for p in root.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    base = root / "portbench"
    cfg = json.loads((base / "configs/cube3d-q2q1-40.json").read_text())
    cfg["name"] = "cube3d-q2q1-3"
    (base / "configs/cube3d-q2q1-3.json").write_text(json.dumps(cfg))
    (base / "traffic/steady3.json").write_text(json.dumps(
        {"episode_steps": 3, "flow_rate_spread": 0.0}))
    (base / "limits/tiny-steady.json").write_text(json.dumps(
        {"mech_residual": 1e-9, "flow_residual": 1e-8,
         "projection_residual": 1e-7}))
    (base / "metrics/fss.steps_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx.stats))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cube3d-q2q1-3", "source": "x",
                             "file": "portbench/configs/cube3d-q2q1-3.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-steady",
                               "config": "cube3d-q2q1-3",
                               "traffic": "steady3", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "fss.steps_seen", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "step_ms",
                               "workloads": ["tiny-steady"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res, _ = harness.run(root, "tiny-steady", 4, 0.1, True, "cpu")
    assert res["correct"] is True
    assert res["metrics"]["fss.steps_seen"]["value"] == res["attempted"]
    assert res["attempted"] % 3 == 0
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
def test_the_float32_control_fails_and_the_program_passes(tmp_path):
    """At 16 cells per axis, each cell's limits: the program's own
    float32 path in place of the configuration's float64 reads not
    correct, the program as configured reads correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import control
    root = tiny_root(tmp_path, n=16)
    for w in ("rows40-hold", "distorted40-hold"):
        for dtype, ok in (("float32", False), (None, True)):
            for rec in control.runs(w, 0.5, [3, 4, 5], dtype, "cuda",
                                    root):
                assert rec["correct"] is ok, rec
