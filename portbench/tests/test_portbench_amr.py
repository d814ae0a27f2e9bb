"""CPU tests of the benchmark's adaptive-mesh path: the reference's
hanging-node constraints against the program's condensed operators, its
Kelly indicator and marks, a tiny adaptive cell added as new files only,
the faults of a remesh that ``correct`` must catch, and the fixed-mesh
cells' episodes left as they were.

    python -m pytest portbench/tests -q

The card test carries the ``cuda`` marker and skips without one.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, spec, traffic  # noqa: E402
from portbench.reference import fem, hanging, judge, remesh  # noqa: E402

DECK = json.loads((ROOT / "portbench/configs/cube3d-q2q1-40.json")
                  .read_text())["deck"]
# the tiny adaptive cell: the deck's box on levels 2 to 3, a remesh before
# every second step, 4-step episodes (two remeshes each)
TINY = {"name": "octree-tiny", "system": "fss_amr", "deck": DECK,
        "overrides": {"Mesh": {"Initial refinement level": "2",
                               "Max refinement level": "3"},
                      "TPU": {"Mechanics CG relative": "true",
                              "AMR": "true", "Refine every": "2"}}}
MIX = {"episode_steps": 4, "flow_rate_spread": 0.05, "drawn_max": 2,
       "trace_episodes": [1, 1]}
LIMITS = {"mech_residual": 1e-8, "flow_residual": 1e-8,
          "projection_residual": 1e-7, "hanging_gap": 1e-12,
          "transfer_gap": 1e-12, "marks_mismatch": 0.0}
# a reader of the new cell: the share of its steps after a remesh
STEPS_AFTER = ("def read(ctx):\n"
               "    if not ctx.segments:\n        return None\n"
               "    return 100.0 * sum(s > 0 for s in ctx.segments) "
               "/ len(ctx.segments)\n")


def adaptive_root(tmp_path: Path) -> Path:
    """A checkout holding the benchmark, the program and the tiny
    adaptive cell, its mix, limits and a reader, as new files only."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    (root / "poroelasticity_dealii_torch").symlink_to(
        ROOT / "poroelasticity_dealii_torch")
    base = root / "portbench"
    (base / "configs/octree-tiny.json").write_text(json.dumps(TINY))
    (base / "traffic/amr4.json").write_text(json.dumps(MIX))
    (base / "limits/amr-tiny.json").write_text(json.dumps(LIMITS))
    (base / "metrics/amr.steps_after_remesh.py").write_text(STEPS_AFTER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "octree-tiny", "source": "x",
                             "file": "portbench/configs/octree-tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "amr-tiny", "config": "octree-tiny",
                               "traffic": "amr4", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "amr.steps_after_remesh",
                               "unit": "%", "better": "lower",
                               "source": "program_counter", "layer": "test",
                               "moves": "step_ms",
                               "workloads": ["amr-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return adaptive_root(tmp_path_factory.mktemp("amr"))


# ---------------------------------------------------------- the reference

@pytest.fixture(scope="module")
def hanging_box():
    """The deck's box at level 2 with 20 cells refined to level 3: the
    program's discretization with its constraints, and the reference's."""
    from poroelasticity_dealii_torch.amr.driver import \
        build_amr_discretization
    from poroelasticity_dealii_torch.amr.octforest import OctForest
    from portbench.systems import _fss
    deck = json.loads(json.dumps(DECK))
    deck.setdefault("TPU", {})["Mechanics CG relative"] = "true"
    data = _fss.program_data(deck)
    forest = OctForest.uniform(-np.full(3, 5.0), np.full(3, 5.0), 2)
    leaves = forest.sorted_leaves()
    pick = np.random.default_rng(0).choice(len(leaves), 20, replace=False)
    forest.refine_and_coarsen({leaves[i] for i in pick}, set())
    d = build_amr_discretization(forest, data, "cpu")
    mesh = d.pressure_space.mesh
    P = hanging.Problem(hanging.Mesh(mesh.vertices, mesh.cells),
                        fem.physics_from_deck(deck))
    return forest, d, data, P


def test_constrained_operators_equal_the_programs_on_a_hanging_box(
        hanging_box):
    _, d, data, P = hanging_box
    assert len(P.mesh.q1.hanging) and len(P.mesh.q2.hanging)
    at_p = torch.as_tensor(P.mesh.index_of(P.mesh.q1,
                                           d.pressure_space.node_coords))
    at_u = torch.as_tensor(P.mesh.index_of(
        P.mesh.q2, d.displacement_space.node_coords))
    g = torch.Generator().manual_seed(0)
    p = torch.randn(P.n_p, generator=g, dtype=torch.float64)
    u = torch.randn(P.n_q2, 3, generator=g, dtype=torch.float64)
    hp, hu = d.hc_p, d.hc_u

    def on_p(y):            # a condensed program vector on the nodes
        return torch.zeros(y.shape[:-1] + (P.n_p,), dtype=y.dtype) \
            .index_add_(-1, at_p, y)

    def on_u(y):
        return torch.zeros(P.n_q2, 3, dtype=y.dtype).index_add_(
            0, at_u, y.reshape(-1, 3)).reshape(-1)

    def close(a, b):
        assert float((a - b).norm() / b.norm()) < 1e-12

    pp, up = hp.distribute(p[at_p]), hu.distribute(u[at_u].reshape(-1))
    close(P.mass(p), on_p(hp.condense_vec(d.mass(pp))))
    close(P.laplace(p), on_p(hp.condense_vec(d.laplace(pp))))
    close(P.elasticity(u.reshape(-1)), on_u(hu.condense_vec(
        d.elasticity(up))))
    close(P.coupling(p), on_u(hu.condense_vec(
        d.coupling_rhs(pp, data.biot_coef))))
    close(P.projection_rhs(u.reshape(-1)), on_p(hp.condense_vec(
        d.strain_projection_rhs(up))))
    close(P.f_well, on_p(hp.condense_vec(d.f_well)))


def test_reference_kelly_and_marks_agree_with_the_programs(hanging_box):
    from poroelasticity_dealii_torch.amr.kelly import (fixed_fraction_marks,
                                                       kelly_estimate_3d)
    from poroelasticity_dealii_torch.amr.octforest import OctForest
    forest, d, _, P = hanging_box
    B = remesh.Boxes(P.mesh.X)
    cells = P.mesh.q1.cell_nodes
    at_p = P.mesh.index_of(P.mesh.q1, d.pressure_space.node_coords)
    g = torch.Generator().manual_seed(1)
    p = P.c1.distribute(torch.randn(P.n_p, generator=g,
                                    dtype=torch.float64)).numpy()
    eta = kelly_estimate_3d(forest, d.pressure_space.mesh, p[at_p])
    ref = remesh.kelly(B, cells, p)
    assert np.abs(ref - eta).max() < 1e-12 * eta.max()

    def remeshed(top):
        f = OctForest(forest.lower, forest.upper, set(forest.leaves))
        f.refine_and_coarsen(*fixed_fraction_marks(f, eta, top, 0.4, 2, 3))
        m = f.to_mesh()
        return remesh.Boxes(m.vertices[m.cells])
    assert remesh.marks_mismatch(B, cells, p, remeshed(0.6), 2, 3) == 0.0
    assert remesh.marks_mismatch(B, cells, p, remeshed(0.45), 2, 3) > 0.0


# ------------------------------------------------- the tiny adaptive cell

def _count_remeshes(monkeypatch):
    from poroelasticity_dealii_torch.amr.driver import AMRSimulationRunner
    calls = []
    original = AMRSimulationRunner._remesh

    def counted(self, state):
        calls.append(1)
        return original(self, state)
    monkeypatch.setattr(AMRSimulationRunner, "_remesh", counted)
    return calls


def test_a_tiny_adaptive_cell_is_new_files_only_and_reads_correct(
        tmp_path, monkeypatch):
    before = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    root = adaptive_root(tmp_path)
    calls = _count_remeshes(monkeypatch)
    res, lines = harness.run(root, "amr-tiny", 2 ** 31 + 11, 0.1, True,
                             "cpu")
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert list(res["checks"]) == list(judge.NUMBERS + judge.ADAPTIVE)
    assert len(lines) == 6
    episodes = res["attempted"] // 4
    assert res["attempted"] == 4 * episodes and episodes >= 2
    # two remeshes in every episode and the warm one: none is cached
    assert len(calls) == 2 * (episodes + 1)
    # segments 0, 1, 1, 2: three steps of four after a remesh
    assert res["metrics"]["amr.steps_after_remesh"]["value"] == 75.0
    for p, data in before.items():
        assert p.read_bytes() == data, p


def _fault(monkeypatch, fault):
    import poroelasticity_dealii_torch.amr.driver as drv
    from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver
    if fault == "hanging_value_perturbed":
        original = FixedStressSolver.time_step

        def time_step(self, state, *args, **kw):
            new, stats = original(self, state, *args, **kw)
            h = self.disc.hc_p.hanging
            h = h[h < self.disc.pressure_space.n_nodes]
            if h.numel():
                p = new.p.clone()
                p[h[0]] *= 1 + 1e-8
                new = dataclasses.replace(new, p=p)
            return new, stats
        monkeypatch.setattr(FixedStressSolver, "time_step", time_step)
    elif fault in ("transfer_drops_eps_v0", "transfer_takes_nearest_node"):
        original = drv.transfer_nodal

        def transfer(forest, mesh, values, points):
            if fault == "transfer_drops_eps_v0":
                out = original(forest, mesh, values, points)
                if values.shape[0] == 9:     # p, eps_v, eps_v0, strains
                    out[2] = 0.0
                return out
            near = np.argmin(((points[:, None, :]
                               - mesh.vertices[None, :, :]) ** 2).sum(-1), 1)
            return values[..., near]
        monkeypatch.setattr(drv, "transfer_nodal", transfer)
    else:
        original = drv.fixed_fraction_marks

        def marks(forest, eta, top, bottom, **kw):
            return original(forest, eta, 0.45, bottom, **kw)
        monkeypatch.setattr(drv, "fixed_fraction_marks", marks)


@pytest.mark.parametrize("fault", ["hanging_value_perturbed",
                                   "transfer_drops_eps_v0",
                                   "transfer_takes_nearest_node",
                                   "marks_other_fraction"])
def test_a_broken_remesh_reads_not_correct(checkout, monkeypatch, fault):
    _fault(monkeypatch, fault)
    res, _ = harness.run(checkout, "amr-tiny", 5, 0.1, False, "cpu")
    assert res["correct"] is False


# ------------------------------------------------ the fixed-mesh cells

def test_fixed_mesh_cells_run_the_harness_episode_as_before(tmp_path,
                                                           monkeypatch):
    """The two cells' systems have no episode of their own: every episode
    of a run, the warm one too, goes through ``harness._episode``; their
    mix keeps the drawn and traced episodes it had, their checks the
    three numbers."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    (root / "poroelasticity_dealii_torch").symlink_to(
        ROOT / "poroelasticity_dealii_torch")
    for f in (root / "portbench" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["cells_per_axis"] = 3
        f.write_text(json.dumps(c))
    systems = []
    original = harness._episode
    monkeypatch.setattr(harness, "_episode",
                        lambda *a: systems.append(a[0]) or original(*a))
    for w in ("rows40-hold", "distorted40-hold"):
        systems.clear()
        res, _ = harness.run(root, w, 3, 0.1, False, "cpu")
        assert res["correct"] is True
        assert len(systems) == res["attempted"] // 6 + 1
        assert not any(hasattr(s, "episode") for s in systems)
        assert list(res["checks"]) == list(judge.NUMBERS)
        sched = traffic.schedule(spec.load(ROOT, w).traffic,
                                 np.random.default_rng(0))
        assert (sched.drawn_max, sched.trace_episodes) == (8, (8, 9))


def test_a_mix_refuses_unknown_and_bad_episode_keys():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError):
        traffic.schedule({"episode_steps": 2, "flow_rate_spread": 0,
                          "trace": [1, 2]}, rng)
    with pytest.raises(ValueError):
        traffic.schedule({"episode_steps": 2, "flow_rate_spread": 0,
                          "trace_episodes": [2, 1]}, rng)
    s = traffic.schedule(MIX, rng)
    assert (s.steps, s.drawn_max, s.trace_episodes) == (4, 2, (1, 1))


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
def test_the_tiny_adaptive_cell_passes_and_its_float32_control_fails(
        tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import control
    root = adaptive_root(tmp_path)
    for dtype, ok in ((None, True), ("float32", False)):
        for rec in control.runs("amr-tiny", 0.5, [3, 4, 5], dtype, "cuda",
                                root):
            assert rec["correct"] is ok, rec
