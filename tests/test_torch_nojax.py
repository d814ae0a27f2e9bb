"""The torch port loads nothing of JAX and nothing of the JAX package: a
fresh interpreter imports every module of the port (and chip_smoke.py),
runs one n = 4 step on the CPU on each 3D mechanics backend (rows and
conv), one 2D step on the parity kit with the elasticity GMG and on
flat vectors, one step of the generic path on ``configs/irregular_3d.msh``
(the gmsh reader, ``build_discretization``), an adaptive run with one
remesh on the 2D quadtree (Kelly, marking, refining, the constraint
builders, the transfer, a step on the hanging mesh), a checkpointed run
with Debug NaNs resumed from its checkpoint, a nondimensional run, one
step each of psum, ghost, gspmd and 2D production on a world-size-1 gloo
group,
and the CLI ``check``, and
finds no module of ``jax``, ``jaxlib`` or
``poroelasticity_dealii_tpu`` loaded (the port keeps its own copies of the
host modules it needs; ``tests/test_torch_vendored.py`` holds them equal to
the originals)."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_CODE = """
import importlib, pkgutil, sys
import torch
import poroelasticity_dealii_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
import chip_smoke  # noqa: F401
from poroelasticity_dealii_torch.cli import main
from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver
from poroelasticity_dealii_torch.solvers.structured import \\
    build_grid_discretization
data = pkg.read_input_file("configs/consolidation_3d.data")
for backend in ("auto", "conv"):
    d = build_grid_discretization(data, cells_per_axis=4,
                                  elasticity_backend=backend, device="cpu")
    assert (d.row_ops is None) == (backend == "conv")
    s = FixedStressSolver(d, data)
    state, stats = s.time_step(s.initial_state(), data.time_step)
    assert stats.cg_converged and stats.fss_iterations >= 1, stats
data2 = pkg.read_input_file("configs/golden_2d.data")
for backend in ("parity", "conv"):
    d = build_grid_discretization(data2, cells_per_axis=8, multigrid="on",
                                  elasticity_backend=backend, device="cpu")
    assert (d.gmg_precond_rows is None) == (backend == "conv")
    s = FixedStressSolver(d, data2)
    state, stats = s.time_step(s.initial_state(), data2.time_step)
    assert stats.cg_converged and stats.fss_iterations >= 1, stats
from poroelasticity_dealii_torch.mesh import read_msh
from poroelasticity_dealii_torch.solvers.discretization import \
    build_discretization
d = build_discretization(read_msh("configs/irregular_3d.msh", dim=3), data,
                         device="cpu")
assert d.row_ops is None and d.n_cells == 210
s = FixedStressSolver(d, data)
state, stats = s.time_step(s.initial_state(), data.time_step)
assert stats.cg_converged and stats.fss_iterations >= 1, stats
import dataclasses
from poroelasticity_dealii_torch.amr.driver import AMRSimulationRunner
amr = dataclasses.replace(data2, amr=True, initial_refinement_level=2,
                          max_refinement_level=3, refine_every=2,
                          t_max=2 * data2.time_step, output_vtk=False)
r = AMRSimulationRunner(amr, device="cpu")
state, hist = r.run()
assert [h["n_cells"] for h in hist][0] == 16 and hist[1]["n_cells"] > 16
assert not r.disc.hc_p.empty and hist[1]["cg_converged"], hist
import tempfile
from poroelasticity_dealii_torch.models.runner import SimulationRunner, \
    run_from_data
with tempfile.TemporaryDirectory() as tmp:
    ck = dataclasses.replace(data2, initial_refinement_level=2,
                             t_max=2 * data2.time_step, output_vtk=False,
                             checkpoint_every=1, checkpoint_directory=tmp,
                             output_directory=tmp, debug_nans=True)
    full = SimulationRunner(ck, device="cpu").run()
    res = SimulationRunner(ck, device="cpu").run(
        resume_from=tmp + "/ckpt-000001.npz")
    assert torch.equal(full.p, res.p)
    nd = run_from_data(dataclasses.replace(ck, nondimensionalize=True,
                                           checkpoint_every=0), device="cpu")
    assert torch.allclose(nd.p * data2.youngs_modulus, full.p, rtol=1e-8)
import torch.distributed as dist
from poroelasticity_dealii_torch.models.runner import structured_generic_mesh
from poroelasticity_dealii_torch.parallel import (
    make_slab_group, shard_discretization, shard_discretization_ghost,
    shard_grid_discretization, shard_production_discretization)
with tempfile.TemporaryDirectory() as tmp:
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", rank=0,
                            world_size=1)
    g = make_slab_group("cpu")
    small = dataclasses.replace(data, initial_refinement_level=1)
    generic = build_discretization(structured_generic_mesh(small), small,
                                   device="cpu")
    for d, shard in (
            (generic, shard_discretization),
            (generic, shard_discretization_ghost),
            (build_grid_discretization(data, cells_per_axis=4, device="cpu"),
             shard_grid_discretization),
            (build_grid_discretization(data2, cells_per_axis=8,
                                       elasticity_backend="parity",
                                       device="cpu"),
             shard_production_discretization)):
        dd = data2 if d.dim == 2 else data
        s = FixedStressSolver(shard(d, g), dd)
        assert s.graphs is None
        state, stats = s.time_step(s.initial_state(), dd.time_step)
        assert stats.cg_converged and stats.fss_iterations >= 1, stats
    dist.destroy_process_group()
assert main(["check", "configs/consolidation_3d.data"]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib",
                                    "poroelasticity_dealii_tpu"))
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_imports_and_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # one intra-op thread: beside busy test workers, torch's default
    # OpenMP pool oversubscribes the host and its barriers stall the
    # many small operators of these steps (minutes instead of seconds)
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", _CODE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NO_JAX_OK" in res.stdout
