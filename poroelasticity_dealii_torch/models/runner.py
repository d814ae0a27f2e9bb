"""Host-side simulation driver for structured decks (port of
``poroelasticity_dealii_tpu/models/runner.py:129-310``): builds the
problem, steps time, writes the JSONL run log and the VTK files, and stops
on a diverged FSS residual."""

from __future__ import annotations

import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..config import InputData
from ..utils.logging_utils import RunLogger
from ..solvers.fss import FixedStressSolver, State
from ..solvers.structured import build_grid_discretization
from ..utils.vtk_io import displacement_at_pressure_nodes, write_vtk


def _check_supported(data: InputData) -> None:
    """Deck features the port does not run yet, with their ROADMAP item."""
    unsupported = [
        (bool(data.mesh_file), "gmsh meshes (ROADMAP A12)"),
        (data.amr, "AMR (ROADMAP A12)"),
        (data.sharding != "none", "sharding (ROADMAP A13)"),
        (data.checkpoint_every > 0, "checkpoints (ROADMAP A8, runner options)"),
        (data.steps_per_dispatch > 1,
         "'Steps per dispatch' > 1 (multi_step, ROADMAP A7)"),
        (data.nondimensionalize,
         "nondimensionalisation (ROADMAP A8, runner options)"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(f"the torch port does not run {what} "
                                      "yet")


class SimulationRunner:
    def __init__(self, data: InputData, device="cuda",
                 logger: Optional[RunLogger] = None):
        _check_supported(data)
        self.data = data
        self.disc = build_grid_discretization(data, device=device)
        self.solver = FixedStressSolver(self.disc, data)
        self.logger = logger or RunLogger(
            os.path.join(data.output_directory, "run_log.jsonl"))

    def output(self, state: State, step: int):
        if not self.data.output_vtk:
            return
        sp, su = self.disc.pressure_space, self.disc.displacement_space
        u_p = displacement_at_pressure_nodes(sp, su, state.u.cpu().numpy())
        strains = state.strains.cpu().numpy()
        stresses = self.solver.effective_stresses(state.strains).cpu().numpy()
        path = os.path.join(self.data.output_directory,
                            f"solution-{step:04d}.vtk")
        write_vtk(path, sp, u_p, state.p.cpu().numpy(), strains, stresses)

    def run(self) -> State:
        data = self.data
        state, t, step = self.solver.initial_state(), 0.0, 0
        self.output(state, 0)
        dt = data.time_step
        while t < data.t_max:
            t0 = time.perf_counter()
            state, stats = self.solver.time_step(state, dt,
                                                 want_u=data.output_vtk)
            if self.disc.device.type == "cuda":
                torch.cuda.synchronize(self.disc.device)
            wall = time.perf_counter() - t0
            t += dt
            step += 1
            self.logger.log_step(step, t, stats, wall)
            self.output(state, step)
            if not np.isfinite(stats.pressure_error):
                raise FloatingPointError(f"FSS residual diverged at step "
                                         f"{step}")
            if not stats.cg_converged:
                warnings.warn(f"step {step}: a linear solve hit its "
                              "iteration cap before reaching tolerance",
                              RuntimeWarning)
        self.logger.close()
        return self.solver.materialize_u(state)


def run_from_data(data: InputData, device="cuda") -> State:
    """Full simulation from a parsed deck, on the card unless ``device``
    says ``"cpu"``."""
    return SimulationRunner(data, device=device).run()
