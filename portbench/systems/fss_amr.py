"""The deck's octree through the program's adaptive runner
(``AMRSimulationRunner``): the box refined to ``Initial refinement
level``, a remesh before every ``Refine every``-th step between that
level and ``Max refinement level``, the deck's ``AMR bucketing``.

Each episode is the runner's first steps from the start state on the
start mesh, as ``AMRSimulationRunner.steps`` runs them: before a remesh
step the runner's own ``_remesh`` (the state to the host, Kelly, marks,
refine, the generic build with the hanging-node constraints, padding,
the old solver's graphs released, the new solver, the transfer), then
``FixedStressSolver.time_step``; the remesh counts in the wall of the
step it comes before.  Every remesh of every episode does all of this:
nothing refined is kept from one episode to the next.  Going back to the
start mesh before an episode (releasing the last refined solver, the
forest's start leaves) is set-up: the start mesh's discretization and
solver, built once, stay alive through the episode, so the first remesh
leaves them standing where the runner would release them.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from .. import meshes
from ..harness import Ran, Segment
from . import _fss


def _hex(mesh) -> meshes.HexMesh:
    """The program's mesh arrays as the benchmark's."""
    v = np.array(mesh.vertices, np.float64)
    h = float(np.min(np.ptp(v[mesh.cells], axis=1)[:, 0]))
    return meshes.HexMesh(v, np.array(mesh.cells), np.array(mesh.face_cells),
                          np.array(mesh.face_local), np.array(mesh.face_ids),
                          int(round(float(np.ptp(v[:, 0])) / h)))


class System(_fss.System):
    """The start mesh's solver, mesh and deck values, and the runner
    whose episodes it runs."""

    def __init__(self, runner, data):
        super().__init__(runner.solver, data.time_step,
                         _hex(runner.disc.pressure_space.mesh),
                         "constrained", data.dtype)
        self.runner = runner
        self.start_leaves = frozenset(runner.forest.leaves)
        self.start_built = (runner.disc, runner.solver)

    def _real(self, state):
        from poroelasticity_dealii_torch.amr.bucketing import real_sizes, \
            slice_state
        return slice_state(state, *real_sizes(self.runner.disc))

    def _segment(self, index, start, before):
        r = self.runner
        return Segment(index, _hex(r.disc.pressure_space.mesh),
                       np.array(r.disc.pressure_space.node_coords),
                       np.array(r.disc.displacement_space.node_coords),
                       start, before)

    def _back_to_start(self):
        r = self.runner
        if r.solver is not self.start_built[1]:
            r.solver.release()
            r.solver = r.disc = None
            gc.collect()
            if r.device.type == "cuda":
                torch.cuda.empty_cache()
        r.forest.leaves = set(self.start_leaves)
        r.disc, r.solver = self.start_built

    def episode(self, start, sched, sync) -> Ran:
        """``sched.steps`` steps from ``start`` on the start mesh."""
        from poroelasticity_dealii_torch.solvers.fss import numbered_steps
        r, every = self.runner, self.runner.data.refine_every
        t = time.perf_counter()
        self._back_to_start()
        sync()
        out = Ran([], [], [], [], time.perf_counter() - t)
        seg = self._segment(0, self._real(start), None)
        state = start
        for k in range(1, sched.steps + 1):
            remesh = bool(every) and k % every == 0
            t = time.perf_counter()
            if remesh:
                if r.solver is self.start_built[1]:
                    r.solver = None          # kept for the next episode
                state = moved = r._remesh(state)
            with numbered_steps(k):
                state, stats = r.solver.time_step(state, self.dt)
            sync()
            out.walls.append(time.perf_counter() - t)
            if remesh:
                seg = self._segment(seg.index + 1, self._real(moved),
                                    out.states[-1] if out.states
                                    else seg.start)
            out.states.append(self._real(state))
            out.stats.append(stats)
            out.segments.append(seg)
        return out


def build(cfg: dict, deck: dict, device) -> System:
    from poroelasticity_dealii_torch.amr.driver import AMRSimulationRunner
    data = _fss.program_data(deck)
    runner = AMRSimulationRunner(data, device=device, cuda_graphs=True)
    if runner._fused:
        raise NotImplementedError("the benchmark steps one at a time: "
                                  "Steps per dispatch must be 1")
    return System(runner, data)
