"""Host-side simulation driver (port of
``poroelasticity_dealii_tpu/models/runner.py:101-126, 129-310``):
:func:`run_from_data` sends an adaptive deck (``TPU / AMR = true``) to
:class:`..amr.driver.AMRSimulationRunner` and any other to
:class:`SimulationRunner`, which builds the
problem (on the deck's gmsh mesh, ``Mesh / Mesh file``, through the generic
discretization, else on its structured grid), shards it when the deck asks
for ``TPU / Sharding = psum | ghost | gspmd | production``
(:func:`_apply_sharding`),
steps time in blocks of up to ``TPU /
Steps per dispatch`` steps
(:meth:`..solvers.fss.FixedStressSolver.multi_step`), writes the JSONL run
log, the VTK files and the checkpoints (``TPU / Checkpoint every``: ``.npz``
files, or directories written asynchronously with ``Checkpoint format =
orbax``; :mod:`..utils.checkpoint`) at sync points every ``TPU / Sync
every`` steps, and stops on a diverged FSS residual.
``run(resume_from=...)`` restarts from a checkpoint of either package.
:func:`run_from_data` applies ``TPU / Nondimensionalize`` (:mod:`.scaling`;
the VTK output is rescaled to SI, the run log and checkpoints stay in
solver units); ``TPU / Debug NaNs`` is the solver's
(:class:`..solvers.fss.FixedStressSolver`).

The sharded run is one process per device in a ``torch.distributed``
process group (``torchrun``, or a group the caller initialised): every
rank runs this time loop and reads the same checkpoint on a resume, and
rank 0 alone writes the run log, the VTK files and the checkpoints from
the whole state (which every rank holds; under ghost, whose ranks hold
chunks of the first-touch renumbered vectors, it is gathered first, and
the files are in that numbering, as the reference's ghost run writes
them; a resume gives each rank its chunk).  ``Sharding = psum`` and
``ghost`` on a deck without a mesh file run the generic discretization of
its structured grid (:func:`structured_generic_mesh`), on one process
too."""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import InputData, read_input_file
from ..mesh import read_msh
from ..mesh.generator import normalize_cells_per_axis
from ..mesh.structured import structured_mesh
from ..parallel.ghost import (GhostShardedDiscretization,
                              shard_discretization_ghost)
from ..parallel.rows import shard_production_discretization
from ..parallel.sharding import (SlabGroup, init_from_env,
                                 shard_discretization,
                                 shard_grid_discretization)
from ..utils.logging_utils import RunLogger
from ..solvers.discretization import build_discretization
from ..solvers.fss import (FixedStressSolver, State, StepStats,
                           numbered_steps)
from ..solvers.structured import build_grid_discretization
from ..utils.checkpoint import (load_checkpoint_any, save_step_checkpoint,
                                wait_for_checkpoints)
from ..utils.vtk_io import displacement_at_pressure_nodes, write_vtk
from .scaling import Scales, nondimensionalize, scale_mesh


def _slab_group(data: InputData, device) -> tuple:
    """``(slab group, created)`` of a sharded run (see
    :func:`..parallel.sharding.init_from_env`); ``TPU / Devices`` must be 0
    (all ranks) or the group's size."""
    group, created = init_from_env(device)
    if data.n_devices not in (0, group.size):
        if created:
            dist.destroy_process_group()
        raise ValueError(f"'TPU / Devices = {data.n_devices}' but the "
                         f"process group has {group.size} rank(s): set it "
                         "to 0 or to the world size")
    return group, created


def structured_generic_mesh(data: InputData):
    """The structured grid of a deck without a mesh file, as a mesh for the
    generic discretization (what ``Sharding = psum`` and ``ghost`` shard:
    JAX's psum and ghost shard the generic cell arrays of its grid
    discretization)."""
    cells = getattr(data, "cells_per_axis", None) \
        or 2 ** data.initial_refinement_level
    return structured_mesh(data.domain_size[:data.dim],
                           normalize_cells_per_axis(cells, data.dim))


def _apply_sharding(disc, data: InputData, group: SlabGroup):
    """``TPU / Sharding = psum | ghost | gspmd | production`` over
    ``group`` (JAX's ``_apply_sharding``, ``models/runner.py:101-126``):
    psum on a generic discretization (cells chunked, one all-reduce per
    apply), ghost on a generic one (every vector sharded, halo windows),
    gspmd on a structured one (stencils on node-plane slabs), production
    on the rows (3D) or parity (2D) kit (slab kits plus the gspmd
    stencils).  One
    process without a process group: a warning and the unsharded
    discretization, as the JAX runner does on one visible device (an
    initialised group of one rank, e.g. ``torchrun --nproc-per-node 1`` or
    one card's NCCL group, runs the sharded form on that rank).  A
    discretization the mode cannot take raises (``TypeError`` or
    ``ValueError``, as in the JAX runner)."""
    mode = data.sharding
    if group.size < 2 and group.group is None:
        warnings.warn(f"'TPU / Sharding = {mode}' with a single process: "
                      "running unsharded", RuntimeWarning)
        return disc
    if mode == "psum":
        return shard_discretization(disc, group)
    if mode == "ghost":
        return shard_discretization_ghost(disc, group)
    if mode == "gspmd":
        return shard_grid_discretization(disc, group)
    if mode == "production":
        return shard_production_discretization(disc, group)
    raise ValueError(f"unknown sharding mode {mode!r}")


def write_state_vtk(path: str, disc, solver, state: State,
                    scales: Optional[Scales] = None) -> None:
    """The VTK file of ``state`` (``state.u`` materialised) on ``disc``'s
    pressure nodes; with ``scales`` (a nondimensional run) p, u, the
    stresses and the node coordinates back in SI units."""
    sp, su = disc.pressure_space, disc.displacement_space
    u_p = displacement_at_pressure_nodes(sp, su, state.u.cpu().numpy())
    stresses = solver.effective_stresses(state.strains).cpu().numpy()
    p = state.p.cpu().numpy()
    if scales is not None:
        u_p, stresses, p = scales.u(u_p), scales.stresses(stresses), \
            scales.p(p)
        sp = dataclasses.replace(sp, node_coords=scales.u(sp.node_coords))
    write_vtk(path, sp, u_p, p, state.strains.cpu().numpy(), stresses)


class SimulationRunner:
    def __init__(self, data: InputData, device="cuda",
                 logger: Optional[RunLogger] = None,
                 scales: Optional[Scales] = None):
        """``scales``: a :class:`.scaling.Scales` when ``data`` is the
        nondimensionalized deck: a gmsh mesh is divided by its length
        scale, and the VTK output is rescaled back to SI (run logs and
        checkpoints stay in solver units)."""
        if data.amr:
            raise ValueError("an adaptive deck (AMR = true) runs through "
                             "run_from_data or amr.driver."
                             "AMRSimulationRunner")
        self.data, self.scales = data, scales
        self.group, self._own_group = None, False
        if data.sharding != "none":
            self.group, self._own_group = _slab_group(data, device)
            device = self.group.device
        self.is_root = self.group is None or self.group.rank == 0
        if data.mesh_file:
            mesh = read_msh(data.mesh_file, dim=data.dim)
            if scales is not None:          # the same L as the deck rescale
                mesh = scale_mesh(mesh, scales)
            self.disc = build_discretization(mesh, data, device=device)
        elif data.sharding in ("psum", "ghost"):
            self.disc = build_discretization(structured_generic_mesh(data),
                                             data, device=device)
        else:
            self.disc = build_grid_discretization(data, device=device)
        if self.group is not None:
            self.disc = _apply_sharding(self.disc, data, self.group)
        self._ghost = isinstance(self.disc, GhostShardedDiscretization)
        self.solver = FixedStressSolver(self.disc, data)
        if logger is None:
            logger = RunLogger(os.path.join(data.output_directory,
                                            "run_log.jsonl")) \
                if self.is_root else RunLogger(None, echo=False)
        self.logger = logger

    def _whole(self, state: State) -> State:
        """``state`` with whole vectors: gathered from every rank under
        ghost (a collective: every rank calls it), else as it is."""
        return self.disc.whole_state(state) if self._ghost else state

    def output(self, state: State, step: int):
        if not self.data.output_vtk:
            return
        state = self._whole(state)
        if not self.is_root:
            return
        write_state_vtk(os.path.join(self.data.output_directory,
                                     f"solution-{step:04d}.vtk"),
                        self.disc, self.solver, state, self.scales)

    def _needed(self, step: int) -> bool:
        """Whether a host consumer reads step ``step``'s whole state: the
        VTK output or a checkpoint."""
        every = self.data.checkpoint_every
        return bool(self.data.output_vtk or (every and step % every == 0))

    def run(self, resume_from: Optional[str] = None) -> State:
        """The JAX runner's time loop (``models/runner.py:186-287``): blocks
        of ``min(Steps per dispatch, steps left)`` steps, each ended early
        at a step whose state a host consumer reads; the buffered steps
        are logged, written, checkpointed and checked at each sync point,
        every ``Sync every`` steps (and after a block that ends at a read
        step).  Every rank of a sharded run flushes at the same steps.

        ``resume_from``: a checkpoint whose state, time and step the run
        continues from (an ``.npz`` file of either package, or a checkpoint
        directory of this one), on the solver's
        dtype and device (under ghost each rank takes its chunk); no
        step-0 VTK is written then.  Returns the final state, whole on
        every rank (under ghost in the renumbered order); an asynchronous
        checkpoint is on disk by then, also when the run raises."""
        try:
            return self._run(resume_from)
        finally:
            wait_for_checkpoints()

    def _run(self, resume_from: Optional[str]) -> State:
        data = self.data
        if resume_from:
            state, t, step = load_checkpoint_any(resume_from, self.disc.dtype,
                                                 self.disc.device)
            if self._ghost:
                state = self.disc.owned_state(state)
        else:
            state, t, step = self.solver.initial_state(), 0.0, 0
            self.output(state, 0)
        dt = data.time_step
        sync_every = max(1, data.sync_every)
        per_dispatch = max(1, data.steps_per_dispatch)
        pending = []      # (step, t, stats, state or None, wall_s)

        def flush():
            for s, ts, stats, st, wall in pending:
                self.logger.log_step(s, ts, stats, wall)
                if st is not None:
                    self.output(st, s)
                every = data.checkpoint_every
                if every and s % every == 0:
                    whole = self._whole(st)
                    if self.is_root:
                        save_step_checkpoint(data.checkpoint_format,
                                             data.checkpoint_directory,
                                             whole, ts, s)
                if not np.isfinite(float(stats.pressure_error)):
                    raise FloatingPointError(f"FSS residual diverged at "
                                             f"step {s}")
                if not bool(stats.cg_converged):
                    if bool(stats.cg_stalled):
                        reason = ("stagnated (residual reduction < 2%/iter "
                                  "— often the benign f32 attainable floor)")
                    else:
                        reason = "hit its iteration cap"
                    warnings.warn(f"step {s}: a linear solve {reason} "
                                  "before reaching tolerance",
                                  RuntimeWarning)
            pending.clear()

        while t < data.t_max:
            remaining = max(1, int(np.ceil((data.t_max - t) / dt - 1e-12)))
            B = min(per_dispatch, remaining)
            for j in range(1, B):     # end the block at the first read step
                if self._needed(step + j):
                    B = j
                    break
            needed = self._needed(step + B)
            t0 = time.perf_counter()
            with numbered_steps(step + 1):
                if B == 1:
                    state, stats = self.solver.time_step(state, dt,
                                                         want_u=needed)
                    block = [stats]
                else:
                    state, stacked = self.solver.multi_step(
                        state, dt, n_steps=B, want_u=needed)
                    block = [StepStats(**{
                        f.name: getattr(stacked, f.name)[i]
                        for f in dataclasses.fields(stacked)})
                        for i in range(B)]
            if sync_every == 1 and B == 1 and \
                    self.disc.device.type == "cuda":
                torch.cuda.synchronize(self.disc.device)
            wall = (time.perf_counter() - t0) / B
            for i, stats in enumerate(block):
                t += dt
                step += 1
                pending.append((step, t, stats,
                                state if (needed and i == B - 1) else None,
                                wall))
            if step % sync_every == 0 or (B > 1 and needed):
                flush()
        flush()
        self.logger.close()
        state = self._whole(self.solver.materialize_u(state))
        if self._own_group:
            dist.destroy_process_group()
        return state


def run_from_data(data: InputData, resume_from: Optional[str] = None,
                  device="cuda") -> State:
    """Full simulation from a parsed deck, on the card unless ``device``
    says ``"cpu"``, from the checkpoint ``resume_from`` (a file or a
    directory) when given: ``Nondimensionalize = true`` rescales the deck first
    (:func:`.scaling.nondimensionalize`) and hands the runner its scales;
    then an adaptive deck runs through
    :class:`..amr.driver.AMRSimulationRunner` (its run log
    ``run_log.jsonl`` in the output directory), any other through
    :class:`SimulationRunner`.  Under ``torchrun`` (or in an initialised
    process group) a deck with ``Sharding = psum``, ``ghost``, ``gspmd`` or
    ``production`` runs sharded, one rank per device (``cuda:{LOCAL_RANK}``
    on CUDA; an adaptive deck with psum only); every rank returns the whole
    state (under ghost in the first-touch renumbered order)."""
    scales = None
    if data.nondimensionalize:
        data, scales = nondimensionalize(data)
    if data.amr:
        from ..amr.driver import AMRSimulationRunner
        runner = AMRSimulationRunner(data, device=device, run_log=True,
                                     scales=scales)
        state, _ = runner.run(resume_from=resume_from)
        return state
    return SimulationRunner(data, device=device, scales=scales).run(
        resume_from=resume_from)


def run_from_deck(path: str, resume_from: Optional[str] = None,
                  device="cuda") -> State:
    """Deck file -> full simulation (:func:`run_from_data`)."""
    return run_from_data(read_input_file(path), resume_from=resume_from,
                         device=device)
