"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``poroelasticity_dealii_torch/csrc``
(one nvcc per source, in parallel, then one link), checks with
``cuobjdump -sass`` that the float64 cell products (elasticity apply and
projection) run on the tensor cores (DMMA) and no float32 kernel does,
holds each kernel against its plain PyTorch twin on the card (n = 40,
timed; n = 21 and 7: ragged tiles), times each kernel's library yardstick
(a cuSPARSE CSR SpMV over the assembled operator), and drives the port's
paths through their entry points, each with the kernel launch counts reset
just before and read just after:

* the Jacobi-CG update's two kernels (``csrc/cg_update.cu``) at the
  benchmark's vector shapes (the rows layout's 984 x 1792, the distorted
  mesh's flat 1,594,323 and the projection's batch of six 68,921-value
  lanes) in float64 and float32, with live, frozen and mixed lanes: each
  wrapper against the same arithmetic in plain torch and the whole fused
  update against the plain body, bit for bit; timed after an L2 flush
  beside their plain twins and bounds (``apply_bench.cg_update_run``);
  and, in the main path, the conv, generic, sharded (production, gspmd,
  psum, ghost) and refinement phases, two steps (the first with the load's
  bc-response solve, the projection's batched mass CG in each) on the
  kernels held bit for bit against the same steps with the plain update
  (:func:`held_to_plain`);

* the main path: 3D Q2/Q1 fixed-stress steps at 40^3, float32, the bench
  configuration, on the rows backend, every CG chunk a captured CUDA graph
  (the launch counts include the replays), cross-checked against a run on
  the plain twins;
* the captured loop against the eager one: 2 evolving + 1 steady steps of
  the main path with the chunks run eagerly (``cuda_graphs=False``), equal
  counts and p, u bit for bit, on the rows and the conv backend;
* ``multi_step``: one block of 4 steps against the same 4 ``time_step``
  calls, bit for bit;
* the sharded production path: the same configuration through
  ``shard_production_discretization`` on a world-size-1 NCCL process group
  (one card), every mechanics apply the slab form of the row-layout kernel,
  the pressure stencils and the fused Jacobian on gspmd slabs, held
  against the main path's steps;
* the gspmd form (``shard_grid_discretization``) of the conv backend at
  40^3 float32 on a world-size-1 NCCL group: every stencil on its
  node-plane slab and gathered, the elasticity slab the flat kernel's slab
  mode (launched at least once per mechanics CG iteration), the fused
  Jacobian through the hook; bit for bit against an eager unsharded conv
  run;
* the flat-apply path: ``tools/apply_bench`` at 40^3 float32, the flat
  elasticity kernel through both its entry points (``make_flat_apply``,
  ``make_grid_elasticity``) held against the conv backend's plain stencil;
* the conv backend: fixed-stress steps at 40^3 float32 on flat vectors,
  its elasticity apply the flat kernel, step 1 compared with a conv run on
  the plain stencil and with the rows path;
* the structured path's solver options (``structured_options_phase``):
  (a) the JAX package's configuration off a TPU, the 40^3 conv backend
  with ``multigrid="auto"`` (4 levels, every level apply above the dense
  coarse inverse the flat kernel: 24 launches a V-cycle, the V-cycle held
  against the same hierarchy on the plain stencil), GMG-Richardson
  mechanics ending converged or on the stagnation exit, never at the cap,
  2 evolving + 1 steady captured steps equal to eager bit for bit, step 1
  against the rows and the conv Jacobi-CG runs, a profiled evolving and
  steady step beside the rows path's ms, and a conv deck through
  ``SimulationRunner``; (b) 40^3 float64 ``Mixed precision refinement``
  on against native f64 GMG-CG; (c) node-block Jacobi against Jacobi on
  rows; (d) the 80 x 40 x 20 anisotropic grid (1,673,784 DOF, plain
  stencils), captured against eager and profiled, its elasticity apply
  beside its bound; (e) a Q2/Q2 step at 16^3;
* the 2D path at ``bench.py::build_2d``'s 512^2 float32 point: the
  parity kit with the parity-resident elasticity GMG (asserted selected),
  GMG-Richardson mechanics, 2 evolving + 1 steady captured steps with
  every solve checked (pressure, projection and bc-response solves
  converged; each mechanics solve converged or stopped on Richardson's
  stagnation exit at the float32 floor of its true residual, as in the
  reference, never at the cap), captured against eager bit for bit, the
  parity apply timed against its bound, and the flat GMG-Richardson path
  (``elasticity_backend="conv"``) on the evolving steps against it; then
  the 2D production form (the y-slab parity kit, its V-cycle on gathered
  slabs) on a world-size-1 NCCL group against that run: the same FSS and
  pressure counts, every mechanics solve on the same exit, p and u within
  1e-4 of max;
* the generic path (``build_discretization``, flat Jacobi-CG; its mass,
  Laplace, pressure Jacobian and elasticity applies the hand-written
  generic kernels of ``csrc/generic.cu``, coupling and projection plain
  torch; the kernels rebuild the cell map from each cell's corner
  offsets and read their tiles by TMA, UTMALDG required in every product
  instance): first the kernels alone (``generic_kernel_phase``: each
  against its plain twin on distorted 2D and 3D grids, the gmsh hex mesh,
  bucketed AMR meshes with phantom cells, geometry shared by every cell
  and a ghost window, 1, 3 and 6 lanes, float64 within 1e-12 and float32
  within 2e-6 of max, repeats bitwise; the bytes each record copied to
  give TMA whole 16-byte rows); then the bench configuration on the
  distorted 40^3 hex mesh (1,663,244 DOF, float32), 2 evolving + 1 steady
  captured steps (both generic kernels launched), every solve converged,
  captured against eager bit for bit; its six applies and the batched Q1
  calls at 40^3 in float32 and float64 (two applies bitwise equal, each
  kernel against its twin, timed beside its twin, its bound and the
  stored-geometry design's, its host enqueue, the twin's scatter share,
  the flat kernel and a cuSPARSE SpMV, or SpMM over 6 lanes, of the
  assembled operator); the generic
  build on the undistorted 20^3 grid against the rows path; then the
  psum form (``shard_discretization``, one all-reduce per apply) on a
  world-size-1 NCCL group against the captured generic run: counts
  equal, p and u bit for bit;
* the ghost form (``parallel/ghost.py``: first-touch renumbering, every
  vector sharded, halo windows) on the same distorted 40^3 mesh: its halo
  arithmetic at full size in one process (``ghost_split_phase``: 1-, 2-,
  4- and 8-way splits, every rank's window-local applies with the windows
  and returns through an in-process transport, stitched, against the
  unsharded applies in float64 and float32; C, H and the halo values per
  apply; rank 0's window elasticity apply timed for the 4-way split),
  then ``shard_discretization_ghost`` on a world-size-1 NCCL group
  (``ghost_phase``: 2 evolving + 1 steady eager steps, the solver on
  sharded vectors with every reduction all-reduced, against the captured
  generic run mapped through the renumbering);
* the CLI on the 3D deck, on the rows backend, on a copy of the deck with
  ``Elasticity backend = conv``, and on a copy with ``Steps per dispatch =
  4``, ``Sync every = 2`` and no VTK output (blocks of 4 and 2 steps), on
  a copy with ``Sharding = ghost`` under ``torchrun`` on one rank against
  the same copy on one process (unsharded), on
  the golden 2D deck (float64, 17 steps) against
  ``tests/data/golden_history.json``, and on the gmsh deck
  ``configs/irregular_2d.data`` (the generic path, float64, 17 steps)
  against :data:`IRREGULAR_2D_PIN`, JAX's counts and residuals;
* adaptive mesh refinement (``amr/``: forests, hanging-node constraints,
  Kelly marking, transfer, the adaptive driver; the generic path, its
  applies the generic kernels): the golden adaptive deck through the CLI
  (float64, 17 steps, 256 -> 1000 cells) against
  ``tests/data/adaptive_golden_history.json``; the gmsh-rooted quad and
  hex forests at JAX's test sizes (float64) against
  :data:`AMR_IRREGULAR_2D_PIN` and :data:`AMR_IRREGULAR_3D_PIN` (the 2D
  one in blocks of two steps); and the 3D octree at scale (the bench
  configuration with AMR, 112,724 DOF at level 4, one remesh to level 5,
  float32, 6 captured steps through the runner's own loop): every solve
  converged, captured equal to eager after the remesh, the hanging values
  consistent, ``condense_vec`` bitwise repeatable, the old mesh's solver,
  graphs and discretization freed and their memory returned, each step's
  ms and the remesh's split, and padded against unpadded steps on the
  final mesh (what ``AMR bucketing`` costs); and the golden adaptive deck
  with ``Sharding = psum`` through the adaptive runner on a world-size-1
  NCCL group (every mesh sharded) against the same pin;
* the runner's deck options (``runner_options_phase``): the 40^3 float32
  bench configuration through ``SimulationRunner`` with a checkpoint every
  2 steps, resumed by a fresh runner from step 2 (steps 3-4 bit for bit,
  K1-K4 launched; the checkpoint's bytes and write ms, the resume's
  set-up seconds); ``Nondimensionalize`` at 40^3 float64 against the
  dimensional run; ``Debug NaNs`` on against off (bit for bit, step ms of
  both) and a NaN deck that must raise; the golden adaptive deck resumed
  after its first remesh; and, in the CLI phase, the 8^3 deck resumed
  with ``--resume`` from a checkpoint the CLI wrote and run with
  ``--profile`` (the trace must hold CUDA kernel events).

Before the paths, the slab form of the row-layout apply (K5's z-slab form,
``nz``/``nv``) is held against its plain twin on every slab of 2-, 4- and
8-way splits at n = 40 and 7, and the slabs stitched against the whole-grid
apply; the 4-way split at 40^3 float32 is timed beside its bound and its
library yardstick.  The flat kernel's slab mode (K6's ``nz``, the gspmd
elasticity slab) is held the same way on the slabs ``SlabStencil`` gives
each rank of 1/2/4/8-way splits of the node planes at n = 40 and 7, the
stitched slabs bit for bit equal to the whole-grid K6, slab 0 of the
4-way split at 40^3 timed in both types.  Every sharded phase runs on one
card (NCCL refuses two ranks on one GPU): the multi-rank split runs on
gloo CPU ranks in the tests; each sharded phase prints its wall seconds,
step ms and, from one more profiled steady step, its busy and idle share.

The 2D path reaches no hand-written kernel (the JAX package computes
it with XLA einsums, outside any Pallas kernel): its products are
``torch.matmul`` / ``torch.einsum`` at full float32, checked with TF32
off.  Neither do the generic path's coupling and projection right-hand
sides, nor AMR's host numpy.

It prints the kernel summary and, as its last line,
``{"ok": true, "device": {...}}``.  Any failure exits non-zero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from poroelasticity_dealii_torch.mesh import hyper_rectangle
from poroelasticity_dealii_torch.models.runner import SimulationRunner
from poroelasticity_dealii_torch.ops import _cuda
from poroelasticity_dealii_torch.ops import cell_products as cp
from poroelasticity_dealii_torch.ops import cg_update
from poroelasticity_dealii_torch.ops import comp_major as cm
from poroelasticity_dealii_torch.ops import elasticity as eg
from poroelasticity_dealii_torch.ops.parity2d import ElasticityParityOps
from poroelasticity_dealii_torch.parallel import ghost as gh
from poroelasticity_dealii_torch.parallel import rows as pr
from poroelasticity_dealii_torch.parallel.sharding import (
    ShardedDiscretization, SlabGroup, SlabStencil, make_slab_group,
    shard_discretization, shard_grid_discretization)
from poroelasticity_dealii_torch.solvers import cg as tcg
from poroelasticity_dealii_torch.solvers.discretization import \
    build_discretization
from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver
from poroelasticity_dealii_torch.solvers.structured import \
    build_grid_discretization
from poroelasticity_dealii_torch.tools import apply_bench, profile_step
from poroelasticity_dealii_torch.tools.apply_bench import cuda_time_ms, \
    device_and_host_ms, nonzeros
from poroelasticity_dealii_torch.tools.profile_step import BC_RATE, \
    amr_data, amr_sizes, bench_data, data_2d, generic_mesh
from poroelasticity_dealii_torch.utils import profiling

REPO = Path(__file__).resolve().parent

KERNEL_SHAPES_N = (40, 21, 7)    # 40 timed; 21 gives ragged product tiles
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}   # relative to max |plain|
# published H100 SXM peaks at 700 W (NVIDIA data sheet) and HBM3 bandwidth:
# float32 outside the tensor cores (TF32 is not float32), float64 on the
# tensor cores (DMMA, full IEEE float64), the card's highest rate for each
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
PEAK_BYTES = 3.35e12


def _rel_err(got, ref) -> float:
    scale = ref.abs().max().item()
    return (got - ref).abs().max().item() / (scale if scale > 0 else 1.0)


def kernel_cases(n: int, dtype, dev, ke, ce, pe, free_mask_u, rng):
    """[(name, input, kernel fn, plain fn)] for every kernel at grid size
    n; ``input`` is the vector that the case's library operator
    (``apply_bench.library_csr``) multiplies."""
    g = 2 * n + 1
    u = rng.standard_normal(g ** 3 * 3)
    uf = torch.as_tensor(u, dtype=dtype, device=dev)
    x = cm.to_rows(uf, n)
    m = torch.as_tensor(cm.to_rows_np(free_mask_u, n), dtype=dtype,
                        device=dev)
    xf = x * m                                  # free-subspace input
    p = torch.as_tensor(rng.standard_normal((n + 1) ** 3), dtype=dtype,
                        device=dev)
    K, Cm, P = (torch.as_tensor(a, dtype=dtype, device=dev)
                for a in (ke, ce, pe))
    return [
        ("elasticity_rows_apply[unmasked]", x,
         lambda: cm.elasticity_rows_apply(x, None, K, n, cm.UNMASKED),
         lambda: cm.elasticity_rows_apply_plain(x, None, K, n, cm.UNMASKED)),
        ("elasticity_rows_apply[free]", xf,
         lambda: cm.elasticity_rows_apply(xf, m, K, n, cm.FREE),
         lambda: cm.elasticity_rows_apply_plain(xf, m, K, n, cm.FREE)),
        ("elasticity_rows_apply[constrained]", x,
         lambda: cm.elasticity_rows_apply(x, m, K, n, cm.CONSTRAINED),
         lambda: cm.elasticity_rows_apply_plain(x, m, K, n,
                                                cm.CONSTRAINED)),
        ("coupling_rows", p,
         lambda: cm.coupling_rows(p, Cm, n),
         lambda: cm.coupling_rows_plain(p, Cm, n)),
        ("projection_rows", x,
         lambda: cm.projection_rows(x, P, n),
         lambda: cm.projection_rows_plain(x, P, n)),
        ("elasticity_grid_apply", uf,
         lambda: eg.elasticity_grid_apply(uf, K, n),
         lambda: eg.elasticity_grid_apply_plain(uf, K, n)),
    ]


def kernel_work(name: str, n: int, dtype, nnz: dict, nz: int = None,
                nv: int = None) -> tuple:
    """(bytes, flop) that kernel ``name`` must move and compute at grid
    size n: each input read once, each output written once, the element
    products counted as 2 flop per nonzero of the element matrix (``nnz``:
    {"ke", "ce", "pe"} counts) per cell, plus the masking ops.  The slab
    form (``elasticity_rows_apply[slab]``) moves ``(nz+1)*24`` rows in and
    out and multiplies its ``nv`` real cell layers only; the flat apply's
    slab mode (``elasticity_grid_apply[slab]``) moves the flat vectors of
    ``nz`` cell layers in and out and multiplies all of them (pass
    ``nv = nz``)."""
    nz = n if nz is None else nz
    rows = (nz + 1) * 24 * cm._width(n)       # row-layout array, padded
    flat = (2 * n + 1) ** 2 * (2 * nz + 1) * 3   # flat Q2 vector (slab)
    q1 = (n + 1) ** 3                         # flat Q1 vector
    cells = (n if nv is None else nv) * n * n
    mat = 2 * nnz["ke"] * cells
    elems, flop = {
        "elasticity_rows_apply[unmasked]": (2 * rows + 81 * 81, mat),
        "elasticity_rows_apply[slab]": (2 * rows + 81 * 81, mat),
        "elasticity_rows_apply[free]": (3 * rows + 81 * 81, mat + rows),
        "elasticity_rows_apply[constrained]": (3 * rows + 81 * 81,
                                               mat + 5 * rows),
        "coupling_rows": (q1 + 81 * 8 + rows, 2 * nnz["ce"] * cells),
        "projection_rows": (rows + 48 * 81 + 6 * q1, 2 * nnz["pe"] * cells),
        "elasticity_grid_apply": (2 * flat + 81 * 81, mat),
        "elasticity_grid_apply[slab]": (2 * flat + 81 * 81, mat),
    }[name]
    item = torch.tensor([], dtype=dtype).element_size()
    return elems * item, flop


def bound(name: str, n: int, dtype, nnz: dict, nz: int = None,
          nv: int = None) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    flop over the peak rate of ``dtype``."""
    nbytes, flop = kernel_work(name, n, dtype, nnz, nz, nv)
    t_bytes, t_flop = nbytes / PEAK_BYTES, flop / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_flop) * 1e3,
            "bytes" if t_bytes >= t_flop else "operations")


def kernel_phase(n: int, dtype, dev, ke, ce, pe, free_mask_u, timing: bool):
    """Compare every kernel with its plain twin at grid size n; assert the
    tolerance and bitwise repeatability; return one record per kernel."""
    rng = np.random.default_rng(n)
    nnz = {"ke": nonzeros(ke), "ce": nonzeros(ce), "pe": nonzeros(pe)}
    out = []
    for name, _, kern, plain in kernel_cases(n, dtype, dev, ke, ce, pe,
                                             free_mask_u, rng):
        y1 = kern()
        y2 = kern()
        ref = plain()
        torch.cuda.synchronize()
        err = _rel_err(y1, ref)
        bitwise = torch.equal(y1, y2)
        rec = {"name": name, "n": n, "dtype": str(dtype).split(".")[-1],
               "max_abs_err": (y1 - ref).abs().max().item(),
               "max_rel_err": err, "bitwise_repeat": bitwise}
        if timing:
            rec["ms"], rec["host_ms"] = device_and_host_ms(kern)
            rec["plain_ms"] = cuda_time_ms(plain)
            rec["bound_ms"], rec["bound_by"] = bound(name, n, dtype, nnz)
            rec["element_nonzeros"] = nnz
        print(json.dumps(rec), flush=True)
        if not (err <= TOL[dtype]):
            raise AssertionError(f"{name} n={n} {dtype}: rel err {err:.3e} "
                                 f"> {TOL[dtype]:.0e}")
        if not bitwise:
            raise AssertionError(f"{name} n={n} {dtype}: repeat runs differ")
        out.append(rec)
    return out


KERNEL_INFO = {
    # wrapper: (source, replaced Pallas kernel, mode timed for the summary)
    "elasticity_rows_apply": (
        "poroelasticity_dealii_torch/csrc/comp_major.cu",
        "poroelasticity_dealii_tpu/ops/pallas_comp_major.py:650",
        "elasticity_rows_apply[free]"),
    "coupling_rows": (
        "poroelasticity_dealii_torch/csrc/comp_major.cu",
        "poroelasticity_dealii_tpu/ops/pallas_comp_major.py:967",
        "coupling_rows"),
    "projection_rows": (
        "poroelasticity_dealii_torch/csrc/comp_major.cu",
        "poroelasticity_dealii_tpu/ops/pallas_comp_major.py:1111",
        "projection_rows"),
    "elasticity_grid_apply": (
        "poroelasticity_dealii_torch/csrc/comp_major.cu",
        "poroelasticity_dealii_tpu/ops/pallas_comp_major.py:1363; "
        "poroelasticity_dealii_tpu/ops/pallas_elasticity.py:108",
        "elasticity_grid_apply"),
}
# the generic path's kernels (no TPU kernel: they replace XLA code of
# the JAX package): wrapper -> (source, replaced code, the apply of
# apply_bench.generic_run timed for the summary)
GENERIC_KERNEL_INFO = {
    "generic_elasticity_apply": (
        "poroelasticity_dealii_torch/csrc/generic.cu",
        "poroelasticity_dealii_tpu/ops/operators.py:171", "elasticity"),
    "generic_q1_apply": (
        "poroelasticity_dealii_torch/csrc/generic.cu",
        "poroelasticity_dealii_tpu/ops/operators.py:158,164", "pressure"),
}
GENERIC_TOL = {torch.float64: 1e-12, torch.float32: 2e-6}   # of max |twin|
MAIN_PATH_KERNELS = ("elasticity_rows_apply", "coupling_rows",
                     "projection_rows")
N_EVOLVING, N_STEADY = 5, 3
N_CONV_EVOLVING, N_CONV_STEADY = 2, 1
N_MAIN = 40               # 40^3 cells: 81^3*3 + 41^3 = 1,663,244 DOF
CROSS_TOL = 1e-4          # plain-vs-kernel fields, relative to max |field|
CLI_PRESSURE_RTOL = 1e-6  # conv vs rows CLI run-log pressure_error


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def run_steps(solver, n_evolving, n_steady, log):
    """initial_state, evolving steps (bc_scale = 1 + 0.05 k), then steady
    steps at the last scale; returns (states after each step, stats, step
    ms)."""
    dt = solver.data.time_step
    state = solver.initial_state()
    states, stats_all, ms_all = [], [], []
    bc_prev = 1.0
    for k in range(1, n_evolving + n_steady + 1):
        bc = 1.0 + BC_RATE * min(k, n_evolving)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, stats = solver.time_step(state, dt, bc, bc_scale_prev=bc_prev,
                                        want_u=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        bc_prev = bc
        kind = "evolving" if k <= n_evolving else "steady"
        if log:
            print(json.dumps({
                "step": k, "kind": kind, "bc_scale": bc, "ms": ms,
                "fss": stats.fss_iterations,
                "pressure": stats.pressure_iterations,
                "cg_pressure": stats.pressure_cg_iterations,
                "cg_mechanics": stats.mech_cg_iterations,
                "cg_projection": stats.projection_cg_iterations,
                "pressure_error": stats.pressure_error,
                "cg_converged": stats.cg_converged}), flush=True)
        states.append(state)
        stats_all.append(stats)
        ms_all.append(ms)
    return states, stats_all, ms_all


def check_state(state, n_pdofs, n_udofs, n_voigt=6):
    for name, t, shape in (("p", state.p, (n_pdofs,)),
                           ("u", state.u, (n_udofs,)),
                           ("eps_v", state.eps_v, (n_pdofs,)),
                           ("strains", state.strains, (n_voigt, n_pdofs))):
        if tuple(t.shape) != shape:
            raise AssertionError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} has non-finite values")


def main_path(dev):
    """The bench configuration through the port's entry points, kernels
    counted (replays included); returns (launch counts, states, stats, step
    ms, solver)."""
    data = bench_data()
    t0 = time.perf_counter()
    disc = build_grid_discretization(data, cells_per_axis=N_MAIN,
                                     multigrid="off", device=dev)
    solver = FixedStressSolver(disc, data)
    torch.cuda.synchronize()
    print(f"main path setup: {time.perf_counter() - t0:.2f} s, "
          f"dofs={disc.n_pdofs + disc.n_udofs}", flush=True)
    cm.reset_launch_counts()
    t0 = time.perf_counter()
    states, stats, ms = run_steps(solver, N_EVOLVING, N_STEADY, log=True)
    torch.cuda.synchronize()
    launches = launch_counts()
    launches["cg_update"] = cm.launch_counts()["cg_update"]
    modes = mode_launches()
    print(f"main path: initial_state + {N_EVOLVING} evolving + {N_STEADY} "
          f"steady steps in {time.perf_counter() - t0:.2f} s, launches "
          f"{launches}, elasticity_rows_apply by mode: unmasked "
          f"{modes[cm.UNMASKED]}, free {modes[cm.FREE]}, constrained "
          f"{modes[cm.CONSTRAINED]}", flush=True)
    graphs = solver.graphs
    if graphs is None or not graphs.replays:
        raise AssertionError("main path: the CG chunks were not captured")
    print(json.dumps({"main_path_graphs": {
        "captures": dict(graphs.captures), "replays": dict(graphs.replays)}}),
        flush=True)
    check_steps(states, stats, disc, N_EVOLVING)
    for name in (*MAIN_PATH_KERNELS, "cg_update"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the main "
                                 "path")
    held_to_plain("rows", lambda: FixedStressSolver(disc, data))
    return launches, states, stats, ms, solver


@contextlib.contextmanager
def plain_cg_update():
    """Every Jacobi-CG solve started in the block runs its update in plain
    torch (``solvers/cg.py::_jacobi_update_plain``, the twin of the update
    kernels) instead of on the kernels."""
    fused = tcg._jacobi_update
    tcg._jacobi_update = lambda b, dinv, batched: tcg._jacobi_update_plain
    try:
        yield
    finally:
        tcg._jacobi_update = fused


def _counted(fn) -> tuple:
    """``(fn(), {(kind, site): n})``: the update kernels' launches, the CG
    chunks' steps and their fused steps that ``fn`` added."""
    kinds = ("launches", "chunk_steps", "fused_steps")
    before = {k: v for k, v in profiling.RECORDER.counts.items()
              if k[0] in kinds}
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before.get(k, 0)
                 for k, v in profiling.RECORDER.counts.items()
                 if k[0] in kinds and v != before.get(k, 0)}


def _same_steps(a: tuple, b: tuple) -> bool:
    """Whether two :func:`run_steps` runs have equal stats, field by field,
    and every tensor of every state bit for bit."""
    for sa, sb in zip(a[0], b[0]):
        for f in dataclasses.fields(sa):
            x, y = getattr(sa, f.name), getattr(sb, f.name)
            if (x is None) != (y is None) or (
                    x is not None and not torch.equal(x, y)):
                return False
    return len(a[0]) == len(b[0]) and all(
        np.array_equal(getattr(x, f.name), getattr(y, f.name))
        for x, y in zip(a[1], b[1]) for f in dataclasses.fields(x))


def held_to_plain(tag: str, make_solver) -> None:
    """One evolving step (the load changes: the bc-response solve) and one
    steady step of a fresh ``make_solver()``, its Jacobi-CG updates on the
    kernels, against the same steps of another with the plain update
    (:func:`plain_cg_update`): equal stats and every state tensor bit for
    bit; the first run's CG steps all fused where Jacobi, the kernels
    launched, the second's none."""
    def run():
        return run_steps(make_solver(), 1, 1, log=False)
    fused, counts = _counted(run)
    with plain_cg_update():
        plain, plain_counts = _counted(run)
    chunks = {k[1]: v for k, v in counts.items() if k[0] == "chunk_steps"}
    rec = {f"{tag}_fused_vs_plain": {
        "bitwise": _same_steps(fused, plain),
        "chunk_steps": chunks,
        "fused_steps": {k[1]: v for k, v in counts.items()
                        if k[0] == "fused_steps"},
        "cg_update_launches": counts.get(("launches", "cg_update"), 0),
        "plain_chunk_steps": {k[1]: v for k, v in plain_counts.items()
                              if k[0] == "chunk_steps"},
        "plain_fused": {k[1]: v for k, v in plain_counts.items()
                        if k[0] == "fused_steps" or k == ("launches",
                                                          "cg_update")}}}
    print(json.dumps(rec), flush=True)
    r = rec[f"{tag}_fused_vs_plain"]
    if not r["bitwise"] or not r["fused_steps"] or r["plain_fused"] or \
            r["cg_update_launches"] < 2 * sum(r["fused_steps"].values()) \
            or r["plain_chunk_steps"] != chunks:
        raise AssertionError(f"{tag}: fused against plain update: {r}")


def cg_update_phase(dev) -> dict:
    """The Jacobi-CG update's two kernels at the benchmark's vector shapes
    (``apply_bench.CG_UPDATE_SHAPES``) in float64 and float32, every lane
    live, none, and (the batch) every other one: ``jacobi_step`` and
    ``direction`` against their arithmetic in plain torch, and the whole
    fused update (``_jacobi_update_cuda``) against the plain body
    (``_jacobi_update_plain``), each output bit for bit; then each timed
    after an L2 flush and back to back beside its plain twin and its bound
    (``apply_bench.cg_update_run``).  Returns the row layout's timing
    record by dtype."""
    out = {}
    for dtype in (torch.float64, torch.float32):
        for name, shape in apply_bench.CG_UPDATE_SHAPES.items():
            batched = name == "batched"
            g = torch.Generator().manual_seed(len(shape) + shape[-1])

            def vec(sh=shape, scale=1.0):
                return (scale * torch.randn(sh, generator=g,
                                            dtype=torch.float64)).to(
                    dtype).to(dev)
            x, r, p, ap = vec(), vec(), vec(), vec(scale=1e3)
            d = vec(shape[1:] if batched else shape).abs() + 0.5
            if batched:
                dot, norm = tcg.LocalReductions.lane_dot, tcg.lane_norm
                lane = (lambda t: t[:, None])
                lives = ([True] * shape[0], [False] * shape[0],
                         [k % 2 == 0 for k in range(shape[0])])
            else:
                dot, norm = tcg.LocalReductions.dot, torch.linalg.norm
                lane = (lambda t: t)
                lives = (True, False)
            for live in lives:
                active = torch.as_tensor(live, device=dev)
                rz, rnorm = dot(r, r * d), norm(r)
                alpha = rz / dot(p, ap)
                x_out, r_out, z = cg_update.jacobi_step(x, r, p, ap, d,
                                                        alpha, active)
                beta = dot(r_out, z) / rz
                p_out = cg_update.direction(z, p, beta, active)
                a, r_new = lane(active), r - lane(alpha) * ap
                want = (torch.where(a, x + lane(alpha) * p, x),
                        torch.where(a, r_new, r), r_new * d,
                        torch.where(a, z + lane(beta) * p, p))
                args = (x, r, p, ap, rz, rnorm, d, active, dot, norm)
                wrappers = [torch.equal(u, v) for u, v in zip(
                    (x_out, r_out, z, p_out), want)]
                whole = [torch.equal(u, v) for u, v in zip(
                    tcg._jacobi_update_cuda(*args),
                    tcg._jacobi_update_plain(*args))]
                rec = {"cg_update_bitwise": {
                    "case": name, "shape": list(shape), "dtype": str(dtype),
                    "active": live, "wrappers": wrappers, "whole": whole}}
                print(json.dumps(rec), flush=True)
                if not all(wrappers + whole):
                    raise AssertionError(f"CG update kernels against plain "
                                         f"torch: {rec}")
        for rec in apply_bench.cg_update_run(dtype, dev):
            print(json.dumps({"cg_update_times": rec}), flush=True)
            if not rec["bitwise"]:
                raise AssertionError(f"CG update timing run: {rec}")
            if rec["case"] == "rows":
                out[dtype] = rec
    return out


def launch_counts() -> dict:
    """Each kernel wrapper's launches (graph replays included)."""
    c = cm.launch_counts()
    return {fn.__name__: c[fn.__name__] for fn in cm.KERNEL_WRAPPERS}


def mode_launches() -> dict:
    """``elasticity_rows_apply``'s whole-grid launches by mode."""
    c = cm.launch_counts()
    return {m: c[("mode", m)] for m in (cm.UNMASKED, cm.FREE,
                                        cm.CONSTRAINED)}


def check_steps(states, stats, disc, n_evolving):
    """Every field finite with its shape, every solve converged, and
    mechanics work in every evolving step."""
    for k, (st, s) in enumerate(zip(states, stats), 1):
        check_state(st, disc.n_pdofs, disc.n_udofs,
                    3 if disc.dim == 2 else 6)
        if not s.cg_converged:
            raise AssertionError(f"step {k}: a linear solve did not converge")
    for k, s in enumerate(stats[:n_evolving], 1):
        if s.mech_cg_iterations <= 0:
            raise AssertionError(f"evolving step {k}: no mechanics CG work")


COUNT_FIELDS = ("fss_iterations", "pressure_iterations",
                "pressure_cg_iterations", "mech_cg_iterations",
                "projection_cg_iterations")
N_GRAPH_EVOLVING, N_GRAPH_STEADY = 2, 1
MULTI_STEP_SCALES = [1.0 + BC_RATE * k for k in (1, 2, 3, 3)]


def _counts(stats) -> list:
    return [getattr(stats, f) for f in COUNT_FIELDS]


def captured_vs_eager(name, captured, disc, data, captured_run=None):
    """2 evolving + 1 steady steps with the captured solver ``captured``
    (or its run ``captured_run`` of those steps, from ``run_steps``) and
    with an eager one on the same discretization: equal counts, and p and u
    bit for bit; prints both runs' ms per step."""
    runs = {}
    for loop, solver in (("captured", captured),
                         ("eager", FixedStressSolver(disc, data,
                                                     cuda_graphs=False))):
        if (solver.graphs is not None) != (loop == "captured"):
            raise AssertionError(f"{name}: the {loop} solver has graphs "
                                 f"{solver.graphs}")
        if loop == "captured" and captured_run is not None:
            runs[loop] = captured_run
            continue
        runs[loop] = run_steps(solver, N_GRAPH_EVOLVING, N_GRAPH_STEADY,
                               log=False)
    (st_c, ss_c, ms_c), (st_e, ss_e, ms_e) = runs["captured"], runs["eager"]
    for k in range(N_GRAPH_EVOLVING + N_GRAPH_STEADY):
        rec = {f"{name}_captured_vs_eager_step": k + 1,
               "counts": [_counts(ss_c[k]), _counts(ss_e[k])],
               "ms": [ms_c[k], ms_e[k]],
               "p_bitwise": torch.equal(st_c[k].p, st_e[k].p),
               "u_bitwise": torch.equal(st_c[k].u, st_e[k].u)}
        print(json.dumps(rec), flush=True)
        if rec["counts"][0] != rec["counts"][1] or not (
                rec["p_bitwise"] and rec["u_bitwise"]):
            raise AssertionError(f"{name} step {k + 1}: captured and eager "
                                 f"runs differ: {rec}")


def multi_step_phase(solver):
    """One block of 4 steps (3 evolving with the 0.05 ramp, 1 steady)
    against the same 4 ``time_step`` calls on the main path's solver: the
    stacked counts equal the per-step counts and every field is equal bit
    for bit."""
    dt = solver.data.time_step
    st0 = solver.initial_state()
    st, prev, seq = st0, 1.0, []
    t0 = time.perf_counter()
    for bc in MULTI_STEP_SCALES:
        st, stats = solver.time_step(st, dt, bc, bc_scale_prev=prev)
        seq.append(stats)
        prev = bc
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    st0 = solver.initial_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blk, stacked = solver.multi_step(st0, dt, bc_scales=MULTI_STEP_SCALES,
                                     bc_scale_prev=1.0, want_u=True)
    torch.cuda.synchronize()
    t_blk = time.perf_counter() - t0
    rec = {"multi_step_block": len(MULTI_STEP_SCALES),
           "bc_scales": MULTI_STEP_SCALES,
           "stacked_counts": [getattr(stacked, f).tolist()
                              for f in COUNT_FIELDS],
           "time_step_counts": [[getattr(x, f) for x in seq]
                                for f in COUNT_FIELDS],
           "ms_per_step": [t_blk * 1e3 / len(seq), t_seq * 1e3 / len(seq)]}
    rec["fields_bitwise"] = {k: torch.equal(getattr(blk, k), getattr(st, k))
                             for k in ("p", "u", "eps_v", "strains",
                                       "u_rows", "mech_b")}
    rec["pressure_error_equal"] = stacked.pressure_error.tolist() == [
        x.pressure_error for x in seq]
    print(json.dumps(rec), flush=True)
    if rec["stacked_counts"] != rec["time_step_counts"] or not all(
            rec["fields_bitwise"].values()) or not rec["pressure_error_equal"]:
        raise AssertionError(f"multi_step block differs from time_step "
                             f"calls: {rec}")


def cross_check(dev, states, stats):
    """Two evolving steps on the plain twins vs the kernel run."""
    data = bench_data()
    disc = build_grid_discretization(data, cells_per_axis=N_MAIN,
                                     multigrid="off", device=dev,
                                     kernels="plain")
    plain_states, plain_stats, _ = run_steps(FixedStressSolver(disc, data),
                                             2, 0, log=False)
    for k in range(2):
        a, b = stats[k], plain_stats[k]
        if (a.fss_iterations, a.pressure_iterations) != \
                (b.fss_iterations, b.pressure_iterations):
            raise AssertionError(f"step {k + 1}: kernel run fss/pressure "
                                 f"{a.fss_iterations}/{a.pressure_iterations}"
                                 f" != plain {b.fss_iterations}/"
                                 f"{b.pressure_iterations}")
        for name in ("p", "u"):
            got = getattr(states[k], name)
            ref = getattr(plain_states[k], name)
            err = _rel_err(got, ref)
            print(json.dumps({"cross_check_step": k + 1, "field": name,
                              "max_rel_err": err, "tol": CROSS_TOL,
                              "cg_mechanics": [a.mech_cg_iterations,
                                               b.mech_cg_iterations]}),
                  flush=True)
            if not err <= CROSS_TOL:
                raise AssertionError(f"step {k + 1} {name}: kernel vs plain "
                                     f"rel err {err:.3e} > {CROSS_TOL}")


SLAB_SHAPES_N = (40, 7)
# slabs of a split (ranks of a group); 1 is the sharded path's own shape on
# one card (Lz = n+1 z-half layers, nv = n real cell layers)
SLAB_SPLITS = (1, 2, 4, 8)
SLAB_TIMED = tuple((N_MAIN, s, t) for s in (1, 4)
                   for t in (torch.float32, torch.float64))
# the slabs stitched vs the whole-grid apply, relative to max |whole|: only
# the sums of each slab's first z-half layer are split in two
STITCH_TOL = {torch.float64: 1e-12, torch.float32: 2e-7}
N_SHARDED_EVOLVING, N_SHARDED_STEADY = 2, 1


def slab_kernel_phase(dev, d) -> dict:
    """K5's slab form (``elasticity_rows_apply(..., nz=Lz, nv=nv)``) on
    every slab of 1-, 2-, 4- and 8-way splits at n = 40 and 7, float64 and
    float32: against its plain twin at the kernel phase's tolerances and
    bitwise repeatable, on inputs with random data in every row past the
    slab's real layers (which its masked cells must not read), and the
    slabs stitched as the sharded kit adds them against the whole-grid
    UNMASKED apply.  The 1-way split (the shape the sharded path launches
    on one card) and the 4-way split at 40^3 are timed slab by slab in both
    types beside their bound and library yardstick (one CSR SpMV of the
    slab's operator, ``apply_bench.library_csr(nz=, nv=)``).  Returns the
    timed records of slab 0 (the most real layers) by (split, type name).
    ``d``: the discretization whose element matrix the slabs multiply."""
    ke_np = d.element_ke
    nnz = {"ke": nonzeros(ke_np), "ce": nonzeros(d.element_ce),
           "pe": nonzeros(d.element_pe)}
    timed = {}
    for n in SLAB_SHAPES_N:
        rng = np.random.default_rng(n)
        u = rng.standard_normal((2 * n + 1) ** 3 * 3)
        W = cm._width(n)
        for dtype in (torch.float64, torch.float32):
            K = torch.as_tensor(ke_np, dtype=dtype, device=dev)
            xg = cm.to_rows(torch.as_tensor(u, dtype=dtype, device=dev), n)
            whole = cm.elasticity_rows_apply(xg, None, K, n, cm.UNMASKED)
            for n_dev in SLAB_SPLITS:
                Lz = pr.slab_layers(n, n_dev)
                L = Lz * 24
                full = torch.zeros(((n_dev * Lz + 1) * 24, W), dtype=dtype,
                                   device=dev)
                full[:xg.shape[0]] = xg
                stitched = torch.zeros_like(full)
                errs = []
                for r in range(n_dev):
                    nv = pr.real_layers(n, n_dev, r)
                    x = full[r * L:r * L + L + 24].clone()
                    x[(nv + 1) * 24:] = torch.as_tensor(rng.standard_normal(
                        tuple(x[(nv + 1) * 24:].shape)), dtype=dtype,
                        device=dev)
                    kern = lambda: cm.elasticity_rows_apply(  # noqa: E731
                        x, None, K, n, cm.UNMASKED, nz=Lz, nv=nv)
                    plain = lambda: cm.elasticity_rows_apply_plain(  # noqa
                        x, None, K, n, cm.UNMASKED, nz=Lz, nv=nv)
                    y1, y2, ref = kern(), kern(), plain()
                    torch.cuda.synchronize()
                    err = _rel_err(y1, ref)
                    errs.append(err)
                    if not err <= TOL[dtype]:
                        raise AssertionError(
                            f"slab {r}/{n_dev} n={n} {dtype}: rel err "
                            f"{err:.3e} vs plain twin > {TOL[dtype]:.0e}")
                    if not torch.equal(y1, y2):
                        raise AssertionError(f"slab {r}/{n_dev} n={n} "
                                             f"{dtype}: repeat runs differ")
                    stitched[r * L:r * L + L + 24] += y1
                    if (n, n_dev, dtype) in SLAB_TIMED:
                        rec = slab_timing(n, dtype, n_dev, Lz, nv, r, x, K,
                                          kern, plain, y1, ref, nnz)
                        if r == 0:
                            timed[(n_dev, rec["dtype"])] = rec
                serr = _rel_err(stitched[:xg.shape[0]], whole)
                rec = {"slab_split": n_dev, "n": n, "Lz": Lz,
                       "dtype": str(dtype).split(".")[-1],
                       "nv": [pr.real_layers(n, n_dev, r)
                              for r in range(n_dev)],
                       "max_rel_err_vs_twin": max(errs),
                       "stitched_rel_err_vs_whole": serr,
                       "tol": STITCH_TOL[dtype]}
                print(json.dumps(rec), flush=True)
                if not serr <= STITCH_TOL[dtype]:
                    raise AssertionError(f"{n_dev} slabs stitched, n={n} "
                                         f"{dtype}: rel err {serr:.3e} vs "
                                         "the whole-grid apply")
                if stitched[xg.shape[0]:].any():
                    raise AssertionError("slab output past the grid's rows")
    return timed


def slab_timing(n, dtype, n_dev, Lz, nv, d, x, K, kern, plain, y, ref,
                nnz) -> dict:
    """Device ms of one slab's kernel and twin, its bound, and its library
    yardstick (assembled in float64 on the card, run in ``dtype``)."""
    rec = {"name": "elasticity_rows_apply[slab]", "slab_split": n_dev,
           "slab": d, "n": n, "Lz": Lz, "nv": nv,
           "dtype": str(dtype).split(".")[-1],
           "max_abs_err": (y - ref).abs().max().item(),
           "max_rel_err": _rel_err(y, ref)}
    rec["ms"], rec["host_ms"] = device_and_host_ms(kern)
    rec["plain_ms"] = cuda_time_ms(plain)
    rec["bound_ms"], rec["bound_by"] = bound(
        "elasticity_rows_apply[slab]", n, dtype, nnz, nz=Lz, nv=nv)
    M64 = apply_bench.library_csr("elasticity_rows_apply[unmasked]", n,
                                  K.double(), None, None, None, nz=Lz, nv=nv)
    M = torch.sparse_csr_tensor(M64.crow_indices(), M64.col_indices(),
                                M64.values().to(dtype), M64.shape)
    rec["library_ms"], yl = apply_bench.spmv_ms(M, x)
    rec["library_nnz"] = M64._nnz()
    rec["library_rel_err_vs_kernel"] = _rel_err(yl.view_as(y), y)
    del M, M64, yl
    torch.cuda.empty_cache()
    print(json.dumps(rec), flush=True)
    if nv > 0 and not rec["library_rel_err_vs_kernel"] <= TOL[torch.float32]:
        raise AssertionError(f"slab {d}: CSR SpMV vs kernel rel err "
                             f"{rec['library_rel_err_vs_kernel']:.3e}")
    return rec


FLAT_SLAB_TIMED = 4          # the flat slab mode's timed split at 40^3


def flat_slab_kernel_phase(dev, d) -> dict:
    """K6's slab mode (``elasticity_grid_apply(..., nz=)``, the gspmd
    elasticity slabs) on every slab of 1-, 2-, 4- and 8-way splits of the
    node planes at n = 40 and 7, float64 and float32, each slab's sub-grid
    the one :class:`..parallel.sharding.SlabStencil` gives its rank:
    against its plain twin at the kernel phase's tolerances and bitwise
    repeatable, and the slabs' owned planes stitched bitwise equal to the
    whole-grid K6.  Slab 0 of the 4-way split at 40^3 is timed in both
    types beside its bound and its library yardstick (one CSR SpMV of the
    slab's operator).  Returns the timed records by type name."""
    nnz = {"ke": nonzeros(d.element_ke), "ce": nonzeros(d.element_ce),
           "pe": nonzeros(d.element_pe)}
    timed = {}
    for n in SLAB_SHAPES_N:
        rng = np.random.default_rng(n)
        g = 2 * n + 1
        u = rng.standard_normal(g ** 3 * 3)
        for dtype in (torch.float64, torch.float32):
            spec = eg.make_grid_elasticity(d.element_ke, n, dtype, dev).spec
            K = torch.as_tensor(d.element_ke, dtype=dtype, device=dev)
            uf = torch.as_tensor(u, dtype=dtype, device=dev)
            whole = eg.elasticity_grid_apply(uf, K, n).reshape(g, g, g, 3)
            X = uf.reshape(g, g, g, 3)
            for n_dev in SLAB_SPLITS:
                stitched = torch.full_like(whole, float("nan"))
                errs = []
                for r in range(n_dev):
                    st = SlabStencil(spec, SlabGroup(r, n_dev, None, dev),
                                     "elasticity")
                    if st.sub is None:
                        continue
                    nz = (st.n_in - 1) // 2
                    xs = X[st.in0:st.in0 + st.n_in].reshape(-1).clone()
                    kern = lambda: st.sub(xs)  # noqa: E731
                    plain = lambda: eg.elasticity_grid_apply_plain(  # noqa
                        xs, K, n, nz)
                    y1, y2, ref = kern(), kern(), plain()
                    torch.cuda.synchronize()
                    err = _rel_err(y1, ref)
                    errs.append(err)
                    if not err <= TOL[dtype]:
                        raise AssertionError(
                            f"flat slab {r}/{n_dev} n={n} {dtype}: rel err "
                            f"{err:.3e} vs plain twin > {TOL[dtype]:.0e}")
                    if not torch.equal(y1, y2):
                        raise AssertionError(f"flat slab {r}/{n_dev} n={n} "
                                             f"{dtype}: repeat runs differ")
                    stitched[st.Z0:st.Z1] = y1.reshape(-1, g, g, 3)[
                        st.out0:st.out0 + st.Z1 - st.Z0]
                    if (n, n_dev, r) == (N_MAIN, FLAT_SLAB_TIMED, 0):
                        timed[str(dtype).split(".")[-1]] = flat_slab_timing(
                            n, nz, dtype, xs, K, kern, plain, y1, ref, nnz)
                bitwise = torch.equal(stitched, whole)
                rec = {"flat_slab_split": n_dev, "n": n,
                       "dtype": str(dtype).split(".")[-1],
                       "max_rel_err_vs_twin": max(errs),
                       "stitched_bitwise_vs_whole": bitwise}
                print(json.dumps(rec), flush=True)
                if not bitwise:
                    raise AssertionError(f"{n_dev} flat slabs stitched, "
                                         f"n={n} {dtype}: not the whole-grid "
                                         "K6 bit for bit")
    return timed


def flat_slab_timing(n, nz, dtype, x, K, kern, plain, y, ref, nnz) -> dict:
    """Device ms of one flat slab's kernel and twin, its bound, and its
    library yardstick (assembled in float64 on the card, run in
    ``dtype``)."""
    rec = {"name": "elasticity_grid_apply[slab]",
           "slab_split": FLAT_SLAB_TIMED, "slab": 0, "n": n, "nz": nz,
           "dtype": str(dtype).split(".")[-1],
           "max_abs_err": (y - ref).abs().max().item(),
           "max_rel_err": _rel_err(y, ref)}
    rec["ms"], rec["host_ms"] = device_and_host_ms(kern)
    rec["plain_ms"] = cuda_time_ms(plain)
    rec["bound_ms"], rec["bound_by"] = bound(
        "elasticity_grid_apply[slab]", n, dtype, nnz, nz=nz, nv=nz)
    M64 = apply_bench.library_csr("elasticity_grid_apply", n, K.double(),
                                  None, None, None, nz=nz)
    M = torch.sparse_csr_tensor(M64.crow_indices(), M64.col_indices(),
                                M64.values().to(dtype), M64.shape)
    rec["library_ms"], yl = apply_bench.spmv_ms(M, x)
    rec["library_nnz"] = M64._nnz()
    rec["library_rel_err_vs_kernel"] = _rel_err(yl.view_as(y), y)
    del M, M64, yl
    torch.cuda.empty_cache()
    print(json.dumps(rec), flush=True)
    if not rec["library_rel_err_vs_kernel"] <= TOL[torch.float32]:
        raise AssertionError(f"flat slab: CSR SpMV vs kernel rel err "
                             f"{rec['library_rel_err_vs_kernel']:.3e}")
    return rec


@contextlib.contextmanager
def world_of_one():
    """A world-size-1 NCCL process group on card 0 (one card: NCCL
    refuses two ranks on one GPU), destroyed at the end."""
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def device_busy(fn) -> tuple:
    """``(fn(), busy ms)``: ``fn`` under ``torch.profiler`` with the
    device's activity only (the union of its kernel and copy intervals;
    no host events, whose processing takes seconds for an eager step; no
    user annotations, the program's spans)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
    cuda = torch.autograd.DeviceType.CUDA
    return out, profile_step._busy_ms(
        [(e.time_range.start, e.time_range.end) for e in prof.events()
         if e.device_type == cuda and not e.is_user_annotation])


def phase_record(tag, t0, ms, solver, state, bc_prev) -> dict:
    """A sharded phase's line: its wall seconds since ``t0``, its steps'
    ms, and one more steady step under the profiler (device busy and idle
    share, :func:`device_busy`)."""
    wall = time.perf_counter() - t0
    (_, _, pms), busy = device_busy(
        lambda: profile_step._step(solver, state, bc_prev, bc_prev))
    rec = {f"{tag}_phase": {
        "wall_s": wall, "step_ms": ms, "profiled_steady_ms": pms,
        "busy_ms": busy, "busy_share": busy / pms,
        "idle_share": 1.0 - busy / pms,
        "gpu": torch.cuda.get_device_name()}}
    print(json.dumps(rec), flush=True)
    return rec


def _last_scale(n_evolving) -> float:
    return 1.0 + BC_RATE * n_evolving


def gspmd_phase(dev) -> int:
    """The gspmd form of the conv backend at 40^3 float32 (1,663,244 DOF,
    ``multigrid="off"``) on a world-size-1 NCCL group: 2 evolving + 1
    steady steps, every stencil on its node-plane slab and gathered, the
    elasticity slab K6's slab mode, the fused pressure Jacobian through the
    hook; held bit for bit against an eager unsharded conv run of the same
    steps; K6's slab mode launched at least once per mechanics CG
    iteration.  Returns its slab launches."""
    data = bench_data()
    t0 = time.perf_counter()
    disc = build_grid_discretization(data, cells_per_axis=N_MAIN,
                                     multigrid="off",
                                     elasticity_backend="conv", device=dev)
    ref = run_steps(FixedStressSolver(disc, data, cuda_graphs=False),
                    N_CONV_EVOLVING, N_CONV_STEADY, log=False)
    with world_of_one():
        t1 = time.perf_counter()
        sdisc = shard_grid_discretization(disc, make_slab_group(dev))
        solver = FixedStressSolver(sdisc, data)
        if solver.graphs is not None or sdisc.row_ops is not None:
            raise AssertionError("gspmd: graphs captured or a rows kit")
        cm.reset_launch_counts()
        SlabStencil.calls.clear()
        states, stats, ms = run_steps(solver, N_CONV_EVOLVING, N_CONV_STEADY,
                                      log=True)
        torch.cuda.synchronize()
        slab = cm.launch_counts()["grid_slab"]
        whole = cm.launch_counts()["elasticity_grid_apply"] - slab
        calls = dict(SlabStencil.calls)
        phase_record("gspmd", t1, ms, solver, states[-1],
                     _last_scale(N_CONV_EVOLVING))
        held_to_plain("gspmd", lambda: FixedStressSolver(sdisc, data))
    check_steps(states, stats, sdisc, N_CONV_EVOLVING)
    mech = sum(s.mech_cg_iterations for s in stats)
    rec = {"gspmd": {"setup_and_reference_s": t1 - t0,
                     "flat_slab_launches": slab, "whole_grid_launches": whole,
                     "mech_cg_iterations": mech, "slab_stencil_calls": calls,
                     "bitwise_vs_unsharded": [
                         torch.equal(a.p, b.p) and torch.equal(a.u, b.u)
                         for a, b in zip(states, ref[0])],
                     "counts": [_counts(s) for s in stats],
                     "reference_counts": [_counts(s) for s in ref[1]],
                     "reference_ms": ref[2]}}
    print(json.dumps(rec), flush=True)
    r = rec["gspmd"]
    if not all(r["bitwise_vs_unsharded"]) or r["counts"] != \
            r["reference_counts"]:
        raise AssertionError(f"gspmd vs the unsharded conv run: {r}")
    if slab < mech or whole:
        raise AssertionError(f"gspmd: K6 slab launches {slab} for {mech} "
                             f"mechanics CG iterations, whole-grid {whole}")
    if not calls.get("jacobian") or set(calls) != {
            "mass", "laplace", "elasticity", "coupling", "projection",
            "jacobian"}:
        raise AssertionError(f"gspmd: wrapped stencils {calls}")
    return slab


def sharded_path_phase(dev, rows_states, rows_stats, rows_ms,
                       slab_shape) -> int:
    """The bench configuration at 40^3 float32 through
    ``shard_production_discretization`` on a world-size-1 NCCL process
    group (initialised here, destroyed at the end): 2 evolving + 1 steady
    steps, every mechanics apply the slab form (nz = 41 cell layers, nv =
    40 real), the masks outside the kernel; the two evolving steps held
    against the main path's (equal FSS and pressure counts, p and u within
    CROSS_TOL of their max).  ``slab_shape``: the (Lz, nv) at which
    ``slab_kernel_phase`` held and timed the kernel; the path's must be the
    same.  Since the pressure stencils and the fused Jacobian run on gspmd
    slabs (``shard_grid_discretization`` under the slab kit), each of them
    must run too.  Returns the slab form's launches in the steps."""
    data = bench_data()
    with world_of_one():
        t0 = time.perf_counter()
        disc = build_grid_discretization(data, cells_per_axis=N_MAIN,
                                         multigrid="off", device=dev)
        group = make_slab_group(dev)
        sdisc = pr.shard_production_discretization(disc, group)
        solver = FixedStressSolver(sdisc, data)
        torch.cuda.synchronize()
        print(f"sharded path setup: {time.perf_counter() - t0:.2f} s, "
              f"{group.size} rank(s), slab Lz={sdisc.row_ops.Lz} "
              f"nv={sdisc.row_ops.nv}", flush=True)
        if (sdisc.row_ops.Lz, sdisc.row_ops.nv) != tuple(slab_shape):
            raise AssertionError(f"sharded path slab (Lz, nv) != the "
                                 f"checked shape {slab_shape}")
        cm.reset_launch_counts()
        SlabStencil.calls.clear()
        t0 = time.perf_counter()
        states, stats, ms = run_steps(solver, N_SHARDED_EVOLVING,
                                      N_SHARDED_STEADY, log=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        slab = cm.launch_counts()["slab"]
        modes = mode_launches()
        calls = dict(SlabStencil.calls)
        phase_record("sharded", t0, ms, solver, states[-1],
                     _last_scale(N_SHARDED_EVOLVING))
        held_to_plain("sharded", lambda: FixedStressSolver(sdisc, data))
    print(f"sharded path: initial_state + {N_SHARDED_EVOLVING} evolving + "
          f"{N_SHARDED_STEADY} steady steps in {wall:.2f} s, launches "
          f"{launches}, slab form {slab}, whole-grid modes {modes}, gspmd "
          f"pressure stencils {calls}", flush=True)
    check_steps(states, stats, sdisc, N_SHARDED_EVOLVING)
    if not all(calls.get(k) for k in ("mass", "laplace", "jacobian")):
        raise AssertionError(f"sharded path: the pressure stencils did not "
                             f"run on gspmd slabs: {calls}")
    if slab <= 0 or launches["coupling_rows"] <= 0 or \
            launches["projection_rows"] <= 0:
        raise AssertionError("sharded path: a kernel of the path never "
                             "launched")
    if any(modes.values()):
        raise AssertionError(f"sharded path ran whole-grid applies: {modes}")
    for k in range(N_SHARDED_EVOLVING):
        a, b = stats[k], rows_stats[k]
        rec = {"sharded_vs_rows_step": k + 1,
               "fss": [a.fss_iterations, b.fss_iterations],
               "pressure": [a.pressure_iterations, b.pressure_iterations],
               "cg_mechanics": [a.mech_cg_iterations, b.mech_cg_iterations],
               "ms": [ms[k], rows_ms[k]]}
        for name in ("p", "u"):
            rec[f"{name}_max_rel_err"] = _rel_err(getattr(states[k], name),
                                                  getattr(rows_states[k],
                                                          name))
        print(json.dumps(rec), flush=True)
        if rec["fss"][0] != rec["fss"][1] or \
                rec["pressure"][0] != rec["pressure"][1]:
            raise AssertionError(f"sharded step {k + 1}: fss/pressure "
                                 f"{rec['fss']} {rec['pressure']}")
        for name in ("p", "u"):
            if not rec[f"{name}_max_rel_err"] <= CROSS_TOL:
                raise AssertionError(f"sharded step {k + 1} {name}: rel err "
                                     f"{rec[f'{name}_max_rel_err']:.3e}")
    return slab


def flat_apply_phase(dev) -> dict:
    """tools/apply_bench at 40^3 float32: the flat kernel through both its
    entry points against the conv backend's plain stencil, and times."""
    rec = apply_bench.run(N_MAIN, torch.float32, dev)
    print(json.dumps({"flat_apply": rec}), flush=True)
    for entry, count in rec["launches"].items():
        if count <= 0:
            raise AssertionError(f"flat kernel never launched through "
                                 f"{entry}")
    for entry, err in rec["rel_err_vs_conv"].items():
        if not err <= TOL[torch.float32]:
            raise AssertionError(f"flat kernel via {entry} vs the conv "
                                 f"plain stencil: rel err {err:.3e}")
    if not rec["bitwise_repeat"]:
        raise AssertionError("flat kernel: repeat runs differ")
    return rec


def conv_phase(dev, rows_states) -> tuple:
    """The conv backend (flat vectors; its elasticity apply is the flat
    kernel) at 40^3 float32: 2 evolving + 1 steady steps, the flat kernel
    launched at least once per mechanics CG iteration; step 1 against a
    conv run on the plain stencil (``kernels="plain"``: equal FSS and
    pressure counts) and against the rows path.  Returns the flat kernel's
    launches in the steps and the state after step 1."""
    data = bench_data()
    t0 = time.perf_counter()
    disc = build_grid_discretization(data, cells_per_axis=N_MAIN,
                                     multigrid="off",
                                     elasticity_backend="conv", device=dev)
    solver = FixedStressSolver(disc, data)
    torch.cuda.synchronize()
    print(f"conv backend setup: {time.perf_counter() - t0:.2f} s", flush=True)
    cm.reset_launch_counts()
    t0 = time.perf_counter()
    states, stats, _ = run_steps(solver, N_CONV_EVOLVING, N_CONV_STEADY,
                                 log=True)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"conv backend: initial_state + {N_CONV_EVOLVING} evolving + "
          f"{N_CONV_STEADY} steady steps in {time.perf_counter() - t0:.2f} "
          f"s, launches {launches}, graphs captured "
          f"{dict(solver.graphs.captures)} replayed "
          f"{dict(solver.graphs.replays)}", flush=True)
    check_steps(states, stats, disc, N_CONV_EVOLVING)
    captured_vs_eager("conv", solver, disc, data)
    held_to_plain("conv", lambda: FixedStressSolver(disc, data))
    mech = sum(s.mech_cg_iterations for s in stats)
    if launches["elasticity_grid_apply"] < mech:
        raise AssertionError(f"conv backend: the flat kernel launched "
                             f"{launches['elasticity_grid_apply']} times for "
                             f"{mech} mechanics CG iterations")
    plain = build_grid_discretization(data, cells_per_axis=N_MAIN,
                                      multigrid="off",
                                      elasticity_backend="conv", device=dev,
                                      kernels="plain")
    plain_states, plain_stats, _ = run_steps(FixedStressSolver(plain, data),
                                             1, 0, log=False)
    a, b = stats[0], plain_stats[0]
    print(json.dumps({"conv_vs_plain_step": 1,
                      "fss": [a.fss_iterations, b.fss_iterations],
                      "pressure": [a.pressure_iterations,
                                   b.pressure_iterations],
                      "cg_mechanics": [a.mech_cg_iterations,
                                       b.mech_cg_iterations]}), flush=True)
    if (a.fss_iterations, a.pressure_iterations) != \
            (b.fss_iterations, b.pressure_iterations):
        raise AssertionError("conv step 1: kernel run fss/pressure "
                             f"{a.fss_iterations}/{a.pressure_iterations} != "
                             f"plain {b.fss_iterations}/"
                             f"{b.pressure_iterations}")
    for ref_name, ref in (("plain", plain_states[0]),
                          ("rows", rows_states[0])):
        for name in ("p", "u"):
            err = _rel_err(getattr(states[0], name), getattr(ref, name))
            print(json.dumps({f"conv_vs_{ref_name}_step": 1, "field": name,
                              "max_rel_err": err, "tol": CROSS_TOL}),
                  flush=True)
            if not err <= CROSS_TOL:
                raise AssertionError(f"step 1 {name}: conv vs {ref_name} "
                                     f"rel err {err:.3e} > {CROSS_TOL}")
    return launches["elasticity_grid_apply"], states[0]


def _run_log(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


CLI_BLOCKS = ("  set Steps per dispatch = 4\n  set Sync every = 2\n"
              "  set Output VTK = false\n")
CLI_CKPT = "  set Checkpoint every = 3\n  set Output VTK = false\n"
CLI_RESUME_STEP = 3


CLI_GHOST = ("  set Sharding = ghost\n  set Mechanics CG relative = true\n"
             "  set Mechanics CG tolerance = 1e-10\n")


def _cli(path: Path, cwd: Path, env: dict, *extra,
         launcher=()) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, *launcher, "-m", "poroelasticity_dealii_torch",
         "run", str(path), "--device", "cuda", *extra], cwd=cwd, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


# one rank through torchrun (NCCL on card 0)
TORCHRUN_ONE = ("-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "1")


def cli_ghost_check(ghost: list, single: list) -> None:
    """The 8^3 deck with ``Sharding = ghost`` (and a relative mechanics
    tolerance, :data:`CLI_GHOST`) under ``torchrun`` on one rank against
    the same deck on one process (a warning, then the unsharded generic
    discretization): per step FSS, pressure and pressure-CG counts
    equal, mechanics and projection CG within :data:`GHOST_CG_SLACK` a
    solve, ``pressure_error`` within :data:`CLI_PRESSURE_RTOL`."""
    for a, b in zip(ghost, single):
        ca, cb = a["cg_iterations"], b["cg_iterations"]
        fss = b["fss_iterations"]
        rec = {"cli_ghost_step": a["step"],
               "fss": [a["fss_iterations"], fss],
               "pressure": [a["pressure_iterations"],
                            b["pressure_iterations"]],
               "cg": [ca, cb], "counts_equal": [
                   a[k] == b[k] for k in ("fss_iterations",
                                          "pressure_iterations",
                                          "cg_iterations")],
               "pressure_error": [a["pressure_error"], b["pressure_error"]]}
        print(json.dumps(rec), flush=True)
        if a["fss_iterations"] != fss or a["pressure_iterations"] != \
                b["pressure_iterations"] or ca["pressure"] != cb["pressure"] \
                or abs(ca["mechanics"] - cb["mechanics"]) > \
                GHOST_CG_SLACK * fss or abs(
                    ca["projection"] - cb["projection"]) > \
                GHOST_CG_SLACK * (fss + 1) or not abs(
                    a["pressure_error"] - b["pressure_error"]) \
                <= CLI_PRESSURE_RTOL * abs(b["pressure_error"]):
            raise AssertionError(f"CLI ghost run differs: {rec}")
    if len(ghost) != len(single) or not ghost:
        raise AssertionError(f"CLI ghost run logged {len(ghost)} steps, "
                             f"the one-process run {len(single)}")


def _finish(runs: dict) -> None:
    """Wait for each CLI run of ``runs`` ({name: (cwd, process)}); fail on
    a non-zero exit; kill what is left on the way out."""
    try:
        for name, (cwd, proc) in runs.items():
            out, err = proc.communicate(timeout=600)
            sys.stdout.write(f"[cli {name}]\n{err[-2000:]}")
            if proc.returncode != 0:
                raise AssertionError(f"CLI run ({name}) failed "
                                     f"({proc.returncode}):\n{out}\n{err}")
    finally:
        for _, proc in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def cli_resume_and_profile(tmp: Path, env: dict, ckpt_deck: Path) -> None:
    """The 8^3 deck through the CLI twice more, at once: resumed with
    ``--resume`` from the checkpoint the ``ckpt`` run wrote at step
    :data:`CLI_RESUME_STEP` (its run log must repeat the ``ckpt`` run's
    later steps: counts exactly, ``pressure_error`` within
    :data:`CLI_PRESSURE_RTOL`), and with ``--profile`` (the trace must
    hold CUDA kernel events)."""
    ckpt = (tmp / "ckpt" / "checkpoints"
            / f"ckpt-{CLI_RESUME_STEP:06d}.npz")
    runs = {}
    for name, extra in (("resume", ("--resume", str(ckpt))),
                        ("profile", ("--profile", str(tmp / "trace")))):
        cwd = tmp / name
        cwd.mkdir()
        runs[name] = (cwd, _cli(ckpt_deck if name == "resume" else
                                REPO / "configs" / "consolidation_3d.data",
                                cwd, env, *extra))
    t0 = time.perf_counter()
    _finish(runs)
    full = _run_log(tmp / "ckpt" / "solution" / "run_log.jsonl")
    resumed = _run_log(tmp / "resume" / "solution" / "run_log.jsonl")
    key = lambda r: (r["step"], r["time"], r["fss_iterations"],  # noqa: E731
                     r["pressure_iterations"], r["cg_iterations"])
    want = full[CLI_RESUME_STEP:]
    same = [key(a) == key(b) and abs(a["pressure_error"]
                                     - b["pressure_error"])
            <= CLI_PRESSURE_RTOL * abs(a["pressure_error"])
            for a, b in zip(resumed, want)]
    trace = tmp / "trace" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    rec = {"cli_resume": {"steps": [r["step"] for r in resumed],
                          "equal_to_uninterrupted": same},
           "cli_profile": {"trace_bytes": trace.stat().st_size,
                           "events": len(events), "kernel_events": kernels},
           "seconds": time.perf_counter() - t0}
    print(json.dumps(rec), flush=True)
    if len(resumed) != len(want) or not want or not all(same):
        raise AssertionError(f"CLI --resume run differs: {rec}")
    if kernels == 0:
        raise AssertionError(f"CLI --profile trace has no CUDA kernel "
                             f"events: {rec}")


def cli_phase():
    """The CLI on the 3D deck as written (8^3, float64, 6 steps), on a copy
    with ``Elasticity backend = conv``, on a copy with blocks of 4 steps
    and a sync every 2 (:data:`CLI_BLOCKS`; no VTK output, which would
    read every step's state and so cut every block to one step), on a copy
    with a checkpoint every 3 steps (:data:`CLI_CKPT`), on a copy with
    ``Sharding = ghost`` under ``torchrun`` on one rank and on one process
    (:func:`cli_ghost_check`), and on the golden
    2D deck (:func:`golden_check`), all at once; the conv run log
    must agree with the rows one in FSS counts and pressure_error, the
    blocks run log in its steps, times and counts; then the resume from
    the checkpoint and a profiled run (:func:`cli_resume_and_profile`)."""
    deck = REPO / "configs" / "consolidation_3d.data"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory() as tmp:
        conv_deck = Path(tmp) / "consolidation_3d_conv.data"
        conv_deck.write_text(deck.read_text() + "\nsubsection TPU\n"
                             "  set Elasticity backend = conv\nend\n")
        blocks_deck = Path(tmp) / "consolidation_3d_blocks.data"
        blocks_deck.write_text(deck.read_text() + "\nsubsection TPU\n"
                               + CLI_BLOCKS + "end\n")
        ckpt_deck = Path(tmp) / "consolidation_3d_ckpt.data"
        ckpt_deck.write_text(deck.read_text() + "\nsubsection TPU\n"
                             + CLI_CKPT + "end\n")
        ghost_deck = Path(tmp) / "consolidation_3d_ghost.data"
        ghost_deck.write_text(deck.read_text() + "\nsubsection TPU\n"
                              + CLI_GHOST + "end\n")
        # the gmsh deck names its mesh relative to the repository's root
        irregular_deck = Path(tmp) / IRREGULAR_DECK.name
        irregular_deck.write_text(IRREGULAR_DECK.read_text() + (
            "\nsubsection Mesh\n  set Mesh file = "
            f"{REPO / 'configs' / 'irregular_2d.msh'}\nend\n"))
        t0 = time.perf_counter()
        runs = {}
        for name, path in (("rows", deck), ("conv", conv_deck),
                           ("blocks", blocks_deck), ("ckpt", ckpt_deck),
                           ("golden_2d", GOLDEN_DECK),
                           ("irregular_2d", irregular_deck),
                           ("ghost", ghost_deck), ("ghost_one", ghost_deck)):
            cwd = Path(tmp) / name
            cwd.mkdir()
            runs[name] = (cwd, _cli(path, cwd, env, launcher=(
                TORCHRUN_ONE if name == "ghost" else ())))
        _finish(runs)
        logs = {}
        for name, (cwd, _) in runs.items():
            sol = cwd / "solution"
            vtks = sorted(sol.glob("solution-*.vtk"))
            log = sol / "run_log.jsonl"
            want = {"blocks": 0, "ckpt": 0, "golden_2d": 18,
                    "irregular_2d": 18}.get(name, 7)
            if len(vtks) != want or not log.exists():
                raise AssertionError(f"CLI output ({name}) incomplete: "
                                     f"{len(vtks)} VTK files, run log "
                                     f"{log.exists()}")
            logs[name] = _run_log(log)
            print(f"cli {name}: {len(vtks)} VTK files, "
                  f"{len(logs[name])} run-log records", flush=True)
        print(f"cli: the {len(runs)} runs in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        golden_check(Path(tmp) / "golden_2d")
        irregular_check(Path(tmp) / "irregular_2d")
        cli_ghost_check(logs["ghost"], logs["ghost_one"])
        cli_resume_and_profile(Path(tmp), env, ckpt_deck)
    rows, conv, blocks = logs["rows"], logs["conv"], logs["blocks"]
    key = lambda r: (r["step"], r["time"], r["fss_iterations"],  # noqa: E731
                     r["pressure_iterations"], r["cg_iterations"])
    for a, b in zip(rows, blocks):
        pa, pb = a["pressure_error"], b["pressure_error"]
        print(json.dumps({"cli_blocks_step": b["step"],
                          "counts_equal": key(a) == key(b),
                          "pressure_error": [pa, pb],
                          "wall_s": [a["wall_s"], b["wall_s"]]}), flush=True)
        if key(a) != key(b) or not abs(pa - pb) <= CLI_PRESSURE_RTOL * abs(pa):
            raise AssertionError(f"CLI blocks run differs at step "
                                 f"{a['step']}: {a} vs {b}")
    if len(blocks) != len(rows):
        raise AssertionError(f"CLI blocks run logged {len(blocks)} steps, "
                             f"the default run {len(rows)}")
    if [r["fss_iterations"] for r in rows] != \
            [r["fss_iterations"] for r in conv]:
        raise AssertionError("CLI conv vs rows: FSS counts differ")
    for a, b in zip(rows, conv):
        pa, pb = a["pressure_error"], b["pressure_error"]
        print(json.dumps({"cli_step": a["step"], "fss": a["fss_iterations"],
                          "pressure_error": [pa, pb],
                          "cg_mechanics": [a["cg_iterations"]["mechanics"],
                                           b["cg_iterations"]["mechanics"]]}),
              flush=True)
        if not abs(pa - pb) <= CLI_PRESSURE_RTOL * abs(pa):
            raise AssertionError(f"CLI step {a['step']}: pressure_error "
                                 f"rows {pa} vs conv {pb}")


# ---------------------------------------------------------------------------
# the 2D structured path: the golden deck, and the 512^2 at-scale point
# ---------------------------------------------------------------------------

N_2D = 512               # 512^2 cells: 1025^2*2 + 513^2 = 2,364,419 DOF
N_2D_EVOLVING, N_2D_STEADY = 2, 1
N_FLAT_EVOLVING = 2
PARITY_VS_FLAT_TOL = 1e-4   # parity vs flat GMG path: p, u rel to max |field|
GOLDEN_RTOL = 1e-6          # the pinned golden history's residuals
GOLDEN_DECK = REPO / "configs" / "golden_2d.data"
GOLDEN_HISTORY = REPO / "tests" / "data" / "golden_history.json"


def vtk_scalars(path: Path) -> tuple:
    """(number of points, {scalar name: values}) of a legacy ASCII VTK
    file written by the port."""
    lines = path.read_text().splitlines()
    n_pts = next(int(ln.split()[1]) for ln in lines
                 if ln.startswith("POINTS"))
    out = {}
    for i, ln in enumerate(lines):
        if ln.startswith("SCALARS"):
            out[ln.split()[1]] = np.array(
                [float(v) for v in lines[i + 2:i + 2 + n_pts]])
    return n_pts, out


def golden_check(cwd: Path) -> None:
    """The CLI's run of the golden 2D deck (16^2 cells, float64, 17 steps
    on the flat Jacobi-CG path) against ``tests/data/golden_history.json``:
    FSS and pressure counts exactly, ``pressure_error`` and the FSS error
    history to :data:`GOLDEN_RTOL`; 18 VTK files, the last with 289 points
    and ``sigma_yy`` != ``sigma_xx``."""
    log = _run_log(cwd / "solution" / "run_log.jsonl")
    ref = json.loads(GOLDEN_HISTORY.read_text())
    if len(log) != len(ref):
        raise AssertionError(f"golden run logged {len(log)} steps, the pin "
                             f"has {len(ref)}")
    worst = 0.0
    for a, b in zip(log, ref):
        hist = [x for x in a["fss_error_history"] if x >= 0]
        errs = [abs(a["pressure_error"] / b["pressure_error"] - 1.0)] + [
            abs(x / y - 1.0) for x, y in zip(hist, b["fss_error_history"])]
        worst = max(worst, *errs)
        if (a["fss_iterations"], a["pressure_iterations"], len(hist)) != (
                b["fss_iterations"], b["pressure_iterations"],
                len(b["fss_error_history"])) or not max(errs) <= GOLDEN_RTOL:
            raise AssertionError(f"golden step {a['step']}: {a} vs pin {b}")
    vtks = sorted((cwd / "solution").glob("solution-*.vtk"))
    n_pts, sc = vtk_scalars(vtks[-1])
    rec = {"golden_2d_cli": {
        "steps": len(log), "fss": [r["fss_iterations"] for r in log],
        "pressure": [r["pressure_iterations"] for r in log],
        "max_rel_err_vs_pin": worst, "rtol": GOLDEN_RTOL,
        "vtk_files": len(vtks), "points": n_pts,
        "sigma_yy_ne_sigma_xx": bool(np.any(sc["sigma_yy"]
                                            != sc["sigma_xx"]))}}
    print(json.dumps(rec), flush=True)
    if len(vtks) != len(ref) + 1 or n_pts != 289 or \
            not rec["golden_2d_cli"]["sigma_yy_ne_sigma_xx"]:
        raise AssertionError(f"golden run VTK output: {rec}")


def _graph_replays(solver) -> int:
    return sum(solver.graphs.replays.values()) if solver.graphs else 0


class SolveLog:
    """Every linear solve a solver runs, by call site: wraps the solver's
    ``_cg`` and ``_richardson`` and keeps each result (device tensors,
    read by :meth:`take`), and each Richardson solve's tolerance."""

    def __init__(self, solver):
        self.entries = []
        cg, rich = solver._cg, solver._richardson

        def cg_logged(site, *args, **kw):
            res = cg(site, *args, **kw)
            self.entries.append((site, res, None))
            return res

        def rich_logged(site, apply, b, x0, precond, tol, *args, **kw):
            res = rich(site, apply, b, x0, precond, tol, *args, **kw)
            self.entries.append((site, res, tol))
            return res

        solver._cg, solver._richardson = cg_logged, rich_logged

    def take(self) -> list:
        """[(site, iterations, all converged, any stalled, final residual
        over tolerance or None)] of the solves since the last call."""
        out = []
        for site, res, tol in self.entries:
            ratio = None if tol is None else (
                res.residual_norm.double() / tol.double()).item()
            out.append((site, int(res.iterations.max()),
                        bool(res.converged.all()),
                        bool(res.stalled.any()), ratio))
        self.entries.clear()
        return out


def check_solves_2d(k, solves, stats, data, tag="2D") -> dict:
    """Step ``k``'s solves: every pressure, projection and bc-response
    solve converged; every mechanics solve converged or stopped on
    Richardson's stagnation exit (the float32 attainable floor of the true
    residual, as in the reference), none at the ``cap``; the FSS loop
    converged.  Returns the mechanics solves' record."""
    cap, mech_tol = data.cg_max_iterations, data.mech_cg_tol
    mech = [x for x in solves if x[0].startswith("mechanics")]
    for site, it, ok, stalled, _ in solves:
        if site.startswith("mechanics"):
            if it >= cap or not (ok or stalled):
                raise AssertionError(f"{tag} step {k}: mechanics solve "
                                     f"{it} iterations, converged {ok}, "
                                     f"stalled {stalled}")
        elif not ok:
            raise AssertionError(f"{tag} step {k}: a {site} solve did not "
                                 "converge")
    if not stats.pressure_error <= float(np.float32(data.fss_tol)):
        raise AssertionError(f"{tag} step {k}: FSS residual "
                             f"{stats.pressure_error} above its tolerance")
    return {"iterations": [x[1] for x in mech],
            "converged": [x[2] for x in mech],
            "stalled": [x[3] for x in mech],
            # final true residual relative to |b| (tol = mech_tol * |b|)
            "rel_residual": [None if x[4] is None else x[4] * mech_tol
                             for x in mech]}


def run_steps_2d(solver, log, n_evolving, n_steady, tag="2d",
                 launches=None, mech_records=None):
    """:func:`run_steps` with every linear solve checked
    (:func:`check_solves_2d`), and the graph replays, the port's kernel
    launches and the mechanics solves of each step printed beside its
    counts; ``log``: the solver's :class:`SolveLog`; ``launches``: a dict
    the steps' kernel launches are added into; ``mech_records``: a list
    each step's mechanics solves are appended to."""
    data = solver.data
    dt = data.time_step
    state = solver.initial_state()
    log.take()
    states, stats_all, ms_all = [], [], []
    bc_prev = 1.0
    for k in range(1, n_evolving + n_steady + 1):
        bc = 1.0 + BC_RATE * min(k, n_evolving)
        replays0 = _graph_replays(solver)
        cm.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, stats = solver.time_step(state, dt, bc, bc_scale_prev=bc_prev,
                                        want_u=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        bc_prev = bc
        mech = check_solves_2d(k, log.take(), stats, data, tag)
        if mech_records is not None:
            mech_records.append(mech)
        print(json.dumps({
            f"{tag}_step": k,
            "kind": "evolving" if k <= n_evolving else "steady",
            "loop": "captured" if solver.graphs else "eager", "ms": ms,
            "fss": stats.fss_iterations,
            "pressure": stats.pressure_iterations,
            "cg_pressure": stats.pressure_cg_iterations,
            "cg_mechanics": stats.mech_cg_iterations,
            "cg_projection": stats.projection_cg_iterations,
            "pressure_error": stats.pressure_error,
            "cg_converged": stats.cg_converged,
            "cg_stalled": stats.cg_stalled, "mechanics_solves": mech,
            "graph_replays": _graph_replays(solver) - replays0,
            "kernel_launches": launch_counts()}), flush=True)
        if launches is not None:
            for name, v in launch_counts().items():
                launches[name] = launches.get(name, 0) + v
        if k <= n_evolving and stats.mech_cg_iterations <= 0:
            raise AssertionError(f"{tag} evolving step {k}: no mechanics "
                                 "work")
        check_state(state, solver.disc.n_pdofs, solver.disc.n_udofs,
                    3 if solver.disc.dim == 2 else 6)
        states.append(state)
        stats_all.append(stats)
        ms_all.append(ms)
    return states, stats_all, ms_all


def build_2d(dev, elasticity_backend=None):
    """``bench.py::build_2d``'s configuration at 512^2 float32 through the
    port's entry point, ``multigrid="auto"``, and the bc-response solve
    (run once, at set-up); returns (data, disc, solver, its
    :class:`SolveLog`, set-up record)."""
    data = data_2d()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    disc = build_grid_discretization(data, cells_per_axis=N_2D,
                                     multigrid="auto", device=dev,
                                     elasticity_backend=elasticity_backend)
    solver = FixedStressSolver(disc, data)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log = SolveLog(solver)
    t0 = time.perf_counter()
    solver._bc_response()
    torch.cuda.synchronize()
    bc_s = time.perf_counter() - t0
    (_, bc_it, bc_ok, _, _), = log.take()
    rec = {"n": N_2D, "dofs": disc.n_pdofs + disc.n_udofs,
           "mechanics": type(disc.row_ops).__name__ if disc.row_ops
           is not None else "flat",
           "setup_s": setup_s, "elasticity_gmg_build_s": disc.gmg_setup_s,
           "bc_response_s": bc_s, "bc_response_iterations": bc_it,
           "bc_response_converged": bc_ok}
    print(json.dumps({"2d_setup": rec}), flush=True)
    if not bc_ok:
        raise AssertionError(f"2D bc response did not converge: {rec}")
    return data, disc, solver, log, rec


def parity_apply_timing(disc, dev) -> dict:
    """Device ms of one unconstrained parity apply at 512^2 float32 beside
    its bound: read and write one parity vector, and 2*18*18 flop per
    cell (the (18, 18) element matrix times each cell's 18 values)."""
    ro = disc.row_ops
    rng = np.random.default_rng(2)
    x = ro.to_rows(torch.as_tensor(rng.standard_normal(disc.n_udofs),
                                   dtype=torch.float32, device=dev))
    fn = lambda: ro.apply_rows(x)  # noqa: E731
    ms, host_ms = device_and_host_ms(fn)
    nbytes = 2 * x.numel() * x.element_size()
    flop = 2 * 18 * 18 * N_2D * N_2D
    t_bytes, t_flop = nbytes / PEAK_BYTES, flop / PEAK_FLOPS[torch.float32]
    rec = {"parity_apply": {
        "n": N_2D, "dtype": "float32", "ms": ms, "host_ms": host_ms,
        "bytes": nbytes, "flop": flop,
        "bound_ms": max(t_bytes, t_flop) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_flop else "operations"}}
    print(json.dumps(rec), flush=True)
    return rec


def phase_2d(dev) -> tuple:
    """The 2D path at the at-scale point on the card: the parity kit with
    the parity-resident GMG (asserted selected), 2 evolving + 1 steady
    captured steps (every solve converged, no mechanics solve at the cap,
    mechanics work on the evolving steps, fields finite), the same steps
    eager (counts, p and u bit for bit), and the flat GMG-Richardson path
    (``elasticity_backend="conv"``) on the evolving steps against them
    (FSS and pressure counts equal, p and u within
    :data:`PARITY_VS_FLAT_TOL`); products at full float32 (TF32 off).
    Returns the captured parity run's states, stats and mechanics
    solves."""
    check_tf32_off()
    data, disc, solver, log, _ = build_2d(dev)
    if not isinstance(disc.row_ops, ElasticityParityOps) or \
            disc.gmg_precond_rows is None:
        raise AssertionError(f"512^2 'auto' did not select the parity kit "
                             f"with gmg_precond_rows: {type(disc.row_ops)}")
    mech = []
    run = run_steps_2d(solver, log, N_2D_EVOLVING, N_2D_STEADY,
                       mech_records=mech)
    states, stats, ms = run
    captured_vs_eager("2d", solver, disc, data, captured_run=run)
    parity_apply_timing(disc, dev)
    # SolveLog's wrappers hold the solver in a reference cycle: free its
    # graphs and buffers now
    del solver, disc, log
    gc.collect()
    torch.cuda.empty_cache()
    _, flat, fsolver, flog, flat_setup = build_2d(dev, "conv")
    if flat.row_ops is not None or flat.gmg_precond is None:
        raise AssertionError("the flat 512^2 path has no flat elasticity GMG")
    f_states, f_stats, f_ms = run_steps_2d(fsolver, flog, N_FLAT_EVOLVING, 0)
    for k in range(N_FLAT_EVOLVING):
        a, b = stats[k], f_stats[k]
        rec = {"2d_parity_vs_flat_step": k + 1,
               "fss": [a.fss_iterations, b.fss_iterations],
               "pressure": [a.pressure_iterations, b.pressure_iterations],
               "cg_mechanics": [a.mech_cg_iterations, b.mech_cg_iterations],
               "ms": [ms[k], f_ms[k]], "flat_setup_s": flat_setup["setup_s"],
               "tol": PARITY_VS_FLAT_TOL}
        for name in ("p", "u"):
            rec[f"{name}_max_rel_err"] = _rel_err(
                getattr(states[k], name), getattr(f_states[k], name))
        print(json.dumps(rec), flush=True)
        if (rec["fss"][0], rec["pressure"][0]) != (rec["fss"][1],
                                                   rec["pressure"][1]):
            raise AssertionError(f"2D step {k + 1}: parity vs flat counts "
                                 f"{rec}")
        for name in ("p", "u"):
            if not rec[f"{name}_max_rel_err"] <= PARITY_VS_FLAT_TOL:
                raise AssertionError(f"2D step {k + 1} {name}: parity vs "
                                     f"flat rel err "
                                     f"{rec[f'{name}_max_rel_err']:.3e}")
    return states, stats, mech


def production_2d_phase(dev, ref_states, ref_stats, ref_mech) -> None:
    """The 2D production form at 512^2 float32 (2,364,419 DOF,
    ``build_2d``'s configuration) on a world-size-1 NCCL group: the y-slab
    parity kit with the parity V-cycle on gathered slabs, the pressure
    stencils on gspmd slabs, 2 evolving + 1 steady steps (every solve
    checked as :func:`run_steps_2d` checks them), against the unsharded
    captured 512^2 run of :func:`phase_2d`: the same FSS and pressure
    counts, each mechanics solve on the same exit (converged or the
    stagnation exit, never the cap), p and u within :data:`CROSS_TOL` of
    their max."""
    data = data_2d()
    with world_of_one():
        t0 = time.perf_counter()
        disc = build_grid_discretization(data, cells_per_axis=N_2D,
                                         multigrid="auto", device=dev)
        sdisc = pr.shard_production_discretization(disc,
                                                   make_slab_group(dev))
        if not isinstance(sdisc.row_ops, pr.ShardedParityOps) or \
                sdisc.gmg_precond_rows is None:
            raise AssertionError("2D production: no y-slab parity kit with "
                                 "its V-cycle")
        solver = FixedStressSolver(sdisc, data)
        log = SolveLog(solver)
        mech = []
        states, stats, ms = run_steps_2d(solver, log, N_2D_EVOLVING,
                                         N_2D_STEADY, tag="2d_sharded",
                                         mech_records=mech)
        phase_record("2d_sharded", t0, ms, solver, states[-1],
                     _last_scale(N_2D_EVOLVING))
        comm = dataclasses.asdict(sdisc.row_ops.comm)
    print(json.dumps({"2d_sharded_comm": comm}), flush=True)
    for k in range(N_2D_EVOLVING + N_2D_STEADY):
        a, b = stats[k], ref_stats[k]
        exits = [list(zip(m["converged"], m["stalled"]))
                 for m in (mech[k], ref_mech[k])]
        rec = {"2d_sharded_vs_unsharded_step": k + 1,
               "fss": [a.fss_iterations, b.fss_iterations],
               "pressure": [a.pressure_iterations, b.pressure_iterations],
               "cg_mechanics": [a.mech_cg_iterations, b.mech_cg_iterations],
               "mechanics_exits": exits, "tol": CROSS_TOL}
        for name in ("p", "u"):
            rec[f"{name}_max_rel_err"] = _rel_err(
                getattr(states[k], name), getattr(ref_states[k], name))
        print(json.dumps(rec), flush=True)
        if rec["fss"][0] != rec["fss"][1] or \
                rec["pressure"][0] != rec["pressure"][1] or \
                exits[0] != exits[1]:
            raise AssertionError(f"2D production step {k + 1}: {rec}")
        for name in ("p", "u"):
            if not rec[f"{name}_max_rel_err"] <= CROSS_TOL:
                raise AssertionError(f"2D production step {k + 1} {name}: "
                                     f"rel err "
                                     f"{rec[f'{name}_max_rel_err']:.3e}")


# ---------------------------------------------------------------------------
# the generic path: gather / plan-scatter applies on distorted hex meshes and
# gmsh meshes
# ---------------------------------------------------------------------------

N_GENERIC_EVOLVING, N_GENERIC_STEADY = 2, 1
GENERIC_DOFS = 1_663_244    # 41^3 Q1 + 81^3 * 3 Q2 at 40^3
N_GENERIC_VS_ROWS = 20      # the undistorted grid the generic build is held
#                             against the rows path on
IRREGULAR_DECK = REPO / "configs" / "irregular_2d.data"
# JAX's FixedStressSolver on configs/irregular_2d.data (float64, 17 steps;
# the CPU, x64): (FSS iterations, pressure iterations, pressure_error, FSS
# error history) per step.  tests/test_torch_generic.py holds this pin
# against the JAX package.
IRREGULAR_2D_PIN = [
    (1, 5, 8.698673482778736e-09, [8.698673482778736e-09]),
    (1, 5, 6.232936354109095e-09, [6.232936354109095e-09]),
    (1, 5, 4.471967633366098e-09, [4.471967633366098e-09]),
    (1, 4, 8.289275858073124e-09, [8.289275858073124e-09]),
    (1, 4, 6.022660341779668e-09, [6.022660341779668e-09]),
    (1, 4, 4.377353279796897e-09, [4.377353279796897e-09]),
    (1, 3, 8.21137323800703e-09, [8.21137323800703e-09]),
    (1, 3, 5.783706953752702e-09, [5.783706953752702e-09]),
    (1, 3, 4.0741076127498734e-09, [4.0741076127498734e-09]),
    (1, 2, 7.405091739297545e-09, [7.405091739297545e-09]),
    (1, 2, 5.6474487556372756e-09, [5.6474487556372756e-09]),
    (1, 2, 4.307074565314081e-09, [4.307074565314081e-09]),
    (1, 1, 8.47539695119151e-09, [8.47539695119151e-09]),
    (1, 1, 5.190864222154098e-09, [5.190864222154098e-09]),
    (1, 0, 8.202847163273675e-09, [8.202847163273675e-09]),
    (1, 0, 8.202847163273675e-09, [8.202847163273675e-09]),
    (1, 0, 8.202847163273675e-09, [8.202847163273675e-09]),
]


# JAX's AMRSimulationRunner on the gmsh-rooted forests (float64, the CPU,
# x64): (n_cells, n_pdofs, FSS iterations, pressure iterations,
# pressure_error) per step, printed by scripts/torch_amr_pins.py.
# configs/irregular_2d.data with AMR on, levels 0 -> 2, refine every 2, 6
# steps:
AMR_IRREGULAR_2D_PIN = [
    (143, 168, 1, 5, 8.698673479713646e-09),
    (176, 209, 1, 5, 7.043066193626105e-09),
    (176, 209, 1, 5, 5.054590159431263e-09),
    (269, 318, 1, 4, 6.903839455127845e-09),
    (269, 318, 1, 4, 5.020981094965438e-09),
    (359, 421, 1, 3, 8.200451004633047e-09),
]
# configs/consolidation_3d.data on configs/irregular_3d.msh, AMR on,
# levels 0 -> 1, refine every 2, 4 steps:
AMR_IRREGULAR_3D_PIN = [
    (210, 336, 1, 8, 4.414570806792333e-09),
    (420, 674, 1, 7, 4.768118706684661e-09),
    (420, 674, 1, 6, 8.861476801574588e-09),
    (511, 798, 1, 6, 5.9957313305838765e-09),
]


def check_tf32_off() -> None:
    """Every float32 matmul (the 2D path's products, the generic cores'
    einsums) runs at full float32."""
    if torch.backends.cuda.matmul.allow_tf32 is not False or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 is on for float32 matmuls")


def generic_phase(dev) -> tuple:
    """The generic path at the at-scale point: the bench configuration on
    the distorted 40^3 hex mesh (``profile_step.generic_mesh``, 1,663,244
    DOF, float32) through ``build_discretization``, 2 evolving + 1 steady
    captured steps (every solve converged, fields finite, both generic
    kernels launched, their launches counted with the graph replays), the
    same steps eager (counts, p and u bit for bit); the six generic
    applies at 40^3 and the 3D path's batched Q1 calls on 6 lanes (the
    projection's mass CG, the pressure Jacobian: ``apply_bench.
    GENERIC_BATCHED``) (``apply_bench.generic_run``, float32 and float64:
    two applies bitwise equal, each kernel within :data:`GENERIC_TOL` of
    its twin, timed beside its twin, its bound, the twin's scatter share, the
    flat kernel K6 and its cuSPARSE yardstick); the generic build on the
    undistorted 20^3 grid against the rows path (:func:`generic_vs_rows`).
    TF32 off throughout.  Returns the discretization, the captured run's
    states and stats, the generic kernels' launches in that run and the
    applies' records by (apply, dtype)."""
    check_tf32_off()
    data = bench_data()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    disc = build_discretization(generic_mesh(N_MAIN), data, device=dev)
    solver = FixedStressSolver(disc, data)
    torch.cuda.synchronize()
    dofs = disc.n_pdofs + disc.n_udofs
    print(json.dumps({"generic_setup": {
        "n": N_MAIN, "cells": disc.n_cells, "dofs": dofs,
        "setup_s": time.perf_counter() - t0,
        "scatter_valence": [disc.plan_p.table.shape[1],
                            disc.plan_u.table.shape[1]]}}), flush=True)
    if dofs != GENERIC_DOFS or disc.row_ops is not None:
        raise AssertionError(f"generic 40^3 build: {dofs} DOF, row_ops "
                             f"{disc.row_ops}")
    cm.reset_launch_counts()
    run = run_steps(solver, N_GENERIC_EVOLVING, N_GENERIC_STEADY, log=True)
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items()
                if k in GENERIC_KERNEL_INFO}
    print(json.dumps({"generic_kernel_launches": launches}), flush=True)
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"generic path: a generic kernel was never "
                             f"launched: {launches}")
    print(json.dumps({"generic_graphs": {
        "captures": dict(solver.graphs.captures),
        "replays": dict(solver.graphs.replays)}}), flush=True)
    check_steps(run[0], run[1], disc, N_GENERIC_EVOLVING)
    captured_vs_eager("generic", solver, disc, data, captured_run=run)
    held_to_plain("generic", lambda: FixedStressSolver(disc, data))
    states, stats = run[0], run[1]
    del solver, run
    gc.collect()
    torch.cuda.empty_cache()
    records = {}
    for rec in apply_bench.generic_run(N_MAIN, dev):
        print(json.dumps({"generic_apply": rec}), flush=True)
        kernel = rec["kernel"]
        ok = rec["bitwise_repeat"] and rec["finite"]
        if kernel is not None:    # the kernel: its twin, its yardstick
            ok = ok and rec["launches"] == {kernel: 2} and \
                rec["max_rel_err"] <= GENERIC_TOL[getattr(torch,
                                                          rec["dtype"])] \
                and rec.get("library_rel_err_vs_kernel", 0.0) <= \
                TOL[torch.float32]
        if not ok:
            raise AssertionError(f"generic apply {rec['apply']} "
                                 f"({rec['dtype']}): {rec}")
        records[(rec["apply"], rec["dtype"])] = rec
    want = {(a, t) for a in (*apply_bench.GENERIC_APPLIES,
                             *apply_bench.GENERIC_BATCHED)
            for t in ("float32", "float64")}
    if set(records) != want:
        raise AssertionError(f"generic applies: records {sorted(records)}, "
                             f"expected {sorted(want)}")
    # each kernel call beside its bounds (the corner-offset design, the
    # stored-geometry design), its library call and its host enqueue
    print(json.dumps({"generic_kernel_times": [
        {k: rec.get(k) for k in ("apply", "dtype", "lanes", "kernel", "ms",
                                 "bound_ms", "bound_by", "stored_bound_ms",
                                 "library_ms", "plain_ms", "host_ms")}
        for rec in records.values() if rec["kernel"] is not None]}),
        flush=True)
    check_tf32_off()
    generic_vs_rows(dev, data)
    return disc, states, stats, launches, records


def generic_kernel_phase(dev) -> None:
    """The generic kernels against their plain twins on the small cases of
    ``apply_bench.GENERIC_CASES`` (distorted 2D and 3D grids, the gmsh hex
    mesh, bucketed AMR meshes with phantom cells, geometry on a cell axis
    of 1), in float64 and float32, and on a ghost window (rank 1 of a
    2-way split of the golden deck's 8 x 8 grid: window-local connectivity
    and plans over C + 2H values): every call within :data:`GENERIC_TOL`
    of max |twin|, finite, two calls bitwise equal."""
    t0 = time.perf_counter()
    worst, copies = {}, {}
    for case in apply_bench.GENERIC_CASES:
        d64 = apply_bench.generic_case(case)
        for dtype in (torch.float64, torch.float32):
            d = apply_bench.on_device(d64, dtype, dev)
            for label, kern, plain in apply_bench.generic_pairs(d):
                _generic_pair(f"{case} {label}", kern, plain, dtype, worst)
            # the device bytes each record copied to give TMA 16-byte rows
            copies[f"{case} {str(dtype).split('.')[-1]}"] = {
                "cells": d.n_cells,
                "q1": d.q1_operands.checked.copied_bytes,
                "elasticity": d.elasticity_operands.checked.copied_bytes}
    for dtype in (torch.float64, torch.float32):
        for label, kern, plain in apply_bench.ghost_window_pairs(dtype,
                                                                 dev):
            _generic_pair(label, kern, plain, dtype, worst)
    print(json.dumps({"generic_kernel_cases": {
        "cases": list(apply_bench.GENERIC_CASES) + ["ghost_window"],
        "worst_rel_err": worst, "staged_copy_bytes": copies,
        "tol": {str(k).split(".")[-1]: v for k, v in GENERIC_TOL.items()},
        "s": time.perf_counter() - t0}}), flush=True)


def _generic_pair(label, kern, plain, dtype, worst) -> None:
    """One kernel call against its twin (:func:`generic_kernel_phase`)."""
    y1, y2 = kern(), kern()
    ref = plain()
    torch.cuda.synchronize()
    err = _rel_err(y1, ref)
    tag = str(dtype).split(".")[-1]
    worst[tag] = max(worst.get(tag, 0.0), err)
    if not (err <= GENERIC_TOL[dtype] and torch.equal(y1, y2)
            and bool(torch.isfinite(y1).all())):
        raise AssertionError(f"generic kernel {label} ({tag}): rel err "
                             f"{err:.3e}, repeat bitwise "
                             f"{torch.equal(y1, y2)}")


def psum_phase(dev, disc, ref_states, ref_stats) -> None:
    """The psum form on the generic path at scale: the distorted 40^3 hex
    mesh (``profile_step.generic_mesh``, 1,663,244 DOF, float32) through
    ``shard_discretization`` on a world-size-1 NCCL group (the rank's
    chunk all 64,000 cells, one all-reduce per apply), 2 evolving + 1
    steady steps against the unsharded captured run of
    :func:`generic_phase` on ``disc`` (its discretization): counts equal,
    p and u bit for bit (the same kernels on the same cells; the
    all-reduce of one rank is exact)."""
    data = bench_data()
    with world_of_one():
        t0 = time.perf_counter()
        sdisc = shard_discretization(disc, make_slab_group(dev))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        del disc
        solver = FixedStressSolver(sdisc, data)
        if not isinstance(sdisc, ShardedDiscretization) or \
                solver.graphs is not None:
            raise AssertionError("psum: not sharded, or graphs captured")
        states, stats, ms = run_steps(solver, N_GENERIC_EVOLVING,
                                      N_GENERIC_STEADY, log=True)
        phase_record("psum", t0, ms, solver, states[-1],
                     _last_scale(N_GENERIC_EVOLVING))
        held_to_plain("psum", lambda: FixedStressSolver(sdisc, data))
    check_steps(states, stats, sdisc, N_GENERIC_EVOLVING)
    print(json.dumps({"psum_setup": {"shard_s": t1 - t0,
                                     "cells": list(sdisc.cells)}}),
          flush=True)
    for k in range(N_GENERIC_EVOLVING + N_GENERIC_STEADY):
        rec = {"psum_vs_generic_step": k + 1,
               "counts": [_counts(stats[k]), _counts(ref_stats[k])],
               "bitwise": torch.equal(states[k].p, ref_states[k].p)
               and torch.equal(states[k].u, ref_states[k].u),
               "tol": CROSS_TOL}
        for name in ("p", "u"):
            rec[f"{name}_max_rel_err"] = _rel_err(
                getattr(states[k], name), getattr(ref_states[k], name))
        print(json.dumps(rec), flush=True)
        if rec["counts"][0] != rec["counts"][1] or not rec["bitwise"]:
            raise AssertionError(f"psum step {k + 1}: {rec}")


GHOST_SPLITS = (1, 2, 4, 8)
GHOST_TIMED = 4            # the split whose rank 0 window apply is timed
GHOST_CG_SLACK = 2         # CG iterations a solve that the float32 dot order
#                            of the renumbered vectors may move


def _apply_args(name: str) -> tuple:
    """The extra arguments of window apply ``name``: the Biot coefficient
    of the coupling, the deck's pressure Jacobian coefficients."""
    if name == "pressure_operator":
        return apply_bench.pressure_coefficients(bench_data())
    return (apply_bench.BIOT,) if name == "coupling_rhs" else ()


def ghost_split_phase(dev, disc) -> None:
    """The ghost form's halo arithmetic at full size on one card: the
    distorted 40^3 generic discretization ``disc`` (1,663,244 DOF)
    renumbered first-touch, and for each split of :data:`GHOST_SPLITS`
    every rank's window-local mass, Laplace, pressure Jacobian,
    elasticity, coupling and projection apply computed in this process
    (``parallel/ghost.py::split_apply``: each window cut from the whole
    renumbered vector as the exchange would deliver it, the returns
    through the same code with an in-process transport, the chunks
    stitched), in float64 and float32, held against the unsharded generic
    apply (permuted) within :data:`TOL` of its max.  Prints each split's
    C, H, the halo values exchanged per apply against the vector's
    length, and for the :data:`GHOST_TIMED`-way split rank 0's window
    elasticity apply in ms (both types) beside the whole apply's."""
    t0 = time.perf_counter()
    renumbered = gh.renumber_discretization(disc)
    rd, order_p, order_u = renumbered
    torch.cuda.synchronize()
    renumber_s = time.perf_counter() - t0
    orders = {"p": torch.as_tensor(order_p, device=dev),
              "u": torch.as_tensor(order_u, device=dev)}
    rng = np.random.default_rng(0)
    xs = {"p": rng.standard_normal(rd.n_pdofs),
          "u": rng.standard_normal(rd.n_udofs)}
    whole = {torch.float32: disc,
             torch.float64: apply_bench._cast(disc, torch.float64)}
    for n_dev in GHOST_SPLITS:
        t1 = time.perf_counter()
        ranks32 = [gh.shard_renumbered(renumbered,
                                       SlabGroup(d, n_dev, None, dev))
                   for d in range(n_dev)]
        r0 = ranks32[0]
        rec = {"ghost_split": n_dev, "C_p": r0.C_p, "H_p": r0.H_p,
               "C_u": r0.C_u, "H_u": r0.H_u, "n_p": rd.n_pdofs,
               "n_u": rd.n_udofs, "build_s": time.perf_counter() - t1,
               "renumber_s": renumber_s, "tol": {}, "max_rel_err": {},
               "halo_values_per_apply": {}}
        for dtype in (torch.float64, torch.float32):
            tag = str(dtype).split(".")[-1]
            ranks = ranks32 if dtype == torch.float32 else \
                [apply_bench._cast(r, dtype) for r in ranks32]
            src = whole[dtype]
            rec["tol"][tag] = TOL[dtype]
            for name, (kin, kout) in gh.WINDOW_APPLIES.items():
                x = torch.as_tensor(xs[kin], dtype=dtype, device=dev)
                unp = torch.empty_like(x)
                unp[orders[kin]] = x        # x in the source numbering
                ref = getattr(src, name)(unp, *_apply_args(name))
                ref = ref[..., orders[kout]]
                got, values = gh.split_apply(ranks, name, x,
                                             *_apply_args(name))
                rec["max_rel_err"][f"{name}_{tag}"] = _rel_err(got, ref)
                rec["halo_values_per_apply"][name] = values
                if not rec["max_rel_err"][f"{name}_{tag}"] <= TOL[dtype]:
                    raise AssertionError(f"ghost {n_dev}-way {name} "
                                         f"({tag}): {rec}")
            if n_dev == GHOST_TIMED:
                x = torch.as_tensor(xs["u"], dtype=dtype, device=dev)
                win = gh.halo_window(
                    torch.nn.functional.pad(x, (0, n_dev * r0.C_u
                                                - x.shape[0]))
                    .reshape(n_dev, r0.C_u), r0.C_u, r0.H_u,
                    gh.StackedShift())[0].contiguous()
                rec[f"rank0_window_elasticity_ms_{tag}"] = \
                    apply_bench.cuda_time_ms(
                        lambda: ranks[0].window_apply("elasticity", win))
                rec[f"whole_elasticity_ms_{tag}"] = apply_bench.cuda_time_ms(
                    lambda: src.elasticity(x))
                rec["rank0_cells"] = list(r0.cells)
            del ranks
        rec["gpu"] = torch.cuda.get_device_name()
        print(json.dumps(rec), flush=True)
        del ranks32
    del whole
    gc.collect()
    torch.cuda.empty_cache()


def _ghost_counts_agree(a, b) -> bool:
    """Step stats ``a`` (ghost) and ``b`` (the generic run): FSS and
    pressure counts equal, each CG count within :data:`GHOST_CG_SLACK`
    iterations a solve (mechanics one per FSS iteration, pressure one per
    pressure iteration, projection one per FSS iteration plus the shear
    one)."""
    solves = {"pressure_cg_iterations": b.pressure_iterations,
              "mech_cg_iterations": b.fss_iterations,
              "projection_cg_iterations": b.fss_iterations + 1}
    return (a.fss_iterations == b.fss_iterations
            and a.pressure_iterations == b.pressure_iterations
            and all(abs(getattr(a, k) - getattr(b, k))
                    <= GHOST_CG_SLACK * n for k, n in solves.items()))


def ghost_phase(dev, disc, ref_states, ref_stats) -> None:
    """The ghost form through its entry points: the distorted 40^3 generic
    discretization ``disc`` through ``shard_discretization_ghost`` on a
    world-size-1 NCCL group (H = 0: the renumbering, the chunked state,
    the solver on sharded vectors and its all-reduces), 2 evolving + 1
    steady eager steps: every solve converged and every field finite;
    against :func:`generic_phase`'s captured run mapped through
    ``order_p`` / ``order_udof`` (:func:`_ghost_counts_agree`, p and u
    within :data:`CROSS_TOL` of their max); its phase record, the
    collectives a step (``kit.comm``) and the shard set-up seconds."""
    data = bench_data()
    with world_of_one():
        t0 = time.perf_counter()
        sdisc = gh.shard_discretization_ghost(disc, make_slab_group(dev))
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        solver = FixedStressSolver(sdisc, data)
        if solver.graphs is not None or sdisc.H_p or sdisc.H_u:
            raise AssertionError("ghost: graphs captured, or a halo at "
                                 "world size 1")
        sdisc.kit.comm.reset()
        states, stats, ms = run_steps(solver, N_GENERIC_EVOLVING,
                                      N_GENERIC_STEADY, log=True)
        comm = dataclasses.asdict(sdisc.kit.comm)
        phase_record("ghost", t0, ms, solver, states[-1],
                     _last_scale(N_GENERIC_EVOLVING))
        held_to_plain("ghost", lambda: FixedStressSolver(sdisc, data))
    check_steps(states, stats, sdisc, N_GENERIC_EVOLVING)
    n_steps = N_GENERIC_EVOLVING + N_GENERIC_STEADY
    print(json.dumps({"ghost_setup": {
        "shard_s": shard_s, "C_p": sdisc.C_p, "C_u": sdisc.C_u,
        "comm": comm, "all_reduce_per_step":
        comm["messages"].get("all_reduce", 0) / n_steps}}), flush=True)
    if comm["messages"].get("p2p") or comm["largest"]["all_reduce"] > 3:
        raise AssertionError(f"ghost at world size 1 sent {comm}")
    order = {"p": torch.as_tensor(sdisc.order_p, device=dev),
             "u": torch.as_tensor(sdisc.order_udof, device=dev)}
    for k in range(n_steps):
        rec = {"ghost_vs_generic_step": k + 1,
               "counts": [_counts(stats[k]), _counts(ref_stats[k])],
               "cg_slack_per_solve": GHOST_CG_SLACK, "tol": CROSS_TOL}
        for name in ("p", "u"):
            rec[f"{name}_max_rel_err"] = _rel_err(
                getattr(states[k], name),
                getattr(ref_states[k], name)[order[name]])
        print(json.dumps(rec), flush=True)
        if not _ghost_counts_agree(stats[k], ref_stats[k]) or not all(
                rec[f"{x}_max_rel_err"] <= CROSS_TOL for x in ("p", "u")):
            raise AssertionError(f"ghost step {k + 1}: {rec}")


def _grid_order(space, n: int) -> np.ndarray:
    """Lexicographic (x fastest) grid index of each node of ``space`` on
    the undistorted n^dim grid of degree-k nodes."""
    x = space.node_coords
    lo, hi = x.min(axis=0), x.max(axis=0)
    m = space.degree * n
    ijk = np.rint((x - lo) / (hi - lo) * m).astype(np.int64)
    return sum(ijk[:, a] * (m + 1) ** a for a in range(x.shape[1]))


def generic_vs_rows(dev, data) -> None:
    """The generic build on the undistorted 20^3 grid against the rows
    path at 20^3, 2 evolving steps each: equal FSS and pressure counts, p
    and u (the generic nodes mapped onto the grid's order) within
    :data:`CROSS_TOL` of their max."""
    n = N_GENERIC_VS_ROWS
    gen = build_discretization(hyper_rectangle([10.0] * 3, cells_per_axis=n),
                               data, device=dev)
    rows = build_grid_discretization(data, cells_per_axis=n,
                                     multigrid="off", device=dev)
    g_states, g_stats, _ = run_steps(FixedStressSolver(gen, data), 2, 0,
                                     log=False)
    r_states, r_stats, _ = run_steps(FixedStressSolver(rows, data), 2, 0,
                                     log=False)
    ip = np.argsort(_grid_order(gen.pressure_space, n))
    iu = (3 * np.argsort(_grid_order(gen.displacement_space, n))[:, None]
          + np.arange(3)).reshape(-1)
    for k in range(2):
        a, b = g_stats[k], r_stats[k]
        rec = {"generic_vs_rows_step": k + 1, "n": n,
               "fss": [a.fss_iterations, b.fss_iterations],
               "pressure": [a.pressure_iterations, b.pressure_iterations],
               "cg_mechanics": [a.mech_cg_iterations, b.mech_cg_iterations],
               "tol": CROSS_TOL}
        for name, order in (("p", ip), ("u", iu)):
            got = getattr(g_states[k], name)[torch.as_tensor(order,
                                                             device=dev)]
            rec[f"{name}_max_rel_err"] = _rel_err(got,
                                                  getattr(r_states[k], name))
        print(json.dumps(rec), flush=True)
        if rec["fss"][0] != rec["fss"][1] or \
                rec["pressure"][0] != rec["pressure"][1] or not (
                rec["p_max_rel_err"] <= CROSS_TOL
                and rec["u_max_rel_err"] <= CROSS_TOL):
            raise AssertionError(f"generic vs rows at {n}^3: {rec}")


def irregular_check(cwd: Path) -> None:
    """The CLI's run of ``configs/irregular_2d.data`` (the gmsh mesh,
    float64, 17 steps, the generic path) against :data:`IRREGULAR_2D_PIN`:
    FSS and pressure counts exactly, ``pressure_error`` and the FSS error
    history to :data:`GOLDEN_RTOL`; 18 VTK files."""
    log = _run_log(cwd / "solution" / "run_log.jsonl")
    if len(log) != len(IRREGULAR_2D_PIN):
        raise AssertionError(f"irregular run logged {len(log)} steps, the "
                             f"pin has {len(IRREGULAR_2D_PIN)}")
    worst = 0.0
    for a, (fss, press, perr, hist_pin) in zip(log, IRREGULAR_2D_PIN):
        hist = a["fss_error_history"]
        errs = [abs(a["pressure_error"] / perr - 1.0)] + [
            abs(x / y - 1.0) for x, y in zip(hist, hist_pin)]
        worst = max(worst, *errs)
        if (a["fss_iterations"], a["pressure_iterations"], len(hist)) != (
                fss, press, len(hist_pin)) or not max(errs) <= GOLDEN_RTOL:
            raise AssertionError(f"irregular step {a['step']}: {a} vs pin "
                                 f"{(fss, press, perr, hist_pin)}")
    vtks = sorted((cwd / "solution").glob("solution-*.vtk"))
    rec = {"irregular_2d_cli": {
        "steps": len(log), "fss": [r["fss_iterations"] for r in log],
        "pressure": [r["pressure_iterations"] for r in log],
        "max_rel_err_vs_pin": worst, "rtol": GOLDEN_RTOL,
        "vtk_files": len(vtks)}}
    print(json.dumps(rec), flush=True)
    if len(vtks) != len(IRREGULAR_2D_PIN) + 1:
        raise AssertionError(f"irregular run VTK output: {rec}")


# ---------------------------------------------------------------------------
# adaptive mesh refinement: forests, hanging-node constraints, remeshes
# ---------------------------------------------------------------------------

AMR_GOLDEN_DECK = REPO / "configs" / "golden_2d_adaptive.data"
AMR_GOLDEN_HISTORY = REPO / "tests" / "data" / "adaptive_golden_history.json"
AMR_GOLDEN_RTOL = 1e-5      # tests/test_adaptive_history.py's tolerance
AMR_PIN_RTOL = 1e-6         # JAX's pinned gmsh-rooted runs
AMR_MAX_LEVEL = 5           # the at-scale point: levels 4 -> 5
AMR_STEPS = 6               # one remesh, before step 5
AMR_DOFS = 112_724          # 17^3 Q1 + 33^3 * 3 Q2 at level 4
AMR_CONSISTENT_TOL = 1e-6   # distribute(x) vs x, relative to max |x| (f32)
# the new mesh's share of device memory over the old one's, per unit of
# the mesh's growth: 1.14-1.23 measured (its hanging-node tables and
# constraint plans do not exist on the uniform mesh); see amr_after_remesh
AMR_MEMORY_SLACK = 2.0
AMR_PADDING_REPEATS = 5     # timed steps of each, see amr_padding_cost
AMR_PADDING_TOL = 1e-4      # padded vs unpadded p, u (float32)


def amr_gmsh_data(case: str):
    """The gmsh-rooted adaptive runs of JAX's tests, float64: (data, pin).
    The 2D run takes its steps between remeshes in blocks of two
    (``Steps per dispatch = 2``, the runner's ``multi_step`` path)."""
    from poroelasticity_dealii_torch.config import read_input_file
    if case == "irregular_2d":
        data = read_input_file(str(IRREGULAR_DECK))
        return dataclasses.replace(
            data, amr=True, mesh_file=str(REPO / "configs" /
                                          "irregular_2d.msh"),
            initial_refinement_level=0, max_refinement_level=2,
            refine_every=2, t_max=6 * data.time_step, output_vtk=False,
            steps_per_dispatch=2), AMR_IRREGULAR_2D_PIN
    data = read_input_file(str(REPO / "configs" / "consolidation_3d.data"))
    return dataclasses.replace(
        data, amr=True, mesh_file=str(REPO / "configs" / "irregular_3d.msh"),
        initial_refinement_level=0, max_refinement_level=1, refine_every=2,
        t_max=4 * data.time_step, output_vtk=False), AMR_IRREGULAR_3D_PIN


def amr_pin_check(name: str, hist: list, pin: list) -> None:
    """An adaptive run's history against its pin: mesh sizes and counts
    exactly, ``pressure_error`` within :data:`AMR_PIN_RTOL`."""
    worst = 0.0
    if len(hist) != len(pin):
        raise AssertionError(f"{name}: {len(hist)} steps, the pin has "
                             f"{len(pin)}")
    for h, (cells, pdofs, fss, press, err) in zip(hist, pin):
        rel = abs(h["err"] / err - 1.0)
        worst = max(worst, rel)
        if (h["n_cells"], h["n_pdofs"], h["fss"], h["press"]) != (
                cells, pdofs, fss, press) or not rel <= AMR_PIN_RTOL:
            raise AssertionError(f"{name} step {h['step']}: {h} vs pin "
                                 f"{(cells, pdofs, fss, press, err)}")
    print(json.dumps({"amr_gmsh_run": {
        "case": name, "steps": len(hist),
        "cells": [h["n_cells"] for h in hist],
        "pressure": [h["press"] for h in hist],
        "ms": [h["wall_s"] * 1e3 for h in hist],
        "max_rel_err_vs_pin": worst, "rtol": AMR_PIN_RTOL}}), flush=True)


def amr_golden_check(cwd: Path, tag: str = "amr_golden_cli") -> None:
    """A run of ``configs/golden_2d_adaptive.data`` (float64, 17 steps,
    256 -> 376 -> 724 -> 1000 cells; the CLI's, or ``tag``'s) against
    ``tests/data/adaptive_golden_history.json``: cells, pressure dofs, FSS
    and pressure counts exactly, ``pressure_error`` within
    :data:`AMR_GOLDEN_RTOL`; 18 VTK files."""
    log = _run_log(cwd / "solution" / "run_log.jsonl")
    ref = json.loads(AMR_GOLDEN_HISTORY.read_text())
    if len(log) != len(ref):
        raise AssertionError(f"adaptive golden run logged {len(log)} steps, "
                             f"the pin has {len(ref)}")
    worst = 0.0
    for a, r in zip(log, ref):
        rel = abs(a["pressure_error"] / r["pressure_error"] - 1.0)
        worst = max(worst, rel)
        if (a["n_cells"], a["n_pdofs"], a["fss_iterations"],
                a["pressure_iterations"]) != (
                r["n_cells"], r["n_pdofs"], r["fss_iterations"],
                r["pressure_iterations"]) or not rel <= AMR_GOLDEN_RTOL:
            raise AssertionError(f"adaptive golden step {a['step']}: {a} "
                                 f"vs pin {r}")
    vtks = sorted((cwd / "solution").glob("solution-*.vtk"))
    rec = {tag: {
        "steps": len(log), "cells": [a["n_cells"] for a in log],
        "pressure": [a["pressure_iterations"] for a in log],
        "wall_ms": [a["wall_s"] * 1e3 for a in log],
        "max_rel_err_vs_pin": worst, "rtol": AMR_GOLDEN_RTOL,
        "vtk_files": len(vtks)}}
    print(json.dumps(rec), flush=True)
    if len(vtks) != len(ref) + 1:
        raise AssertionError(f"adaptive golden run VTK output: {rec}")


def amr_psum_check(dev) -> None:
    """The golden adaptive deck with ``Sharding = psum`` through the
    adaptive runner on a world-size-1 NCCL group (every mesh's
    discretization sharded after its padding, one all-reduce per apply),
    float64, 17 steps and 3 remeshes, held against the pin as the CLI run
    (:func:`amr_golden_check`); its last step under ``torch.profiler``."""
    from poroelasticity_dealii_torch.amr.driver import AMRSimulationRunner
    from poroelasticity_dealii_torch import read_input_file
    base = read_input_file(str(AMR_GOLDEN_DECK))
    n_steps = int(np.ceil(base.t_max / base.time_step - 1e-12))
    with tempfile.TemporaryDirectory() as tmp, world_of_one():
        cwd = Path(tmp)
        data = dataclasses.replace(base, sharding="psum",
                                   output_directory=str(cwd / "solution"))
        t0 = time.perf_counter()
        runner = AMRSimulationRunner(data, device=dev, run_log=True)
        sharded = [isinstance(runner.disc, ShardedDiscretization)]
        busy = None
        events = runner.steps()
        for kind, _, info in events:
            if kind == "before":
                sharded.append(isinstance(runner.disc,
                                          ShardedDiscretization))
                if info == n_steps:
                    _, busy = device_busy(lambda: next(events))
        runner.logger.close()
        wall = time.perf_counter() - t0
        log = _run_log(cwd / "solution" / "run_log.jsonl")
        last_ms = log[-1]["wall_s"] * 1e3
        print(json.dumps({"amr_psum_phase": {
            "wall_s": wall, "step_ms": [a["wall_s"] * 1e3 for a in log],
            "profiled_last_step_ms": last_ms, "busy_ms": busy,
            "busy_share": busy / last_ms, "idle_share": 1.0 - busy / last_ms,
            "gpu": torch.cuda.get_device_name()}}), flush=True)
        if not all(sharded):
            raise AssertionError(f"adaptive psum: a mesh ran unsharded "
                                 f"{sharded}")
        amr_golden_check(cwd, "amr_psum_golden")


def _memory(dev) -> dict:
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return {"allocated": torch.cuda.memory_allocated(dev),
            "reserved": torch.cuda.memory_reserved(dev)}


def _pool_bytes(pool) -> int:
    """Bytes of the device segments the caching allocator holds for the
    graph memory pool ``pool`` (a ``torch.cuda.graph_pool_handle()``)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def amr_step_check(runner, state, log, block) -> list:
    """A block of adaptive steps the runner ran (``AMRSimulationRunner
    .steps``'s ``after`` event), every solve checked; prints each step and
    returns its ms."""
    data = runner.data
    solves = log.take()
    bad = [x for x in solves if not x[2]]
    out = []
    for rec, stats in block:
        k = rec["step"]
        if bad or not stats.cg_converged or \
                not stats.pressure_error <= float(np.float32(data.fss_tol)):
            raise AssertionError(f"AMR step {k}: solves {bad}, stats "
                                 f"{stats}")
        check_state(state, runner.disc.n_pdofs, runner.disc.n_udofs)
        out.append(rec["wall_s"] * 1e3)
        print(json.dumps({
            "amr_step": k, "ms": out[-1], **amr_sizes(runner),
            "fss": stats.fss_iterations,
            "pressure": stats.pressure_iterations,
            "cg_pressure": stats.pressure_cg_iterations,
            "cg_mechanics": stats.mech_cg_iterations,
            "cg_projection": stats.projection_cg_iterations,
            "pressure_error": stats.pressure_error,
            "solves": len(solves), "graph_replays": _graph_replays(
                runner.solver)}), flush=True)
    return out


def amr_consistency(runner, state, dev) -> dict:
    """On the hanging mesh: ``distribute`` leaves the final p and u as
    they are within float32 rounding (hanging values are their masters'
    interpolation), and ``condense_vec`` repeats bit for bit on the card
    and agrees with the CPU's."""
    d = runner.disc
    out = {}
    for name, hc, x in (("p", d.hc_p, state.p), ("u", d.hc_u, state.u)):
        scale = x.abs().max().item()
        err = (hc.distribute(x) - x).abs().max().item() / scale
        rng = np.random.default_rng(3)
        r = torch.as_tensor(rng.standard_normal(x.shape[0]), dtype=x.dtype,
                            device=dev)
        once, again = hc.condense_vec(r), hc.condense_vec(r.clone())
        host = hc.to("cpu").condense_vec(r.cpu())
        out[name] = {"hanging_rows": int((hc.weights != 0).any(1).sum()),
                     "distribute_rel_change": err,
                     "condense_bitwise_repeat": bool(torch.equal(once,
                                                                 again)),
                     "condense_vs_cpu": _rel_err(once.cpu(), host)}
        if not (err <= AMR_CONSISTENT_TOL and out[name][
                "condense_bitwise_repeat"] and out[name]["condense_vs_cpu"]
                <= TOL[torch.float32]) or out[name]["hanging_rows"] == 0:
            raise AssertionError(f"AMR constraints on {name}: {out[name]}")
    return out


def amr_scale_point(dev) -> None:
    """The 3D octree at scale: the bench configuration with AMR from the
    uniform level-4 mesh (4,096 cells, 112,724 DOF), levels 4 -> 5,
    bucketing on, float32, 6 captured steps with one remesh before step 5,
    through the runner's own loop (``AMRSimulationRunner.steps``).  Every
    solve converged (the bc response included, solved once on the hanging
    mesh), fields finite; step 5 captured equal to step 5 eager bit for
    bit; the hanging values consistent and ``condense_vec`` repeatable
    (:func:`amr_consistency`).  Memory (:func:`amr_after_remesh`): after
    the remesh nothing keeps the old mesh's solver, graphs or
    discretization alive, and the allocator holds no segment of the old
    graphs' pool (it held some before); once the runner has released them
    the allocator holds no more than before the remesh less that pool (so
    the old mesh's memory went back too); and memory after step 5 is at
    most the level after the release plus :data:`AMR_MEMORY_SLACK` times
    the old mesh's share scaled by the mesh's growth.  Levels are compared
    between points with no product on a new stream in between: torch's
    cuBLAS workspaces (one per stream, ~1 GiB here) sit outside any
    tensor and never shrink.  Prints every step's ms and the remesh's
    split, then :func:`amr_padding_cost`."""
    import weakref
    from poroelasticity_dealii_torch.amr.driver import AMRSimulationRunner
    check_tf32_off()
    data = amr_data(AMR_MAX_LEVEL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner = AMRSimulationRunner(data, device=dev)
    torch.cuda.synchronize()
    sizes0 = amr_sizes(runner)
    print(json.dumps({"amr_setup": {"setup_s": time.perf_counter() - t0,
                                    "split_s": dict(runner.timings),
                                    **sizes0}}), flush=True)
    if sizes0["dofs"] != AMR_DOFS or sizes0["hanging_rows"] != [0, 0]:
        raise AssertionError(f"AMR level-4 build: {sizes0}")
    if runner.solver.graphs is None or runner.solver.graphs.captures:
        raise AssertionError("AMR: no graphs, or graphs captured before "
                             "the first step")
    mem_base = _memory(dev)
    ms_all, log, before, old, post = [], None, None, None, None
    for kind, state, info in runner.steps(AMR_STEPS):
        if kind == "start":
            log = SolveLog(runner.solver)
        elif kind == "before" and info % data.refine_every == 0:
            # just remeshed: the old mesh's objects and pool must be gone
            gc.collect()
            kept = [name for name, ref in old.items() if ref() is not None]
            after = amr_sizes(runner)
            mem_pre["graph_pool_after_remesh"] = _pool_bytes(pool)
            if kept or after["hanging_rows"][1] == 0 or \
                    mem_pre["graph_pool_after_remesh"] or \
                    not mem_pre["graph_pool"]:
                raise AssertionError(f"AMR remesh: kept {kept} of the old "
                                     f"mesh, its graph pool {mem_pre}, "
                                     f"hanging rows {after}")
            log = SolveLog(runner.solver)
            post = dataclasses.replace(state, **{
                n: getattr(state, n).clone()
                for n in ("p", "u", "eps_v", "eps_v0", "strains")})
        elif kind == "after":
            k = info[-1][0]["step"]
            ms_all += amr_step_check(runner, state, log, info)
            if (k + 1) % data.refine_every == 0 and k + 1 <= AMR_STEPS:
                mem_pre = _memory(dev)
                pool = runner.solver.graphs._pool
                mem_pre["graph_pool"] = _pool_bytes(pool)
                before = amr_sizes(runner)
                old = {"solver": weakref.ref(runner.solver),
                       "graphs": weakref.ref(runner.solver.graphs),
                       "discretization": weakref.ref(runner.disc)}
            elif post is not None:
                amr_after_remesh(runner, state, info[-1][1], ms_all[-1],
                                 log, post, before, mem_base, mem_pre, dev)
                post = None
    cons = amr_consistency(runner, state, dev)
    print(json.dumps({"amr_scale_point": {
        "gpu": gpu_line(), "ms_per_step": ms_all,
        "constraints": cons}}), flush=True)
    amr_padding_cost(runner, state, dev)


def amr_after_remesh(runner, state, stats, ms, log, post, before,
                     mem_base, mem_pre, dev) -> None:
    """The checks of :func:`amr_scale_point` on the step after the remesh:
    captured equals eager, the bc response, device memory."""
    data = runner.data
    mem_post = _memory(dev)
    # the same step eager, from the same post-remesh state
    eager = FixedStressSolver(runner.disc, data, cuda_graphs=False)
    e_state, e_stats = eager.time_step(post, data.time_step)
    same = all(torch.equal(getattr(state, n), getattr(e_state, n))
               for n in ("p", "u", "eps_v", "strains")) and \
        _counts(stats) == _counts(e_stats)
    del eager, e_state
    after = amr_sizes(runner)
    growth = max(after["cells"] / before["cells"],
                 after["dofs"] / before["dofs"])
    released = runner.reserved_after_release
    bound = released + AMR_MEMORY_SLACK * growth * (
        mem_pre["reserved"] - released)
    bc = runner.solver._bc_response()
    bc_solves = log.take()
    rec = {"amr_remesh": {
        "before_step": data.refine_every, "gpu": gpu_line(),
        "remesh_s": runner.timings["remesh_s"],
        "split_s": dict(runner.timings),
        "first_step_ms_with_captures": ms,
        "before": before, "after": after,
        "memory_before_captures": mem_base, "memory_before_remesh": mem_pre,
        "reserved_after_release": released,
        "memory_after_step": mem_post, "memory_bound_reserved": bound,
        "captured_equals_eager": same,
        "bc_response": [x[:3] for x in bc_solves]}}
    print(json.dumps(rec), flush=True)
    if not same:
        raise AssertionError("AMR step after the remesh: captured and "
                             f"eager differ: {_counts(stats)} vs "
                             f"{_counts(e_stats)}")
    if not (released <= mem_pre["reserved"] - mem_pre["graph_pool"]
            and mem_post["reserved"] <= bound):
        raise AssertionError(f"AMR device memory not released: {rec}")
    if not bc_solves or not all(x[2] for x in bc_solves) or \
            not bool(torch.isfinite(bc).all()):
        raise AssertionError(f"AMR bc response: {bc_solves}")


def amr_padding_cost(runner, state, dev) -> None:
    """What ``AMR bucketing`` costs on the card: the runner's padded
    discretization of the final mesh against the unpadded one built for
    the same forest, each with its own captured solver, stepping from the
    same real-sized state (:data:`AMR_PADDING_REPEATS` timed steps each,
    alternating, after one warm step each).  Equal FSS and pressure
    counts, p and u within :data:`AMR_PADDING_TOL`; prints both ms.
    Then the device memory the process holds outside any tensor: torch's
    cuBLAS workspaces (one per stream that ran a product), measured by
    clearing them."""
    from poroelasticity_dealii_torch.amr.bucketing import pad_state
    from poroelasticity_dealii_torch.amr.driver import \
        build_amr_discretization
    data = runner.data
    real = runner._real_state(state)
    disc = build_amr_discretization(runner.forest, data, device=dev)
    solvers = {"unpadded": FixedStressSolver(disc, data),
               "padded": runner.solver}
    starts = {"unpadded": real,
              "padded": pad_state(real, runner.disc.n_pdofs,
                                  runner.disc.n_udofs)}
    ms, out = {"padded": [], "unpadded": []}, {}
    for rep in range(AMR_PADDING_REPEATS + 1):
        for name in ("padded", "unpadded"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = solvers[name].time_step(starts[name],
                                                data.time_step)
            torch.cuda.synchronize()
            if rep:
                ms[name].append((time.perf_counter() - t0) * 1e3)
    (sp, tp), (su, tu) = out["padded"], out["unpadded"]
    n_p, n_u = disc.n_pdofs, disc.n_udofs
    diff = {"p": _rel_err(sp.p[:n_p], su.p), "u": _rel_err(sp.u[:n_u], su.u)}
    rec = {"amr_padding": {
        "gpu": gpu_line(), "ms": ms,
        "median_ms": {k: float(np.median(v)) for k, v in ms.items()},
        "cells": [disc.n_cells, runner.disc.n_cells],
        "pdofs": [n_p, runner.disc.n_pdofs],
        "udofs": [n_u, runner.disc.n_udofs],
        "counts": {"padded": _counts(tp), "unpadded": _counts(tu)},
        "max_rel_diff": diff, "tol": AMR_PADDING_TOL}}
    print(json.dumps(rec), flush=True)
    if _counts(tp)[:2] != _counts(tu)[:2] or \
            not max(diff.values()) <= AMR_PADDING_TOL:
        raise AssertionError(f"AMR padded and unpadded steps differ: {rec}")
    del solvers, starts, out, sp, su
    held = _memory(dev)
    # frees the workspaces; no graph captured before this is replayed after
    # it (the last phase runs the CLI in subprocesses)
    torch._C._cuda_clearCublasWorkspaces()
    print(json.dumps({"amr_memory_outside_tensors": {
        "before_clearing_cublas_workspaces": held,
        "after": _memory(dev)}}), flush=True)


def amr_phase(dev) -> None:
    """Adaptive runs on the card: the golden adaptive deck through the CLI
    (float64, 17 steps, :func:`amr_golden_check`) while the gmsh-rooted
    quad and hex forests run in this process (float64, JAX's test sizes,
    against :data:`AMR_IRREGULAR_2D_PIN` and :data:`AMR_IRREGULAR_3D_PIN`),
    then the 3D octree at scale alone (:func:`amr_scale_point`)."""
    from poroelasticity_dealii_torch.amr.driver import AMRSimulationRunner
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory() as tmp:
        cwd = Path(tmp)
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "poroelasticity_dealii_torch", "run",
             str(AMR_GOLDEN_DECK), "--device", "cuda"], cwd=cwd, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            for case in ("irregular_2d", "irregular_3d"):
                data, pin = amr_gmsh_data(case)
                _, hist = AMRSimulationRunner(data, device=dev).run()
                amr_pin_check(case, hist, pin)
            out, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        sys.stdout.write(f"[cli golden_2d_adaptive]\n{err[-1500:]}")
        if proc.returncode != 0:
            raise AssertionError(f"adaptive golden CLI run failed "
                                 f"({proc.returncode}):\n{out}\n{err}")
        print(f"amr: gmsh-rooted runs and the adaptive golden CLI run in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        amr_golden_check(cwd)
    gc.collect()
    torch.cuda.empty_cache()
    amr_scale_point(dev)


# ---------------------------------------------------------------------------
# the runner's deck options: checkpoints and resume, Nondimensionalize,
# Debug NaNs, the adaptive resume
# ---------------------------------------------------------------------------

N_OPTIONS_STEPS = 4          # the checkpointed 40^3 run: 4 steps, one
CKPT_EVERY = 2               # checkpoint every 2, resumed from step 2
RESUME_SKIP_TOL = 1e-4       # resumed vs uninterrupted p, u, strains, rel
#                              to max |field|, only when the uninterrupted
#                              run took the bitwise skip the resume cannot
# both checkpoint backends (TPU / Checkpoint format = npz | orbax) on the
# same 4 steps with a checkpoint every step, in turns
CKPT_BACKEND_RUNS = ("npz", "orbax", "orbax", "npz")
# Nondimensionalize at 40^3 float64, dimensional vs nondimensional runs at
# the bench's relative mechanics tolerance and at 1e-10: FSS, pressure and
# pressure CG counts equal and p within tests/test_scaling.py's 1e-10; the
# mechanics Jacobi-CG (85-172 iterations at 1.66M DOF) stops a few
# iterations apart in the two runs, so its counts are held within 15% (test:
# 5 iterations; measured up to 9.6%) and u within 10x the solve's own
# tolerance relative to max |u| (test: 1e-8 elementwise; measured 0.2-1.5x
# the tolerance)
ND_MECH_TOLS = (1e-5, 1e-10)
ND_P_RTOL = 1e-10
ND_MECH_SLACK = 0.15
ND_U_TOL_FACTOR = 10.0
# JAX's tests/test_amr.py::test_amr_checkpoint_resume
AMR_RESUME_P_RTOL = 1e-12
AMR_RESUME_EPS_RTOL = 1e-10
COUNTS = ("fss_iterations", "pressure_iterations", "pressure_cg_iterations",
          "mech_cg_iterations", "projection_cg_iterations")


class RecordingLog:
    """A run logger that keeps each step's number, counts and residual."""

    def __init__(self):
        self.steps = []

    def log_step(self, step, t, stats, wall_s, extra=None):
        self.steps.append({"step": step, "wall_ms": wall_s * 1e3,
                           "counts": [int(getattr(stats, f))
                                      for f in COUNTS],
                           "pressure_error": float(stats.pressure_error)})

    def close(self):
        pass


def _options_data(tmp: Path, name: str, **kw):
    """The bench configuration at 40^3 as a deck (elasticity GMG off: the
    3D rows kit never builds it with ``auto``), no VTK, its output and
    checkpoints under ``tmp``."""
    data = bench_data()
    return dataclasses.replace(
        data, cells_per_axis=(N_MAIN,) * 3,
        t_max=N_OPTIONS_STEPS * data.time_step, output_vtk=False,
        output_directory=str(tmp / f"out_{name}"),
        checkpoint_directory=str(tmp / f"ckpt_{name}"), **kw)


def _field_gap(a, b) -> float:
    return _rel_err(a, b) if a.shape == b.shape else float("inf")


def checkpoint_resume_check(dev, tmp: Path) -> None:
    """4 steps of the 40^3 float32 bench configuration through
    ``SimulationRunner`` with a checkpoint every 2, then a fresh runner
    resumed from ``ckpt-000002.npz``: steps 3-4 give the uninterrupted
    run's counts, and p, u and strains bit for bit (or within
    :data:`RESUME_SKIP_TOL` if the uninterrupted run took the bitwise skip
    at step 3, which the resume cannot take); K1-K4 launched; the
    checkpoint's write ms and bytes and the resume's set-up seconds."""
    from poroelasticity_dealii_torch.models.runner import SimulationRunner
    from poroelasticity_dealii_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint)
    cm.reset_launch_counts()
    data = _options_data(tmp, "full", checkpoint_every=CKPT_EVERY)
    full_log = RecordingLog()
    full = SimulationRunner(data, device=dev, logger=full_log)
    st_full = full.run()
    torch.cuda.synchronize()
    launches = launch_counts()
    modes = mode_launches()
    del full
    ckpt = Path(data.checkpoint_directory) / f"ckpt-{CKPT_EVERY:06d}.npz"
    t0 = time.perf_counter()
    resumed = SimulationRunner(_options_data(tmp, "resumed"), device=dev,
                               logger=RecordingLog())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    load_checkpoint(str(ckpt), resumed.disc.dtype, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    st_res = resumed.run(resume_from=str(ckpt))
    res_log = resumed.logger.steps
    torch.cuda.synchronize()
    t0w = time.perf_counter()
    save_checkpoint(str(tmp / "timed.npz"), st_res, 0.0, 0)
    write_ms = (time.perf_counter() - t0w) * 1e3
    tail = full_log.steps[CKPT_EVERY:]
    skip = tail[0]["counts"][3] == 0 and res_log[0]["counts"][3] > 0
    gaps = {k: _field_gap(getattr(st_res, k), getattr(st_full, k))
            for k in ("p", "u", "strains")}
    bitwise = {k: torch.equal(getattr(st_res, k), getattr(st_full, k))
               for k in ("p", "u", "strains")}
    rec = {"checkpoint_resume": {
        "dofs": resumed.disc.n_pdofs + resumed.disc.n_udofs,
        "checkpoint_bytes": ckpt.stat().st_size,
        "checkpoint_write_ms": write_ms,
        "resume_setup_s": {"runner": t1 - t0, "load": t2 - t1},
        "uninterrupted": full_log.steps, "resumed": res_log,
        "bitwise": bitwise, "max_rel_err": gaps,
        "uninterrupted_took_skip_at_resume": skip,
        "launches": launches,
        "rows_apply_modes": {"free": modes[cm.FREE],
                             "constrained": modes[cm.CONSTRAINED]}}}
    print(json.dumps(rec), flush=True)
    if [s["step"] for s in res_log] != [s["step"] for s in tail] or \
            len(tail) != N_OPTIONS_STEPS - CKPT_EVERY:
        raise AssertionError(f"resumed run's steps differ: {rec}")
    if skip:
        print("checkpoint_resume: the uninterrupted run took the bitwise "
              "skip at its first resumed step; fields held to "
              f"{RESUME_SKIP_TOL}", flush=True)
        if not all(g <= RESUME_SKIP_TOL for g in gaps.values()) or [
                s["counts"][:3] for s in tail] != [
                s["counts"][:3] for s in res_log]:
            raise AssertionError(f"resumed run differs: {rec}")
    elif [s["counts"] for s in tail] != [s["counts"] for s in res_log] \
            or not all(bitwise.values()):
        raise AssertionError(f"resumed run differs from the uninterrupted "
                             f"one: {rec}")
    for name in MAIN_PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} not launched by the "
                                 "checkpointed runs")
    if modes[cm.FREE] <= 0 or modes[cm.CONSTRAINED] <= 0:
        raise AssertionError(f"K1 / K2 not launched: {dict(modes)}")
    checkpoint_backends_check(dev, tmp, full_log.steps)


class TimedLog(RecordingLog):
    """A :class:`RecordingLog` that also keeps the host clock at each
    step's record: consecutive records are a step's period, the save of the
    step before included (the runner logs, then saves, then steps)."""

    def __init__(self):
        super().__init__()
        self.clock = []

    def log_step(self, step, t, stats, wall_s, extra=None):
        self.clock.append(time.perf_counter())
        super().log_step(step, t, stats, wall_s, extra)


@contextlib.contextmanager
def _timed(module, name, into: list):
    """Append the ms of every call of ``module.name`` to ``into`` (on
    whichever thread makes it) while the block runs."""
    fn = getattr(module, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            into.append((time.perf_counter() - t0) * 1e3)

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, fn)


def _ckpt_files_equal(a: Path, b: Path) -> bool:
    with np.load(a) as za, np.load(b) as zb:
        return za.files == zb.files and all(
            za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k])
            for k in za.files)


def checkpoint_backends_check(dev, tmp: Path, want_steps: list) -> None:
    """The 40^3 float32 rows run of :func:`checkpoint_resume_check` with a
    checkpoint every step through each backend, in turns
    (:data:`CKPT_BACKEND_RUNS`): each step's wall (the run log's, which
    ends at the step's synchronize) and period (record to record: the step
    and the save before it), the ms each save blocked the host, the
    writer's ms (``orbax``: the writer thread's commit, the copy's wait
    included; both: the file write) and the bytes; every directory
    checkpoint equals the ``.npz`` of its step and turn bit for bit, the
    runs' counts equal ``want_steps``'; a fresh runner resumed from the
    directory ``ckpt-000002`` reproduces steps 3-4 as the ``.npz`` resume
    does."""
    from poroelasticity_dealii_torch.models import runner as runner_mod
    from poroelasticity_dealii_torch.utils import checkpoint as ckpt_mod
    runs, states = [], {}
    for turn, fmt in enumerate(CKPT_BACKEND_RUNS):
        name = f"{fmt}{turn}"
        data = _options_data(tmp, name, checkpoint_every=1,
                             checkpoint_format=fmt)
        log, blocked, commits, writes = TimedLog(), [], [], []
        r = SimulationRunner(data, device=dev, logger=log)
        with _timed(runner_mod, "save_step_checkpoint", blocked), \
                _timed(ckpt_mod, "_commit", commits), \
                _timed(ckpt_mod, "_write_npz", writes):
            t0 = time.perf_counter()
            states[name] = r.run()
            run_s = time.perf_counter() - t0
        del r
        root = Path(data.checkpoint_directory)
        files = [root / (f"ckpt-{s:06d}.npz" if fmt == "npz"
                         else f"ckpt-{s:06d}/state.npz")
                 for s in range(1, N_OPTIONS_STEPS + 1)]
        runs.append({
            "format": fmt, "run_s": run_s,
            "wall_ms": [st["wall_ms"] for st in log.steps],
            "period_ms": [(b - a) * 1e3 for a, b in zip(log.clock,
                                                       log.clock[1:])],
            "save_blocked_ms": blocked, "writer_ms": commits,
            "write_ms": writes, "bytes": [f.stat().st_size for f in files],
            "counts": [st["counts"] for st in log.steps],
            "dir": str(root)})
        gc.collect()
    # a resume from the first orbax turn's directory at step 2
    src = next(r for r in runs if r["format"] == "orbax")
    res_log = RecordingLog()
    resumed = SimulationRunner(_options_data(tmp, "resumed_dir"), device=dev,
                               logger=res_log)
    st_res = resumed.run(resume_from=str(Path(src["dir"]) / "ckpt-000002"))
    del resumed
    st_src = states[f"orbax{CKPT_BACKEND_RUNS.index('orbax')}"]
    tail = want_steps[CKPT_EVERY:]
    skip = tail[0]["counts"][3] == 0 and res_log.steps[0]["counts"][3] > 0
    gaps = {k: _field_gap(getattr(st_res, k), getattr(st_src, k))
            for k in ("p", "u", "strains")}
    bitwise = {k: torch.equal(getattr(st_res, k), getattr(st_src, k))
               for k in ("p", "u", "strains")}
    equal = {}
    for npz, orb in ((0, 1), (3, 2)):
        equal[f"{npz}/{orb}"] = [_ckpt_files_equal(
            Path(runs[npz]["dir"]) / f"ckpt-{s:06d}.npz",
            Path(runs[orb]["dir"]) / f"ckpt-{s:06d}" / "state.npz")
            for s in range(1, N_OPTIONS_STEPS + 1)]
    rec = {"checkpoint_backends": {
        "runs": [{k: v for k, v in r.items() if k != "dir"} for r in runs],
        "directory_equals_npz": equal,
        "resumed_from_directory": res_log.steps, "bitwise": bitwise,
        "max_rel_err": gaps, "uninterrupted_took_skip_at_resume": skip}}
    print(json.dumps(rec), flush=True)
    for fmt in ("npz", "orbax"):
        mine = [r for r in runs if r["format"] == fmt]
        later = [x for r in mine for x in r["save_blocked_ms"][1:]]
        writer = [r["writer_ms" if fmt == "orbax" else "write_ms"]
                  for r in mine]
        print(f"checkpoint backend {fmt}: saves 2-{N_OPTIONS_STEPS} blocked "
              f"the host {min(later):.3f}-{max(later):.3f} ms (first save "
              f"{[r['save_blocked_ms'][0] for r in mine]}), step walls "
              f"2-{N_OPTIONS_STEPS} {[r['wall_ms'][1:] for r in mine]} ms, "
              f"periods {[r['period_ms'] for r in mine]} ms, writer "
              f"{writer} ms, bytes {mine[0]['bytes'][0]}", flush=True)
    for r in runs:
        if r["counts"] != [st["counts"] for st in want_steps] or \
                len(r["save_blocked_ms"]) != N_OPTIONS_STEPS or \
                len(set(r["bytes"])) != 1:
            raise AssertionError(f"checkpoint backends differ: {rec}")
    if not all(all(v) for v in equal.values()):
        raise AssertionError(f"directory checkpoints differ from the .npz "
                             f"ones: {equal}")
    if [s["step"] for s in res_log.steps] != [s["step"] for s in tail]:
        raise AssertionError(f"resumed run's steps differ: {rec}")
    if skip:
        if not all(g <= RESUME_SKIP_TOL for g in gaps.values()):
            raise AssertionError(f"resumed run differs: {rec}")
    elif [s["counts"] for s in tail] != \
            [s["counts"] for s in res_log.steps] or not all(bitwise.values()):
        raise AssertionError(f"the resume from the directory differs from "
                             f"the uninterrupted run: {rec}")


def nondimensional_check(dev, tmp: Path) -> None:
    """2 steps of the 40^3 bench configuration in float64 through
    ``SimulationRunner``, dimensional and nondimensionalized
    (tests/test_scaling.py's check), at each mechanics tolerance of
    :data:`ND_MECH_TOLS`: FSS, pressure and pressure CG counts equal,
    mechanics CG within :data:`ND_MECH_SLACK`, p rescaled to SI within
    :data:`ND_P_RTOL` and u within :data:`ND_U_TOL_FACTOR` times the
    mechanics tolerance, relative to max |u|."""
    from poroelasticity_dealii_torch.models.runner import SimulationRunner
    from poroelasticity_dealii_torch.models.scaling import nondimensionalize
    for tol in ND_MECH_TOLS:
        data = _options_data(tmp, "dim", dtype="float64", mech_cg_tol=tol)
        scaled, sc = nondimensionalize(data)
        out = {}
        for name, d, scales in (("dim", data, None), ("nd", scaled, sc)):
            r = SimulationRunner(d, device=dev, scales=scales)
            st = r.solver.initial_state()
            counts, ms = [], []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, stats = r.solver.time_step(st, d.time_step)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                counts.append([getattr(stats, f) for f in COUNTS])
            out[name] = (st.p.cpu().numpy(), st.u.cpu().numpy(), counts, ms)
            del r, st
        (p_d, u_d, c_d, ms_d), (p_n, u_n, c_n, ms_n) = out["dim"], out["nd"]
        p_si, u_si = sc.p(p_n), sc.u(u_n)
        du = np.abs(u_si - u_d)
        big = np.abs(u_d) > 1e-3 * np.abs(u_d).max()
        rec = {"nondimensional": {
            "mech_cg_tol": tol, "counts": [c_d, c_n], "ms": [ms_d, ms_n],
            "p_max_rel_err": float(np.max(np.abs(p_si - p_d)
                                          / np.abs(p_d))),
            "u_max_err_rel_to_max": float(du.max() / np.abs(u_d).max()),
            "u_max_rel_err_above_1e-3_max": float(np.max(
                du[big] / np.abs(u_d[big]))),
            "p_rtol": ND_P_RTOL, "u_tol": ND_U_TOL_FACTOR * tol}}
        print(json.dumps(rec), flush=True)
        rec = rec["nondimensional"]
        for a, b in zip(c_d, c_n):
            if a[:3] != b[:3] or abs(a[3] - b[3]) > ND_MECH_SLACK * a[3]:
                raise AssertionError(f"nondimensional counts differ: {rec}")
        if not (rec["p_max_rel_err"] <= ND_P_RTOL
                and rec["u_max_err_rel_to_max"] <= rec["u_tol"]):
            raise AssertionError(f"nondimensional fields differ: {rec}")


def debug_nans_check(dev, tmp: Path) -> None:
    """``Debug NaNs`` at 40^3 float32: 2 evolving + 1 steady captured
    steps with the option on equal the option-off steps bit for bit,
    counts and fields (step ms of both printed); a deck with a NaN flow
    rate raises ``FloatingPointError`` naming the pressure residual in
    its first step, through the runner."""
    from poroelasticity_dealii_torch.models.runner import SimulationRunner
    data = bench_data()
    disc = build_grid_discretization(data, cells_per_axis=N_MAIN,
                                     multigrid="off", device=dev)
    runs = {}
    for on in (False, True):
        solver = FixedStressSolver(
            disc, dataclasses.replace(data, debug_nans=on))
        runs[on] = run_steps(solver, N_GRAPH_EVOLVING, N_GRAPH_STEADY,
                             log=False)
        del solver
    (st_off, ss_off, ms_off), (st_on, ss_on, ms_on) = runs[False], runs[True]
    rec = {"debug_nans": {
        "counts": [[_counts(s) for s in ss_off], [_counts(s) for s in ss_on]],
        "ms": [ms_off, ms_on],
        "bitwise": all(torch.equal(getattr(a, k), getattr(b, k))
                       for a, b in zip(st_off, st_on)
                       for k in ("p", "u", "eps_v", "strains"))}}
    del runs, st_off, st_on, disc
    nan_data = _options_data(tmp, "nan", flow_rate=float("nan"),
                             debug_nans=True)
    try:
        SimulationRunner(nan_data, device=dev).run()
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    rec["debug_nans"]["nan_run_raised"] = raised
    print(json.dumps(rec), flush=True)
    if rec["debug_nans"]["counts"][0] != rec["debug_nans"]["counts"][1] \
            or not rec["debug_nans"]["bitwise"]:
        raise AssertionError(f"Debug NaNs changed a finite run: {rec}")
    if raised is None or not raised.startswith(
            "step 1: Debug NaNs: the pressure residual"):
        raise AssertionError(f"the NaN run did not raise as it should: "
                             f"{raised!r}")


def amr_resume_check(dev, tmp: Path) -> None:
    """:func:`amr_resume_once` with each checkpoint format."""
    for fmt in ("npz", "orbax"):
        amr_resume_once(dev, tmp, fmt)


def amr_resume_once(dev, tmp: Path, fmt: str) -> None:
    """The golden adaptive deck (float64, levels 4 -> 6, a remesh before
    every 5th step) for 8 steps with a checkpoint every 6 in format
    ``fmt``, and a fresh runner resumed from ``ckpt-000006.npz`` (``orbax``:
    the directory ``ckpt-000006``; after the first remesh): the forest's
    leaves equal, p within 1e-12 and eps_v within 1e-10 relative (JAX's
    tests/test_amr.py::test_amr_checkpoint_resume), and whether every field
    is bitwise equal."""
    from poroelasticity_dealii_torch.amr.driver import AMRSimulationRunner
    from poroelasticity_dealii_torch.config import read_input_file
    data = dataclasses.replace(
        read_input_file(str(AMR_GOLDEN_DECK)), t_max=480.0,
        output_vtk=False, checkpoint_every=6, checkpoint_format=fmt,
        checkpoint_directory=str(tmp / f"ckpt_amr_{fmt}"))
    full = AMRSimulationRunner(data, device=dev)
    st_full, hist = full.run()
    res = AMRSimulationRunner(data, device=dev)
    st_res, res_hist = res.run(resume_from=str(
        tmp / f"ckpt_amr_{fmt}"
        / ("ckpt-000006.npz" if fmt == "npz" else "ckpt-000006")))
    p_gap = float(np.max(np.abs(st_res.p.cpu().numpy()
                                - st_full.p.cpu().numpy())
                         / np.abs(st_full.p.cpu().numpy())))
    e_r, e_f = st_res.eps_v.cpu().numpy(), st_full.eps_v.cpu().numpy()
    eps_ok = bool(np.all(np.abs(e_r - e_f)
                         <= AMR_RESUME_EPS_RTOL * np.abs(e_f)))
    rec = {"amr_resume": {
        "format": fmt, "cells": [h["n_cells"] for h in hist],
        "resumed_steps": [h["step"] for h in res_hist],
        "leaves_equal": res.forest.leaves == full.forest.leaves,
        "counts": [[(h["fss"], h["press"]) for h in hist[6:]],
                   [(h["fss"], h["press"]) for h in res_hist]],
        "p_max_rel_err": p_gap, "p_rtol": AMR_RESUME_P_RTOL,
        "eps_v_within_rtol": eps_ok,
        "bitwise": {k: torch.equal(getattr(st_res, k), getattr(st_full, k))
                    for k in ("p", "u", "eps_v", "eps_v0", "strains")}}}
    print(json.dumps(rec), flush=True)
    if not (rec["amr_resume"]["leaves_equal"] and eps_ok
            and p_gap <= AMR_RESUME_P_RTOL
            and rec["amr_resume"]["resumed_steps"] == [7, 8]
            and len(set(rec["amr_resume"]["cells"])) > 1):
        raise AssertionError(f"adaptive resume differs: {rec}")


def runner_options_phase(dev) -> None:
    """The runner's deck options on the card, every step on the rows kit
    with K1-K4 and captured chunks (the adaptive resume on the generic
    path): :func:`checkpoint_resume_check`, :func:`nondimensional_check`,
    :func:`debug_nans_check`, :func:`amr_resume_check`."""
    with tempfile.TemporaryDirectory() as tmp:
        for check in (checkpoint_resume_check, nondimensional_check,
                      debug_nans_check, amr_resume_check):
            t0 = time.perf_counter()
            check(dev, Path(tmp))
            gc.collect()
            torch.cuda.empty_cache()
            print(f"runner options: {check.__name__} in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# the structured path's solver options: 3D elasticity GMG (the JAX package's
# configuration off a TPU), refinement, node-block Jacobi, anisotropic
# grids, another degree pair
# ---------------------------------------------------------------------------

N_GMG_LEVELS = 4          # 40/20/10/5 cells; the coarsest 3 * 11^3 = 3,993
#                           dofs, inverted densely on the host
VCYCLE_APPLIES = 8        # operator applies per level visit: 3 + 3 smoother
#                           applies (degree-3 Chebyshev) and 2 residuals
VCYCLE_TOL = 1e-5         # K6 V-cycle vs the plain one, relative to max |z|
#                           (f32 rounding through 4 levels)
N_OPT_EVOLVING, N_OPT_STEADY = 2, 1
REFINE_GAP_FACTOR = 10.0  # refined vs native f64: p and u gaps (relative to
#                           max |field|) within 10x the mechanics tolerance
ANISO_CELLS = (80, 40, 20)
ANISO_DOMAIN = (20.0, 10.0, 5.0)
ANISO_DOFS = 1_673_784    # 161*81*41*3 + 81*41*21
DEGREE_PAIR = (2, 2)      # (pressure, displacement) degrees of phase (e)
N_DEGREE = 16


def _free_opts() -> None:
    """Free what a finished option run left (SolveLog's cycles, graphs)."""
    gc.collect()
    torch.cuda.empty_cache()


def profiled_steps(solver, state, bc_prev, tag) -> list:
    """One more evolving step (the ramp's next scale) and one steady step
    after a run, each under ``torch.profiler``: wall ms, device busy ms and
    idle share, the flat kernel's device ms and its launches, the host's
    launch calls and the kernels with the most device time."""
    out = []
    bc = bc_prev + BC_RATE
    for kind, prev in (("evolving", bc_prev), ("steady", bc)):
        cm.reset_launch_counts()
        (state, stats, ms), dev = profile_step._profiled(
            solver, lambda st=state, p=prev: profile_step._step(
                solver, st, bc, p))
        check_state(state, solver.disc.n_pdofs, solver.disc.n_udofs)
        rec = {f"{tag}_profiled_step": kind, "wall_ms_profiled": ms,
               "busy_ms": dev["busy_ms"],
               "idle_share": 1.0 - dev["busy_ms"] / ms,
               "counts": _counts(stats),
               "elasticity_grid_apply": {
                   "device_ms": dev["elasticity_grid_apply"]["ms"],
                   "calls": cm.launch_counts()["elasticity_grid_apply"]},
               "runtime_calls": dev["runtime_calls"],
               "graphs": dev["graphs"],
               "top_kernels": dict(list(dev["kernels"].items())[:8])}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def gmg_config_phase(dev, rows_step1, conv_step1, rows_ms) -> None:
    """(a) The JAX package's configuration of the 40^3 bench deck off a
    TPU: the conv kit with ``multigrid="auto"`` (4 levels), f32, every
    mechanics solve GMG-Richardson, ending converged or on its stagnation
    exit, never at the cap; 2 evolving + 1 steady captured steps, equal to
    eager bit for bit; step 1 within :data:`CROSS_TOL` of the rows and the
    conv Jacobi-CG runs; every level apply of a V-cycle on the flat
    kernel, and the V-cycle within :data:`VCYCLE_TOL` of the plain
    stencil's; the hierarchy's set-up, one V-cycle's device ms, a profiled
    evolving and steady step beside the rows path's ms; and one conv deck
    through ``SimulationRunner``."""
    data = bench_data()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    disc = build_grid_discretization(data, cells_per_axis=N_MAIN,
                                     multigrid="auto",
                                     elasticity_backend="conv", device=dev)
    solver = FixedStressSolver(disc, data)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if disc.row_ops is not None or disc.gmg_levels != N_GMG_LEVELS:
        raise AssertionError(f"40^3 conv 'auto': kit {disc.row_ops}, "
                             f"{disc.gmg_levels} GMG levels")
    rng = np.random.default_rng(40)
    r = torch.as_tensor(rng.standard_normal(disc.n_udofs),
                        dtype=torch.float32, device=dev) * disc.free_mask_u
    cm.reset_launch_counts()
    z = disc.gmg_precond(r)
    torch.cuda.synchronize()
    per_vcycle = cm.launch_counts()["elasticity_grid_apply"]
    if per_vcycle != VCYCLE_APPLIES * (N_GMG_LEVELS - 1) or not bool(
            torch.isfinite(z).all()):
        raise AssertionError(f"one V-cycle launched the flat kernel "
                             f"{per_vcycle} times (want "
                             f"{VCYCLE_APPLIES * (N_GMG_LEVELS - 1)})")
    # the same hierarchy on the plain stencil: the V-cycle's every level
    # (K6 at n = 40, 20 and 10) against its plain twin on the same r
    plain = build_grid_discretization(data, cells_per_axis=N_MAIN,
                                      multigrid="auto",
                                      elasticity_backend="conv", device=dev,
                                      kernels="plain")
    cm.reset_launch_counts()
    z_plain = plain.gmg_precond(r)
    torch.cuda.synchronize()
    if cm.launch_counts()["elasticity_grid_apply"]:
        raise AssertionError("the plain hierarchy launched the flat kernel")
    vcycle_err = _rel_err(z, z_plain)
    if not vcycle_err <= VCYCLE_TOL:
        raise AssertionError(f"V-cycle on K6 vs the plain stencil: rel err "
                             f"{vcycle_err:.3e} > {VCYCLE_TOL}")
    del plain, z_plain
    vcycle_ms, vcycle_host_ms = device_and_host_ms(
        lambda: disc.gmg_precond(r), reps=5, calls=4)
    log = SolveLog(solver)
    launches = {}
    cm.reset_launch_counts()
    run = run_steps_2d(solver, log, N_OPT_EVOLVING, N_OPT_STEADY,
                       tag="gmg", launches=launches)
    states, stats, ms = run
    k6 = launches["elasticity_grid_apply"]
    if k6 <= 0:
        raise AssertionError("the GMG path never launched the flat kernel")
    captured_vs_eager("gmg", solver, disc, data, captured_run=run)
    errs = {}
    for ref_name, ref in (("rows", rows_step1),
                          ("conv_jacobi", conv_step1)):
        for name in ("p", "u"):
            err = _rel_err(getattr(states[0], name), getattr(ref, name))
            errs[f"{name}_vs_{ref_name}"] = err
            if not err <= CROSS_TOL:
                raise AssertionError(f"GMG step 1 {name} vs {ref_name}: "
                                     f"rel err {err:.3e} > {CROSS_TOL}")
    prof = profiled_steps(solver, states[-1],
                          1.0 + BC_RATE * N_OPT_EVOLVING, "gmg")
    print(json.dumps({"gmg_config": {
        "gpu": gpu_line(), "n": N_MAIN, "dofs": disc.n_pdofs + disc.n_udofs,
        "levels": disc.gmg_levels, "setup_s": setup_s,
        "gmg_setup_s": disc.gmg_setup_s, "vcycle_ms": vcycle_ms,
        "vcycle_host_ms": vcycle_host_ms,
        "flat_kernel_launches_per_vcycle": per_vcycle,
        "vcycle_vs_plain_rel_err": vcycle_err, "vcycle_tol": VCYCLE_TOL,
        "flat_kernel_launches_in_steps": k6,
        "richardson_iterations_per_step": [x.mech_cg_iterations
                                           for x in stats],
        "ms_per_step": ms, "rows_ms_per_step": rows_ms,
        "profiled": [{k: x[k] for k in ("wall_ms_profiled", "busy_ms",
                                        "idle_share")} for x in prof],
        "step1_rel_err": errs, "tol": CROSS_TOL}}), flush=True)
    del solver, disc, log, run, states
    _free_opts()
    # the runner builds the hierarchy from a conv deck
    tmp = Path(tempfile.mkdtemp(prefix="gmg_runner_"))
    try:
        rdata = dataclasses.replace(
            data, elasticity_backend="conv", cells_per_axis=(N_MAIN,) * 3,
            t_max=data.time_step, output_vtk=False,
            output_directory=str(tmp))
        runner = SimulationRunner(rdata, device=dev)
        if runner.disc.gmg_levels != N_GMG_LEVELS:
            raise AssertionError(f"SimulationRunner on the conv deck built "
                                 f"{runner.disc.gmg_levels} GMG levels")
        state = runner.run()
        check_state(state, runner.disc.n_pdofs, runner.disc.n_udofs)
        log_rec = _run_log(tmp / "run_log.jsonl")
        print(json.dumps({"gmg_runner": {"levels": runner.disc.gmg_levels,
                                         "run_log": log_rec}}), flush=True)
        del runner, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _free_opts()


def refinement_check(dev) -> None:
    """(b) The 40^3 bench deck in float64 with ``Elasticity backend =
    conv`` (multigrid 'auto'), ``Mixed precision refinement`` on against
    off, 2 evolving steps each: off is native f64 GMG-CG (its V-cycle's
    applies the flat kernel on DMMA), on is f64 Richardson over whole f32
    solves of the conv twin (flat Jacobi-CG on the flat kernel, the
    pressure's f32 GMG-CG, batched mass CG).  Every solve converges, and
    the gaps in p and u after each step stay within
    :data:`REFINE_GAP_FACTOR` times the mechanics tolerance."""
    runs = {}
    for mode in ("off", "on"):
        data = dataclasses.replace(bench_data(), dtype="float64",
                                   elasticity_backend="conv",
                                   mixed_precision_refinement=mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        disc = build_grid_discretization(data, cells_per_axis=N_MAIN,
                                         multigrid="auto", device=dev)
        solver = FixedStressSolver(disc, data)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        if (solver._ir is not None) != (mode == "on") or \
                disc.gmg_levels != N_GMG_LEVELS or (
                    mode == "on" and solver._ir_disc32.row_ops is not None):
            raise AssertionError(f"refinement {mode}: inner "
                                 f"{solver._ir}, {disc.gmg_levels} levels")
        cm.reset_launch_counts()
        states, stats, ms = run_steps(solver, N_OPT_EVOLVING, 0, log=False)
        check_steps(states, stats, disc, N_OPT_EVOLVING)
        if mode == "on":
            # the f32 inner solves: flat Jacobi-CG, batched mass CG
            held_to_plain("refinement", lambda: FixedStressSolver(disc,
                                                                  data))
        runs[mode] = {"states": states, "rec": {
            "setup_s": setup_s, "ms": ms,
            "counts": [_counts(x) for x in stats],
            "pressure_error": [x.pressure_error for x in stats],
            "launches": launch_counts()}}
        del solver, disc
        _free_opts()
    limit = REFINE_GAP_FACTOR * bench_data().mech_cg_tol
    gaps = [{name: _rel_err(getattr(on, name), getattr(off, name))
             for name in ("p", "u")}
            for on, off in zip(runs["on"]["states"], runs["off"]["states"])]
    print(json.dumps({"refinement_40": {
        "gpu": gpu_line(), "dtype": "float64",
        "off": runs["off"]["rec"], "on": runs["on"]["rec"],
        "gap": gaps, "limit": limit}}), flush=True)
    for k, gap in enumerate(gaps, 1):
        for name, g in gap.items():
            if not g <= limit:
                raise AssertionError(f"step {k}: refined vs native f64 "
                                     f"{name} gap {g:.3e} > {limit:.1e}")


def block_jacobi_check(dev) -> None:
    """(c) The rows kit at 40^3 f32 with ``Mechanics preconditioner =
    block`` against ``jacobi``: 2 evolving + 1 steady captured steps each,
    every solve converged; counts, ms, the set-up (the block build) and
    the gaps in p and u printed."""
    runs = {}
    for prec in ("jacobi", "block"):
        data = dataclasses.replace(bench_data(), mech_precond=prec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        disc = build_grid_discretization(data, cells_per_axis=N_MAIN,
                                         multigrid="off", device=dev)
        solver = FixedStressSolver(disc, data)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        if (solver._block is not None) != (prec == "block"):
            raise AssertionError(f"{prec}: block preconditioner "
                                 f"{solver._block}")
        cm.reset_launch_counts()
        states, stats, ms = run_steps(solver, N_OPT_EVOLVING, N_OPT_STEADY,
                                      log=False)
        check_steps(states, stats, disc, N_OPT_EVOLVING)
        runs[prec] = {"states": states, "rec": {
            "setup_s": setup_s, "ms": ms,
            "counts": [_counts(x) for x in stats],
            "launches": launch_counts()}}
        del solver, disc
        _free_opts()
    gaps = {name: _rel_err(getattr(runs["block"]["states"][-1], name),
                           getattr(runs["jacobi"]["states"][-1], name))
            for name in ("p", "u")}
    print(json.dumps({"block_jacobi_40": {
        "gpu": gpu_line(), "jacobi": runs["jacobi"]["rec"],
        "block": runs["block"]["rec"], "gap_last_step": gaps}}), flush=True)
    for name, gap in gaps.items():
        if not gap <= CROSS_TOL:
            raise AssertionError(f"block vs Jacobi {name}: gap {gap:.3e}")


def aniso_check(dev) -> None:
    """(d) The 3D deck on a 20 x 10 x 5 box with 80 x 40 x 20 cells, f32,
    the bench's tolerances: the conv kit on the plain stencil (the flat
    kernel takes one n), flat Jacobi-CG mechanics and Jacobi pressure CG
    (no GMG on unequal counts); 2 evolving + 1 steady captured steps with
    every solve checked, equal to eager bit for bit, a profiled evolving and
    steady step, and the elasticity apply's device ms beside its bound."""
    data = dataclasses.replace(bench_data(), domain_size=ANISO_DOMAIN,
                               cells_per_axis=ANISO_CELLS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    disc = build_grid_discretization(data, device=dev)
    solver = FixedStressSolver(disc, data)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if disc.n_pdofs + disc.n_udofs != ANISO_DOFS or disc.row_ops is not None \
            or disc.gmg_precond is not None:
        raise AssertionError(f"anisotropic build: {disc.n_pdofs} + "
                             f"{disc.n_udofs} dofs, kit {disc.row_ops}")
    log = SolveLog(solver)
    cm.reset_launch_counts()
    launches = {}
    run = run_steps_2d(solver, log, N_OPT_EVOLVING, N_OPT_STEADY,
                       tag="aniso", launches=launches)
    captured_vs_eager("aniso", solver, disc, data, captured_run=run)
    prof = profiled_steps(solver, run[0][-1],
                          1.0 + BC_RATE * N_OPT_EVOLVING, "aniso")
    u = torch.as_tensor(np.random.default_rng(3).standard_normal(
        disc.n_udofs), dtype=torch.float32, device=dev)
    apply_ms, apply_host_ms = device_and_host_ms(
        lambda: disc.stencil_elasticity(u))
    cells = int(np.prod(ANISO_CELLS))
    nbytes = 2 * disc.n_udofs * 4
    flop = 2 * 81 * 81 * cells
    t_bytes, t_flop = nbytes / PEAK_BYTES, flop / PEAK_FLOPS[torch.float32]
    print(json.dumps({"aniso_3d": {
        "gpu": gpu_line(), "cells": list(ANISO_CELLS),
        "dofs": disc.n_pdofs + disc.n_udofs, "setup_s": setup_s,
        "ms_per_step": run[2], "counts": [_counts(x) for x in run[1]],
        "launches": launches,
        "profiled": [{k: x[k] for k in ("wall_ms_profiled", "busy_ms",
                                        "idle_share")} for x in prof],
        "elasticity_apply": {"ms": apply_ms, "host_ms": apply_host_ms,
                             "bytes": nbytes, "flop": flop,
                             "bound_ms": max(t_bytes, t_flop) * 1e3,
                             "bound_by": "bytes" if t_bytes >= t_flop
                             else "operations"}}}), flush=True)
    if launches.get("elasticity_grid_apply", 0):
        raise AssertionError("the anisotropic grid launched the flat kernel")
    del solver, disc, log, run
    _free_opts()


def degree_pair_check(dev) -> None:
    """(e) One evolving step of the bench deck with Q2 pressure and Q2
    displacement at 16^3 (the conv kit on plain stencils, the degree-2
    pressure GMG): converged, finite."""
    kp, ku = DEGREE_PAIR
    data = bench_data()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    disc = build_grid_discretization(data, cells_per_axis=N_DEGREE,
                                     pressure_degree=kp,
                                     displacement_degree=ku, device=dev)
    solver = FixedStressSolver(disc, data)
    state = solver.initial_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    p_gmg = solver._pressure_precond(data.time_step) is not None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, stats = solver.time_step(state, data.time_step, 1.0 + BC_RATE,
                                    bc_scale_prev=1.0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    check_state(state, disc.n_pdofs, disc.n_udofs)
    print(json.dumps({"degree_pair": {
        "degrees": [kp, ku], "n": N_DEGREE,
        "dofs": disc.n_pdofs + disc.n_udofs, "pressure_gmg": p_gmg,
        "setup_s": setup_s, "ms": ms, "counts": _counts(stats),
        "cg_converged": stats.cg_converged}}), flush=True)
    if not stats.cg_converged or stats.mech_cg_iterations <= 0:
        raise AssertionError(f"degree pair {DEGREE_PAIR}: {stats}")
    del solver, disc
    _free_opts()


def structured_options_phase(dev, rows_step1, conv_step1, rows_ms) -> None:
    """Phases (a)-(e) of the structured path's solver options, timed."""
    t0 = time.perf_counter()
    gmg_config_phase(dev, rows_step1, conv_step1, rows_ms)
    refinement_check(dev)
    block_jacobi_check(dev)
    aniso_check(dev)
    degree_pair_check(dev)
    print(f"structured options phase: {time.perf_counter() - t0:.1f} s",
          flush=True)


TENSOR_CORE_OP = re.compile(r"\b([DHIBQ]G?MMA)\b")
TMA_LOAD_OP = re.compile(r"\bUTMALDG\b")
FMA_OP = re.compile(r"\b[DF]FMA\b")


def sass_check(lib_path: Path) -> dict:
    """Tensor-core and TMA load instructions per kernel in the built
    library (``cuobjdump -sass``): the float64 cell product pass must hold
    DMMA in each of its instances (the row-layout elasticity apply's, 81
    rows, the projection's, 48 rows, and the flat apply's, 81 rows), so
    must the generic elasticity apply's float64 products (2D and 3D); no
    float32 kernel any tensor-core instruction (no TF32); and every
    instance of the generic product passes (elasticity and Q1, float32 and
    float64, 2D and 3D, the Q1 pass's one- and six-lane, mass and
    Laplacian instances) its tiles' TMA loads (UTMALDG); and no instance
    of the Jacobi-CG update's two kernels (float32 and float64, packed and
    one value a thread) a fused multiply-add (DFMA, FFMA), which would round
    otherwise than the plain torch update they equal bitwise."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    ops, tma, fma, name = {}, {}, {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            ops[name], tma[name], fma[name] = {}, 0, 0
        elif name is not None:
            for op in TENSOR_CORE_OP.findall(line):
                ops[name][op] = ops[name].get(op, 0) + 1
            tma[name] += len(TMA_LOAD_OP.findall(line))
            fma[name] += len(FMA_OP.findall(line))
    # mangled (kernelId / kernelIf, row count Li81E / Li48E) or demangled
    # (kernel<double, 81 / kernel<float); the layout by its struct's name
    products64 = [k for k in ops if re.search(
        r"rows_products_kernel(Id|<double)", k)]
    rows64 = {r: [k for k in products64 if "RowLayout" in k and
                  re.search(rf"Li{r}E|, {r}\b", k)]
              for r in (cp.ELASTICITY_ROWS, cp.PROJECTION_ROWS)}
    rows64["flat"] = [k for k in products64 if "FlatLayout" in k]
    # the generic elasticity apply's float64 products, 2D and 3D
    generic64 = [k for k in ops if re.search(
        r"generic_elasticity_products_kernel(Id|<double)", k)]
    float32 = [k for k in ops if re.search(r"kernel(If|<float)", k)]
    generic = [k for k in ops if re.search(
        r"generic_(elasticity|q1)_products_kernel", k)]
    update = [k for k in ops if re.search(
        r"cg_(jacobi_step|direction)_kernel", k)]
    rec = {"sass": ops, "utmaldg": {k: tma[k] for k in generic},
           "cg_update_fma": {k: fma[k] for k in update}}
    print(json.dumps(rec), flush=True)
    # 2 kernels x 2 dtypes x (16-byte packs, one value a thread)
    if len(update) != 8 or any(fma[k] for k in update):
        raise AssertionError(f"CG update kernels missing or contracted: "
                             f"{rec['cg_update_fma']}")
    # elasticity: 2 dtypes x 2 dims; Q1: 2 dtypes x 2 dims x (1 lane, 6)
    # x (the mass alone, with the Laplacian)
    if len(generic) != 20 or not all(tma[k] > 0 for k in generic):
        raise AssertionError(f"generic product passes without TMA loads: "
                             f"{rec['utmaldg']}")
    if not all(rows64.values()) or len(generic64) != 2 or not all(
            ops[k].get("DMMA", 0) > 0 and set(ops[k]) == {"DMMA"}
            for k in products64 + generic64):
        raise AssertionError(f"float64 products without DMMA: {rows64}, "
                             f"generic {generic64}")
    if not float32 or any(ops[k] for k in float32):
        raise AssertionError("a float32 kernel holds tensor-core "
                             f"instructions: {[ops[k] for k in float32]}")
    return rec


def library_phase(dev, d, records):
    """Every kernel's library yardstick at 40^3: one cuSPARSE CSR SpMV
    (``torch.mv``) over the case's operator assembled on the card
    (``apply_bench.library_csr``, masks folded in), in float64 and float32,
    on the kernel phase's inputs and held against the kernel.  One operator
    at a time, each freed before the next (the largest has 276M
    nonzeros)."""
    n = N_MAIN
    mask = d.free_mask_u.numpy()
    cases = {dtype: {name: (inp, kern) for name, inp, kern, _ in kernel_cases(
        n, dtype, dev, d.element_ke, d.element_ce, d.element_pe, mask,
        np.random.default_rng(n))} for dtype in (torch.float64, torch.float32)}
    ke, ce, pe, m = (torch.as_tensor(a, dtype=torch.float64, device=dev)
                     for a in (d.element_ke, d.element_ce, d.element_pe,
                               cm.to_rows_np(mask, n)))
    out = {}
    for case in apply_bench.LIBRARY_CASES:
        t0 = time.perf_counter()
        M64 = apply_bench.library_csr(case, n, ke, ce, pe, m)
        torch.cuda.synchronize()
        rec = {"assembly_s": time.perf_counter() - t0, "nnz": M64._nnz()}
        for dtype in (torch.float64, torch.float32):
            M = M64 if dtype == torch.float64 else torch.sparse_csr_tensor(
                M64.crow_indices(), M64.col_indices(), M64.values().float(),
                M64.shape)
            inp, kern = cases[dtype][case]
            ms, y = apply_bench.spmv_ms(M, inp)
            ref = kern()
            err = _rel_err(y.view_as(ref), ref)
            name = str(dtype).split(".")[-1]
            rec[name] = {"library_ms": ms, "rel_err_vs_kernel": err}
            records[(case, n, name)]["library_ms"] = ms
            del M, y
            if not err <= TOL[torch.float32]:
                raise AssertionError(f"CSR SpMV vs kernel ({case}, {name}): "
                                     f"rel err {err:.3e}")
        del M64
        torch.cuda.empty_cache()
        out[case] = rec
        print(json.dumps({"library_csr_spmv": {case: rec}}), flush=True)
    return out


def timed_phase(name: str, fn, *args):
    """``fn(*args)``, its wall seconds printed (the sharded phases)."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"{name} phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    print(gpu_line(), flush=True)        # name, power limit (nvidia-smi)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    lib = _cuda.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{lib.build_seconds:.2f} s: one process per source, in parallel, "
          f"{lib.compile_seconds} s each, then one link) -> {lib.path.name}",
          flush=True)

    sass_check(lib.path)
    cg_records = timed_phase("cg update", cg_update_phase, dev)
    records = {}
    slab_rec = None
    for n in KERNEL_SHAPES_N:
        d = build_grid_discretization(bench_data(), cells_per_axis=n,
                                      multigrid="off", device="cpu")
        mask = d.free_mask_u.numpy()
        for dtype in (torch.float64, torch.float32):
            for rec in kernel_phase(n, dtype, dev, d.element_ke,
                                    d.element_ce, d.element_pe, mask,
                                    timing=(n == N_MAIN)):
                records[(rec["name"], n, rec["dtype"])] = rec
        if n == N_MAIN:
            library_phase(dev, d, records)
            # the shape the sharded path launches on one card: a 1-way split
            slab_rec = slab_kernel_phase(dev, d)[(1, "float32")]
            # K6's slab mode at n = 40 and 7; the 4-way split timed
            flat_slab_rec = timed_phase("flat slab kernel",
                                        flat_slab_kernel_phase, dev,
                                        d)["float32"]

    launches, states, stats, ms, solver = main_path(dev)
    captured_vs_eager("rows", solver, solver.disc, solver.data)
    multi_step_phase(solver)
    del solver
    cross_check(dev, states, stats)
    slab_launches = sharded_path_phase(dev, states, stats, ms,
                                       (slab_rec["Lz"], slab_rec["nv"]))
    flat_slab_launches = timed_phase("gspmd", gspmd_phase, dev)
    flat_apply_phase(dev)
    # the kernels line keeps the conv path's own K6 count; the GMG path's
    # is in its "gmg_config" line
    launches["elasticity_grid_apply"], conv_step1 = conv_phase(dev, states)
    structured_options_phase(dev, states[0], conv_step1, ms)
    del states, conv_step1
    timed_phase("2D production", production_2d_phase, dev, *phase_2d(dev))
    timed_phase("generic kernel", generic_kernel_phase, dev)
    generic_disc, generic_states, generic_stats, generic_launches, \
        generic_records = generic_phase(dev)
    timed_phase("psum", psum_phase, dev, generic_disc, generic_states,
                generic_stats)
    timed_phase("ghost split", ghost_split_phase, dev, generic_disc)
    timed_phase("ghost", ghost_phase, dev, generic_disc, generic_states,
                generic_stats)
    del generic_disc, generic_states, generic_stats
    amr_phase(dev)
    timed_phase("adaptive psum", amr_psum_check, dev)
    runner_options_phase(dev)
    cli_phase()

    summary = []
    for name, (src, replaces, timed) in KERNEL_INFO.items():
        rec = records[(timed, N_MAIN, "float32")]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                 "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                 "bound_by": rec["bound_by"],
                 # one CSR SpMV over the assembled operator
                 "library_ms": rec["library_ms"]}
        summary.append(entry)
    summary.append({
        "name": "elasticity_rows_apply[slab]", "route": "cuda",
        "source": "poroelasticity_dealii_torch/csrc/comp_major.cu",
        "replaces": "poroelasticity_dealii_tpu/ops/pallas_comp_major.py:406",
        "launches": slab_launches, "max_abs_err": slab_rec["max_abs_err"],
        # 40^3 float32 at the sharded path's shape (Lz = 41, nv = 40)
        "ms": slab_rec["ms"], "plain_ms": slab_rec["plain_ms"],
        "bound_ms": slab_rec["bound_ms"], "bound_by": slab_rec["bound_by"],
        "library_ms": slab_rec["library_ms"]})
    summary.append({
        "name": "elasticity_grid_apply[slab]", "route": "cuda",
        "source": "poroelasticity_dealii_torch/csrc/comp_major.cu",
        "replaces": "poroelasticity_dealii_tpu/ops/pallas_comp_major.py:1363; "
                    "poroelasticity_dealii_tpu/ops/pallas_elasticity.py:108",
        # the gspmd 40^3 run's launches; 40^3 float32 slab 0 of a 4-way
        # split (nz = 11 cell layers)
        "launches": flat_slab_launches,
        "max_abs_err": flat_slab_rec["max_abs_err"],
        "ms": flat_slab_rec["ms"], "plain_ms": flat_slab_rec["plain_ms"],
        "bound_ms": flat_slab_rec["bound_ms"],
        "bound_by": flat_slab_rec["bound_by"],
        "library_ms": flat_slab_rec["library_ms"]})
    for name, (src, replaces, timed) in GENERIC_KERNEL_INFO.items():
        rec = generic_records[(timed, "float32")]
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            # the generic phase's captured 40^3 run (replays included);
            # 40^3 float32 on the distorted mesh (Q1: the pressure Jacobian)
            "launches": generic_launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    # the main path's float64 row-layout vector, after an L2 flush; one
    # launch of each kernel a fused iteration, so half the counter each
    rec = cg_records[torch.float64]
    for kernel, timed in (("cg_jacobi_step_kernel", "step"),
                          ("cg_direction_kernel", "direction")):
        summary.append({
            "name": kernel, "route": "cuda",
            "source": "poroelasticity_dealii_torch/csrc/cg_update.cu",
            "replaces": "no TPU kernel: XLA fuses the JAX package's CG "
                        "vector algebra",
            "launches": launches["cg_update"] // 2, "max_abs_err": 0.0,
            "dtype": rec["dtype"], "ms": rec["ms"][f"{timed}_kernel"],
            "warm_ms": rec["warm_ms"][f"{timed}_kernel"],
            "plain_ms": rec["ms"][f"{timed}_plain"],
            "bound_ms": rec["bound_ms"][f"{timed}_kernel"],
            "bound_by": "bytes", "library_ms": None})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all",
          flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
