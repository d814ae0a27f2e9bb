"""Device time of fixed-stress steps by kernel, from ``torch.profiler``:

    python -m poroelasticity_dealii_torch.tools.profile_step [n] [backend] [loop] [site=C ...]

runs the bench configuration (:func:`bench_data`) at ``n`` cells per axis
(default 40) on the card, on the rows backend (default), the conv backend
(``backend`` ``conv``) or the sharded production path on a world-size-1
NCCL process group (``sharded``: the rows kit replaced by the z-slab kit,
every mechanics apply the slab kernel, the pressure stencils on gspmd
slabs), or the gspmd form of the conv backend on that group (``gspmd``:
every stencil on node-plane slabs, the elasticity slab the flat kernel's
slab mode), or the 2D configuration (:func:`data_2d`, ``backend`` ``2d``,
e.g. ``512 2d``: the parity kit with the parity-resident elasticity GMG
from 150,000 displacement dofs, GMG-Richardson in float32; ``2d_sharded``:
the same through the 2D production form on the world-size-1 group, the
y-slab parity kit), or the bench configuration on the distorted hex mesh
of the generic path (``generic``: :func:`generic_mesh`, the generic
discretization's applies, on the card the hand-written generic kernels
for the mass, Laplace, pressure Jacobian and elasticity, flat Jacobi-CG
mechanics and Jacobi pressure CG; ``psum``: the same through the psum form
on the world-size-1 group, one all-reduce per apply; ``ghost``: the same
through the ghost form on that group, every vector sharded and every
reduction all-reduced, its record with what the kit sent in the step,
``kit.comm``), or the adaptive
octree run (``amr``:
:func:`amr_data`, ``n`` the ``Max refinement level``, 5 or 6: 6 or 10
steps from the uniform level-4 mesh with a remesh before every 5th, the
hanging-node constrained generic path), with the solver's CG chunks
captured as CUDA graphs (``loop`` ``captured``, the default; the sharded
forms always run them eagerly) or run eagerly (``eager``), each call
site's chunk size from ``solvers/fss.py::CHUNK`` unless a ``site=C``
argument sets it (e.g. ``mechanics_gmg=1``):
``initial_state``, evolving steps with the Dirichlet load ramp, then steady
steps at the last load (``amr``: steady steps, no ramp; it profiles the
step before the first remesh and the last step, and prints each remesh's
split and every step's wall time).  It profiles the last evolving and the
last steady step and prints one JSON line for each: the step's counts,
its wall time
unprofiled (the step before, of the same kind) and profiled, the device
busy time (union of the device activity intervals) over the profiled wall
span, the host's ``cudaGraphLaunch`` and ``cudaLaunchKernel`` calls, the
graphs captured and replayed in the step by call site, device time and
launches per kernel name, with each kernel wrapper's CUDA kernels also
summed under its name (:data:`WRAPPERS`) beside its calls (replays
included), and the host operators with the most self time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch

DECK = (Path(__file__).resolve().parents[2] / "configs"
        / "consolidation_3d.data")
BC_RATE = 0.05            # per-step Dirichlet load ramp (bench.py BC_RATE)


def bench_data(deck=DECK):
    """The bench configuration (``bench.py::build``): the 3D consolidation
    deck in float32 with tolerances that keep every solver working each
    step."""
    from ..config import read_input_file
    return dataclasses.replace(
        read_input_file(str(deck)), dtype="float32", flow_rate=1e-2,
        fss_tol=2e-5, pressure_tol=2e-5, mech_cg_tol=1e-5,
        mech_cg_relative=True, pressure_cg_tol=1e-5, projection_cg_tol=1e-5)


DECK_2D = DECK.parent / "golden_2d.data"


def data_2d(deck=DECK_2D):
    """The 2D at-scale configuration (``bench.py::build_2d``): the golden
    deck's physics in float32, flow rate 1.0 and the bench tolerances, so
    that every solver works each step at 512^2."""
    from ..config import read_input_file
    return dataclasses.replace(
        read_input_file(str(deck)), dtype="float32", flow_rate=1.0,
        fss_tol=2e-5, pressure_tol=2e-5, mech_cg_tol=1e-5,
        mech_cg_relative=True, pressure_cg_tol=1e-5, projection_cg_tol=1e-5)


def generic_mesh(n: int):
    """The generic path's at-scale mesh: ``hyper_rectangle`` of ``n`` cells
    per axis over the 3D deck's [0, 10]^3, every interior vertex moved by
    up to 0.2 of its cell size (``perturb_interior``, seed 0)."""
    from ..mesh import hyper_rectangle
    from ..mesh.generator import perturb_interior
    return perturb_interior(hyper_rectangle([10.0] * 3, cells_per_axis=n),
                            0.2, seed=0)


AMR_INITIAL_LEVEL = 4     # 4,096 cells, 112,724 DOF
AMR_REFINE_EVERY = 5


def amr_data(max_level: int = 5, deck=DECK):
    """The adaptive at-scale configuration: the bench configuration
    (:func:`bench_data`) on the 3D deck's octree, AMR on from the uniform
    level-4 mesh (4,096 cells, 112,724 DOF), leaves clamped to levels
    4 .. ``max_level``, a remesh before every 5th step (the reference's
    cadence), shape bucketing on, no VTK output."""
    return dataclasses.replace(
        bench_data(deck), amr=True,
        initial_refinement_level=AMR_INITIAL_LEVEL,
        max_refinement_level=max_level, refine_every=AMR_REFINE_EVERY,
        amr_bucketing=True, output_vtk=False)


def _busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, us -> ms."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def _short(name: str) -> str:
    """A kernel's demangled name without its namespace and arguments."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0]


WRAPPERS = ("elasticity_rows_apply", "coupling_rows", "projection_rows",
            "elasticity_grid_apply", "generic_elasticity_apply",
            "generic_q1_apply")


def _wrapper(name: str):
    """The kernel wrapper (:data:`WRAPPERS`) that launches the CUDA kernel
    ``name``, or None.  The applies and the projection share the cell
    product pass, told apart by its input layout (the flat apply's is
    ``FlatLayout``) and row count (81 or 48); the generic applies share
    the plan sum, told apart by its lane count (1 for the elasticity
    apply); older trees' kernel names are recognised too."""
    if "generic_elasticity" in name or re.search(
            r"plan_sum_kernel<\w+, 1\b", name):
        return "generic_elasticity_apply"
    if "generic_q1" in name or "plan_sum_kernel" in name:
        return "generic_q1_apply"
    if any(k in name for k in ("FlatLayout", "elasticity_flat_sum",
                               "elasticity_grid_apply")):
        return "elasticity_grid_apply"
    if "projection" in name or re.search(r"rows_products_kernel<\w+, 48\b",
                                         name):
        return "projection_rows"
    if "coupling_rows" in name:
        return "coupling_rows"
    if "elasticity_rows" in name or "rows_products_kernel" in name:
        return "elasticity_rows_apply"
    return None


RUNTIME_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC")


def device_summary(prof) -> dict:
    """Busy ms, the host's CUDA launch calls (:data:`RUNTIME_CALLS`), and
    per-kernel (ms, launches) of the device events, with each kernel
    wrapper's CUDA kernels also summed under its name.  The program's spans
    (``record_function`` ranges), which the trace may also list on the
    device as user annotations, are no device work and are left out."""
    per = defaultdict(lambda: [0.0, 0])
    intervals = []
    calls = dict.fromkeys(RUNTIME_CALLS, 0)
    for e in prof.events():
        if e.name in calls:
            calls[e.name] += 1
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.is_user_annotation:
            continue
        a, b = e.time_range.start, e.time_range.end
        intervals.append((a, b))
        per[e.name][0] += (b - a) / 1e3
        per[e.name][1] += 1
    out = {"busy_ms": _busy_ms(intervals), "runtime_calls": calls}
    for wrapper in WRAPPERS:
        rows = {_short(k): {"ms": v[0], "launches": v[1]}
                for k, v in per.items() if _wrapper(k) == wrapper}
        out[wrapper] = {
            "ms": sum(v["ms"] for v in rows.values()),
            "kernel_launches": sum(v["launches"] for v in rows.values()),
            "by_kernel": rows}
    out["kernels"] = {k: {"ms": v[0], "launches": v[1]}
                      for k, v in sorted(per.items(),
                                         key=lambda kv: -kv[1][0])}
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    out["host_top_ops"] = {e.key: {"self_ms": e.self_cpu_time_total / 1e3,
                                   "calls": e.count} for e in host[:10]}
    return out


def _step(solver, state, bc, bc_prev):
    """One synced time step; returns (state, stats, wall ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, stats = solver.time_step(state, solver.data.time_step, bc,
                                    bc_scale_prev=bc_prev, want_u=True)
    torch.cuda.synchronize()
    return state, stats, (time.perf_counter() - t0) * 1e3


BACKENDS = ("rows", "conv", "sharded", "gspmd", "2d", "2d_sharded",
            "generic", "psum", "ghost", "amr")
# the backends that run on a world-size-1 process group
SHARDED = ("sharded", "gspmd", "2d_sharded", "psum", "ghost")
LOOPS = ("captured", "eager")


def run(n: int = 40, n_evolving: int = 5, n_steady: int = 3,
        device="cuda", backend: str = "rows", loop: str = "captured") -> list:
    """Profile the last evolving and the last steady step on ``backend``
    (:data:`BACKENDS`) with the CG chunks ``loop`` (:data:`LOOPS`);
    returns their records.  The sharded backends (:data:`SHARDED`)
    initialise a world-size-1 process group here (NCCL on CUDA, gloo on
    the CPU) and destroy it at the end."""
    if backend == "amr":
        return _run_amr(n, device, loop)
    if backend not in SHARDED:
        return _run(n, n_evolving, n_steady, device, backend, loop)
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if torch.device(device).type == "cuda" else "gloo",
            init_method=f"file://{tmp}/pg", rank=0, world_size=1)
        try:
            return _run(n, n_evolving, n_steady, device, backend, loop)
        finally:
            dist.destroy_process_group()


def _run(n, n_evolving, n_steady, device, backend, loop) -> list:
    from ..ops import comp_major as cm
    from ..parallel import (make_slab_group, shard_discretization,
                            shard_discretization_ghost,
                            shard_grid_discretization,
                            shard_production_discretization)
    from ..solvers.discretization import build_discretization
    from ..solvers.fss import CHUNK, FixedStressSolver
    from ..solvers.structured import build_grid_discretization

    if backend in ("generic", "psum", "ghost"):
        data = bench_data()
        disc = build_discretization(generic_mesh(n), data, device=device)
    elif backend in ("2d", "2d_sharded"):
        data = data_2d()
        disc = build_grid_discretization(data, cells_per_axis=n,
                                         multigrid="auto", device=device)
    else:
        data = bench_data()
        disc = build_grid_discretization(
            data, cells_per_axis=n, multigrid="off", device=device,
            elasticity_backend="conv" if backend in ("conv", "gspmd")
            else "auto")
    shard = {"sharded": shard_production_discretization,
             "2d_sharded": shard_production_discretization,
             "gspmd": shard_grid_discretization,
             "psum": shard_discretization,
             "ghost": shard_discretization_ghost}.get(backend)
    if shard is not None:
        disc = shard(disc, make_slab_group(disc.device))
    solver = FixedStressSolver(disc, data,
                               cuda_graphs=loop == "captured")
    graphs = solver.graphs
    state = solver.initial_state()
    records, bc_prev, last_ms = [], 1.0, None
    steps = n_evolving + n_steady
    for k in range(1, steps + 1):
        bc = 1.0 + BC_RATE * min(k, n_evolving)
        kind = "evolving" if k <= n_evolving else "steady"
        if k not in (n_evolving, steps):
            state, _, last_ms = _step(solver, state, bc, bc_prev)
            bc_prev = bc
            continue
        cm.reset_launch_counts()
        kit = getattr(disc, "kit", None)
        if kit is not None:
            kit.comm.reset()
        (state, stats, ms), dev = _profiled(
            solver, lambda: _step(solver, state, bc, bc_prev))
        bc_prev = bc
        calls = cm.launch_counts()
        for wrapper in WRAPPERS:
            dev[wrapper]["calls"] = calls[wrapper]
        dev["elasticity_grid_apply"]["slab_calls"] = calls["grid_slab"]
        records.append({
            "step": k, "kind": kind, "n": n, "backend": backend,
            "loop": "captured" if graphs else "eager",
            "gpu": torch.cuda.get_device_name(),
            "wall_ms_unprofiled_previous_step": last_ms,
            "wall_ms_profiled": ms,
            "idle_share": 1.0 - dev["busy_ms"] / ms,
            "chunks": dict(CHUNK),
            "mechanics": type(disc.row_ops).__name__ if disc.row_ops
            is not None else "flat", "elasticity_gmg": disc.gmg_precond
            is not None,
            "counts": {"fss": stats.fss_iterations,
                       "pressure": stats.pressure_iterations,
                       "cg_pressure": stats.pressure_cg_iterations,
                       "cg_mechanics": stats.mech_cg_iterations,
                       "cg_projection": stats.projection_cg_iterations},
            **({} if kit is None else {"comm": dataclasses.asdict(kit.comm)}),
            **dev})
        last_ms = ms
    return records


@contextlib.contextmanager
def _profiling(solver):
    """``torch.profiler`` around the block; yields a dict that receives,
    at its end, the device summary and the graphs the solver captured and
    replayed during it."""
    from torch.profiler import ProfilerActivity, profile
    graphs = solver.graphs
    before = (dict(graphs.captures), dict(graphs.replays)) if graphs \
        else ({}, {})
    dev = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield dev
    dev.update(device_summary(prof))
    dev["graphs"] = {
        kind: {k: v - old.get(k, 0) for k, v in now.items()}
        for kind, now, old in (
            ("captures", graphs.captures if graphs else {}, before[0]),
            ("replays", graphs.replays if graphs else {}, before[1]))}


def _profiled(solver, fn):
    """Run ``fn`` (one synced step, returning (state, stats, ms)) under
    :func:`_profiling`; returns its result and the device summary."""
    with _profiling(solver) as dev:
        out = fn()
    return out, dev


def _run_amr(max_level, device, loop) -> list:
    """The adaptive run of :func:`amr_data` through the runner's own loop
    (``AMRSimulationRunner.steps``): 6 steps at ``max_level`` 5, 10 at 6;
    every step's wall time and counts, each remesh's split, and the step
    before the first remesh and the last step under the profiler."""
    from ..amr.driver import AMRSimulationRunner

    data = amr_data(max_level)
    n_steps = 6 if max_level <= 5 else 10
    t0 = time.perf_counter()
    runner = AMRSimulationRunner(data, device=device,
                                 cuda_graphs=loop == "captured")
    torch.cuda.synchronize()
    print(json.dumps({"amr_setup": {
        "max_level": max_level, "setup_s": time.perf_counter() - t0,
        **amr_sizes(runner)}}), flush=True)
    records, sizes = [], amr_sizes(runner)
    events = runner.steps(n_steps)
    for kind, _, k in events:
        if kind != "before":
            continue
        if k % data.refine_every == 0:
            print(json.dumps({"amr_remesh": {
                "before_step": k, "remesh_s": runner.timings["remesh_s"],
                "split_s": dict(runner.timings), "before": sizes,
                "after": amr_sizes(runner)}}), flush=True)
        dev = None
        if k in (data.refine_every - 1, n_steps):
            with _profiling(runner.solver) as dev:
                _, _, block = next(events)
        else:
            _, _, block = next(events)
        sizes = amr_sizes(runner)
        for step, stats in block:
            ms = step["wall_s"] * 1e3
            rec = {"step": step["step"], "backend": "amr",
                   "max_level": max_level,
                   "loop": "captured" if runner.solver.graphs else "eager",
                   "gpu": torch.cuda.get_device_name(),
                   "wall_ms": ms, **sizes,
                   "counts": {
                       "fss": stats.fss_iterations,
                       "pressure": stats.pressure_iterations,
                       "cg_pressure": stats.pressure_cg_iterations,
                       "cg_mechanics": stats.mech_cg_iterations,
                       "cg_projection": stats.projection_cg_iterations},
                   "cg_converged": stats.cg_converged}
            if dev is None:
                print(json.dumps(rec), flush=True)
                continue
            rec.update(idle_share=1.0 - dev["busy_ms"] / ms, **dev)
            records.append(rec)
    return records


def amr_sizes(runner) -> dict:
    """Real cells, DOF and hanging rows of an adaptive runner's mesh."""
    d = runner.disc
    sp, su = d.pressure_space, d.displacement_space
    hang = lambda hc: int((hc.weights != 0).any(1).sum())  # noqa: E731
    return {"cells": sp.mesh.n_cells,
            "dofs": sp.n_nodes + sp.mesh.dim * su.n_nodes,
            "hanging_rows": [hang(d._hcp), hang(d._hcu)]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 40
    backend = argv[1] if len(argv) > 1 else "rows"
    loop = argv[2] if len(argv) > 2 else "captured"
    from ..solvers.fss import CHUNK
    for arg in argv[3:]:
        site, size = arg.split("=")
        if site not in CHUNK:
            raise SystemExit(f"profile_step: no call site {site!r} in "
                             f"{sorted(CHUNK)}")
        CHUNK[site] = int(size)
    if backend == "amr" and n not in (5, 6):
        raise SystemExit("profile_step: the amr backend takes the Max "
                         f"refinement level 5 or 6 as n, got {n}")
    if backend not in BACKENDS or loop not in LOOPS:
        raise SystemExit(f"profile_step: backend must be one of {BACKENDS} "
                         f"and loop one of {LOOPS}, got {backend!r}, "
                         f"{loop!r}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device "
                         "(torch.cuda.is_available() is False)")
    for rec in run(n, backend=backend, loop=loop):
        top = dict(list(rec.pop("kernels", {}).items())[:12])
        print(json.dumps({**rec, "top_kernels": top}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
