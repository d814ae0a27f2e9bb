"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``poroelasticity_dealii_torch/csrc``,
holds each kernel against its plain PyTorch twin on the card, drives the
main path (3D Q2/Q1 fixed-stress steps at 40^3, float32, the bench
configuration) through the port's entry points, cross-checks it against a
run on the plain twins, runs the CLI on the 3D deck, and prints as its last
line ``{"ok": true, "device": {...}}``.  Any failure exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from poroelasticity_dealii_torch import read_input_file
from poroelasticity_dealii_torch.ops import _cuda
from poroelasticity_dealii_torch.ops import comp_major as cm
from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver
from poroelasticity_dealii_torch.solvers.structured import \
    build_grid_discretization

REPO = Path(__file__).resolve().parent

KERNEL_SHAPES_N = (40, 7)
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}   # relative to max |plain|


def cuda_time_ms(fn, reps: int = 20) -> float:
    """Median device time of ``fn()`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _rel_err(got, ref) -> float:
    scale = ref.abs().max().item()
    return (got - ref).abs().max().item() / (scale if scale > 0 else 1.0)


def kernel_cases(n: int, dtype, dev, ke, ce, pe, free_mask_u, rng):
    """[(name, kernel fn, plain fn)] for every kernel at grid size n."""
    g = 2 * n + 1
    u = rng.standard_normal(g ** 3 * 3)
    x = cm.to_rows(torch.as_tensor(u, dtype=dtype, device=dev), n)
    m = torch.as_tensor(cm.to_rows_np(free_mask_u, n), dtype=dtype,
                        device=dev)
    xf = x * m                                  # free-subspace input
    p = torch.as_tensor(rng.standard_normal((n + 1) ** 3), dtype=dtype,
                        device=dev)
    K, Cm, P = (torch.as_tensor(a, dtype=dtype, device=dev)
                for a in (ke, ce, pe))
    return [
        ("elasticity_rows_apply[unmasked]",
         lambda: cm.elasticity_rows_apply(x, None, K, n, cm.UNMASKED),
         lambda: cm.elasticity_rows_apply_plain(x, None, K, n, cm.UNMASKED)),
        ("elasticity_rows_apply[free]",
         lambda: cm.elasticity_rows_apply(xf, m, K, n, cm.FREE),
         lambda: cm.elasticity_rows_apply_plain(xf, m, K, n, cm.FREE)),
        ("elasticity_rows_apply[constrained]",
         lambda: cm.elasticity_rows_apply(x, m, K, n, cm.CONSTRAINED),
         lambda: cm.elasticity_rows_apply_plain(x, m, K, n,
                                                cm.CONSTRAINED)),
        ("coupling_rows",
         lambda: cm.coupling_rows(p, Cm, n),
         lambda: cm.coupling_rows_plain(p, Cm, n)),
        ("projection_rows",
         lambda: cm.projection_rows(x, P, n),
         lambda: cm.projection_rows_plain(x, P, n)),
    ]


def kernel_phase(n: int, dtype, dev, ke, ce, pe, free_mask_u, timing: bool):
    """Compare every kernel with its plain twin at grid size n; assert the
    tolerance and bitwise repeatability; return one record per kernel."""
    rng = np.random.default_rng(n)
    out = []
    for name, kern, plain in kernel_cases(n, dtype, dev, ke, ce, pe,
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
            rec["ms"] = cuda_time_ms(kern)
            rec["plain_ms"] = cuda_time_ms(plain)
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
}
BC_RATE = 0.05            # per-step Dirichlet load ramp (bench.py BC_RATE)
N_EVOLVING, N_STEADY = 5, 3
N_MAIN = 40               # 40^3 cells: 81^3*3 + 41^3 = 1,663,244 DOF
CROSS_TOL = 1e-4          # plain-vs-kernel fields, relative to max |field|


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def bench_data():
    """The bench configuration (bench.py::build): the 3D consolidation deck
    in float32 with tolerances that keep every solver working each step."""
    data = read_input_file(str(REPO / "configs" / "consolidation_3d.data"))
    return dataclasses.replace(
        data, dtype="float32", flow_rate=1e-2, fss_tol=2e-5,
        pressure_tol=2e-5, mech_cg_tol=1e-5, mech_cg_relative=True,
        pressure_cg_tol=1e-5, projection_cg_tol=1e-5)


def run_steps(solver, n_evolving, n_steady, log):
    """initial_state, evolving steps (bc_scale = 1 + 0.05 k), then steady
    steps at the last scale; returns (states after each step, stats)."""
    dt = solver.data.time_step
    state = solver.initial_state()
    states, stats_all = [], []
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
    return states, stats_all


def check_state(state, n_pdofs, n_udofs):
    for name, t, shape in (("p", state.p, (n_pdofs,)),
                           ("u", state.u, (n_udofs,)),
                           ("eps_v", state.eps_v, (n_pdofs,)),
                           ("strains", state.strains, (6, n_pdofs))):
        if tuple(t.shape) != shape:
            raise AssertionError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} has non-finite values")


def main_path(dev):
    """The bench configuration through the port's entry points, kernels
    counted; returns (launch counts, states, stats)."""
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
    states, stats = run_steps(solver, N_EVOLVING, N_STEADY, log=True)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in cm.KERNEL_WRAPPERS}
    print(f"main path: initial_state + {N_EVOLVING} evolving + {N_STEADY} "
          f"steady steps in {time.perf_counter() - t0:.2f} s, launches "
          f"{launches}", flush=True)
    for k, (st, s) in enumerate(zip(states, stats), 1):
        check_state(st, disc.n_pdofs, disc.n_udofs)
        if not s.cg_converged:
            raise AssertionError(f"step {k}: a linear solve did not converge")
    for k, s in enumerate(stats[:N_EVOLVING], 1):
        if s.mech_cg_iterations <= 0:
            raise AssertionError(f"evolving step {k}: no mechanics CG work")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched on the main "
                                 "path")
    return launches, states, stats


def cross_check(dev, states, stats):
    """Two evolving steps on the plain twins vs the kernel run."""
    data = bench_data()
    disc = build_grid_discretization(data, cells_per_axis=N_MAIN,
                                     multigrid="off", device=dev,
                                     kernels="plain")
    plain_states, plain_stats = run_steps(FixedStressSolver(disc, data), 2,
                                          0, log=False)
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


def cli_phase():
    """The CLI on the 3D deck as written (8^3, float64, 6 steps)."""
    deck = REPO / "configs" / "consolidation_3d.data"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "poroelasticity_dealii_torch", "run",
             str(deck), "--device", "cuda"], cwd=tmp, env=env,
            capture_output=True, text=True, timeout=600)
        sys.stdout.write(res.stderr[-2000:])
        if res.returncode != 0:
            raise AssertionError(f"CLI run failed ({res.returncode}):\n"
                                 f"{res.stdout}\n{res.stderr}")
        out = Path(tmp) / "solution"
        vtks = sorted(out.glob("solution-*.vtk"))
        log = out / "run_log.jsonl"
        if len(vtks) != 7 or not log.exists():
            raise AssertionError(f"CLI output incomplete: {len(vtks)} VTK "
                                 f"files, run log {log.exists()}")
        n_log = len(log.read_text().splitlines())
        print(f"cli: {len(vtks)} VTK files, {n_log} run-log records in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    print(gpu_line(), flush=True)        # name, power limit (nvidia-smi)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    lib = _cuda.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_seconds:.2f} s) -> {lib.path.name}", flush=True)

    records = {}
    for n in KERNEL_SHAPES_N:
        d = build_grid_discretization(bench_data(), cells_per_axis=n,
                                      multigrid="off", device="cpu")
        mask = d.free_mask_u.numpy()
        for dtype in (torch.float64, torch.float32):
            for rec in kernel_phase(n, dtype, dev, d.element_ke,
                                    d.element_ce, d.element_pe, mask,
                                    timing=(n == N_MAIN)):
                records[(rec["name"], n, rec["dtype"])] = rec

    launches, states, stats = main_path(dev)
    cross_check(dev, states, stats)
    cli_phase()

    summary = []
    for name, (src, replaces, timed) in KERNEL_INFO.items():
        rec = records[(timed, N_MAIN, "float32")]
        summary.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"]})
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
