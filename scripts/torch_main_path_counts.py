"""Print the solver counts of one tree of the PyTorch port, for comparing
two commits on one card.

    python3 scripts/torch_main_path_counts.py TREE
    python3 scripts/torch_main_path_counts.py TREE f64 DEVICE [CASE ...]
    python3 scripts/torch_main_path_counts.py compare A.log B.log

With only ``TREE`` it runs ``chip_smoke.main_path`` (the 40^3 float32
bench configuration, 5 evolving + 3 steady captured steps) of the tree
whose root is ``TREE``, after building that tree's kernels, and prints
one line ``MAIN_PATH_COUNTS {...}``: kernel launches, graph captures and
replays, counts and step times.

With ``f64`` it runs that tree's generic path in float64 on ``DEVICE``
(``cuda`` or ``cpu``) and prints one line ``F64_COUNTS {...}`` per case,
each step's (FSS, pressure, CG) counts and ``pressure_error``; the cases
(all by default):

* ``generic40``: the distorted 40^3 bench configuration, 3 steps through
  ``FixedStressSolver``, each step's ms too (3^3 on the CPU);
* ``generic40_first``: its first step alone under ``cProfile`` (the
  functions that took the most host time, cumulative and own), then the
  first step of a second solver on the same discretization, unprofiled:
  what the first step pays once a process, once a solver and every time;
* ``irregular3d``: ``configs/irregular_3d.msh`` with the 3D deck, 6 steps,
  mechanics tolerance 1e-10 relative;
* ``irregular2d``, ``adaptive``: the decks ``configs/irregular_2d.data``
  and ``configs/golden_2d_adaptive.data`` through ``run_from_data`` (their
  run logs; mechanics tolerance 1e-12 absolute, the decks' own);
* ``adaptive_relative``: the adaptive deck with the mechanics tolerance of
  ``chip_smoke.py``'s ghost CLI pair, 1e-10 relative.

``compare`` prints, for every case of both logs (each log of one tree on
one device), how many steps have equal counts, each step whose counts
differ, the largest relative gap of ``pressure_error`` and the step ms
of both.

To compare two commits on one card, unpack the older one with ``git
archive`` into ``build/parent`` and run, in one command, in the order
parent, change, change, parent:

    S=$PWD/scripts/torch_main_path_counts.py
    for t in $PWD/build/parent $PWD $PWD $PWD/build/parent; do
        (cd $t && PYTHONPATH=$t python3 $S $t)
    done
"""

import dataclasses
import json
import sys
import time

F64_CASES = ("generic40", "irregular3d", "irregular2d", "adaptive",
             "adaptive_relative")
PROFILE_TOP = 25      # entries of each cProfile ranking printed


def main(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from poroelasticity_dealii_torch.ops import _cuda
    from poroelasticity_dealii_torch.ops import comp_major as cm
    _cuda.library()
    launches, states, stats, ms, solver = cs.main_path(torch.device("cuda"))
    modes = cs.mode_launches()
    print("MAIN_PATH_COUNTS " + json.dumps({
        "tree": tree, "gpu": cs.gpu_line(), "launches": launches,
        "modes": {"unmasked": modes[cm.UNMASKED], "free": modes[cm.FREE],
                  "constrained": modes[cm.CONSTRAINED]},
        "captures": dict(solver.graphs.captures),
        "replays": dict(solver.graphs.replays),
        "counts": [cs._counts(s) for s in stats], "ms": ms}), flush=True)


def _steps(disc, data, n, dev):
    import torch

    from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver
    solver = FixedStressSolver(disc, data)
    st = solver.initial_state()
    out = []
    for k in range(1, n + 1):
        t0 = time.perf_counter()
        st, s = solver.time_step(st, data.time_step, 1.0 + 0.05 * k,
                                 bc_scale_prev=1.0 + 0.05 * (k - 1))
        if dev == "cuda":
            torch.cuda.synchronize()
        out.append({"step": k, "counts": [
            s.fss_iterations, s.pressure_iterations,
            s.pressure_cg_iterations, s.mech_cg_iterations,
            s.projection_cg_iterations], "pressure_error": s.pressure_error,
            "ms": (time.perf_counter() - t0) * 1e3})
    return out


def _first_step(disc, data, tree: str) -> dict:
    """The first step of a new solver on ``disc`` under ``cProfile`` and,
    after it, the first step of a second new solver, unprofiled."""
    import cProfile
    import pstats

    import torch
    prof = cProfile.Profile()
    prof.enable()
    first = _steps(disc, data, 1, "cuda")[0]
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats

    def top(key: int) -> list:
        rows = sorted(stats.items(), key=lambda kv: -kv[1][key])
        return [[f"{f.replace(tree, '.')}:{line}({fn})", nc, tt * 1e3,
                 ct * 1e3]
                for (f, line, fn), (_, nc, tt, ct, _) in rows[:PROFILE_TOP]]
    return {"profiled_step": first, "by_cumulative_ms": top(3),
            "by_own_ms": top(2),
            "second_solver_step": _steps(disc, data, 1, "cuda")[0]}


def _deck_steps(case, deck, dev, **changes):
    from poroelasticity_dealii_torch.config import read_input_file
    from poroelasticity_dealii_torch.models.runner import run_from_data
    out = f"build/f64_counts/{case}_{dev}"
    run_from_data(dataclasses.replace(
        read_input_file(deck), output_vtk=False, output_directory=out,
        **changes), device=dev)
    with open(f"{out}/run_log.jsonl") as f:
        return [{"step": r["step"], "counts": [
            r["fss_iterations"], r["pressure_iterations"], r["cg_iterations"]],
            "pressure_error": r["pressure_error"]}
            for r in map(json.loads, f)]


def f64(tree: str, dev: str, cases) -> None:
    sys.path.insert(0, tree)
    from poroelasticity_dealii_torch.config import read_input_file
    from poroelasticity_dealii_torch.mesh import read_msh
    from poroelasticity_dealii_torch.solvers.discretization import \
        build_discretization
    from poroelasticity_dealii_torch.tools.profile_step import bench_data, \
        generic_mesh

    relative = {"mech_cg_relative": True, "mech_cg_tol": 1e-10}
    if dev == "cuda":
        from poroelasticity_dealii_torch.ops import _cuda
        _cuda.library()       # the kernel build stays out of the steps
    for case in cases:
        if case == "generic40":
            data = dataclasses.replace(bench_data(), dtype="float64")
            d = build_discretization(
                generic_mesh(40 if dev == "cuda" else 3), data, device=dev)
            steps = _steps(d, data, 3, dev)
        elif case == "generic40_first":
            data = dataclasses.replace(bench_data(), dtype="float64")
            d = build_discretization(generic_mesh(40), data, device=dev)
            print("F64_FIRST_STEP " + json.dumps({
                "tree": tree, **_first_step(d, data, tree)}), flush=True)
            continue
        elif case == "irregular3d":
            data = dataclasses.replace(
                read_input_file("configs/consolidation_3d.data"), **relative)
            d = build_discretization(read_msh("configs/irregular_3d.msh",
                                              dim=3), data, device=dev)
            steps = _steps(d, data, 6, dev)
        elif case == "irregular2d":
            steps = _deck_steps(case, "configs/irregular_2d.data", dev)
        elif case in ("adaptive", "adaptive_relative"):
            steps = _deck_steps(case, "configs/golden_2d_adaptive.data", dev,
                                **(relative if case != "adaptive" else {}))
        else:
            raise SystemExit(f"no case {case!r}; cases: {F64_CASES}, "
                             "generic40_first")
        print("F64_COUNTS " + json.dumps({"tree": tree, "case": case,
                                          "device": dev, "steps": steps}),
              flush=True)


def compare(log_a: str, log_b: str) -> None:
    runs = []
    for path in (log_a, log_b):
        with open(path) as f:
            runs.append({r["case"]: r for r in (
                json.loads(line.split(" ", 1)[1]) for line in f
                if line.startswith("F64_COUNTS "))})
    for case in sorted(set(runs[0]) & set(runs[1])):
        a, b = runs[0][case]["steps"], runs[1][case]["steps"]
        same = sum(x["counts"] == y["counts"] for x, y in zip(a, b))
        gap = max(abs(x["pressure_error"] / y["pressure_error"] - 1)
                  for x, y in zip(a, b))
        print(f"{case} ({runs[0][case]['device']} / "
              f"{runs[1][case]['device']}): steps {len(a)} / {len(b)}, counts "
              f"equal in {same}, largest relative pressure_error gap "
              f"{gap:.3e}")
        for x, y in zip(a, b):
            if x["counts"] != y["counts"]:
                print(f"   step {x['step']}: {x['counts']} / {y['counts']}")
        if "ms" in a[0]:
            print("   ms", [round(x["ms"], 1) for x in a], "/",
                  [round(y["ms"], 1) for y in b])


if __name__ == "__main__":
    if sys.argv[1] == "compare":
        compare(sys.argv[2], sys.argv[3])
    elif sys.argv[2:3] == ["f64"]:
        f64(sys.argv[1], sys.argv[3], sys.argv[4:] or F64_CASES)
    else:
        main(sys.argv[1])
