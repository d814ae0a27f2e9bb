"""One run of one cell: set-up, the measured window, the check of what the
window produced, and the result line.

Set-up is everything from the process's start to the window's first step:
imports and the CUDA context, the kernel library (built in the checkout's
``build/torch_kernels/`` on the first run there), the inputs drawn from
the seed, the program's discretization and solver, the start state, and
one warm episode, which captures the cell's CUDA graphs.

The window runs whole episodes back to back, each from the start state,
through ``FixedStressSolver.time_step``, as the program's runner calls it:
one call a step at the deck's load, u asked for on the episode's last
step only, each step
ended by ``torch.cuda.synchronize()`` and timed by the host clock.  It
ends with the first episode that ends after ``seconds``.  With ``trace``
two episodes (:data:`TRACE_EPISODES`) run under ``torch.profiler``, and
the per-layer metrics are read from that trace and the program's
counters.

Then the program's state is freed and the states of three episodes of the
window (the first, one drawn from the seed among the next seven, the last)
are judged against the reference (``portbench/reference/``), built from
the same deck values and mesh arrays.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import subprocess
import sys
import time

import numpy as np
import torch

from . import spec, tracing, traffic, work
from .reference import fem, judge

# the seed draws one checked episode from episodes 1 .. DRAWN_MAX - 1
DRAWN_MAX = 8
# the episodes of the window under the profiler in a traced run: after
# the drawn one, so that the states kept for the check no longer grow the
# caching allocator (its cudaMalloc calls would read as idle device time)
TRACE_EPISODES = (DRAWN_MAX, DRAWN_MAX + 1)
FORBIDDEN = ("jax", "jaxlib", "flax", "poroelasticity_dealii_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _streams(seed: int):
    """Independent generators for the traffic and the sample (any whole
    number seeds them)."""
    entropy = 2 * abs(int(seed)) + (int(seed) < 0)
    return [np.random.default_rng(s)
            for s in np.random.SeedSequence(entropy).spawn(2)]


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads: every step's counts, the
    trace of the traced episodes, the program's launch counters over
    them, and the sizes the kernels' least work counts."""
    stats: list
    trace: dict = None
    launches: dict = None
    sizes: dict = None


def _episode(system, start, sched, sync):
    """One episode from ``start``: its states, step walls and counts."""
    solver, last = system.solver, sched.steps - 1
    state, states, walls, stats = start, [], [], []
    for k in range(sched.steps):
        t = time.perf_counter()
        state, st = solver.time_step(state, system.dt, want_u=k == last)
        sync()
        walls.append(time.perf_counter() - t)
        stats.append(st)
        states.append(state)
    return states, walls, stats


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _sizes(P: fem.Problem, hm, dtype: str) -> dict:
    """What the kernels' least work counts, from the reference's mesh."""
    ph = P.phys
    h = float(hm.vertices[:, 0].max() - hm.vertices[:, 0].min()) / hm.n
    return {"dtype": dtype, "n": hm.n, "cells": int(P.cells.shape[0]),
            "n_udofs": P.n_u,
            "ke_nonzeros": work.nonzeros(
                work.element_stiffness(h, ph.lam, ph.mu))}


@dataclasses.dataclass
class Inputs:
    """What a seed draws for a cell: the episode, the deck with its well
    rate, and the drawn checked episode."""
    schedule: traffic.Schedule
    deck: dict
    drawn: int


def prepare(cell: spec.Cell, seed: int, dtype: str = None) -> Inputs:
    """The :class:`Inputs` that ``seed`` draws for ``cell``: the source's
    deck with the configuration's ``overrides`` over it (and ``dtype``
    over its precision, for the control)."""
    traffic_rng, sample_rng = _streams(seed)
    sched = traffic.schedule(cell.traffic, traffic_rng)
    deck = copy.deepcopy(cell.config["deck"])
    for sub, entries in cell.config.get("overrides", {}).items():
        deck.setdefault(sub, {}).update(entries)
    if dtype is not None:
        deck.setdefault("TPU", {})["Dtype"] = dtype
    props = deck["Properties"]
    props["Flow rate"] = repr(float(props["Flow rate"]) * sched.flow_factor)
    return Inputs(sched, deck, int(sample_rng.integers(1, DRAWN_MAX)))


def reference(hm, numbering: str, deck: dict, dtype, device) -> fem.Problem:
    """The reference's problem on the mesh ``hm`` of a cell."""
    cell_nodes, n_q2 = fem.q2_numbering(hm.cells, len(hm.vertices),
                                        numbering, hm.n)
    return fem.Problem(hm.vertices, hm.cells, cell_nodes, n_q2,
                       fem.physics_from_deck(deck), dtype, device)


def judge_episodes(P: fem.Problem, start: dict, episodes) -> dict:
    """The worst of each number of :mod:`.reference.judge` over
    ``episodes`` (each a list of step fields) from ``start``."""
    numbers = {}
    for steps in episodes:
        got = judge.judge(P, start, steps)
        for k, v in got.items():
            numbers[k] = judge.worst(numbers.get(k, v), v)
    return numbers


@dataclasses.dataclass
class Window:
    """What the measured window ran: every step's wall (s) and counts, its
    length, the states of the episodes kept for the check, and with a
    trace the profiler, its episodes' wall and steps and the program's
    launch counters over them."""
    walls: list
    stats: list
    seconds: float
    kept: dict
    prof: object = None
    traced_s: float = 0.0
    traced_steps: int = 0
    launches: dict = None


def _window(system, start, sched, sync, seconds: float, trace: bool,
            drawn: int, cuda: bool) -> Window:
    """Whole episodes from ``start`` until ``seconds`` have passed (and,
    with ``trace``, the traced episodes have run)."""
    from poroelasticity_dealii_torch.ops import comp_major as cm
    w = Window([], [], 0.0, {})
    ep, t0 = 0, time.perf_counter()
    while ep == 0 or time.perf_counter() < t0 + seconds or (
            trace and ep <= TRACE_EPISODES[-1]):
        if trace and ep == TRACE_EPISODES[0]:
            from torch.profiler import ProfilerActivity, profile
            # on the card, kernels and the runtime calls only: recording
            # every host operator would slow the host-bound loop and read
            # as idle device time
            w.prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                         else ProfilerActivity.CPU])
            cm.reset_launch_counts()
            sync()
            w.prof.start()
            t_tr = time.perf_counter()
        states, walls, stats = _episode(system, start, sched, sync)
        if trace and TRACE_EPISODES[0] <= ep <= TRACE_EPISODES[-1]:
            w.traced_steps += len(walls)
        if trace and ep == TRACE_EPISODES[-1]:
            w.traced_s = time.perf_counter() - t_tr
            w.launches = dict(cm.launch_counts())
            w.prof.stop()
        w.walls += walls
        w.stats += stats
        if ep in (0, drawn):
            w.kept[ep] = states
        w.kept["last"] = states
        ep += 1
    w.seconds = time.perf_counter() - t0
    return w


def run(root, workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", t0: float = None, dtype: str = None):
    """Run cell ``workload`` of ``root``'s benchmark once; returns (the
    result line's dict, the check lines) or raises.  ``dtype`` replaces
    the deck's precision (the control's runs only)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = spec.load(root, workload)
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    inp = prepare(cell, seed, dtype)
    sched = inp.schedule

    system = cell.system().build(cell.config, inp.deck, device)
    start = system.solver.initial_state()
    _episode(system, start, sched, sync)                 # warm episode
    sync()
    setup_s = time.perf_counter() - t0

    win = _window(system, start, sched, sync, seconds, trace, inp.drawn,
                  cuda)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    attempted = len(win.walls)
    failed = sum(1 for s in win.stats if not bool(s.cg_converged)
                 or not np.isfinite(float(s.pressure_error)))
    start_fields = system.fields(start)
    episodes = [[system.fields(s) for s in states]
                for states in win.kept.values()]
    hm, numbering, dtype = system.mesh, system.numbering, system.dtype
    win.kept.clear()
    del start, system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference, after the window and with the program's state freed
    P = reference(hm, numbering, inp.deck, torch.float64, device)
    numbers = judge_episodes(P, start_fields, episodes)
    checks = {k: {"value": numbers[k], "limit": float(cell.limits[k])}
              for k in judge.NUMBERS}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power_limit_w"] = _power_limit()
    metrics, extra = {}, {}
    if trace:
        summary = tracing.summarize(win.prof.events(), win.traced_s * 1e6,
                                    win.traced_steps)
        ctx = Context(win.stats, summary, win.launches, _sizes(P, hm, dtype))
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        dev["busy_s"] = summary["busy_ms"] / 1e3
        dev["window_s"] = summary["wall_ms"] / 1e3
        extra["breakdown"] = tracing.breakdown(summary)
    else:
        values = {"setup_s": setup_s,
                  "step_ms": win.seconds * 1e3 / attempted,
                  "step_ms_p95": float(np.percentile(win.walls, 95)) * 1e3}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev,
              **extra, "checks": checks}
    lines = [f"portbench check {k}: {c['value']!r} (limit {c['limit']!r})"
             for k, c in checks.items()]
    return result, lines
