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
the mix's traced episodes (``trace_episodes``, :mod:`.traffic`) run under
``torch.profiler``, and the per-layer metrics are read from that trace
and the program's counters.

A system whose mesh changes within an episode runs the episode itself
(``System.episode``, see :class:`Ran`): a remesh counts in the wall of
the step it comes before, and the system's return to the start mesh
before each episode is set-up, left out of ``step_ms``.

Then the program's state is freed and the states of three episodes of the
window (the first, one drawn from the seed among the next ``drawn_max``
- 1, the last) are judged against the reference
(``portbench/reference/``), built from the same deck values and mesh
arrays; an episode whose mesh changes is judged mesh by mesh, with each
remesh's marks and transfer (:func:`judge_segments`).
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

from . import meshes, spec, tracing, traffic, work
from .reference import fem, hanging, judge, remesh

# the fields a remesh carries over (the source's SolutionTransfer)
TRANSFERRED = ("p", "eps_v", "eps_v0")
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
    them, the sizes the kernels' least work counts, and every step's
    segment (0 on the episode's start mesh, one more after each
    remesh)."""
    stats: list
    trace: dict = None
    launches: dict = None
    sizes: dict = None
    segments: list = None


@dataclasses.dataclass
class Segment:
    """The mesh a run of an episode's steps lives on: its arrays, the
    coordinates of its Q1 and Q2 nodes in the program's order, the state
    its first step starts from (the episode's start, or what a remesh's
    transfer gave), and the state before that remesh (on the previous
    segment's mesh; None on the start mesh).  States are real-sized."""
    index: int
    mesh: meshes.HexMesh
    x_p: np.ndarray
    x_u: np.ndarray
    start: object
    before: object = None


@dataclasses.dataclass
class Ran:
    """One episode: each step's state, wall (s), counts and
    :class:`Segment` (None: one mesh all through), and the seconds the
    system took before the first step to go back to the start mesh."""
    states: list
    walls: list
    stats: list
    segments: list = None
    return_s: float = 0.0


def _run_episode(system, start, sched, sync) -> Ran:
    """The system's own episode, or :func:`_episode` for a system
    without one."""
    own = getattr(system, "episode", None)
    if own is None:
        return Ran(*_episode(system, start, sched, sync))
    return own(start, sched, sync)


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
    return Inputs(sched, deck,
                  int(sample_rng.integers(1, sched.drawn_max)))


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


def _group(ran: Ran):
    """An episode's steps split where its mesh changes: (segment, its
    steps' states)."""
    groups = []
    for seg, state in zip(ran.segments, ran.states):
        if not groups or groups[-1][0] is not seg:
            groups.append((seg, []))
        groups[-1][1].append(state)
    return groups


def segment_fields(system, ran: Ran) -> list:
    """An episode's meshes as the judge reads them: per segment its mesh,
    node coordinates, start, the state before its remesh and its steps,
    each state as :meth:`System.fields` gives it."""
    out = []
    for seg, states in _group(ran):
        out.append(dict(
            mesh=seg.mesh, x_p=seg.x_p, x_u=seg.x_u,
            start=system.fields(seg.start),
            before=None if seg.before is None else system.fields(seg.before),
            steps=[system.fields(s) for s in states]))
    return out


class References:
    """The reference's problems on the meshes of a run, each built once."""

    def __init__(self, deck: dict, device):
        self.phys = fem.physics_from_deck(deck)
        self.device = device
        self.levels = tuple(int(deck["Mesh"][k]) for k in (
            "Initial refinement level", "Max refinement level"))
        self._made = {}

    def __call__(self, hm: meshes.HexMesh):
        key = (hm.vertices.tobytes(), np.asarray(hm.cells).tobytes())
        if key not in self._made:
            P = hanging.Problem(hanging.Mesh(hm.vertices, hm.cells),
                                self.phys, torch.float64, self.device)
            self._made[key] = (P, remesh.Boxes(P.mesh.X))
        return self._made[key]


def judge_segments(refs: References, episodes) -> dict:
    """The worst of each number over ``episodes`` (each a list of
    :func:`segment_fields`), every segment on the reference's constrained
    problem of its own mesh; each remesh's marks and transfer judged from
    the state before it."""
    numbers = {}

    def note(k, v):
        numbers[k] = judge.worst(numbers.get(k, v), v)
    for segments in episodes:
        prev = None
        for g in segments:
            P, B = refs(g["mesh"])
            read = hanging.Reader(P, g["x_p"], g["x_u"])
            # a transferred start's u and strains are a solve's warm start
            start, gap = read(g["start"] if g["before"] is None else {
                k: g["start"][k] for k in TRANSFERRED})
            steps = []
            for s in g["steps"]:
                fields, g_s = read(s)
                steps.append(fields)
                gap = max(gap, g_s)
            for k, v in judge.judge(P, start, steps,
                                    at_t0=g["before"] is None).items():
                note(k, v)
            note("hanging_gap", gap)
            if g["before"] is not None:
                P0, B0 = refs(prev["mesh"])
                old, _ = hanging.Reader(P0, prev["x_p"], prev["x_u"])(
                    {k: g["before"][k] for k in TRANSFERRED})
                cells0 = P0.mesh.q1.cell_nodes
                old3 = torch.stack([old[k] for k in TRANSFERRED]) \
                    .cpu().numpy()
                masters = np.setdiff1d(np.arange(P.n_p), P.mesh.q1.hanging)
                new3 = torch.stack([start[k] for k in TRANSFERRED]) \
                    .cpu().numpy()[:, masters]
                note("transfer_gap", remesh.transfer_gap(
                    B0, cells0, old3, P.mesh.q1.coords[masters], new3))
                note("marks_mismatch", remesh.marks_mismatch(
                    B0, cells0, old3[0], B, *refs.levels))
            prev = g
    return numbers


@dataclasses.dataclass
class Window:
    """What the measured window ran: every step's wall (s), counts and
    segment, its length and the seconds its episodes spent going back to
    the start mesh, the episodes kept for the check, and with a trace the
    profiler, its episodes' wall and steps and the program's launch
    counters over them."""
    walls: list
    stats: list
    seconds: float
    kept: dict
    prof: object = None
    traced_s: float = 0.0
    traced_steps: int = 0
    launches: dict = None
    segments: list = dataclasses.field(default_factory=list)
    returns: float = 0.0


def _window(system, start, sched, sync, seconds: float, trace: bool,
            drawn: int, cuda: bool) -> Window:
    """Whole episodes from ``start`` until ``seconds`` have passed (and,
    with ``trace``, the traced episodes have run)."""
    from poroelasticity_dealii_torch.ops import comp_major as cm
    w = Window([], [], 0.0, {})
    first, last = sched.trace_episodes
    ep, t0 = 0, time.perf_counter()
    while ep == 0 or time.perf_counter() < t0 + seconds or (
            trace and ep <= last):
        if trace and ep == first:
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
        ran = _run_episode(system, start, sched, sync)
        if trace and first <= ep <= last:
            w.traced_steps += len(ran.walls)
        if trace and ep == last:
            w.traced_s = time.perf_counter() - t_tr
            w.launches = dict(cm.launch_counts())
            w.prof.stop()
        w.walls += ran.walls
        w.stats += ran.stats
        w.segments += [0] * len(ran.walls) if ran.segments is None \
            else [seg.index for seg in ran.segments]
        w.returns += ran.return_s
        if ep in (0, drawn):
            w.kept[ep] = ran
        w.kept["last"] = ran
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
    _run_episode(system, start, sched, sync)             # warm episode
    sync()
    setup_s = time.perf_counter() - t0

    win = _window(system, start, sched, sync, seconds, trace, inp.drawn,
                  cuda)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    attempted = len(win.walls)
    failed = sum(1 for s in win.stats if not bool(s.cg_converged)
                 or not np.isfinite(float(s.pressure_error)))
    adaptive = hasattr(system, "episode")
    if adaptive:
        episodes = [segment_fields(system, ran)
                    for ran in win.kept.values()]
    else:
        start_fields = system.fields(start)
        episodes = [[system.fields(s) for s in ran.states]
                    for ran in win.kept.values()]
    hm, numbering, dtype = system.mesh, system.numbering, system.dtype
    win.kept.clear()
    del start, system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference, after the window and with the program's state freed
    if adaptive:
        refs = References(inp.deck, device)
        numbers = judge_segments(refs, episodes)
        P = refs(hm)[0]
    else:
        P = reference(hm, numbering, inp.deck, torch.float64, device)
        numbers = judge_episodes(P, start_fields, episodes)
    names = judge.NUMBERS + tuple(k for k in judge.ADAPTIVE
                                  if k in cell.limits)
    missing = [k for k in names if k not in numbers]
    if missing:
        raise ValueError(f"portbench: the limits of {workload} name "
                         f"{missing}, which no judged episode gives")
    checks = {k: {"value": numbers[k], "limit": float(cell.limits[k])}
              for k in names}
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
        ctx = Context(win.stats, summary, win.launches, _sizes(P, hm, dtype),
                      win.segments)
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
                  "step_ms": (win.seconds - win.returns) * 1e3
                  / attempted,
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
