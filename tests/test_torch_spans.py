"""The port's recorder of spans and counters (``utils/profiling.py``) and the
benchmark's readers of it (``portbench/spans.py``, ``portbench/metrics/``).

On the CPU: spans nest and share their step's id in a bounded buffer; a CG
solve's host reads and frozen iterations are what its count and chunk size
imply; a step gives the same fields and counts with a profiler recording
and without one; each reader gives the known answer on a hand-built
recorder and context, the clock fit and the idle split too.  On the card
(``cuda`` marker, skipped without one), a few steps of the structured 40^3
cell under the benchmark's CUDA-only profiler: the fit's anchors and
residual, and the idle split against the trace's idle.

    python -m pytest --noconftest tests/test_torch_spans.py -m cuda
"""

import dataclasses
import math
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from poroelasticity_dealii_torch.solvers.cg import cg_solve  # noqa: E402
from poroelasticity_dealii_torch.solvers.fss import StepStats  # noqa: E402
from poroelasticity_dealii_torch.utils import profiling  # noqa: E402
from portbench import harness, spans, spec, tracing  # noqa: E402

PHASE_METRICS = {"fss.pressure_loop_ms_per_step": "fss.pressure_loop",
                 "fss.mechanics_ms_per_step": "fss.mechanics",
                 "fss.projection_ms_per_step": "fss.projection"}
IDLE_METRICS = {"fss.pressure_loop_idle_ms_per_step": "fss.pressure_loop",
                "fss.mechanics_idle_ms_per_step": "fss.mechanics",
                "fss.projection_idle_ms_per_step": "fss.projection"}


@pytest.fixture
def rec(monkeypatch):
    """The process recorder, emptied for the test and restored after it."""
    r = profiling.RECORDER
    for k, v in vars(profiling.Recorder()).items():
        monkeypatch.setattr(r, k, v)
    return r


def _reader(name):
    return spec.load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                            f"test_spans_{name.replace('.', '_')}")


def _system(workload, n, device="cpu"):
    cell = spec.load(ROOT, workload)
    cell.config["cells_per_axis"] = n
    inp = harness.prepare(cell, 2 ** 31 + 11)
    return cell.system().build(cell.config, inp.deck, torch.device(device))


# ------------------------------------------------------------ the recorder

def test_spans_nest_share_the_step_id_and_the_buffer_stays_bounded():
    r = profiling.Recorder(max_steps=3)
    with r.span("outside"):            # no step open: nothing kept
        pass
    for _ in range(5):
        with r.step():
            with r.span("fss.pressure_loop"):
                with r.span("inner", "a", 2):
                    r.count("host_reads", "x")
            with r.span("fss.mechanics"):
                pass
            r.count("host_reads", "x", 2)
            r.count("chunk_steps", "y", 8)
    assert len(r.steps) == 3
    assert [s.step for s in r.steps] == [3, 4, 5]
    assert r.counts[("host_reads", "x")] == 15
    for s in r.steps:
        names = [(x.name, x.attrs, x.parent) for x in s.spans]
        assert names == [("fss.step", (), None), ("fss.pressure_loop", (), 0),
                         ("inner", ("a", 2), 1), ("fss.mechanics", (), 0)]
        for x in s.spans:
            assert x.end >= x.start
            if x.parent is not None:
                p = s.spans[x.parent]
                assert p.start <= x.start and x.end <= p.end
        assert s.counts == {"host_reads": {"x": 3}, "chunk_steps": {"y": 8}}
        assert s.total("host_reads") == 3 and not s.profiled


def test_leaf_spans_only_while_a_profiler_records(rec):
    with profiling.step():
        assert profiling.leaf("cg.solve", "s") is profiling._NULL
    assert not rec.steps[-1].profiled and len(rec.steps[-1].spans) == 1
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.step():
            with profiling.span("fss.mechanics"):
                with profiling.leaf("cg.solve", "mechanics"):
                    assert profiling.read("mechanics",
                                          torch.tensor(True).__bool__)
    last = rec.steps[-1]
    assert last.profiled
    assert [(s.name, s.attrs, s.parent) for s in last.spans] == [
        ("fss.step", (), None), ("fss.mechanics", (), 0),
        ("cg.solve", ("mechanics",), 1), ("cg.host_read", ("mechanics",), 2)]
    names = {e.name for e in prof.events()}
    assert {"fss.step", "fss.mechanics", "cg.solve[mechanics]",
            "cg.host_read[mechanics]"} <= names


def test_launch_counters_live_in_the_one_registry(rec):
    from poroelasticity_dealii_torch.ops import comp_major as cm
    assert set(cm.launch_counts()) == set(cm.LAUNCH_KEYS)
    cm.add_launch_counts(dict.fromkeys(cm.LAUNCH_KEYS, 2))
    assert rec.counts[("launches", "coupling_rows")] == 2
    assert rec.counts[("launches", ("mode", cm.FREE))] == 2
    # a graph's delta holds only the counters its capture moved
    cm.add_launch_counts({"coupling_rows": 1})
    assert cm.launch_counts()["coupling_rows"] == 3
    assert cm.launch_counts()["projection_rows"] == 2
    rec.count("host_reads", "pressure")
    cm.reset_launch_counts()
    assert set(cm.launch_counts().values()) == {0}
    assert rec.counts[("host_reads", "pressure")] == 1


@pytest.mark.parametrize("chunk", [1, 2, 3, 8])
def test_host_reads_and_frozen_iterations_of_a_cg_solve(rec, chunk):
    n = 40
    rng = np.random.default_rng(chunk)
    m = rng.standard_normal((n, n))
    a = torch.as_tensor(m @ m.T + n * np.eye(n))
    b = torch.as_tensor(rng.standard_normal(n))
    with profiling.step():
        res = cg_solve(lambda x: a @ x, b, torch.zeros_like(b), diag=a.diag(),
                       tol=1e-10, max_iter=200, chunk=chunk,
                       graph_key=("site",))
    k = int(res.iterations)
    assert bool(res.converged) and 0 < k < 200
    got = rec.steps[-1].counts
    # one read per chunk, and the last read finds the solve stopped
    assert got["host_reads"] == {"site": math.ceil(k / chunk) + 1}
    frozen = got["chunk_steps"]["site"] - k
    assert 0 <= frozen <= chunk - 1


def test_tracing_changes_no_result(rec):
    """A profiler recording the leaf spans changes no field and no count."""
    from torch.profiler import ProfilerActivity, profile
    system = _system("rows40-hold", 3)
    s0 = system.solver.initial_state()
    runs = []
    for traced in (False, True):
        ctx = profile(activities=[ProfilerActivity.CPU]) if traced \
            else profiling._NULL
        with ctx:
            st, stats = s0, []
            for k in range(3):
                st, s = system.solver.time_step(st, system.dt,
                                                want_u=k == 2)
                stats.append(s)
        runs.append((st, stats, [dict(r.counts) for r in rec.steps][-3:]))
    (a, sa, ca), (b, sb, cb) = runs
    assert [r.profiled for r in rec.steps][-6:] == [False] * 3 + [True] * 3
    for x, y in zip(sa, sb):
        for f in dataclasses.fields(StepStats):
            assert np.array_equal(getattr(x, f.name), getattr(y, f.name))
    for f in ("p", "u", "eps_v", "strains"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert ca == cb


def test_a_step_records_its_phases_counts_and_cg_counts(rec):
    system = _system("distorted40-hold", 3)
    st = system.solver.initial_state()
    st, s = system.solver.time_step(st, system.dt)
    r = rec.steps[-1]
    assert r.cg == {"pressure_cg_iterations": s.pressure_cg_iterations,
                    "mech_cg_iterations": s.mech_cg_iterations,
                    "projection_cg_iterations": s.projection_cg_iterations}
    names = [x.name for x in r.spans]
    assert names[0] == "fss.step"
    assert names.count("fss.pressure_loop") == names.count(
        "fss.mechanics") == s.fss_iterations
    # the volumetric projection per FSS iteration, the shear one after
    assert names.count("fss.projection") == s.fss_iterations + 1
    assert all(x.parent == 0 for x in r.spans[1:])
    reads = r.counts["host_reads"]
    assert reads["stats"] == 1 and reads["fss_residual"] == s.fss_iterations
    assert reads["pressure_residual"] == \
        s.fss_iterations + s.pressure_iterations
    frozen = r.total("chunk_steps", ("mechanics", "pressure")) \
        - s.mech_cg_iterations - s.pressure_cg_iterations
    assert 0 <= frozen


# ------------------------------------------------------------ the readers

@dataclasses.dataclass
class _Stats:
    pressure_cg_iterations: int
    mech_cg_iterations: int
    projection_cg_iterations: int


def _record(r, step, t0, profiled, phases, reads=(), cg=(3, 10, 20),
            chunk_steps=None):
    """A hand-built record: root span [t0, t0 + 100 us], ``phases`` (name,
    start, end) in us from t0, ``reads`` host-read spans (start, end)."""
    rec = profiling.StepRecord(step, profiled)
    us = 1000
    rec.spans.append(profiling.Span("fss.step", (), t0, None))
    rec.spans[0].end = t0 + 100 * us
    for name, a, b in phases:
        s = profiling.Span(name, (), t0 + a * us, 0)
        s.end = t0 + b * us
        rec.spans.append(s)
    for a, b in reads:
        s = profiling.Span("cg.host_read", ("pressure",), t0 + a * us, 1)
        s.end = t0 + b * us
        rec.spans.append(s)
    rec.counts = {"host_reads": {"pressure": 5, "stats": 1},
                  "chunk_steps": chunk_steps or {"pressure": 4,
                                                 "mechanics": 16,
                                                 "projection": 24}}
    rec.cg = dict(zip(spans.CG_FIELDS, cg))
    r.steps.append(rec)
    return _Stats(*cg)


PHASES = [("fss.pressure_loop", 10, 30), ("fss.mechanics", 30, 70),
          ("fss.projection", 70, 90)]


def _program_counters(ctx) -> tuple:
    return tuple(_reader(name).read(ctx) for name in (
        "fss.pressure_loop_ms_per_step", "fss.mechanics_ms_per_step",
        "fss.projection_ms_per_step", "cg.host_reads_per_step",
        "cg.frozen_iters_per_step"))


def test_program_counter_readers_on_a_hand_built_recorder(rec):
    t0 = 1_760_000_000_000_000_000
    stats = [_record(rec, 1, t0, False, PHASES),
             _record(rec, 2, t0 + 10 ** 9, False, PHASES[:2]),
             _record(rec, 3, t0 + 2 * 10 ** 9, True, PHASES)]
    # no step after the profiled one: the two before it; 16 + 4 chunk
    # steps against 10 + 3 live iterations
    assert _program_counters(harness.Context(stats)) == pytest.approx(
        (0.020, 0.040, 0.010, 6, 7))
    stats.append(_record(rec, 4, t0 + 3 * 10 ** 9, False, [
        ("fss.mechanics", 0, 100)],
        chunk_steps={"pressure": 5, "mechanics": 11}))
    # the step after the profiled one only: 11 + 5 against 13
    assert _program_counters(harness.Context(stats)) == pytest.approx(
        (0.0, 0.100, 0.0, 6, 3))
    stats.append(_record(rec, 5, t0 + 4 * 10 ** 9, False, PHASES))
    ctx = harness.Context(stats)
    assert _program_counters(ctx) == pytest.approx(
        (0.010, 0.070, 0.010, 6, 5))
    # a window whose counts are not the recorder's reads nothing
    wrong = harness.Context(stats[:2] + [_Stats(3, 11, 20)] + stats[3:])
    for name in list(PHASE_METRICS) + ["cg.host_reads_per_step",
                                       "cg.frozen_iters_per_step"]:
        assert _reader(name).read(wrong) is None
        assert _reader(name).read(harness.Context([])) is None
    # a window longer than the recorder holds reads nothing either
    assert spans.window(harness.Context(stats * 2)) is None


def test_readers_read_nothing_without_the_recorder(monkeypatch):
    monkeypatch.delattr(profiling, "RECORDER")
    ctx = harness.Context([_Stats(1, 2, 3)], trace={"device_events": 1})
    for name in list(PHASE_METRICS) + list(IDLE_METRICS) + [
            "cg.host_reads_per_step", "cg.frozen_iters_per_step"]:
        assert _reader(name).read(ctx) is None


def _trace(offset_us, reads_us, device_us, extra_syncs=()):
    """A summary as ``tracing.summarize`` gives it: one cudaStreamSynchronize
    in the middle of each host read (at trace time = host time - offset),
    other syncs, and device intervals."""
    host = []
    for a, b in reads_us:
        m = (a + b) / 2 - offset_us
        host.append((m - 1.0, m + 1.0, "cudaStreamSynchronize"))
    host += [(t - offset_us, t - offset_us + 2, "cudaDeviceSynchronize")
             for t in extra_syncs]
    host.append((0.0, 1.0, "cudaGraphLaunch"))
    device = [(a - offset_us, b - offset_us, "k") for a, b in device_us]
    return {"device_events": len(device), "_device": device, "_host": host,
            "steps": 1, "wall_ms": 0.1, "busy_ms": 0.0}


def test_clock_fit_and_idle_split_on_synthetic_intervals(rec):
    t0 = 1_760_000_000_123_456_789
    reads = [(12, 14), (25, 28), (40, 41), (68, 69.5), (80, 82)]
    stats = [_record(rec, 1, t0 - 10 ** 9, False, PHASES),
             _record(rec, 2, t0, True, PHASES, reads)]
    # host us from t0 (the first read's span starts at t0 + 12 us)
    device = [(0, 5), (8, 20), (18, 26), (35, 60), (75, 95)]
    # the trace's clock starts 1234.5 us after the host's t0
    offset = 1234.5
    trace = _trace(offset, reads, device, extra_syncs=(99.5,))
    ctx = harness.Context(stats, trace)
    fit = spans.fit_clock(rec.steps, trace)
    assert fit.matched == 1.0 and fit.residual_ns == pytest.approx(0, abs=1)
    # host ns = base + offset + trace ns, base the first read's start
    assert fit.base == t0 + 12_000
    assert fit.offset == pytest.approx(offset * 1e3 - 12_000, abs=1)
    split = spans.idle_split(ctx)
    # idle in the root span [0, 100]: [5, 8], [26, 35], [60, 75], [95, 100]
    assert split["fss.pressure_loop"] == pytest.approx(0.004)   # [26, 30]
    # [30, 35] and [60, 70]
    assert split["fss.mechanics"] == pytest.approx(0.015)
    assert split["fss.projection"] == pytest.approx(0.005)      # [70, 75]
    assert split["fss.bc_response"] == 0.0
    assert split["rest"] == pytest.approx(0.003 + 0.005)
    assert split["total"] == pytest.approx(0.003 + 0.009 + 0.015 + 0.005)
    for name, phase in IDLE_METRICS.items():
        assert _reader(name).read(ctx) == pytest.approx(split[phase])
    # a host read that holds no synchronizing call: under 99%, no fit
    bad = _trace(offset, reads[:-1], device)
    assert spans.fit_clock(rec.steps, bad) is None
    assert _reader("fss.mechanics_idle_ms_per_step").read(
        harness.Context(stats, bad)) is None
    # no device events (the CPU): nothing
    cpu = dict(trace, device_events=0, _device=[])
    assert _reader("fss.mechanics_idle_ms_per_step").read(
        harness.Context(stats, cpu)) is None


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trace's device events and "
                    "runtime calls come from the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_clock_fit_and_idle_split_under_the_benchmarks_profiler(cuda_dev):
    """A few steps of the structured 40^3 cell traced as the benchmark
    traces them (CUDA activity only), between untraced episodes: the
    trace's device events are device work alone (no span shows there as a
    user annotation), every host read holds one of the trace's
    synchronizing calls, the fit's median residual is at most 20 us, and
    the idle split adds up to the trace's idle."""
    from torch.profiler import ProfilerActivity, profile
    system = _system("rows40-hold", 40, "cuda")
    start = system.solver.initial_state()
    stats = []

    def episode():
        st = start
        for k in range(6):
            st, s = system.solver.time_step(st, system.dt, want_u=k == 5)
            torch.cuda.synchronize()
            stats.append(s)

    episode()                                   # warm: captures the graphs
    stats.clear()
    episode()
    prof = profile(activities=[ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    t = time.perf_counter()
    assert torch.autograd._profiler_enabled()
    episode()
    wall_us = (time.perf_counter() - t) * 1e6
    prof.stop()
    episode()
    events = prof.events()
    assert not [e.name for e in events if e.is_user_annotation]
    summary = tracing.summarize(events, wall_us, 6)
    ctx = harness.Context(stats, summary)
    recs = spans.window(ctx)
    assert [r.profiled for r in recs] == [False] * 6 + [True] * 6 + \
        [False] * 6
    split = spans.idle_split(ctx)
    assert split is not None, "fewer than 99% of the host reads matched"
    fit = split["fit"]
    print(f"fit: matched {fit.matched:.4f}, median residual "
          f"{fit.residual_ns / 1e3:.2f} us; idle ms/step {split}; "
          f"trace idle {(summary['wall_ms'] - summary['busy_ms']) / 6}")
    assert fit.matched >= 0.99
    assert fit.residual_ns <= 20_000
    idle = (summary["wall_ms"] - summary["busy_ms"]) / 6
    parts = sum(split[p] for p in spans.PHASES) + split["rest"]
    assert parts == pytest.approx(idle, rel=0.01)
    for name in list(PHASE_METRICS) + list(IDLE_METRICS) + [
            "cg.host_reads_per_step", "cg.frozen_iters_per_step"]:
        assert np.isfinite(_reader(name).read(ctx)), name
