"""The program's step records, for the per-layer readers: the window's
records, and their spans on the trace's clock.

The program (``poroelasticity_dealii_torch/utils/profiling.py``) keeps a
record of each step: its spans in ns of ``time.time_ns()``, its counters'
deltas (``host_reads``, ``chunk_steps``), its CG counts, and whether a
profiler recorded during it.  :func:`window` takes the window's steps as
the recorder's last ``len(ctx.stats)`` records, and only if their CG counts
are those of ``ctx.stats``; a program without the recorder gives None.

The trace (:func:`.tracing.summarize`) has its events in µs from its own
start, and the helper assumes no common epoch: :func:`fit_clock` fits the
one constant between the two clocks from the profiled steps'
``cg.host_read`` spans, each of which holds exactly one of the trace's
synchronizing runtime calls (:data:`.tracing.SYNC_CALLS`) on the card.
:func:`idle_split` then puts each idle gap of the device (between the union
of its intervals) down to the phase span it falls in.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .tracing import SYNC_CALLS

PHASES = ("fss.bc_response", "fss.pressure_loop", "fss.mechanics",
          "fss.projection")
CG_FIELDS = ("pressure_cg_iterations", "mech_cg_iterations",
             "projection_cg_iterations")
# the share of host-read spans that must hold exactly one synchronizing call
MATCH = 0.99
# the calls tried as the first host read's own, in trace order
FIRST_CALLS = 64


def window(ctx):
    """The window's step records (oldest first), or None."""
    if not ctx.stats:
        return None
    try:
        from poroelasticity_dealii_torch.utils import profiling
        steps = profiling.RECORDER.steps
    except (ImportError, AttributeError):
        return None
    n = len(ctx.stats)
    if len(steps) < n:
        return None
    recs = list(steps)[-n:]
    for r, s in zip(recs, ctx.stats):
        if r.cg != {f: int(getattr(s, f)) for f in CG_FIELDS}:
            return None
    return recs


def unprofiled(ctx):
    """The window's records of the steps after the last one a profiler
    recorded (in a traced run the window's steps after its traced
    episodes, which run as untraced steps do), or, where no step follows
    it, of those before it; None if there are none."""
    recs = window(ctx) or []
    last = max((i for i, r in enumerate(recs) if r.profiled), default=-1)
    return recs[last + 1:] or [r for r in recs if not r.profiled] or None


def phase_ms(ctx, phase: str):
    """Host ms a step in ``phase`` spans, over :func:`unprofiled`."""
    recs = unprofiled(ctx)
    if recs is None:
        return None
    return sum(r.span_ns(phase) for r in recs) / len(recs) / 1e6


@dataclasses.dataclass
class Fit:
    """``host ns = base + offset + trace ns``; ``matched`` the share of
    host-read spans holding exactly one synchronizing call, ``residual_ns``
    the median distance of a span's middle from its call's."""
    base: int
    offset: float
    matched: float
    residual_ns: float


def _holds(calls, s0, s1, c):
    """Per span [s0, s1] (host ns from base), the calls' middles (trace ns)
    it holds with offset ``c``, and the index of the first."""
    lo = np.searchsorted(calls, s0 - c, "left")
    hi = np.searchsorted(calls, s1 - c, "right")
    return hi - lo, lo


def fit_clock(recs, trace):
    """The :class:`Fit` of the profiled steps' ``cg.host_read`` spans to the
    trace's synchronizing calls, or None when under :data:`MATCH` of the
    spans hold exactly one."""
    spans = [(s.start, s.end) for r in recs if r.profiled for s in r.spans
             if s.name == "cg.host_read" and s.end is not None]
    calls = np.sort(np.array([(a + b) * 500.0 for a, b, name in
                              trace["_host"] if name in SYNC_CALLS]))
    if not spans or not len(calls):
        return None
    base = spans[0][0]
    s0 = np.array([a - base for a, _ in spans], dtype=np.float64)
    s1 = np.array([b - base for _, b in spans], dtype=np.float64)
    mid = (s0 + s1) / 2
    # the first read's call is among the first few calls: try each, keep
    # the offset that most spans agree with, then take the median offset
    # of the spans it matches
    best = max((int(np.sum(_holds(calls, s0, s1, mid[0] - t)[0] == 1)),
                mid[0] - t) for t in calls[:FIRST_CALLS])
    c = best[1]
    for _ in range(2):
        held, lo = _holds(calls, s0, s1, c)
        one = held == 1
        if not one.any():
            return None
        c = float(np.median(mid[one] - calls[lo[one]]))
    held, lo = _holds(calls, s0, s1, c)
    one = held == 1
    if one.mean() < MATCH:
        return None
    resid = np.abs(mid[one] - calls[lo[one]] - c)
    return Fit(base, c, float(one.mean()), float(np.median(resid)))


def _gap_cover(g0, g1):
    """``cover(t)``: the length of the gaps [g0, g1] (sorted, disjoint)
    before ``t``."""
    cum = np.concatenate([[0.0], np.cumsum(g1 - g0)])

    def cover(t):
        i = np.searchsorted(g0, t, "right")
        last = np.clip(t - g0[np.maximum(i - 1, 0)], 0.0,
                       (g1 - g0)[np.maximum(i - 1, 0)])
        return cum[np.maximum(i - 1, 0)] + np.where(i > 0, last, 0.0)
    return cover


def idle_split(ctx):
    """Device idle ms a traced step by phase (:data:`PHASES`), ``rest``
    (idle in no phase span) and ``total``, over the profiled steps' root
    spans; with the ``fit``.  None without device events, profiled steps
    or a clock fit."""
    t = ctx.trace
    if not t or not t.get("device_events"):
        return None
    recs = [r for r in window(ctx) or () if r.profiled]
    if not recs:
        return None
    fit = fit_clock(recs, t)
    if fit is None:
        return None

    def rel(a, b):             # host ns -> trace ns
        return a - fit.base - fit.offset, b - fit.base - fit.offset
    roots = [rel(r.spans[0].start, r.spans[0].end) for r in recs]
    w0, w1 = min(a for a, _ in roots), max(b for _, b in roots)
    dev = np.array([(a * 1e3, b * 1e3) for a, b, _ in t["_device"]])
    dev = dev[np.argsort(dev[:, 0])]
    reach = np.maximum.accumulate(dev[:, 1])
    # gaps: before the first interval, between the union's blocks, after
    starts = np.concatenate([[w0], reach[:-1][dev[1:, 0] > reach[:-1]],
                             [reach[-1]]])
    ends = np.concatenate([[dev[0, 0]], dev[1:, 0][dev[1:, 0] > reach[:-1]],
                           [w1]])
    g0, g1 = np.clip(starts, w0, w1), np.clip(ends, w0, w1)
    keep = g1 > g0
    g0, g1 = g0[keep], g1[keep]
    cover = _gap_cover(g0, g1)
    total = float(np.sum(g1 - g0))
    out = {}
    for phase in PHASES:
        iv = np.array([rel(s.start, s.end) for r in recs for s in r.spans
                       if s.name == phase and s.end is not None])
        out[phase] = float(np.sum(cover(iv[:, 1]) - cover(iv[:, 0]))) \
            if len(iv) and len(g0) else 0.0
    n = len(recs) * 1e6
    split = {k: v / n for k, v in out.items()}
    split["rest"] = (total - sum(out.values())) / n
    split["total"] = total / n
    split["fit"] = fit
    return split


def phase_idle_ms(ctx, phase: str):
    """Device idle ms a traced step inside ``phase`` spans, or None."""
    split = idle_split(ctx)
    return None if split is None else split[phase]
