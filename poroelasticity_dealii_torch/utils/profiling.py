"""The port's one recorder of spans and counters, and its device trace.

**Counters.** One registry, :attr:`Recorder.counts`, of integers keyed
``(kind, key)`` and added to where the work happens:

* ``("launches", key)``: the kernel wrappers' launches, graph replays
  included, keyed as :func:`..ops.comp_major.launch_counts` returns them;
* ``("host_reads", site)``: every device-to-host read on a step's path,
  counted where it is made: the pressure and FSS residual norms
  (``pressure_residual``, ``fss_residual``) and the step's stats
  (``stats``) each by :func:`read`, a CG call site's chunk flags under the
  call site's name by its chunk loop, which adds a solve's reads at the
  solve's end (:mod:`..solvers.cuda_graphs`);
* ``("chunk_steps", site)``: the iterations the chunks at a CG call site
  ran, frozen ones included, known on the host from the chunk lengths and
  added the same way;
* ``("fused_steps", site)``: those of them that ran the fused Jacobi-CG
  update (:mod:`..ops.cg_update`), added beside ``chunk_steps``.

**Spans.** A span has a name, the attributes it was opened with, a start
and an end in ns on one host clock (``time.time_ns()``), and its parent;
the spans of one step share the step's id.  A step (:func:`step`, the root
span ``fss.step``) leaves one :class:`StepRecord`, with its spans, its
counters' deltas and, once its stats are read, its CG counts
(:func:`note_cg`), in a bounded buffer of :data:`MAX_STEPS` steps.  Spans
opened outside a step are not kept.  Two levels:

* phase spans (:func:`span`), always: ``fss.bc_response``,
  ``fss.pressure_loop``, ``fss.mechanics``, ``fss.projection``;
* leaf spans (:func:`leaf`), only while a ``torch.profiler`` records
  (else one check of a flag): ``cg.solve`` (site), ``cg.replay`` (site,
  chunk), ``cg.host_read`` (site), ``kernel.enqueue`` (wrapper).  A step
  that records them is marked ``profiled``.

While a profiler records, every span is also a ``record_function`` range
(its C++ form, :data:`_RANGE`; a profiler with CUDA activity may also list
it as a device-side user annotation, which readers of device time leave
out), so a trace with CPU activity
(``run --profile``) shows the spans on its own timeline.

The program records into the process's :data:`RECORDER`, as the launch
counters always were process-wide: the benchmark reads it in the process
that ran the steps.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

import torch

# steps kept: a 51-s window at ten times the 40^3 rows cell's rate, and more
MAX_STEPS = 16384

# the CG counts a step record keeps
CG_FIELDS = ("pressure_cg_iterations", "mech_cg_iterations",
             "projection_cg_iterations")

_profiling = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()
# a span's range in the profiler's trace: the C++ context manager (a
# microsecond or less, where ``record_function`` takes ten under a profiler)
_RANGE = torch._C._profiler._RecordFunctionFast


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the enclosed block with ``torch.profiler`` (CPU and, where a
    card is visible, CUDA activities) and write it as a Chrome trace,
    ``logdir/trace.json`` (``chrome://tracing``, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Span:
    """One span of a step: ``parent`` the index of its parent in the step's
    ``spans`` (None for the root), ``end`` None while it is open."""
    __slots__ = ("name", "attrs", "start", "end", "parent")

    def __init__(self, name, attrs, start, parent):
        self.name, self.attrs, self.start, self.parent = \
            name, attrs, start, parent
        self.end = None


class StepRecord:
    """One step: its id, its spans (the root ``fss.step`` first), its
    counters' deltas by kind and key (``counts["host_reads"]["pressure"]``),
    its CG counts once read (``cg``: ``pressure_cg_iterations``,
    ``mech_cg_iterations``, ``projection_cg_iterations``), and whether a
    profiler recorded during it."""
    __slots__ = ("step", "spans", "counts", "cg", "profiled")

    def __init__(self, step: int, profiled: bool):
        self.step, self.profiled = step, profiled
        self.spans, self.counts, self.cg = [], {}, None

    def total(self, kind: str, keys=None) -> int:
        """The step's count of ``kind``, over ``keys`` (all if None)."""
        got = self.counts.get(kind, {})
        return sum(v for k, v in got.items() if keys is None or k in keys)

    def span_ns(self, name: str) -> int:
        """The summed length of the step's spans named ``name``."""
        return sum(s.end - s.start for s in self.spans
                   if s.name == name and s.end is not None)


def _label(name, attrs) -> str:
    return f"{name}[{','.join(map(str, attrs))}]" if attrs else name


class _Open:
    """The context of one span."""
    __slots__ = ("rec", "name", "attrs", "span", "rf")

    def __init__(self, rec, name, attrs):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        self.rf = None
        if _profiling():
            self.rf = _RANGE(_label(self.name, self.attrs))
            self.rf.__enter__()
        self.span = self.rec._push(self.name, self.attrs)
        return self.span

    def __exit__(self, *exc):
        if self.span is not None:
            self.rec._pop(self.span)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _Step(_Open):
    """The context of a step's root span, ``fss.step``, and its record."""
    __slots__ = ()

    def __init__(self, rec):
        super().__init__(rec, "fss.step", ())

    def __enter__(self):
        self.rec._begin()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.rec._end()
        return False


class Recorder:
    """Counters (:attr:`counts`) and the last :data:`MAX_STEPS` steps'
    records (:attr:`steps`), see the module docstring."""

    def __init__(self, max_steps: int = MAX_STEPS):
        self.counts = collections.Counter()
        self.steps = collections.deque(maxlen=max_steps)
        self._record = None          # the open step's record
        self._stack = []             # its open spans' indices, innermost last
        self._before = None          # the counters at its start
        self._last_id = 0

    def count(self, kind: str, key, n: int = 1) -> None:
        self.counts[(kind, key)] += n

    def clear(self, kind: str) -> None:
        """Zero every counter of ``kind``."""
        for k in [k for k in self.counts if k[0] == kind]:
            del self.counts[k]

    def step(self):
        """Context of one step: its root span and its record."""
        return _Step(self)

    def span(self, name: str, *attrs):
        """Context of a phase span."""
        return _Open(self, name, attrs)

    def leaf(self, name: str, *attrs):
        """Context of a leaf span, kept only while a profiler records."""
        if not _profiling():
            return _NULL
        if self._record is not None:
            self._record.profiled = True
        return _Open(self, name, attrs)

    def read(self, site: str, fn):
        """``fn()``, a device-to-host read (a bound ``item``, ``tolist`` or
        ``__bool__``), counted under ``host_reads[site]``."""
        self.counts[("host_reads", site)] += 1
        if not _profiling():
            return fn()
        with self.leaf("cg.host_read", site):
            return fn()

    def note_cg(self, stats) -> None:
        """The CG counts of the last ``len(stats)`` steps, from their host
        ``StepStats``."""
        first = len(self.steps) - len(stats)
        for i, s in enumerate(stats):
            if first + i >= 0:
                self.steps[first + i].cg = {
                    f: int(getattr(s, f)) for f in CG_FIELDS}

    def _begin(self) -> None:
        self._last_id += 1
        self._record = StepRecord(self._last_id, _profiling())
        self._before = dict(self.counts)

    def _end(self) -> None:
        rec, before = self._record, self._before
        rec.profiled = rec.profiled or _profiling()
        for (kind, key), v in self.counts.items():
            d = v - before.get((kind, key), 0)
            if d:
                rec.counts.setdefault(kind, {})[key] = d
        self._record = self._before = None
        self.steps.append(rec)

    def _push(self, name, attrs):
        rec = self._record
        if rec is None:
            return None
        parent = self._stack[-1] if self._stack else None
        s = Span(name, attrs, time.time_ns(), parent)
        self._stack.append(len(rec.spans))
        rec.spans.append(s)
        return s

    def _pop(self, s) -> None:
        s.end = time.time_ns()
        self._stack.pop()


# the process's recorder, which the program records into, and its methods
# as the program calls them
RECORDER = Recorder()
count, step, span, leaf, read, note_cg = (
    RECORDER.count, RECORDER.step, RECORDER.span, RECORDER.leaf,
    RECORDER.read, RECORDER.note_cg)
