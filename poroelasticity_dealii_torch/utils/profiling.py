"""Profiling hooks (port of ``poroelasticity_dealii_tpu/utils/profiling.py``).

Thin wrappers over ``torch.profiler`` plus a phase-timer for the host loop:
the observability layer the reference lacks entirely (its only instrumentation
is std::cout progress prints)."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


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


class PhaseTimer:
    """Accumulating wall-clock timer for named host-side phases.

    Synchronises the device of ``block_on`` (a tensor) at phase ends so
    the numbers mean what they say.  Usage::

        timer = PhaseTimer()
        with timer.phase("assembly"):
            ...
        print(timer.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None and block_on.device.type == "cuda":
                torch.cuda.synchronize(block_on.device)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name:<24s} {t:9.3f}s  x{n:<6d} "
                         f"{t / max(n, 1) * 1e3:9.2f} ms/call")
        return "\n".join(lines)


def annotate(name: str):
    """Decorator adding a named ``record_function`` range around a function
    (shows up in device traces)."""
    def wrap(fn):
        def inner(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return inner
    return wrap
