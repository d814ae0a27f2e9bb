"""Chunked solver loops, and their chunks as captured CUDA graphs.

A solver loop here is a start (``init``: the solve's inputs to its first
state, a tuple of tensors), an iteration ``step`` that maps state to state
and freezes it once the loop's condition fails, and that condition,
``cond``, as a device flag.  :func:`run_chunks` runs up to ``size`` steps
per chunk and reads the flag on the host once per chunk: the only host read
of the loop.  Because a frozen step changes nothing, the result equals the
one-step-per-read loop bit for bit.  Each solve counts its flag reads under
``host_reads[site]`` and the steps its chunks ran, frozen ones included,
under ``chunk_steps[site]``, and those steps again under
``fused_steps[site]`` when its iteration runs the fused Jacobi-CG update
(:mod:`..utils.profiling`; ``site`` the call site's name), adding them to
the recorder once, at its end, and while a
profiler records it opens the leaf spans ``cg.solve``, ``cg.host_read``
and, per graph replay, ``cg.replay``.

:class:`ChunkGraphs` (the card only) stands in for the reference's ``jit``:
each call site and shape (its key) gets static input and state buffers, a
graph of its start and, per chunk length, a graph of a chunk, each
captured with ``torch.cuda.graph`` after one eager warm-up on a side
stream, all graphs in one memory pool.  A solve copies its inputs into the
buffers, replays the start, then a chunk while the flag says so, and
clones the result out, because the next solve with that key reuses the
buffers.  A key holds the solver (``"cg"``, ``"cg_batched"``,
``"richardson"``) and the right-hand side's type and shape, so a flat, a
row-layout and a parity-layout solve at one call site get graphs of their
own.  Capture raises on a host read inside a graph, which is the proof
that a chunk holds none.  Every tensor a graph reads is a buffer, a
per-solve constant copied into a buffer (``consts``), or a constant of the
operators that outlives the solver (the element matrices, masks and, for a
V-cycle preconditioner, every level's tensors and the coarse inverse,
which the discretization holds); the caller keeps the operators of one key
the same.

The kernel wrappers count a launch in Python, which a replay does not run:
the counts a capture adds are recorded and taken back, and each solve adds
them again for every replay it made
(:func:`..ops.comp_major.add_launch_counts`), so the counts include the
applies of frozen iterations.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
from typing import Callable

import torch

from ..ops import comp_major as cm
from ..utils import profiling


def run_chunks(init: Callable, step: Callable, cond: Callable,
               inputs: tuple, consts: tuple, budget: int, size: int,
               graphs: "ChunkGraphs" = None, key=None,
               site: str = "cg", fused: bool = False) -> tuple:
    """From ``state = init(inputs, consts)``, apply ``step(state, consts)``
    in chunks of at most ``size`` while the host reads ``cond(state,
    consts)`` true at the chunk's start, at most ``budget`` times in all;
    return the final state.

    A chunk is cut to the budget left: a true flag means every step so far
    was live, so the host knows the count.  With ``graphs``, the start and
    each chunk are replays under ``key``, whose first item is ``site``
    (:meth:`ChunkGraphs.run`).  ``fused``: ``step`` runs the fused
    Jacobi-CG update (:func:`.cg._jacobi_update_cuda`), counted under
    ``fused_steps``."""
    with profiling.leaf("cg.solve", site):
        if graphs is not None:
            return graphs.run(key, init, step, cond, inputs, consts, budget,
                              size, fused)
        state = init(inputs, consts)
        done = reads = 0
        while done < budget:
            reads += 1
            with profiling.leaf("cg.host_read", site):
                if not bool(cond(state, consts)):
                    break
            n = min(size, budget - done)
            for _ in range(n):
                state = step(state, consts)
            done += n
        _count_steps(site, reads, done, fused)
        return state


def _count_steps(site: str, reads: int, done: int, fused: bool) -> None:
    """Add one solve's flag reads and chunk steps (and, for a fused update,
    its fused steps) to the recorder."""
    profiling.count("host_reads", site, reads)
    profiling.count("chunk_steps", site, done)
    if fused:
        profiling.count("fused_steps", site, done)


@dataclasses.dataclass
class _Site:
    """The static buffers of one key, and its graphs: the start under
    ``"init"``, a chunk under its length."""
    inputs: tuple
    consts: tuple
    flag: torch.Tensor
    state: tuple = None
    graphs: dict = dataclasses.field(default_factory=dict)
    deltas: dict = dataclasses.field(default_factory=dict)

    def load(self, inputs, consts) -> None:
        for buf, t in zip(self.inputs + self.consts, inputs + consts):
            buf.copy_(t)


class ChunkGraphs:
    """The captured chunks of one solver: a graph per key and chunk length,
    in one memory pool.  ``captures`` and ``replays`` count them by the
    key's first item (the call site)."""

    def __init__(self):
        self._pool = torch.cuda.graph_pool_handle()
        self._sites = {}
        self.captures = collections.Counter()
        self.replays = collections.Counter()

    def release(self) -> None:
        """Destroy every graph and drop every buffer, so that the pool's
        memory goes back to the allocator (an adaptive run releases the
        old mesh's solver before the new mesh's captures)."""
        for site in self._sites.values():
            for graph in site.graphs.values():
                graph.reset()
        self._sites.clear()

    def run(self, key, init, step, cond, inputs, consts, budget,
            size, fused=False) -> tuple:
        """:func:`run_chunks` with the start and each chunk a graph
        replay."""
        site = self._sites.get(key)
        if site is None:
            site = self._sites[key] = _Site(
                inputs=tuple(t.clone() for t in inputs),
                consts=tuple(t.clone() for t in consts),
                flag=torch.ones((), dtype=torch.bool,
                                device=inputs[0].device))
        else:
            site.load(inputs, consts)
        self._replay(site, key, "init", init, cond)
        replayed = {"init": 1}
        done = reads = 0
        while done < budget:
            reads += 1
            with profiling.leaf("cg.host_read", key[0]):
                if not bool(site.flag):
                    break
            n = min(size, budget - done)
            self._replay(site, key, n, step, cond)
            replayed[n] = replayed.get(n, 0) + 1
            done += n
        self._count(site, key[0], replayed, reads, done, fused)
        return tuple(t.clone() for t in site.state)

    def _replay(self, site, key, which, fn, cond) -> None:
        """Replay graph ``which`` of ``site`` (capture it first if need
        be)."""
        if which not in site.graphs:
            self._capture(site, key, which, fn, cond)
        with profiling.leaf("cg.replay", key[0], which):
            site.graphs[which].replay()

    def _count(self, site, name, replayed, reads, done, fused) -> None:
        """Add one solve's counts: the launches of its replays (``replayed``
        by graph), the replays, its flag reads and the steps its chunks
        ran (fused ones too)."""
        for which, m in replayed.items():
            cm.add_launch_counts(
                {k: v * m for k, v in site.deltas[which].items()})
        self.replays[name] += sum(replayed.values())
        _count_steps(name, reads, done, fused)

    def _capture(self, site, key, which, fn, cond) -> None:
        """Capture the start (``which == "init"``, ``fn = init``: inputs
        to state) or a chunk of ``which`` steps (``fn = step``); both end
        by writing the state buffers and the flag."""
        start = which == "init"
        src = site.inputs if start else site.state
        # one eager call on a side stream first (lazy initialisation, the
        # kernel library's load, cuBLAS workspaces); the start's result
        # gives the state buffers their shapes
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = fn(src, site.consts)
            cond(out, site.consts)
        torch.cuda.current_stream().wait_stream(side)
        if start:
            site.state = tuple(torch.empty_like(t) for t in out)
        before = cm.launch_counts()
        graph = torch.cuda.CUDAGraph()
        # no garbage collection while capturing: collecting another
        # solver's graphs (a graph reset) would invalidate this capture
        gc_enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                out = src
                for _ in range(1 if start else which):
                    out = fn(out, site.consts)
                site.flag.copy_(cond(out, site.consts))
                for buf, t in zip(site.state, out):
                    buf.copy_(t)
        finally:
            if gc_enabled:
                gc.enable()
        # the launches the capture counted (only the counters it moved: a
        # replay adds these)
        delta = {k: v - before[k] for k, v in cm.launch_counts().items()
                 if v != before[k]}
        cm.add_launch_counts({k: -v for k, v in delta.items()})
        site.graphs[which], site.deltas[which] = graph, delta
        self.captures[key[0]] += 1
