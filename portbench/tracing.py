"""Reduce a ``torch.profiler`` trace of whole episodes to what the
per-layer metrics read.

Frozen copies, so that a later change to the program cannot move the
yardstick: the union of device intervals (busy time), the map from a
CUDA kernel's name to the hand-written wrapper that launches it, and the
host runtime calls that launch work are from
``poroelasticity_dealii_torch/tools/profile_step.py`` (``_busy_ms``,
``_short``, ``WRAPPERS``, ``_wrapper``, ``RUNTIME_CALLS``); the calls
that make the host wait for the device are added here.
"""

from __future__ import annotations

import re
from collections import defaultdict

WRAPPERS = ("elasticity_rows_apply", "coupling_rows", "projection_rows",
            "elasticity_grid_apply", "generic_elasticity_apply",
            "generic_q1_apply")
LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC")
# the host waits for the device in these; a plain cudaMemcpy is
# synchronous (the asynchronous copies are named cudaMemcpyAsync)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def short(name: str) -> str:
    """A kernel's demangled name without its namespace and arguments."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0]


def wrapper(name: str):
    """The kernel wrapper (:data:`WRAPPERS`) that launches the CUDA kernel
    ``name``, or None.  The applies and the projection share the cell
    product pass, told apart by its input layout (the flat apply's is
    ``FlatLayout``) and row count (81 or 48); the generic applies share
    the plan sum, told apart by its lane count (1 for the elasticity
    apply)."""
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


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def summarize(events, wall_us: float, steps: int) -> dict:
    """The traced window's device activity: ``events`` the profiler's
    events, ``wall_us`` the host wall time of the traced episodes,
    ``steps`` the steps in them.  Times in ms."""
    device, host = [], []
    runtime = defaultdict(int)
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if str(e.device_type).endswith("CUDA"):
            device.append((a, b, e.name))
        else:
            host.append((a, b, e.name))
            runtime[e.name] += 1
    kernels = defaultdict(lambda: [0.0, 0])
    for a, b, name in device:
        kernels[name][0] += (b - a) / 1e3
        kernels[name][1] += 1
    wrapper_ms = defaultdict(float)
    plain_ms = 0.0
    for name, (ms, _) in kernels.items():
        w = wrapper(name)
        if w is not None:
            wrapper_ms[w] += ms
        elif _is_kernel(name):
            plain_ms += ms
    return {"busy_ms": busy_us([(a, b) for a, b, _ in device]) / 1e3,
            "wall_ms": wall_us / 1e3, "steps": steps,
            "device_events": len(device),
            "runtime": {k: runtime.get(k, 0)
                        for k in LAUNCH_CALLS + SYNC_CALLS},
            "kernels": {k: v for k, v in kernels.items()},
            "wrapper_ms": dict(wrapper_ms), "plain_ms": plain_ms,
            "_device": device, "_host": host}


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time, each under its wrapper
    (or ``torch``), and the longest idle gaps of the device, each named by
    the host call in flight through most of it (the innermost one among
    those that cover at least nine tenths of the widest cover; on the
    card the trace holds the CUDA runtime calls)."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])
    device_ops = [[f"{wrapper(k) or 'torch'}: {short(k)}", v[0] / 1e3]
                  for k, v in ops[:top]]
    spans = sorted((a, b) for a, b, _ in summary["_device"])
    gaps, end = [], None
    for a, b in spans:
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host = summary["_host"]
    idle = []
    for g0, g1 in gaps:
        cover = [(min(b, g1) - max(a, g0), b - a, name)
                 for a, b, name in host if a < g1 and b > g0]
        label = "none"
        if cover:
            widest = max(c[0] for c in cover)
            label = min((c for c in cover if c[0] >= 0.9 * widest),
                        key=lambda c: c[1])[2]
        idle.append([label, (g1 - g0) / 1e6])
    return {"device_ops": device_ops, "idle_gaps": idle}
