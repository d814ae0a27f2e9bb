"""Host launches of device work per traced step: the profiler's
``cudaGraphLaunch``, ``cudaLaunchKernel`` and ``cudaLaunchKernelExC``
calls (a replayed CUDA graph is one launch)."""

from portbench.tracing import LAUNCH_CALLS


def read(ctx):
    t = ctx.trace
    if not t or not t["device_events"] or not t["steps"]:
        return None
    total = sum(t["runtime"][k] for k in LAUNCH_CALLS)
    # every step of the card's loop launches and waits: none seen means
    # the trace holds no runtime calls, not a step without them
    return total / t["steps"] if total else None
