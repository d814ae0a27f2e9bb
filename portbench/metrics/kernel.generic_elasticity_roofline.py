"""The generic elasticity kernel (``csrc/generic.cu`` through
``ops/generic_apply.py::generic_elasticity_apply``) against its roofline:
the sum of its calls' least times (``portbench/work``), the calls counted
by the program's launch counter (graph replays included), over the
device ms of its kernels in the trace, in %."""

from portbench import work

WRAPPER = "generic_elasticity_apply"


def read(ctx):
    t, calls = ctx.trace, ctx.launches
    if not t or not calls:
        return None
    ms = t["wrapper_ms"].get(WRAPPER, 0.0)
    if ms <= 0 or not calls.get(WRAPPER):
        return None
    s = ctx.sizes
    one = work.generic_elasticity_ms(s["cells"], s["n_udofs"], s["dtype"])
    return 100.0 * calls[WRAPPER] * one / ms
