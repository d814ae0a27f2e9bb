"""The structured elasticity kernel (``csrc/comp_major.cu`` through
``ops/comp_major.py::elasticity_rows_apply``) against its roofline: the
sum of its calls' least times (``portbench/work``), the calls counted by
mode by the program's launch counter (graph replays included), over the
device ms of its kernels in the trace, in %."""

from portbench import work

WRAPPER = "elasticity_rows_apply"


def read(ctx):
    t, calls = ctx.trace, ctx.launches
    if not t or not calls:
        return None
    ms = t["wrapper_ms"].get(WRAPPER, 0.0)
    modes = {k[1]: v for k, v in calls.items()
             if isinstance(k, tuple) and k[0] == "mode"}
    if ms <= 0 or not calls.get(WRAPPER) or \
            calls.get("slab", 0) or sum(modes.values()) != calls[WRAPPER]:
        return None
    s = ctx.sizes
    bound = sum(v * work.rows_elasticity_ms(s["n"], s["dtype"], m,
                                            s["ke_nonzeros"])
                for m, v in modes.items())
    return 100.0 * bound / ms
