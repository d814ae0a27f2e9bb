"""Device ms per traced step of the kernels that no hand-written wrapper
launched: plain torch (stencils, the generic coupling and projection,
the multigrid, the CG vector algebra)."""


def read(ctx):
    t = ctx.trace
    if not t or not t["device_events"] or not t["steps"]:
        return None
    return t["plain_ms"] / t["steps"]
