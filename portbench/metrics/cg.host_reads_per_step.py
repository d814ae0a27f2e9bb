"""Device-to-host reads per step, counted by the program where each is made
(``host_reads``: the CG chunk flags by call site, the pressure and FSS
residual norms, the step's stats), over the window's steps after its traced
episodes (:func:`portbench.spans.unprofiled`)."""

from portbench import spans


def read(ctx):
    recs = spans.unprofiled(ctx)
    if recs is None:
        return None
    return sum(r.total("host_reads") for r in recs) / len(recs)
