"""Iterations per step that the mechanics and pressure CG chunks ran past
convergence, each a full apply that changes nothing: the program's
``chunk_steps`` at those call sites less the step's mechanics and pressure
CG counts (the batched projection is left out: its count sums lanes), over
the window's steps after its traced episodes
(:func:`portbench.spans.unprofiled`)."""

from portbench import spans

SITES = ("mechanics", "mechanics_gmg", "pressure")


def read(ctx):
    recs = spans.unprofiled(ctx)
    if recs is None:
        return None
    frozen = [r.total("chunk_steps", SITES) - r.cg["mech_cg_iterations"]
              - r.cg["pressure_cg_iterations"] for r in recs]
    # a negative step: its counts come from other call sites (the outer
    # loops of mixed-precision refinement)
    if min(frozen) < 0:
        return None
    return sum(frozen) / len(recs)
