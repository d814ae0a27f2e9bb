"""Mechanics CG iterations per step over the window's steps (the
program's ``StepStats.mech_cg_iterations``)."""


def read(ctx):
    if not ctx.stats:
        return None
    return sum(int(s.mech_cg_iterations) for s in ctx.stats) \
        / len(ctx.stats)
