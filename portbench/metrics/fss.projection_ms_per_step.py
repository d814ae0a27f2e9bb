"""Host ms per step in the program's ``fss.projection`` spans (the projection
right-hand side and solves: the volumetric one in the loop, the shear one
after it), the mean over the window's steps after its traced episodes
(:func:`portbench.spans.unprofiled`)."""

from portbench import spans


def read(ctx):
    return spans.phase_ms(ctx, "fss.projection")
