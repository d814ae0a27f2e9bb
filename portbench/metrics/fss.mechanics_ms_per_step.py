"""Host ms per step in the program's ``fss.mechanics`` spans (the coupling
right-hand side and the mechanics solve), the mean over the window's steps
after its traced episodes (:func:`portbench.spans.unprofiled`)."""

from portbench import spans


def read(ctx):
    return spans.phase_ms(ctx, "fss.mechanics")
