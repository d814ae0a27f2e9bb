"""Host ms per step in the program's ``fss.pressure_loop`` spans (the pressure
inner loop, one span per FSS iteration), the mean over the window's steps
after its traced episodes (:func:`portbench.spans.unprofiled`)."""

from portbench import spans


def read(ctx):
    return spans.phase_ms(ctx, "fss.pressure_loop")
