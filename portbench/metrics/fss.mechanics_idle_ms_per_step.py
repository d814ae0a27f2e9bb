"""Device idle ms per traced step inside the program's ``fss.mechanics`` spans
(the coupling right-hand side and the mechanics solve): the gaps between
the union of the trace's device intervals, put on the spans' clock by the
fit of ``portbench/spans.py``."""

from portbench import spans


def read(ctx):
    return spans.phase_idle_ms(ctx, "fss.mechanics")
