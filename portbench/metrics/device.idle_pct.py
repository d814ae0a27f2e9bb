"""The share of the traced episodes' wall time in which no operation ran
on the device: 100 (1 - union of the device intervals / wall)."""


def read(ctx):
    t = ctx.trace
    if not t or not t["device_events"] or t["wall_ms"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_ms"] / t["wall_ms"])
