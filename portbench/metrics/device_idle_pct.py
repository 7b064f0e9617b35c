"""device_idle_pct: the share of the traced window (host clock, first
traced job's start to the last one's end) in which no kernel, copy or
set ran on the card (the union of the trace's device intervals)."""

SOURCE = "device_trace"
UNIT = "%"


def read(ctx):
    if ctx.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.window_s)
