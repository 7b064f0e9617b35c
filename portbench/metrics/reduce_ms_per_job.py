"""reduce_ms_per_job: device time of the statistics' sort (the radix
sort that orders every grid point's variants for the exact quantiles,
and its index fill) per traced job."""

SOURCE = "device_trace"
UNIT = "ms"


def _sort(name: str) -> bool:
    return "RadixSort" in name or "fill_reverse_indices" in name


def read(ctx):
    s = ctx.trace.seconds(_sort)
    return s / ctx.jobs * 1e3 if s > 0 and ctx.jobs else None
