"""front_end_ms: the median host time a traced job spent in the program's
front end (``parse_netlist`` and ``build_tensors`` of the deck's text),
from the benchmark's own span around those two calls."""

import statistics

SOURCE = "host_clock"
UNIT = "ms"


def read(ctx):
    return statistics.median(ctx.front_end_s) * 1e3 if ctx.front_end_s \
        else None
