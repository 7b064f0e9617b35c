"""launches_per_job: kernel launches a traced job made, from the CUDA
runtime's launch calls in the trace, plus any launch the program's own
counters saw (``K*`` launch counters) whose kernel the trace lacks."""

SOURCE = "device_trace"
UNIT = "launches"


def read(ctx):
    if not ctx.jobs:
        return None
    missing = 0
    for symbol, launched in ctx.counters.items():
        missing += max(0, launched - ctx.trace.count(
            lambda n, s=symbol: s in n))
    return (ctx.trace.launches + missing) / ctx.jobs
