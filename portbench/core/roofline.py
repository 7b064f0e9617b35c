"""A kernel's share of its roofline: the least time the card could take
for the work (``peaks.least_seconds``) over the kernel's device time in
the trace, in percent. A kernel the trace does not show has no share."""

from . import peaks


def share(ctx, symbols: tuple[str, ...], flops: float, nbytes: float):
    seconds = ctx.trace.seconds(lambda n: any(s in n for s in symbols))
    if seconds <= 0 or ctx.jobs == 0:
        return None
    return 100.0 * peaks.least_seconds(flops, nbytes,
                                       ctx.shape["dtype"]) / seconds
