"""k9_roofline: K9's share of its roofline in the traced jobs. K9 is the
fused nonlinear Monte-Carlo transient (``mc_tran_nr_kernel``); its work
is ``work/k9.py`` at the passes the inputs need (the reference's count),
its time the trace's."""

from portbench.core.roofline import share

SOURCE = "device_trace"
UNIT = "%"
SYMBOLS = ("mc_tran_nr_kernel",)


def read(ctx):
    passes = ctx.info.get("passes_per_lane")
    if passes is None:
        return None
    sh = ctx.shape
    flops, nbytes = ctx.work("k9").work(
        sh["n"], passes * sh["variants"] * ctx.jobs, sh["stamp_adds"],
        sh["variants"] * ctx.jobs, sh["swept"], sh["points"],
        sh["sources"], sh["itemsize"])
    return share(ctx, SYMBOLS, flops, nbytes)
