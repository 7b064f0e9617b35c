"""k2_roofline: K2's share of its roofline in the traced jobs. K2 is the
dense real solve of every Newton pass (``gj_real_thread_kernel``,
``gj_real_block_kernel``); its work is ``work/k2.py`` at the passes the
inputs need (the reference's count), its time the trace's."""

from portbench.core.roofline import share

SOURCE = "device_trace"
UNIT = "%"
SYMBOLS = ("gj_real_thread_kernel", "gj_real_block_kernel")


def read(ctx):
    passes = ctx.info.get("passes_per_lane")
    if passes is None:
        return None
    sh = ctx.shape
    flops, nbytes = ctx.work("k2").work(
        sh["n"], passes * sh["variants"] * ctx.jobs, sh["itemsize"])
    return share(ctx, SYMBOLS, flops, nbytes)
