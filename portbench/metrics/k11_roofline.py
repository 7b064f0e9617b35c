"""k11_roofline: K11's share of its roofline in the traced jobs. K11
assembles each Newton pass's system in the batched time loop
(``stamp_real_tile_kernel``, ``stamp_real_entry_kernel``: both forms
count); its work is ``work/k11.py`` at the passes the inputs need (the
reference's count) and the configuration's ``lane_values`` and
``stamp_adds`` (the reference's stamper's), its time the trace's."""

from portbench.core.roofline import share

SOURCE = "device_trace"
UNIT = "%"
SYMBOLS = ("stamp_real_tile_kernel", "stamp_real_entry_kernel")


def read(ctx):
    passes = ctx.info.get("passes_per_lane")
    sh = ctx.shape
    if passes is None or "lane_values" not in sh:
        return None
    flops, nbytes = ctx.work("k11").work(
        sh["n"], passes * sh["variants"] * ctx.jobs, sh["lane_values"],
        sh["stamp_adds"], sh["itemsize"])
    return share(ctx, SYMBOLS, flops, nbytes)
