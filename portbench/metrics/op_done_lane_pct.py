"""op_done_lane_pct: the share of the batched Newton's lane-passes in
``op_batch`` spent on lanes already settled, which ride along frozen
until the last lane settles: 100 (1 - ``op.lane_passes`` /
(``op.newton_passes`` x lanes)), the lanes' own passes over the batched
passes times the lanes a job, from the program's counters."""

SOURCE = "program_counter"
UNIT = "%"


def read(ctx):
    c = ctx.program_counters
    passes, lane = c.get("op.newton_passes"), c.get("op.lane_passes")
    lanes = ctx.shape.get("variants")
    if not passes or lane is None or not lanes:
        return None
    return 100.0 * (1.0 - lane / (passes * lanes))
