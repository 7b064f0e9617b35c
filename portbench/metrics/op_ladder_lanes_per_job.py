"""op_ladder_lanes_per_job: the lanes of a traced job's ``op_batch`` that
its batched Newton left invalid and sent through the convergence ladder,
from the program's ``op.ladder_lanes``; 0 where the program counted its
passes and no lane needed the ladder."""

SOURCE = "program_counter"
UNIT = "lanes"


def read(ctx):
    c = ctx.program_counters
    if "op.newton_passes" not in c or not ctx.jobs:
        return None
    return c.get("op.ladder_lanes", 0.0) / ctx.jobs
