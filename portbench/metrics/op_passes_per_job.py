"""op_passes_per_job: the batched Newton passes a traced job ran in
``op_batch`` (its convergence ladder's not among them), from the
program's ``op.newton_passes``, per job."""

SOURCE = "program_counter"
UNIT = "passes"


def read(ctx):
    passes = ctx.program_counters.get("op.newton_passes")
    if passes is None or not ctx.jobs:
        return None
    return passes / ctx.jobs
