"""op_pass_ms: host ms of ``op_batch/solve`` (the batched Newton: each
pass's assembly, its solve and its ``bool(done.all())``) a batched pass:
the spans' total over the program's ``op.newton_passes``."""

SOURCE = "program_span"
UNIT = "ms"


def read(ctx):
    passes = ctx.program_counters.get("op.newton_passes")
    solve = [end - start for qual, start, end in ctx.spans
             if qual == "op_batch/solve" or qual.endswith("/op_batch/solve")]
    if not passes or not solve:
        return None
    return 1e-6 * sum(solve) / passes
