"""newton_passes_per_step: the program's ``tran.newton_passes`` over its
``tran.steps`` in the traced window: the batched time loop's Newton
passes a time step (``core/spans.py:newton_passes_per_step``)."""

from portbench.core.spans import metric

SOURCE, UNIT, read = metric("newton_passes_per_step")
