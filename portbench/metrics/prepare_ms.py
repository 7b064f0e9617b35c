"""prepare_ms: the median host ms a traced job spent in its entry's
``prepare`` span (checks, tiling, the copies to the card, the route's
inputs), from the program's spans (``core/spans.py:prepare_ms``)."""

from portbench.core.spans import metric

SOURCE, UNIT, read = metric("prepare_ms")
