"""reduce_span_ms: device ms per traced job of every kernel, copy or set
whose runtime call was made inside a job's ``reduce`` span: the
program's spans joined to the trace by correlation id
(``core/spans.py:reduce_span_ms``)."""

from portbench.core.spans import metric

SOURCE, UNIT, read = metric("reduce_span_ms")
