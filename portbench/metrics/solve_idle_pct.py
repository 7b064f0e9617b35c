"""solve_idle_pct: the device's idle time while a job's ``solve`` span
(or one inside it) was the innermost open on the host, in % of the
traced window: the program's spans joined to the trace
(``core/spans.py:solve_idle_pct``)."""

from portbench.core.spans import metric

SOURCE, UNIT, read = metric("solve_idle_pct")
