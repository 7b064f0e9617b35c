"""syncs_per_job: the program's ``sync.*`` counters (each place on the
route where the host waits for the card) per traced job
(``core/spans.py:syncs_per_job``)."""

from portbench.core.spans import metric

SOURCE, UNIT, read = metric("syncs_per_job")
