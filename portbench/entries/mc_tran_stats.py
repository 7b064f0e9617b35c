"""Entry: ``spicey_tpu_torch.mc_tran_stats``, per-point statistics of one probed
response over a job's variants (core/entry.py: StatsEntry)."""

from portbench.core.entry import StatsEntry

ENTRY = StatsEntry("mc_tran_stats")
