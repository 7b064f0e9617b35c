"""Entry: ``spicey_tpu_torch.mc_tran_stats``, per-point statistics of one
probed response over a job's variants (core/entry.py: StatsEntry).

Its faults (``FAULTS``): ``frozen``, a time step that returns its state
unchanged (every point holds the first point's value); ``half``, half of
the batch left out and the statistics taken over the rest; ``altered``,
one variant's answer altered where it is produced. The first and last
are planted in the route that produces a job's responses, chosen by the
``method`` the cell passes (the fused kernel or the batched time loop);
``half`` in the reduction that both routes share. No cell of this entry
runs across chips, so no exchange between chips can be left out.
"""

from __future__ import annotations

import torch

from portbench.core.entry import StatsEntry
from portbench.faults import patched

ENTRY = StatsEntry("mc_tran_stats")

# the program's route function that produces a job's responses, by the
# ``method`` a cell passes
ROUTES = {"pallas": "_mc_tran_fused_responses",
          "gj": "_mc_tran_loop_responses"}


def _frozen(v: torch.Tensor) -> torch.Tensor:
    return v[:, :1].expand_as(v).clone()


def _altered(v: torch.Tensor) -> torch.Tensor:
    out = v.clone()
    out[0] = out[0] * 1.5
    return out


def _route(spec: dict, change):
    from spicey_tpu_torch.analysis import mc

    def wrap(inner):
        def broken(*a, **k):
            v, valid = inner(*a, **k)
            return change(v), valid
        return broken
    return patched(mc, ROUTES[spec["args"]["method"]], wrap)


def _half(spec: dict):
    from spicey_tpu_torch.analysis import mc

    def wrap(inner):
        def broken(resp, valid, *a, **k):
            n = resp.shape[0] // 2
            return inner(resp[:n], valid[:n], *a, **k)
        return broken
    return patched(mc, "_reduce", wrap)


FAULTS = {"frozen": lambda spec: _route(spec, _frozen),
          "half": _half,
          "altered": lambda spec: _route(spec, _altered)}
