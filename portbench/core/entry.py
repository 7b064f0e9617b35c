"""How a cell drives one entry point of the program, and how the
yardstick judges what it returned.

An entry (``entries/<name>.py``) binds a caller to a public function of
the program (``ENTRY``: one of these classes, or one of its own) and
declares the faults its route can have (``FAULTS``, ``faults.py``).
``call`` is the job's call; ``dtype`` the precision it computes in (the
work formulas' item size); ``points`` the solutions one variant gives;
``invalid`` the lanes it reports as failed, read between jobs; ``judge``
the comparison of a returned answer with the plain reference, run after
the window on the sampled jobs; ``control`` the same comparison with the
reference in a lower precision put in the program's place.

Compared numbers (each with its limit in ``workloads/<cell>.json``):
  - ``stats_gap``: statistics jobs. Row by row (mean, std, min, max and
    each quantile, over the grid), the largest difference from the
    reference's statistics over the largest reference value of that row;
    the worst row.
  - ``op_gap``: operating-point jobs (``entries/op_batch.py``). The
    largest difference from the reference over every variant and node
    voltage, over the reference's largest value.
  - ``lanes_missing``: variants that the program left out, reported
    invalid, or returned as NaN; exact, 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import stats

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}
# the program's precision argument -> the dtype it computes in
PRECISIONS = {"f64": "float64", "f32": "float32"}


class StatsEntry:
    """``mc_tran_stats`` / ``mc_ac_stats``: per-point statistics of one
    probed response over the variants."""

    def __init__(self, function: str):
        self.function = function

    def call(self, program, ckt, tensors, overrides, spec, device):
        fn = getattr(program, self.function)
        return fn(ckt, overrides, spec["node"], tensors=tensors,
                  quantiles=tuple(float(q) for q in spec["quantiles"]),
                  device=device, **spec["args"])

    def dtype(self, spec) -> str:
        return PRECISIONS[spec["args"]["precision"]]

    def points(self, result) -> int:
        return len(result.grid)

    def invalid(self, result, B: int) -> int:
        rows = [result.mean, result.std, result.min, result.max,
                *result.quantiles.values()]
        finite = all(np.all(np.isfinite(r)) for r in rows)
        return (B - int(result.n_valid)) + (0 if finite else 1)

    def answer(self, result) -> dict[str, np.ndarray]:
        out = {"mean": result.mean, "std": result.std, "min": result.min,
               "max": result.max}
        for q, row in result.quantiles.items():
            out[stats.quantile_name(float(q))] = row
        return {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}

    def _reference(self, ref, deck_text, overrides, spec, dtype, device):
        """The reference's statistics at ``dtype`` over the variants whose
        responses are finite, the variants it failed (a pivot under its
        floor, or a NaN), and what it counted (``info``)."""
        resp, ok, info = ref.responses(deck_text, overrides, spec["node"],
                                       dtype, device)
        finite = torch.isfinite(resp).all(dim=1)
        if not bool(finite.any()):
            return None, int((~ok).sum()), info
        summary = stats.summary(resp[finite], tuple(
            float(q) for q in spec["quantiles"]))
        return summary, int((~ok).sum()), info

    def judge(self, result, tensors, ref, deck_text, overrides, spec,
              device) -> tuple[dict, dict]:
        B = len(next(iter(overrides.values())))
        want, ref_missing, info = self._reference(
            ref, deck_text, overrides, spec, torch.float64, device)
        if ref_missing:
            raise RuntimeError(f"the reference failed {ref_missing} of {B} "
                               "variants")
        return ({"stats_gap": stats.gap(self.answer(result), want),
                 "lanes_missing": self.invalid(result, B)}, info)

    def control(self, ref, deck_text, overrides, spec, device) -> dict:
        want, _m, _i = self._reference(ref, deck_text, overrides, spec,
                                       torch.float64, device)
        got, missing, _i = self._reference(
            ref, deck_text, overrides, spec, DTYPES[spec["control_dtype"]],
            device)
        gap = math.inf if got is None else stats.gap(got, want)
        return {"stats_gap": gap, "lanes_missing": missing}
