"""Entry: ``spicey_tpu_torch.op_batch``, the batched DC operating point of
a deck over a job's variants (a ``.step`` sweep becomes one such call):
one answer a variant, every node voltage.

``call`` runs ``op_batch(ckt, overrides, tensors=, method=, device=)``
with the cell's ``args`` (no ``precision``: ``op_batch`` computes in
float64 only). The reference (``reference/<config>.py``) gives, for the
same overrides, ``operating_points(deck_text, overrides, dtype, device)
-> (v (B, nodes), node names, ok (B,), info)``.

Compared numbers: ``op_gap``, the largest |program - reference| over
every variant and node voltage, over the reference's largest |value|;
``lanes_missing``, variants reported invalid or not finite (exact, 0).

Its faults (``FAULTS``): ``half``, half of the variants reported
invalid; ``altered``, one variant's solution times 1.5, both where the
batched Newton's answer leaves the card (``op._batched_op``); and
``one_pass``, the Newton loop (``op._op_core``) stopped after its first
pass with every variant marked done.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.core import stats
from portbench.core.entry import DTYPES
from portbench.faults import patched


class OpBatchEntry:
    def call(self, program, ckt, tensors, overrides, spec, device):
        return program.op_batch(ckt, overrides, tensors=tensors,
                                device=device, **spec["args"])

    def dtype(self, spec) -> str:
        return "float64"

    def points(self, result) -> int:
        return 1

    def invalid(self, result, B: int) -> int:
        finite = np.isfinite(np.asarray(result.x)).all(axis=1)
        return (B - int(np.asarray(result.valid).sum())) \
            + int((~finite).sum())

    def _reference(self, ref, deck_text, overrides, dtype, device):
        v, names, ok, info = ref.operating_points(deck_text, overrides,
                                                  dtype, device)
        return v.to(torch.float64).cpu().numpy(), [n.upper() for n in
                                                   names], ok, info

    def judge(self, result, tensors, ref, deck_text, overrides, spec,
              device) -> tuple[dict, dict]:
        B = len(next(iter(overrides.values())))
        want, names, ok, info = self._reference(
            ref, deck_text, overrides, torch.float64, device)
        if not bool(ok.all()):
            raise RuntimeError(f"the reference failed "
                               f"{int((~ok).sum())} of {B} variants")
        cols = [n.upper() for n in result.node_names]
        got = np.asarray(result.x, np.float64)[:, [cols.index(n)
                                                    for n in names]]
        return ({"op_gap": stats.gap({"x": got}, {"x": want}),
                 "lanes_missing": self.invalid(result, B)}, info)

    def control(self, ref, deck_text, overrides, spec, device) -> dict:
        want, _n, _ok, _i = self._reference(ref, deck_text, overrides,
                                            torch.float64, device)
        got, _n, ok, _i = self._reference(
            ref, deck_text, overrides, DTYPES[spec["control_dtype"]],
            device)
        return {"op_gap": stats.gap({"x": got}, {"x": want}),
                "lanes_missing": int((~ok).sum())}


ENTRY = OpBatchEntry()


def _answer(change):
    from spicey_tpu_torch.analysis import op

    def wrap(inner):
        def broken(*a, **k):
            x, valid, passes = inner(*a, **k)
            return (*change(x.copy(), valid.copy()), passes)
        return broken
    return patched(op, "_batched_op", wrap)


def _half(x, valid):
    valid[: len(valid) // 2] = False
    return x, valid


def _altered(x, valid):
    x[0] = x[0] * 1.5
    return x, valid


def _one_pass(spec: dict):
    from spicey_tpu_torch.analysis import op

    def wrap(inner):
        def broken(*a, **k):
            x, sw, valid, passes = inner(*a, **dict(k, max_iters=1))
            return x, sw, torch.ones_like(valid), passes
        return broken
    return patched(op, "_op_core", wrap)


FAULTS = {"half": lambda spec: _answer(_half),
          "altered": lambda spec: _answer(_altered),
          "one_pass": _one_pass}
