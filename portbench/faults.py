"""Faults planted under a cell's timed path, for the checks that a run
with the path broken comes out not correct (``tests/``) and for reading
what each fault does to the compared numbers at the cell's own size
(``control.py --faults``).

The faults a statistics cell can have: ``frozen``, a time step that
returns its state unchanged (every point holds the first point's value);
``half``, half of the batch left out and the statistics taken over the
rest; ``altered``, one variant's answer altered where it is produced. No
cell runs across chips, so no exchange between chips can be left out.
"""

from __future__ import annotations

import contextlib

import torch

# the program's route function that produces a job's responses, by the
# ``method`` a cell passes (the fused kernel or the batched time loop)
ROUTES = {"pallas": "_mc_tran_fused_responses",
          "gj": "_mc_tran_loop_responses"}
FAULTS = ("frozen", "half", "altered")


def frozen(v: torch.Tensor) -> torch.Tensor:
    return v[:, :1].expand_as(v).clone()


def altered(v: torch.Tensor) -> torch.Tensor:
    out = v.clone()
    out[0] = out[0] * 1.5
    return out


@contextlib.contextmanager
def planted(spec: dict, fault: str):
    """Run the body with ``fault`` planted in the program's route for the
    cell ``spec`` (``manifest.Cell.spec``); the route is restored after."""
    from spicey_tpu_torch.analysis import mc
    if fault == "half":
        name, inner = "_reduce", mc._reduce

        def broken(resp, valid, *a, **k):
            n = resp.shape[0] // 2
            return inner(resp[:n], valid[:n], *a, **k)
    elif fault in ("frozen", "altered"):
        name = ROUTES[spec["args"]["method"]]
        inner, change = getattr(mc, name), globals()[fault]

        def broken(*a, **k):
            v, valid = inner(*a, **k)
            return change(v), valid
    else:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    setattr(mc, name, broken)
    try:
        yield
    finally:
        setattr(mc, name, inner)
