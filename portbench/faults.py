"""Faults planted under a cell's timed path, for the checks that a run
with the path broken comes out not correct (``tests/``) and for reading
what each fault does to the compared numbers at the cell's own size
(``control.py --faults``).

Each entry declares the faults its route can have
(``entries/<entry>.py:FAULTS``: name -> a function of the cell's spec
returning a context manager that plants the fault where that route
produces or reduces its answer, and restores the route after). This
module finds them by the cell's entry; ``patched`` is the one way an
entry swaps a function of the program for a broken one.
"""

from __future__ import annotations

import contextlib

from portbench.core import manifest


def of(spec: dict) -> dict:
    """The faults of the cell ``spec``'s entry (``manifest.Cell.spec``):
    name -> context manager factory."""
    return dict(getattr(manifest.module("entries", spec["entry"]),
                        "FAULTS", {}))


def names(spec: dict) -> tuple[str, ...]:
    return tuple(of(spec))


@contextlib.contextmanager
def planted(spec: dict, fault: str):
    """Run the body with ``fault`` planted in the program's route for the
    cell ``spec``; the route is restored after."""
    faults = of(spec)
    if fault not in faults:
        raise ValueError(f"the entry {spec['entry']!r} has no fault "
                         f"{fault!r}; it has {tuple(faults)}")
    with faults[fault](spec):
        yield


@contextlib.contextmanager
def patched(owner, name: str, wrap):
    """``owner.<name>`` replaced by ``wrap(<the original>)`` in the body,
    restored after."""
    inner = getattr(owner, name)
    setattr(owner, name, wrap(inner))
    try:
        yield
    finally:
        setattr(owner, name, inner)
