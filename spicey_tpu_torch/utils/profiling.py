"""Spans and counters of the engine, on the profiler's clock.

The reference has no tracing/profiling of any kind (SURVEY §5 — no timers,
no counters anywhere in lib/). This module gives the engine a minimal,
zero-dependency observability layer:

    from spicey_tpu_torch.utils import profiling
    with profiling.profiled():       # enable collection
        mc_tran_stats(...)
        with profiling.span("my-postprocess"):
            ...
    print(profiling.report())        # calls, total and own ms per span
    profiling.intervals()            # [(qualified name, start_ns, end_ns)]
    profiling.counters()             # {name: value}

What a span records. Inside ``profiled()``, ``span(name)`` reads
``time.time_ns()`` as it opens and as it closes, and keeps the interval
as (qualified name, start_ns, end_ns), the qualified name being the open
spans' names joined by "/" ("mc_tran_stats/solve"). ``time.time_ns()`` is
the base of ``torch.profiler``'s records: its host records, and the
device records, which Kineto converts to that base. So an interval can be
laid beside a trace's records. Each qualified name also adds one call and
its interval to ``report()``'s totals (own ms: the total less the spans
opened directly inside it), on the same clock.

A span times the host. On a CUDA device the work it enqueues runs later,
so the interval holds the enqueue (and any host sync inside it), not the
kernels. A span calls no CUDA API: it does not sync, record an event or
launch anything, so the profiler's trace is the same with spans on or
off. To put device time to a span, join the trace to the intervals: a
kernel or copy belongs to the span that was open when its runtime call
was made (the trace's correlation ids link the two).

``count(name, value)`` bumps a named counter, which ``report()`` lists
after the spans. The engine's counters: ``tran.steps`` and
``tran.newton_passes`` (the batched time loop), and one ``sync.<site>``
per place on the Monte-Carlo routes where the host waits for the device
(``bool``/``.item()``/``.cpu()`` of a device tensor).

Off (outside ``profiled()``, the default), ``span`` costs one flag check
and returns a shared no-op context manager, and ``count`` one flag check;
the per-pass loops keep their tallies in local ints and call ``count``
once per call, never once per pass. A copy in names of
spicey_tpu/utils/profiling.py: ``profiled``, ``span``, ``count`` and
``report`` behave as there.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

_NOOP = nullcontext()


@dataclass
class _Node:
    count: int = 0
    total_ns: int = 0
    children_ns: int = 0


@dataclass
class _State:
    enabled: bool = False
    spans: dict[str, _Node] = field(default_factory=dict)
    stack: list[str] = field(default_factory=list)
    counters: dict[str, float] = field(default_factory=dict)
    intervals: list[tuple[str, int, int]] = field(default_factory=list)


_state = _State()


class _Span:
    """One open span: its interval on ``time.time_ns()``'s clock."""

    __slots__ = ("name", "qual", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Span":
        _state.stack.append(self.name)
        self.qual = "/".join(_state.stack)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.time_ns()
        _state.stack.pop()
        _state.intervals.append((self.qual, self.t0, t1))
        node = _state.spans.setdefault(self.qual, _Node())
        node.count += 1
        node.total_ns += t1 - self.t0
        if _state.stack:
            parent = "/".join(_state.stack)
            _state.spans.setdefault(parent, _Node()).children_ns += \
                t1 - self.t0
        return False


@contextmanager
def profiled(reset: bool = True):
    """Enable span/counter collection inside the block; ``reset`` clears
    what an earlier block collected."""
    if reset:
        _state.spans.clear()
        _state.counters.clear()
        _state.intervals.clear()
    prev = _state.enabled
    _state.enabled = True
    try:
        yield _state
    finally:
        _state.enabled = prev


def span(name: str):
    """A named span (a no-op unless inside profiled()): ``with span(n):``."""
    if not _state.enabled:
        return _NOOP
    return _Span(name)


def count(name: str, value: float = 1.0) -> None:
    """Bump a named counter (no-op unless inside profiled())."""
    if _state.enabled:
        _state.counters[name] = _state.counters.get(name, 0.0) + value


def intervals() -> list[tuple[str, int, int]]:
    """Every closed span's (qualified name, start_ns, end_ns), in the order
    they closed, ``time.time_ns()``'s clock."""
    return list(_state.intervals)


def counters() -> dict[str, float]:
    """Every counter's value."""
    return dict(_state.counters)


def report() -> str:
    """Human-readable table of collected spans and counters."""
    lines = ["span, calls, total_ms, own_ms"]
    for name in sorted(_state.spans):
        n = _state.spans[name]
        own = max(0, n.total_ns - n.children_ns)
        lines.append(
            f"{name}, {n.count}, {n.total_ns * 1e-6:.3f}, {own * 1e-6:.3f}"
        )
    if _state.counters:
        lines.append("counter, value")
        for name in sorted(_state.counters):
            lines.append(f"{name}, {_state.counters[name]:g}")
    return "\n".join(lines)
