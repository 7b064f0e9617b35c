"""Lightweight instrumentation: wall-clock spans and counters.

The reference has no tracing/profiling of any kind (SURVEY §5 — no timers,
no counters anywhere in lib/). This module gives the engine a minimal,
zero-dependency observability layer:

    from spicey_tpu_torch.utils.profiling import profiled, span, report
    with profiled():                 # enable collection
        simulate(net)
        with span("my-postprocess"):
            ...
    print(report())

Spans nest; each records call count and total/own wall time. Collection is
off by default and costs nothing when disabled (a module-level flag check).
CUDA asynchronous launch caveat: spans measure host wall-clock; call
``torch.cuda.synchronize()`` around device work you want attributed
precisely (the engine adds none). A copy of spicey_tpu/utils/profiling.py;
``count`` bumps a named counter, which ``report`` lists after the spans.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class _Node:
    count: int = 0
    total_s: float = 0.0
    children_s: float = 0.0


@dataclass
class _State:
    enabled: bool = False
    spans: dict[str, _Node] = field(default_factory=dict)
    stack: list[str] = field(default_factory=list)
    counters: dict[str, float] = field(default_factory=dict)


_state = _State()


@contextmanager
def profiled(reset: bool = True):
    """Enable span/counter collection inside the block."""
    if reset:
        _state.spans.clear()
        _state.counters.clear()
    prev = _state.enabled
    _state.enabled = True
    try:
        yield _state
    finally:
        _state.enabled = prev


@contextmanager
def span(name: str):
    """Record a named wall-clock span (no-op unless inside profiled())."""
    if not _state.enabled:
        yield
        return
    qual = "/".join(_state.stack + [name])
    _state.stack.append(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - t0
        _state.stack.pop()
        node = _state.spans.setdefault(qual, _Node())
        node.count += 1
        node.total_s += elapsed
        if _state.stack:
            parent = "/".join(_state.stack)
            _state.spans.setdefault(parent, _Node()).children_s += elapsed


def count(name: str, value: float = 1.0) -> None:
    """Bump a named counter (no-op unless inside profiled())."""
    if _state.enabled:
        _state.counters[name] = _state.counters.get(name, 0.0) + value


def report() -> str:
    """Human-readable table of collected spans and counters."""
    lines = ["span, calls, total_ms, own_ms"]
    for name in sorted(_state.spans):
        n = _state.spans[name]
        own = max(0.0, n.total_s - n.children_s)
        lines.append(
            f"{name}, {n.count}, {n.total_s * 1e3:.3f}, {own * 1e3:.3f}"
        )
    if _state.counters:
        lines.append("counter, value")
        for name in sorted(_state.counters):
            lines.append(f"{name}, {_state.counters[name]:g}")
    return "\n".join(lines)
