"""The program's spans joined to a profiler trace of the same window.

The program records its spans on ``time.time_ns()``'s clock
(``spicey_tpu_torch.utils.profiling.intervals()``: qualified name, start
and end in ns), the base of ``torch.profiler``'s records. This module
reads the trace's raw records (``records``), as ``core/trace.py`` does,
keeping what that reduction drops: each CUDA runtime call's start, end and
correlation id, and each device record's correlation id. ``join`` then
puts

- each idle interval of the device (the window less the union of the
  device records: before the first, between, after the last) to the
  innermost program span open on the host over it, split where the spans
  change; time in no span is ``OUTSIDE`` ("outside the program");
- each device record to the span that was open when its launch or copy
  call was made (its runtime record, found by correlation id); a record
  whose call the trace lacks is put to ``UNLINKED``;
- each runtime call (launches, syncs) to the span open at its start,
  and each sync also to what the call before it put on the device (a
  copy to the host the program waits for, or a copy from the host that
  PyTorch follows with a sync).

The readers of the per-layer metrics that read spans and counters are at
the end (``READERS``): each takes a ``SpanContext`` and returns None when
the program has no such span or counter. A job's phases (``prepare``,
``solve``, ``reduce``) are the spans directly under its top-level span,
whatever the entry's name. ``metric`` binds a reader to a per-layer
metric's file (``metrics/<name>.py``), which gets run.py's ``Context``.
"""

from __future__ import annotations

import bisect
import statistics
from dataclasses import dataclass, field

from .trace import LAUNCH_CALLS, short

OUTSIDE = "outside the program"
UNLINKED = "no runtime call"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


@dataclass
class Records:
    """A trace's raw records: device (start_ns, end_ns, name, correlation)
    and host runtime calls (start_ns, end_ns, name, correlation)."""
    device: list[tuple[int, int, str, int]] = field(default_factory=list)
    runtime: list[tuple[int, int, str, int]] = field(default_factory=list)


def program_readings(profiling) -> tuple[list, dict]:
    """The program's closed spans and its counters
    (``profiling.intervals()``, ``profiling.counters()``); a program
    without the accessors has none of either."""
    return (list(getattr(profiling, "intervals", list)()),
            dict(getattr(profiling, "counters", dict)()))


def records(prof) -> Records:
    """The raw records of a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    out = Records()
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        rec = (start, start + e.duration_ns(), e.name(), e.correlation_id())
        if e.device_type() == DeviceType.CUDA:
            out.device.append(rec)
        else:
            out.runtime.append(rec)
    return out


class Timeline:
    """The innermost open span at each instant: ``segments`` is a sorted
    list of (start_ns, end_ns, label) that never overlap; an instant in
    none of them is in no span."""

    def __init__(self, intervals: list[tuple[str, int, int]]):
        events = []
        for qual, s, e in intervals:
            depth = qual.count("/")
            # at one instant: closes first (inner before outer), then
            # opens (outer before inner)
            events.append((s, 1, depth, qual))
            events.append((e, 0, -depth, qual))
        events.sort()
        self.segments: list[tuple[int, int, str]] = []
        open_: dict[str, int] = {}
        last = None
        for t, opens, _d, qual in events:
            if open_ and last is not None and t > last:
                label = max(open_, key=lambda q: q.count("/"))
                self.segments.append((last, t, label))
            if opens:
                open_[qual] = open_.get(qual, 0) + 1
            else:
                open_[qual] -= 1
                if not open_[qual]:
                    del open_[qual]
            last = t
        self._starts = [s for s, _e, _l in self.segments]

    def at(self, t: int) -> str:
        """The innermost span open at ``t`` (ns), else OUTSIDE."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t < self.segments[i][1]:
            return self.segments[i][2]
        return OUTSIDE

    def split(self, a: int, b: int) -> list[tuple[str, int]]:
        """[a, b) cut where the innermost span changes: (label, ns)."""
        out = []
        i = max(0, bisect.bisect_right(self._starts, a) - 1)
        t = a
        while t < b:
            if i < len(self.segments) and self.segments[i][1] <= t:
                i += 1
                continue
            if i < len(self.segments) and self.segments[i][0] <= t:
                end = min(b, self.segments[i][1])
                out.append((self.segments[i][2], end - t))
            else:
                end = b if i >= len(self.segments) \
                    else min(b, self.segments[i][0])
                out.append((OUTSIDE, end - t))
            t = end
        return out


@dataclass
class Join:
    """What ``join`` puts to each span label (a qualified span name,
    OUTSIDE, or for device records UNLINKED), in seconds and counts."""
    window_s: float = 0.0
    busy_s: float = 0.0
    idle_s: dict[str, float] = field(default_factory=dict)
    device_s: dict[str, float] = field(default_factory=dict)
    launches: dict[str, int] = field(default_factory=dict)
    syncs: dict[str, int] = field(default_factory=dict)
    host: dict[str, list[float]] = field(default_factory=dict)
    # label -> what the runtime call before each sync made on the device
    # ("Memcpy DtoH (Device -> Pageable)", ...) -> syncs
    sync_after: dict[str, dict[str, int]] = field(default_factory=dict)
    # "before <record>" (core/trace.py's names of the gaps between
    # records; the window's edges "before the first record" and "after
    # the last record") -> label -> idle seconds
    gap_split: dict[str, dict[str, float]] = field(default_factory=dict)

    @property
    def idle_total_s(self) -> float:
        return sum(self.idle_s.values())


def _add(d: dict, k, v) -> None:
    d[k] = d.get(k, 0) + v


def join(recs: Records, intervals: list[tuple[str, int, int]],
         window: tuple[int, int]) -> Join:
    """Join a trace's ``recs`` to the program's ``intervals`` over the
    traced ``window`` (start_ns, end_ns on the same clock)."""
    w0, w1 = window
    tl = Timeline(intervals)
    out = Join(window_s=(w1 - w0) * 1e-9)
    for qual, s, e in intervals:
        out.host.setdefault(qual, []).append((e - s) * 1e-9)
    # runtime calls: the span each was made in; a sync also by the
    # device record of the call just before it (the copy it waits for)
    by_corr: dict[int, str] = {}
    dev_name = {corr: name for _s, _e, name, corr in recs.device}
    prev = None
    for s, e, name, corr in sorted(recs.runtime):
        label = tl.at(s)
        by_corr[corr] = label
        if name in LAUNCH_CALLS:
            _add(out.launches, label, 1)
        elif name in SYNC_CALLS:
            _add(out.syncs, label, 1)
            after = ("no call" if prev is None
                     else short(dev_name.get(prev[3], prev[2]), 40))
            _add(out.sync_after.setdefault(label, {}), after, 1)
        prev = (s, e, name, corr)
    # device records: their span, the busy union, the idle gaps
    busy = 0
    cur_s = cur_e = None

    def idle(a: int, b: int, key: str) -> None:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            return
        split = out.gap_split.setdefault(key, {})
        for label, ns in tl.split(a, b):
            _add(out.idle_s, label, ns * 1e-9)
            _add(split, label, ns * 1e-9)

    def clipped(a: int, b: int) -> int:
        return max(0, min(b, w1) - max(a, w0))

    for s, e, name, corr in sorted(recs.device):
        _add(out.device_s, by_corr.get(corr, UNLINKED), (e - s) * 1e-9)
        if cur_e is None:
            idle(w0, s, "before the first record")
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += clipped(cur_s, cur_e)
            idle(cur_e, s, "before " + short(name, 80))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is None:
        idle(w0, w1, "no device record")
    else:
        busy += clipped(cur_s, cur_e)
        idle(cur_e, w1, "after the last record")
    out.busy_s = busy * 1e-9
    return out


def table(j: Join, jobs: int) -> list[list]:
    """Rows of the span table, per job: [label, host ms, device ms,
    launches, syncs, device idle ms]; host ms is each span's whole
    interval (its children's included), and OUTSIDE's the window less the
    outermost spans'."""
    labels = sorted(set(j.host) | set(j.idle_s) | set(j.device_s)
                    | set(j.launches) | set(j.syncs),
                    key=lambda q: (q in (OUTSIDE, UNLINKED), q))
    top = sum(sum(v) for q, v in j.host.items() if "/" not in q)
    per = 1.0 / max(jobs, 1)
    rows = []
    for q in labels:
        host = (max(0.0, j.window_s - top) if q == OUTSIDE
                else sum(j.host.get(q, [])))
        rows.append([q, 1e3 * host * per, 1e3 * j.device_s.get(q, 0.0) * per,
                     j.launches.get(q, 0) * per, j.syncs.get(q, 0) * per,
                     1e3 * j.idle_s.get(q, 0.0) * per])
    return rows


def format_table(rows: list[list]) -> str:
    lines = [f"{'span':<34} {'host ms':>10} {'device ms':>10} "
             f"{'launches':>9} {'syncs':>7} {'idle ms':>10}   (per job)"]
    for q, h, d, n, s, i in rows:
        lines.append(f"{q:<34} {h:>10.4f} {d:>10.4f} {n:>9.1f} {s:>7.1f} "
                     f"{i:>10.4f}")
    return "\n".join(lines)


# --- the readers of the span and counter metrics --------------------------

@dataclass
class SpanContext:
    """What a span or counter reader gets: the traced jobs, the join, and
    the program's counters over the traced window."""
    jobs: int
    join: Join
    counters: dict[str, float]


def _phase(q: str, phase: str) -> bool:
    """``q`` is the phase ``phase`` of a job's top-level span, or inside
    it."""
    parts = q.split("/")
    return len(parts) >= 2 and parts[1] == phase


def prepare_ms(ctx: SpanContext):
    """Median host ms a traced job spent in its ``prepare``."""
    times = [t for q, ts in ctx.join.host.items()
             if _phase(q, "prepare") and q.count("/") == 1 for t in ts]
    return 1e3 * statistics.median(times) if times else None


def solve_idle_pct(ctx: SpanContext):
    """Device idle inside ``solve`` spans, % of the traced window."""
    if not any(_phase(q, "solve") for q in ctx.join.host) \
            or ctx.join.window_s <= 0:
        return None
    idle = sum(s for q, s in ctx.join.idle_s.items() if _phase(q, "solve"))
    return 100.0 * idle / ctx.join.window_s


def reduce_span_ms(ctx: SpanContext):
    """Device ms per traced job of every record launched inside
    ``reduce``."""
    if not any(_phase(q, "reduce") for q in ctx.join.host) \
            or not ctx.join.device_s or not ctx.jobs:
        return None
    s = sum(v for q, v in ctx.join.device_s.items() if _phase(q, "reduce"))
    return 1e3 * s / ctx.jobs


def syncs_per_job(ctx: SpanContext):
    """The program's ``sync.*`` counters per traced job."""
    syncs = [v for k, v in ctx.counters.items() if k.startswith("sync.")]
    return sum(syncs) / ctx.jobs if syncs and ctx.jobs else None


def newton_passes_per_step(ctx: SpanContext):
    """``tran.newton_passes`` over ``tran.steps``."""
    steps = ctx.counters.get("tran.steps")
    passes = ctx.counters.get("tran.newton_passes")
    return passes / steps if steps and passes is not None else None


# name -> (source, unit, reader)
READERS = {
    "prepare_ms": ("program_span", "ms", prepare_ms),
    "solve_idle_pct": ("program_span", "%", solve_idle_pct),
    "reduce_span_ms": ("program_span", "ms", reduce_span_ms),
    "syncs_per_job": ("program_counter", "syncs", syncs_per_job),
    "newton_passes_per_step": ("program_counter", "passes",
                               newton_passes_per_step),
}


def metric(name: str) -> tuple:
    """(SOURCE, UNIT, read) of the per-layer metric ``name`` for its file
    under ``metrics/``: ``read`` takes run.py's ``Context`` and reads
    ``READERS[name]`` from its spans and counters."""
    source, unit, reader = READERS[name]

    def read(ctx):
        sc = ctx.span_context
        return None if sc is None else reader(sc)
    return source, unit, read
