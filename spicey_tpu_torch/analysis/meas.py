"""Measurements (.meas tran|ac|dc) — an extension.

The reference has no measurement directives (SURVEY §5: no post-processing).
This implements the core of ngspice's ``.meas`` grammar over all three
sweep axes:

  .meas tran <name> max|min|pp|avg|rms|integ v(node) [from=t1] [to=t2]
  .meas tran <name> when v(node)=<val> [rise=k|fall=k|cross=k]
  .meas tran <name> find v(node) at=<t>
  .meas tran <name> trig v(n1)=<v1> [rise|fall|cross=k]
                    targ v(n2)=<v2> [rise|fall|cross=k]     (delay)
  .meas ac   <name> ... with x = frequency and the AC accessors
                    v()/vm() (magnitude), vdb() (20*log10|V|),
                    vp() (phase, degrees), vr()/vi() (real/imag)
  .meas dc   <name> ... with x = the swept source value (1D sweeps)

Both ``v(n)=val`` and ngspice's ``v(n) val=<val>`` spellings are accepted.
All evaluation is host-side numpy over the recorded waveforms (linear
interpolation between sweep points, trapezoidal integrals); measurements
that cannot be satisfied (missing crossing, empty window) evaluate to NaN
rather than raising, so one bad measure never kills a batch report. The
one evaluation kernel is shared by all three axes (and the batched
Monte-Carlo path), so they can never disagree on crossing semantics.

A copy of spicey_tpu/analysis/meas.py over the port's results, whose
series (and BatchTranResult's ``xs``) are already host NumPy arrays.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from .results import TranResult

_STAT_KINDS = ("max", "min", "pp", "avg", "rms", "integ")

_MEAS_HEAD_RE = re.compile(
    r"^\.meas(?:ure)?\s+(tran|ac|dc)\s+(\S+)\s+(.*)$", re.IGNORECASE)
_ACC = r"(v|vm|vdb|vp|vr|vi)"
_STAT_RE = re.compile(
    r"^(max|min|pp|avg|rms|integ)\s+" + _ACC + r"\(([^)]+)\)\s*(.*)$",
    re.IGNORECASE)
_WHEN_RE = re.compile(
    r"^when\s+" + _ACC
    + r"\(([^)]+)\)\s*(?:=\s*(\S+)|val\s*=\s*(\S+))\s*(.*)$",
    re.IGNORECASE)
_FIND_RE = re.compile(
    r"^find\s+" + _ACC + r"\(([^)]+)\)\s+at\s*=\s*(\S+)\s*$",
    re.IGNORECASE)
_TRIG_TARG_RE = re.compile(
    r"^trig\s+" + _ACC
    + r"\(([^)]+)\)\s*(?:=\s*(\S+)|val\s*=\s*(\S+))\s*(.*?)"
    r"\btarg\s+" + _ACC
    + r"\(([^)]+)\)\s*(?:=\s*(\S+)|val\s*=\s*(\S+))\s*(.*)$",
    re.IGNORECASE)
_KV_RE = re.compile(r"(\w+)\s*=\s*(\S+)")


@dataclass
class MeasSpec:
    name: str
    kind: str                 # one of _STAT_KINDS | "when" | "find" | "delay"
    node: str
    node2: str | None = None
    val: float | None = None
    val2: float | None = None
    edge: str = "cross"
    edge2: str = "cross"
    k: int = 1
    k2: int = 1
    t_from: float | None = None
    t_to: float | None = None
    at: float | None = None
    analysis: str = "tran"    # tran | ac | dc (the sweep axis)
    acc: str = "v"            # AC accessor: v/vm (|V|), vdb, vp, vr, vi
    acc2: str = "v"           # targ accessor (delay measures)


def _check_acc(analysis: str, acc: str, line: str) -> str:
    acc = acc.lower()
    if analysis != "ac" and acc != "v":
        raise ValueError(
            f".meas {analysis} supports only the v() accessor "
            f"(vm/vdb/vp/vr/vi are AC accessors): {line!r}")
    return acc


def _num(tok: str) -> float:
    from ..parsing.numbers import parse_number_with_units

    return parse_number_with_units(tok)


def _edge_and_count(opts: str) -> tuple[str, int]:
    """Parse trailing ``rise=K`` / ``fall=K`` / ``cross=K`` options."""
    edge, k = "cross", 1
    for key, val in _KV_RE.findall(opts):
        key = key.lower()
        if key in ("rise", "fall", "cross"):
            edge, k = key, int(float(val))
            if k < 1:
                raise ValueError(
                    f".meas crossing count must be >= 1, got {key}={val}")
    return edge, k


def parse_meas_line(line: str) -> MeasSpec:
    """Parse one ``.meas tran|ac|dc ...`` line into a MeasSpec (raises on
    errors)."""
    head = _MEAS_HEAD_RE.match(line.strip())
    if not head:
        raise ValueError(f"malformed .meas directive (tran/ac/dc measures "
                         f"are supported): {line!r}")
    analysis = head.group(1).lower()
    name, rest = head.group(2), head.group(3).strip()

    m = _STAT_RE.match(rest)
    if m:
        kind, acc, node, opts = (m.group(1).lower(), m.group(2),
                                 m.group(3), m.group(4))
        spec = MeasSpec(name=name, kind=kind, node=node, analysis=analysis,
                        acc=_check_acc(analysis, acc, line))
        for key, val in _KV_RE.findall(opts):
            if key.lower() == "from":
                spec.t_from = _num(val)
            elif key.lower() == "to":
                spec.t_to = _num(val)
        return spec

    m = _TRIG_TARG_RE.match(rest)
    if m:
        spec = MeasSpec(
            name=name, kind="delay", analysis=analysis,
            acc=_check_acc(analysis, m.group(1), line),
            node=m.group(2), val=_num(m.group(3) or m.group(4)),
            acc2=_check_acc(analysis, m.group(6), line),
            node2=m.group(7), val2=_num(m.group(8) or m.group(9)))
        spec.edge, spec.k = _edge_and_count(m.group(5))
        spec.edge2, spec.k2 = _edge_and_count(m.group(10))
        return spec

    m = _WHEN_RE.match(rest)
    if m:
        spec = MeasSpec(name=name, kind="when", analysis=analysis,
                        acc=_check_acc(analysis, m.group(1), line),
                        node=m.group(2),
                        val=_num(m.group(3) or m.group(4)))
        spec.edge, spec.k = _edge_and_count(m.group(5))
        return spec

    m = _FIND_RE.match(rest)
    if m:
        return MeasSpec(name=name, kind="find", analysis=analysis,
                        acc=_check_acc(analysis, m.group(1), line),
                        node=m.group(2), at=_num(m.group(3)))

    raise ValueError(f"malformed .meas directive: {line!r}")


def _waveform(tran: TranResult, node: str) -> tuple[np.ndarray, np.ndarray]:
    by_upper = {n.upper(): n for n in tran.node_voltages}
    canonical = by_upper.get(node.upper())
    if canonical is None:
        raise ValueError(
            f"Unknown node {node} in .meas (is it filtered out by "
            f".print tran?)")
    return (np.asarray(tran.times, dtype=np.float64),
            np.asarray(tran.node_voltages[canonical], dtype=np.float64))


def _apply_acc(z: np.ndarray, acc: str) -> np.ndarray:
    """AC accessor: complex phasors -> the measured real quantity."""
    if acc in ("v", "vm"):
        return np.abs(z)
    if acc == "vdb":
        return 20.0 * np.log10(np.maximum(np.abs(z), 1e-300))
    if acc == "vp":
        return np.degrees(np.angle(z))
    if acc == "vr":
        return np.asarray(z).real
    return np.asarray(z).imag  # vi


def _ac_waveform(ac, node: str, acc: str) -> tuple[np.ndarray, np.ndarray]:
    by_upper = {n.upper(): n for n in ac.node_voltages}
    canonical = by_upper.get(node.upper())
    if canonical is None:
        raise ValueError(f"Unknown node {node} in .meas ac")
    return (np.asarray(ac.freqs, dtype=np.float64),
            _apply_acc(np.asarray(ac.node_voltages[canonical]), acc))


def _dc_waveform(dc, node: str) -> tuple[np.ndarray, np.ndarray]:
    if dc.shape2d is not None:
        raise ValueError(
            ".meas dc is defined for 1D sweeps (the 2D nested sweep has "
            "no single x axis)")
    by_upper = {n.upper(): n for n in dc.node_voltages}
    canonical = by_upper.get(node.upper())
    if canonical is None:
        raise ValueError(f"Unknown node {node} in .meas dc")
    x = np.asarray(dc.sweep, dtype=np.float64)
    y = np.asarray(dc.node_voltages[canonical], dtype=np.float64)
    if x.shape[0] > 1 and x[1] < x[0]:
        # the crossing/window kernel assumes an increasing x axis
        x, y = x[::-1].copy(), y[::-1].copy()
    return x, y


def _interp_at(x: float, t: np.ndarray, V: np.ndarray) -> np.ndarray:
    """Linear interpolation of (B, S) waveforms at time x (in [t0, tN])."""
    j = int(np.searchsorted(t, x))
    if j >= t.shape[0]:
        return V[:, -1]
    if j == 0 or t[j] == x:
        return V[:, j]
    frac = (x - t[j - 1]) / (t[j] - t[j - 1])
    return V[:, j - 1] + frac * (V[:, j] - V[:, j - 1])


def _window(t: np.ndarray, V: np.ndarray, t_from: float | None,
            t_to: float | None):
    """Clip (B, S) waveforms to [from, to] with interpolated boundary
    samples, so integrals/averages cover the exact requested window even on
    coarse timesteps. Returns (tw, Vw) or (None, None) for an empty window."""
    t0 = t[0] if t_from is None else max(t_from, float(t[0]))
    t1 = t[-1] if t_to is None else min(t_to, float(t[-1]))
    if t1 < t0:
        return None, None
    inside = (t > t0) & (t < t1)
    tw = np.concatenate([[t0], t[inside], [t1]])
    Vw = np.concatenate(
        [_interp_at(t0, t, V)[:, None], V[:, inside],
         _interp_at(t1, t, V)[:, None]], axis=1)
    return tw, Vw


def _crossing_time_batch(t: np.ndarray, V: np.ndarray, level: float,
                         edge: str, k: int,
                         t_min: np.ndarray | None = None) -> np.ndarray:
    """k-th crossing time per variant (counting only crossings strictly
    after each variant's ``t_min``, when given). V: (B, S) -> (B,), NaN if
    the k-th crossing does not exist."""
    s = V - level
    sl, sr = s[:, :-1], s[:, 1:]
    rise = (sl < 0) & (sr >= 0) & (sr != sl)
    fall = (sl > 0) & (sr <= 0) & (sr != sl)
    hit = rise if edge == "rise" else fall if edge == "fall" else rise | fall
    denom = sr - sl
    denom = np.where(denom == 0.0, 1.0, denom)
    tc = t[:-1] + (-sl / denom) * (t[1:] - t[:-1])  # (B, S-1) crossing times
    if t_min is not None:
        # drop crossings strictly before t_min (a targ event simultaneous
        # with its trig counts — zero delay is a valid measurement; the
        # tolerance absorbs interpolation round-off between two
        # mathematically coincident crossings). NaN t_min filters nothing,
        # but the caller's targ-trig arithmetic propagates the NaN anyway
        tol = (t[-1] - t[0]) * 1e-9
        hit = hit & ~(tc < t_min[:, None] - tol)
    # first column where the running hit-count reaches k
    kth = (np.cumsum(hit, axis=1) == k) & hit
    found = kth.any(axis=1)
    i = kth.argmax(axis=1)
    b = np.arange(V.shape[0])
    return np.where(found, tc[b, i], np.nan)


def _batch_waveform(batch, node: str) -> np.ndarray:
    names_upper = [n.upper() for n in batch.node_names]
    if node.upper() not in names_upper:
        raise ValueError(f"Unknown node {node} in .meas")
    return np.asarray(batch.node_voltage(node), dtype=np.float64)


def _evaluate_rows(spec: MeasSpec, t: np.ndarray, V: np.ndarray,
                   V2: np.ndarray | None) -> np.ndarray:
    """The one evaluation kernel: (B, S) waveforms -> (B,) measurements.
    The scalar path runs it with B=1, so single and batched measurements
    can never disagree."""
    if spec.kind in _STAT_KINDS:
        tw, Vw = _window(t, V, spec.t_from, spec.t_to)
        if tw is None:
            return np.full(V.shape[0], np.nan)
        if spec.kind == "max":
            return Vw.max(axis=1)
        if spec.kind == "min":
            return Vw.min(axis=1)
        if spec.kind == "pp":
            return Vw.max(axis=1) - Vw.min(axis=1)
        span = tw[-1] - tw[0]
        if spec.kind == "integ":
            return np.trapezoid(Vw, tw, axis=1)
        if span <= 0.0:
            return Vw[:, 0] if spec.kind == "avg" else np.abs(Vw[:, 0])
        if spec.kind == "avg":
            return np.trapezoid(Vw, tw, axis=1) / span
        return np.sqrt(np.trapezoid(Vw ** 2, tw, axis=1) / span)  # rms

    if spec.kind == "when":
        return _crossing_time_batch(t, V, spec.val, spec.edge, spec.k)

    if spec.kind == "find":
        if spec.at < t[0] or spec.at > t[-1]:
            return np.full(V.shape[0], np.nan)
        return _interp_at(spec.at, t, V)

    # delay: k-th trig crossing, then the k2-th targ crossing AFTER it
    trig = _crossing_time_batch(t, V, spec.val, spec.edge, spec.k)
    targ = _crossing_time_batch(t, V2, spec.val2, spec.edge2, spec.k2,
                                t_min=trig)
    return targ - trig


def evaluate_meas(spec: MeasSpec, tran: TranResult) -> float:
    t, v = _waveform(tran, spec.node)
    v2 = (_waveform(tran, spec.node2)[1][None, :]
          if spec.kind == "delay" else None)
    return float(_evaluate_rows(spec, t, v[None, :], v2)[0])


def evaluate_meas_ac(spec: MeasSpec, ac) -> float:
    f, v = _ac_waveform(ac, spec.node, spec.acc)
    v2 = (_ac_waveform(ac, spec.node2, spec.acc2)[1][None, :]
          if spec.kind == "delay" else None)
    return float(_evaluate_rows(spec, f, v[None, :], v2)[0])


def evaluate_meas_dc(spec: MeasSpec, dc) -> float:
    x, v = _dc_waveform(dc, spec.node)
    v2 = (_dc_waveform(dc, spec.node2)[1][None, :]
          if spec.kind == "delay" else None)
    return float(_evaluate_rows(spec, x, v[None, :], v2)[0])


def simulate_meas(ckt, tran: TranResult | None, ac=None,
                  dc=None) -> dict[str, float] | None:
    """Evaluate every `.meas` line against its analysis' finished sweep."""
    if not ckt.meas:
        return None
    out: dict[str, float] = {}
    for spec in ckt.meas:
        if spec.analysis == "tran":
            if tran is None:
                raise ValueError(
                    ".meas tran requires a .tran analysis in the netlist")
            out[spec.name] = evaluate_meas(spec, tran)
        elif spec.analysis == "ac":
            if ac is None:
                raise ValueError(
                    ".meas ac requires a .ac analysis in the netlist")
            out[spec.name] = evaluate_meas_ac(spec, ac)
        else:
            if dc is None:
                raise ValueError(
                    ".meas dc requires a .dc analysis in the netlist")
            out[spec.name] = evaluate_meas_dc(spec, dc)
    return out


# --- batched evaluation over Monte-Carlo variants ---------------------------

def evaluate_meas_batch(spec: MeasSpec, batch) -> np.ndarray:
    """Evaluate one MeasSpec across every variant of a BatchTranResult.

    Returns a (B,) array — the measurement's Monte-Carlo distribution.
    Everything is vectorized numpy over the batch axis; no per-variant
    Python loop, so 10k-variant yield metrics stay O(ms).
    """
    t = np.asarray(batch.times, dtype=np.float64)
    V = _batch_waveform(batch, spec.node)
    V2 = _batch_waveform(batch, spec.node2) if spec.kind == "delay" else None
    return _evaluate_rows(spec, t, V, V2)


def meas_batch(ckt, batch) -> dict[str, np.ndarray]:
    """Every `.meas tran` line evaluated across a BatchTranResult's variants:
    the Monte-Carlo distribution of each measurement, ``{name: (B,)}``.
    AC/DC measures are per-run scalars and are skipped here."""
    if not ckt.meas:
        raise ValueError("netlist has no .meas lines")
    return {spec.name: evaluate_meas_batch(spec, batch)
            for spec in ckt.meas if spec.analysis == "tran"}
