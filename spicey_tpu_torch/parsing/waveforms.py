"""Time-domain source waveforms: PULSE(...) and PWL(...).

Contract:
  - PulseSpec fields:  spicey/lib/types/simulation.ts:1-10
  - parse_pulse_args:  spicey/lib/parsing/parsePulseArgs.ts:4-23
  - pulse_value:       spicey/lib/parsing/pulseValue.ts:4-22
  - parse_pwl_args:    spicey/lib/parsing/parsePwlArgs.ts:3-19
  - pwl_value:         spicey/lib/parsing/pwlValue.ts:3-16

Unlike the reference (per-call scalar closures), each waveform also exposes a
vectorized ``sample(t)`` over a whole time grid (NumPy, float64) so transient
runs can precompute every source value for every timestep in one shot before
entering the compiled `lax.scan` — the time axis never sees Python callbacks.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import numpy as np

from ..constants import EPS
from .numbers import parse_number_with_units

_PULSE_HEAD_RE = re.compile(r"^pulse\s*\(", re.IGNORECASE)
_PWL_HEAD_RE = re.compile(r"^pwl\s*\(", re.IGNORECASE)
_SPLIT_RE = re.compile(r"[\s,]+")


def _strip_call(token: str, head_re: re.Pattern[str]) -> str:
    clean = head_re.sub("(", token.strip(), count=1)
    clean = re.sub(r"^\(", "", clean)
    clean = re.sub(r"\)$", "", clean)
    return clean.strip()


@dataclass(frozen=True)
class PulseSpec:
    v1: float
    v2: float
    td: float
    tr: float
    tf: float
    ton: float
    period: float
    ncycles: float  # Infinity when unbounded


def parse_pulse_args(token: str) -> PulseSpec:
    inside = _strip_call(token, _PULSE_HEAD_RE)
    parts = [p for p in _SPLIT_RE.split(inside) if p]
    if len(parts) < 7:
        raise ValueError("PULSE(...) requires 7 or 8 args")
    vals = [parse_number_with_units(p) for p in parts]
    if any(math.isnan(v) for v in vals):
        raise ValueError("Invalid PULSE() numeric value")
    return PulseSpec(
        v1=vals[0], v2=vals[1], td=vals[2], tr=vals[3], tf=vals[4],
        ton=vals[5], period=vals[6],
        ncycles=vals[7] if len(parts) > 7 else math.inf,
    )


def parse_pwl_args(token: str) -> list[tuple[float, float]]:
    inside = _strip_call(token, _PWL_HEAD_RE)
    parts = [p for p in _SPLIT_RE.split(inside) if p]
    if len(parts) == 0 or len(parts) % 2 != 0:
        raise ValueError("PWL(...) requires an even number of time/value pairs")
    pairs: list[tuple[float, float]] = []
    for i in range(0, len(parts), 2):
        t = parse_number_with_units(parts[i])
        v = parse_number_with_units(parts[i + 1])
        if math.isnan(t) or math.isnan(v):
            raise ValueError("Invalid PWL() numeric value")
        pairs.append((t, v))
    return pairs


def pulse_value(p: PulseSpec, t: float) -> float:
    """Scalar pulse evaluation (reference pulseValue.ts:4-22)."""
    if t < p.td:
        return p.v1
    tt = t - p.td
    cycles_done = math.floor(tt / p.period)
    if cycles_done >= p.ncycles:
        return p.v1
    tc = tt - cycles_done * p.period
    if tc < p.tr:
        return p.v1 + (p.v2 - p.v1) * (tc / max(p.tr, EPS))
    if tc < p.tr + p.ton:
        return p.v2
    if tc < p.tr + p.ton + p.tf:
        a = (tc - (p.tr + p.ton)) / max(p.tf, EPS)
        return p.v2 + (p.v1 - p.v2) * a
    return p.v1


def pwl_value(pairs: list[tuple[float, float]], t: float) -> float:
    """Scalar PWL evaluation (reference pwlValue.ts:3-16): clamp-ends lerp."""
    if not pairs:
        return 0.0
    if t <= pairs[0][0]:
        return pairs[0][1]
    for i in range(1, len(pairs)):
        tp, vp = pairs[i - 1]
        tc, vc = pairs[i]
        if t <= tc:
            dt = max(tc - tp, EPS)
            return vp + (vc - vp) * ((t - tp) / dt)
    return pairs[-1][1]


class Waveform:
    """Base class: a time-domain source with scalar and vectorized sampling."""

    def __call__(self, t: float) -> float:
        raise NotImplementedError

    def sample(self, t: np.ndarray) -> np.ndarray:
        """Vectorized float64 evaluation over a time grid."""
        raise NotImplementedError


class PulseWaveform(Waveform):
    def __init__(self, spec: PulseSpec) -> None:
        self.spec = spec

    def __call__(self, t: float) -> float:
        return pulse_value(self.spec, t)

    def sample(self, t: np.ndarray) -> np.ndarray:
        p = self.spec
        t = np.asarray(t, dtype=np.float64)
        tt = t - p.td
        with np.errstate(divide="ignore", invalid="ignore"):
            cycles_done = np.floor(tt / p.period)
        tc = tt - cycles_done * p.period
        rise = p.v1 + (p.v2 - p.v1) * (tc / max(p.tr, EPS))
        fall = p.v2 + (p.v1 - p.v2) * ((tc - (p.tr + p.ton)) / max(p.tf, EPS))
        out = np.where(
            tc < p.tr, rise,
            np.where(tc < p.tr + p.ton, p.v2,
                     np.where(tc < p.tr + p.ton + p.tf, fall, p.v1)),
        )
        out = np.where(cycles_done >= p.ncycles, p.v1, out)
        out = np.where(t < p.td, p.v1, out)
        return out


class PwlWaveform(Waveform):
    def __init__(self, pairs: list[tuple[float, float]]) -> None:
        self.pairs = pairs

    def __call__(self, t: float) -> float:
        return pwl_value(self.pairs, t)

    def sample(self, t: np.ndarray) -> np.ndarray:
        t = np.asarray(t, dtype=np.float64)
        if not self.pairs:
            return np.zeros_like(t)
        ts = np.array([p[0] for p in self.pairs], dtype=np.float64)
        vs = np.array([p[1] for p in self.pairs], dtype=np.float64)
        if ts.shape[0] == 1 or not np.all(np.diff(ts) >= 0):
            # non-monotone knots: fall back to the scalar first-match scan
            return np.array([pwl_value(self.pairs, float(x)) for x in t])
        # vectorized version of the reference's exact lerp formula
        # (pwlValue.ts:8-14): segment i is the first with t <= ts[i]
        idx = np.searchsorted(ts, t, side="left")
        seg = np.clip(idx, 1, ts.shape[0] - 1)
        tp, tc = ts[seg - 1], ts[seg]
        vp, vc = vs[seg - 1], vs[seg]
        a = (t - tp) / np.maximum(tc - tp, EPS)
        out = vp + (vc - vp) * a
        out = np.where(t <= ts[0], vs[0], out)
        out = np.where(t > ts[-1], vs[-1], out)
        return out


# --- extended-dialect waveforms (no reference analog: the reference's
# source scanner skips unknown keywords, parseNetlist.ts:384-388) ---

_SIN_HEAD_RE = re.compile(r"^sin\s*\(", re.IGNORECASE)
_EXP_HEAD_RE = re.compile(r"^exp\s*\(", re.IGNORECASE)
_SFFM_HEAD_RE = re.compile(r"^sffm\s*\(", re.IGNORECASE)
_AM_HEAD_RE = re.compile(r"^am\s*\(", re.IGNORECASE)


@dataclass(frozen=True)
class SinSpec:
    """SIN(VO VA FREQ [TD [THETA [PHASE]]]) — ngspice semantics:
    v(t) = VO for t < TD, else
    VO + VA * e^{-(t-TD)*THETA} * sin(2*pi*(FREQ*(t-TD) + PHASE/360))."""

    vo: float
    va: float
    freq: float
    td: float = 0.0
    theta: float = 0.0
    phase_deg: float = 0.0


def parse_sin_args(token: str) -> SinSpec:
    parts = [p for p in _SPLIT_RE.split(_strip_call(token, _SIN_HEAD_RE)) if p]
    if len(parts) < 3 or len(parts) > 6:
        raise ValueError("SIN() requires 3 to 6 arguments")
    vals = [parse_number_with_units(p) for p in parts]
    vals += [0.0] * (6 - len(vals))
    return SinSpec(*vals)


@dataclass(frozen=True)
class ExpSpec:
    """EXP(V1 V2 TD1 TAU1 TD2 TAU2) — rise toward V2 after TD1 with time
    constant TAU1, fall back toward V1 after TD2 with TAU2 (ngspice)."""

    v1: float
    v2: float
    td1: float = 0.0
    tau1: float = 1e-9
    td2: float = 1e-9
    tau2: float = 1e-9


def parse_exp_args(token: str) -> ExpSpec:
    parts = [p for p in _SPLIT_RE.split(_strip_call(token, _EXP_HEAD_RE)) if p]
    if len(parts) < 2 or len(parts) > 6:
        raise ValueError("EXP() requires 2 to 6 arguments")
    vals = [parse_number_with_units(p) for p in parts]
    defaults = [None, None, 0.0, 1e-9, None, 1e-9]
    out = list(vals) + defaults[len(vals):]
    if out[4] is None:
        out[4] = out[2] + out[3]  # default TD2 = TD1 + TAU1
    return ExpSpec(*out)


class SinWaveform(Waveform):
    def __init__(self, spec: SinSpec) -> None:
        self.spec = spec

    def sample(self, t: np.ndarray) -> np.ndarray:
        s = self.spec
        t = np.asarray(t, dtype=np.float64)
        dt = t - s.td
        active = dt >= 0.0
        damp = np.exp(-np.where(active, dt, 0.0) * s.theta)
        wave = s.vo + s.va * damp * np.sin(
            2.0 * math.pi * (s.freq * dt + s.phase_deg / 360.0))
        return np.where(active, wave, s.vo)

    def __call__(self, t: float) -> float:
        return float(self.sample(np.asarray([t]))[0])


class ExpWaveform(Waveform):
    def __init__(self, spec: ExpSpec) -> None:
        self.spec = spec

    def sample(self, t: np.ndarray) -> np.ndarray:
        s = self.spec
        t = np.asarray(t, dtype=np.float64)
        tau1 = max(s.tau1, EPS)
        tau2 = max(s.tau2, EPS)
        d1 = np.maximum(t - s.td1, 0.0)
        d2 = np.maximum(t - s.td2, 0.0)
        rise = (s.v2 - s.v1) * (1.0 - np.exp(-d1 / tau1))
        fall = (s.v1 - s.v2) * (1.0 - np.exp(-d2 / tau2))
        return s.v1 + np.where(t >= s.td1, rise, 0.0) \
            + np.where(t >= s.td2, fall, 0.0)

    def __call__(self, t: float) -> float:
        return float(self.sample(np.asarray([t]))[0])


@dataclass(frozen=True)
class SffmSpec:
    """SFFM(VO VA FC MDI FS [PHASEC [PHASES]]) — single-frequency FM
    (ngspice): v(t) = VO + VA*sin(2*pi*FC*t + PHASEC/360*2*pi
                                  + MDI*sin(2*pi*FS*t + PHASES/360*2*pi))."""

    vo: float
    va: float
    fc: float
    mdi: float = 0.0
    fs: float = 0.0
    phasec_deg: float = 0.0
    phases_deg: float = 0.0


def parse_sffm_args(token: str) -> SffmSpec:
    parts = [p for p in _SPLIT_RE.split(_strip_call(token, _SFFM_HEAD_RE))
             if p]
    if len(parts) < 3 or len(parts) > 7:
        raise ValueError("SFFM() requires 3 to 7 arguments")
    vals = [parse_number_with_units(p) for p in parts]
    vals += [0.0] * (7 - len(vals))
    return SffmSpec(*vals)


@dataclass(frozen=True)
class AmSpec:
    """AM(VA VO MF FC [TD [PHASES]]) — amplitude modulation (ngspice):
    v(t) = VA*(VO + sin(2*pi*MF*(t-TD)))*sin(2*pi*FC*(t-TD)
               + PHASES/360*2*pi) for t >= TD, else 0."""

    va: float
    vo: float
    mf: float
    fc: float
    td: float = 0.0
    phases_deg: float = 0.0


def parse_am_args(token: str) -> AmSpec:
    parts = [p for p in _SPLIT_RE.split(_strip_call(token, _AM_HEAD_RE)) if p]
    if len(parts) < 4 or len(parts) > 6:
        raise ValueError("AM() requires 4 to 6 arguments")
    vals = [parse_number_with_units(p) for p in parts]
    vals += [0.0] * (6 - len(vals))
    return AmSpec(*vals)


class SffmWaveform(Waveform):
    def __init__(self, spec: SffmSpec) -> None:
        self.spec = spec

    def sample(self, t: np.ndarray) -> np.ndarray:
        s = self.spec
        t = np.asarray(t, dtype=np.float64)
        two_pi = 2.0 * math.pi
        inner = two_pi * s.fs * t + s.phases_deg / 360.0 * two_pi
        return s.vo + s.va * np.sin(
            two_pi * s.fc * t + s.phasec_deg / 360.0 * two_pi
            + s.mdi * np.sin(inner))

    def __call__(self, t: float) -> float:
        return float(self.sample(np.asarray([t]))[0])


class AmWaveform(Waveform):
    def __init__(self, spec: AmSpec) -> None:
        self.spec = spec

    def sample(self, t: np.ndarray) -> np.ndarray:
        s = self.spec
        t = np.asarray(t, dtype=np.float64)
        two_pi = 2.0 * math.pi
        dt = t - s.td
        wave = s.va * (s.vo + np.sin(two_pi * s.mf * dt)) * np.sin(
            two_pi * s.fc * dt + s.phases_deg / 360.0 * two_pi)
        return np.where(dt >= 0.0, wave, 0.0)

    def __call__(self, t: float) -> float:
        return float(self.sample(np.asarray([t]))[0])
