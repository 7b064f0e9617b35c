"""Fourier analysis of transient waveforms (.four) — an extension.

The reference has no `.four` (SURVEY §5: no post-processing beyond the text
formatters). This mirrors ngspice's `.four <f0> v(node)...`: decompose each
probed node's transient waveform over its final fundamental period into DC
plus the first ``n_harmonics`` harmonics and report magnitude, phase,
normalized magnitude, and total harmonic distortion.

Pure host-side numpy post-processing of an already-computed TranResult —
a few hundred samples per probe, far below the threshold where shipping it
to the card would pay for the transfer. A copy of
spicey_tpu/analysis/four.py over the port's TranResult (its series are
already host NumPy arrays).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..parsing.netlist import ParsedCircuit
from .results import TranResult


@dataclass
class FourierProbe:
    """Decomposition of one node's waveform."""

    node: str
    freqs: np.ndarray          # (H+1,) harmonic frequencies, k*f0
    magnitude: np.ndarray      # (H+1,) |c_k| (index 0 = DC component)
    phase_deg: np.ndarray      # (H+1,) phase in degrees
    normalized: np.ndarray     # (H+1,) magnitude / magnitude[1]
    thd_percent: float         # sqrt(sum_{k>=2} |c_k|^2) / |c_1| * 100


@dataclass
class FourierResult:
    fundamental: float
    probes: dict[str, FourierProbe] = field(default_factory=dict)


def fourier_of_waveform(times, values, f0: float,
                        n_harmonics: int = 9,
                        n_points: int = 1000) -> tuple[np.ndarray, ...]:
    """Harmonic decomposition of one waveform's final period.

    ngspice semantics: analyze the LAST full period [t_end - 1/f0, t_end],
    resampled onto ``n_points`` uniform points by linear interpolation.
    Returns (magnitude, phase_deg, normalized, thd_percent) with index 0
    the DC term and indices 1..n_harmonics the harmonics of ``f0``.
    """
    times = np.asarray(times, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    if f0 <= 0.0:
        raise ValueError(".four fundamental frequency must be > 0")
    period = 1.0 / f0
    t_end = float(times[-1])
    t_start = t_end - period
    if t_start < float(times[0]) - 1e-15:
        raise ValueError(
            f".four needs at least one full period of {f0} Hz in the "
            f"transient window ({times[0]}..{t_end} s)")
    # uniform resample, excluding the endpoint (it aliases the start)
    grid = t_start + period * np.arange(n_points) / n_points
    y = np.interp(grid, times, values)

    spec = np.fft.rfft(y) / n_points
    k = np.arange(n_harmonics + 1)
    c = spec[k]
    # one-sided amplitudes: DC stays as-is, harmonics double
    mag = np.abs(c) * np.where(k == 0, 1.0, 2.0)
    phase = np.degrees(np.angle(c))
    ref = mag[1]
    normalized = mag / ref if ref > 0 else np.zeros_like(mag)
    thd = (100.0 * np.sqrt(np.sum(mag[2:] ** 2)) / ref if ref > 0
           else 0.0)
    return mag, phase, normalized, float(thd)


def simulate_four(
    ckt: ParsedCircuit,
    tran: TranResult | None,
    n_harmonics: int = 9,
) -> FourierResult | None:
    """Run the `.four` post-analysis over a finished transient."""
    if ckt.four is None:
        return None
    if tran is None:
        raise ValueError(".four requires a .tran analysis in the netlist")
    spec = ckt.four
    by_upper = {n.upper(): n for n in tran.node_voltages}
    result = FourierResult(fundamental=spec.f0)
    for probe in spec.probes:
        canonical = by_upper.get(probe.upper())
        if canonical is None:
            raise ValueError(
                f"Unknown node {probe} in .four (is it filtered out by "
                f".print tran?)")
        mag, phase, normalized, thd = fourier_of_waveform(
            tran.times, tran.node_voltages[canonical], spec.f0,
            n_harmonics=n_harmonics)
        freqs = spec.f0 * np.arange(n_harmonics + 1)
        result.probes[canonical] = FourierProbe(
            node=canonical, freqs=freqs, magnitude=mag, phase_deg=phase,
            normalized=normalized, thd_percent=thd)
    return result
