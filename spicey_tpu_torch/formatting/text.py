"""Text-table result formatters.

Contract:
  - format_ac_result:   spicey/lib/formatting/formatAcResult.ts:3-25
    header ``f(Hz), <node>:|V|,∠V(deg), ...``; per-row 6-sig-fig magnitude and
    phase (degrees) via JS toPrecision semantics; this exact text (including
    the ``∠`` glyph) is the basics01 golden-snapshot contract.
  - format_tran_result: spicey/lib/formatting/formatTranResult.ts:1-23
    header ``t(s), <node>:V, ...``; 6-sig-fig rows.
"""

from __future__ import annotations

import math

from typing import TYPE_CHECKING

import numpy as np

from .jsnum import to_precision

if TYPE_CHECKING:  # import-cycle-free annotations only
    from ..analysis.results import ACResult, TranResult


def _abs_phase(z: complex) -> tuple[float, float]:
    mag = math.hypot(z.real, z.imag)
    phase = math.atan2(z.imag, z.real) * 180.0 / math.pi
    return mag, phase


def format_ac_result(ac: ACResult | None) -> str:
    if ac is None:
        return "No AC analysis.\n"
    nodes = list(ac.node_voltages.keys())
    lines = ["f(Hz), " + ", ".join(f"{n}:|V|,∠V(deg)" for n in nodes)]
    freqs = np.asarray(ac.freqs)
    for k in range(len(freqs)):
        parts = [to_precision(float(freqs[k]), 6)]
        for n in nodes:
            z = complex(ac.node_voltages[n][k])
            mag, phase = _abs_phase(z)
            parts.append(f"{to_precision(mag, 6)},{to_precision(phase, 6)}")
        lines.append(", ".join(parts))
    return "\n".join(lines)


def format_tran_result(tran: TranResult | None) -> str:
    if tran is None:
        return "No TRAN analysis.\n"
    nodes = list(tran.node_voltages.keys())
    header = ", ".join(["t(s)"] + [f"{n}:V" for n in nodes])
    lines = [header]
    times = np.asarray(tran.times)
    for k in range(len(times)):
        row = [to_precision(float(times[k]), 6)]
        for n in nodes:
            row.append(to_precision(float(tran.node_voltages[n][k]), 6))
        lines.append(", ".join(row))
    return "\n".join(lines)
