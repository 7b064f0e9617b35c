"""Text-table result formatters.

Contract:
  - format_ac_result:   spicey/lib/formatting/formatAcResult.ts:3-25
    header ``f(Hz), <node>:|V|,∠V(deg), ...``; per-row 6-sig-fig magnitude and
    phase (degrees) via JS toPrecision semantics; this exact text (including
    the ``∠`` glyph) is the basics01 golden-snapshot contract.
  - format_tran_result: spicey/lib/formatting/formatTranResult.ts:1-23
    header ``t(s), <node>:V, ...``; 6-sig-fig rows.
  - format_dc_result, format_tf_result, format_noise_result,
    format_op_result, format_four_result: the extended analyses' tables,
    copies of spicey_tpu/formatting/text.py:67-182.
"""

from __future__ import annotations

import math

from typing import TYPE_CHECKING

import numpy as np

from .jsnum import to_precision

if TYPE_CHECKING:  # import-cycle-free annotations only
    from ..analysis.four import FourierResult
    from ..analysis.noise import NoiseResult
    from ..analysis.op import DCResult, OPResult
    from ..analysis.results import ACResult, TranResult
    from ..analysis.tf import TFResult


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


def format_dc_result(dc: DCResult | None) -> str:
    """Text table for the extended-dialect .dc sweep (no reference analog;
    mirrors format_tran_result's 6-sig-fig layout with the swept value as
    the first column)."""
    if dc is None:
        return "No DC analysis.\n"
    nodes = list(dc.node_voltages.keys())
    header = ", ".join(["sweep"] + [f"{n}:V" for n in nodes])
    lines = [header]
    sweep = np.asarray(dc.sweep)
    for k in range(len(sweep)):
        row = [to_precision(float(sweep[k]), 6)]
        for n in nodes:
            row.append(to_precision(float(dc.node_voltages[n][k]), 6))
        lines.append(", ".join(row))
    return "\n".join(lines)


def format_tf_result(tf: TFResult | None) -> str:
    """Text summary for the extended-dialect .tf analysis (ngspice-style
    three-line report)."""
    if tf is None:
        return "No TF analysis.\n"
    return "\n".join([
        f"transfer_function({tf.out_spec}/{tf.src_name}) = "
        f"{to_precision(tf.transfer_function, 6)}",
        f"input_impedance({tf.src_name}) = "
        f"{to_precision(tf.input_impedance, 6)}",
        f"output_impedance({tf.out_spec}) = "
        f"{to_precision(tf.output_impedance, 6)}",
    ])


def format_noise_result(noise: NoiseResult | None) -> str:
    """Text table for the extended-dialect .noise analysis."""
    if noise is None:
        return "No NOISE analysis.\n"
    lines = [
        f"Noise analysis at {noise.out_spec}, input {noise.src_name}, "
        f"total output noise = "
        f"{to_precision(float(noise.total_output_rms), 6)} Vrms",
        "f(Hz), onoise(V/sqrt(Hz)), inoise(V/sqrt(Hz)), |gain|",
    ]
    onoise = noise.output_v_per_sqrt_hz
    inoise = noise.input_v_per_sqrt_hz
    gain = np.abs(noise.gain)
    for k in range(len(noise.freqs)):
        lines.append(", ".join([
            to_precision(float(noise.freqs[k]), 6),
            to_precision(float(onoise[k]), 6),
            to_precision(float(inoise[k]), 6),
            to_precision(float(gain[k]), 6),
        ]))
    return "\n".join(lines)


def format_op_result(op: OPResult | None) -> str:
    """Text table for the extended-dialect .op operating point."""
    if op is None:
        return "No OP analysis.\n"
    lines = ["node, V"]
    for name, v in op.node_voltages.items():
        lines.append(f"{name}, {to_precision(float(v), 6)}")
    lines.append("element, I")
    for name, i in op.element_currents.items():
        lines.append(f"{name}, {to_precision(float(i), 6)}")
    return "\n".join(lines)


def format_four_result(four: FourierResult | None) -> str:
    """Text table for the extended-dialect .four Fourier analysis
    (ngspice-style per-probe harmonic table)."""
    if four is None:
        return "No FOUR analysis.\n"
    blocks = []
    for name, p in four.probes.items():
        lines = [
            f"Fourier analysis for v({name}), fundamental "
            f"{to_precision(float(four.fundamental), 6)} Hz, "
            f"THD = {to_precision(float(p.thd_percent), 6)} %",
            "harmonic, f(Hz), magnitude, phase(deg), normalized",
        ]
        for k in range(len(p.freqs)):
            lines.append(", ".join([
                str(k),
                to_precision(float(p.freqs[k]), 6),
                to_precision(float(p.magnitude[k]), 6),
                to_precision(float(p.phase_deg[k]), 6),
                to_precision(float(p.normalized[k]), 6),
            ]))
        blocks.append("\n".join(lines))
    return "\n\n".join(blocks)


def format_noise_result(noise: NoiseResult | None) -> str:
    """Text table for the extended-dialect .noise analysis."""
    if noise is None:
        return "No NOISE analysis.\n"
    lines = [
        f"Noise analysis at {noise.out_spec}, input {noise.src_name}, "
        f"total output noise = "
        f"{to_precision(float(noise.total_output_rms), 6)} Vrms",
        "f(Hz), onoise(V/sqrt(Hz)), inoise(V/sqrt(Hz)), |gain|",
    ]
    onoise = noise.output_v_per_sqrt_hz
    inoise = noise.input_v_per_sqrt_hz
    gain = np.abs(noise.gain)
    for k in range(len(noise.freqs)):
        lines.append(", ".join([
            to_precision(float(noise.freqs[k]), 6),
            to_precision(float(onoise[k]), 6),
            to_precision(float(inoise[k]), 6),
            to_precision(float(gain[k]), 6),
        ]))
    return "\n".join(lines)


def format_op_result(op: OPResult | None) -> str:
    """Text table for the extended-dialect .op operating point."""
    if op is None:
        return "No OP analysis.\n"
    lines = ["node, V"]
    for name, v in op.node_voltages.items():
        lines.append(f"{name}, {to_precision(float(v), 6)}")
    lines.append("element, I")
    for name, i in op.element_currents.items():
        lines.append(f"{name}, {to_precision(float(i), 6)}")
    return "\n".join(lines)
