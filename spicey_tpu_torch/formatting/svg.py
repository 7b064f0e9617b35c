"""Simulation-graph SVG rendering.

Analog of the reference test stack's visualization path (SURVEY §2.19-2.20):
the reference feeds its vgraph elements through the external `circuit-to-svg`
package's ``convertCircuitJsonToSimulationGraphSvg`` and snapshots the result
(tests/transient/transient01.test.ts:57-62). This is a clean-room renderer
with the same interface shape: it consumes the circuit-json
``simulation_transient_voltage_graph`` dicts produced by
formatting/vgraph.py and emits a deterministic standalone SVG line chart
(axes, per-trace polylines, legend), suitable for snapshot testing.
A copy of spicey_tpu/formatting/svg.py on the port's ``to_precision``.
"""

from __future__ import annotations

from .jsnum import to_precision

_WIDTH = 800
_HEIGHT = 480
_MARGIN_L = 64
_MARGIN_R = 160
_MARGIN_T = 32
_MARGIN_B = 48

_TRACE_COLORS = (
    "#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e",
    "#8c564b", "#e377c2", "#17becf",
)


def _nice_ticks(lo: float, hi: float, n: int = 6) -> list[float]:
    """Evenly spaced ticks across [lo, hi] (deterministic, no magic)."""
    if hi <= lo:
        hi = lo + 1.0
    step = (hi - lo) / (n - 1)
    return [lo + i * step for i in range(n)]


def _fmt(x: float) -> str:
    return to_precision(float(x), 4)


def convert_simulation_graphs_to_svg(
    circuit_json: list,
    simulation_experiment_id: str,
) -> str:
    """Render the experiment's voltage graphs to an SVG string.

    ``circuit_json`` mixes a ``simulation_experiment`` element and
    ``simulation_transient_voltage_graph`` elements, mirroring the
    reference's CircuitJsonWithSimulation input shape.
    """
    experiment = next(
        (el for el in circuit_json
         if el.get("type") == "simulation_experiment"
         and el.get("simulation_experiment_id") == simulation_experiment_id),
        None,
    )
    graphs = [
        el for el in circuit_json
        if el.get("type") == "simulation_transient_voltage_graph"
        and el.get("simulation_experiment_id") == simulation_experiment_id
    ]
    title = (experiment or {}).get("name", simulation_experiment_id)

    all_t = [t for g in graphs for t in g["timestamps_ms"]]
    all_v = [v for g in graphs for v in g["voltage_levels"]]
    t_lo, t_hi = (min(all_t), max(all_t)) if all_t else (0.0, 1.0)
    v_lo, v_hi = (min(all_v), max(all_v)) if all_v else (0.0, 1.0)
    if v_hi == v_lo:
        v_hi = v_lo + 1.0
    pad = 0.05 * (v_hi - v_lo)
    v_lo -= pad
    v_hi += pad

    plot_w = _WIDTH - _MARGIN_L - _MARGIN_R
    plot_h = _HEIGHT - _MARGIN_T - _MARGIN_B

    def sx(t: float) -> float:
        return _MARGIN_L + (t - t_lo) / (t_hi - t_lo or 1.0) * plot_w

    def sy(v: float) -> float:
        return _MARGIN_T + (v_hi - v) / (v_hi - v_lo) * plot_h

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{_WIDTH}" '
        f'height="{_HEIGHT}" viewBox="0 0 {_WIDTH} {_HEIGHT}">',
        f'<rect width="{_WIDTH}" height="{_HEIGHT}" fill="white"/>',
        f'<text x="{_MARGIN_L}" y="20" font-family="monospace" '
        f'font-size="14" fill="#222">{title}</text>',
    ]

    # grid + axis labels
    for tv in _nice_ticks(t_lo, t_hi):
        x = sx(tv)
        parts.append(
            f'<line x1="{x:.2f}" y1="{_MARGIN_T}" x2="{x:.2f}" '
            f'y2="{_MARGIN_T + plot_h}" stroke="#ddd" stroke-width="1"/>'
        )
        parts.append(
            f'<text x="{x:.2f}" y="{_HEIGHT - 28}" font-family="monospace" '
            f'font-size="11" fill="#555" text-anchor="middle">{_fmt(tv)}</text>'
        )
    for vv in _nice_ticks(v_lo, v_hi):
        y = sy(vv)
        parts.append(
            f'<line x1="{_MARGIN_L}" y1="{y:.2f}" '
            f'x2="{_MARGIN_L + plot_w}" y2="{y:.2f}" stroke="#ddd" '
            f'stroke-width="1"/>'
        )
        parts.append(
            f'<text x="{_MARGIN_L - 6}" y="{y + 4:.2f}" '
            f'font-family="monospace" font-size="11" fill="#555" '
            f'text-anchor="end">{_fmt(vv)}</text>'
        )
    parts.append(
        f'<text x="{_MARGIN_L + plot_w / 2:.2f}" y="{_HEIGHT - 8}" '
        f'font-family="monospace" font-size="12" fill="#222" '
        f'text-anchor="middle">t (ms)</text>'
    )
    parts.append(
        f'<text x="16" y="{_MARGIN_T + plot_h / 2:.2f}" '
        f'font-family="monospace" font-size="12" fill="#222" '
        f'text-anchor="middle" '
        f'transform="rotate(-90 16 {_MARGIN_T + plot_h / 2:.2f})">V</text>'
    )

    # traces + legend
    for gi, g in enumerate(graphs):
        color = _TRACE_COLORS[gi % len(_TRACE_COLORS)]
        pts = " ".join(
            f"{sx(t):.2f},{sy(v):.2f}"
            for t, v in zip(g["timestamps_ms"], g["voltage_levels"])
        )
        dash = ' stroke-dasharray="5,3"' if gi % 2 else ""
        parts.append(
            f'<polyline points="{pts}" fill="none" stroke="{color}" '
            f'stroke-width="1.5"{dash}/>'
        )
        ly = _MARGIN_T + 16 + gi * 18
        lx = _WIDTH - _MARGIN_R + 12
        parts.append(
            f'<line x1="{lx}" y1="{ly - 4}" x2="{lx + 24}" y2="{ly - 4}" '
            f'stroke="{color}" stroke-width="1.5"{dash}/>'
        )
        name = g.get("name", g["simulation_transient_voltage_graph_id"])
        parts.append(
            f'<text x="{lx + 30}" y="{ly}" font-family="monospace" '
            f'font-size="11" fill="#222">{name}</text>'
        )

    parts.append("</svg>")
    return "\n".join(parts)
