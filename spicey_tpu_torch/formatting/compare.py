"""Voltage-trace comparison metric.

Contract: spicey/tests/fixtures/compare-voltage-levels.ts:23-134 —
the reference uses this to quantify deviation vs its ngspice oracle
(mean/max absolute difference and mean-vs-reference-max percentage per node,
names normalized by stripping a trailing " (ngspice)" and uppercasing,
values rounded via Number(x.toFixed(6))).
"""

from __future__ import annotations

import re

from .jsnum import to_fixed


def _normalize_graph_name(name: str) -> str:
    return re.sub(r"\s*\(ngspice\)$", "", name, flags=re.IGNORECASE).upper()


def _round6(value: float) -> float:
    return float(to_fixed(value, 6))


def _graph_name(graph: dict) -> str:
    return graph.get("name") or graph["simulation_transient_voltage_graph_id"]


def _compare_node(spicey_graph: dict, ngspice_graph: dict) -> dict:
    sv = spicey_graph["voltage_levels"]
    nv = ngspice_graph["voltage_levels"]
    samples = min(len(sv), len(nv))

    sum_abs = 0.0
    max_abs = 0.0
    ref_max = 0.0
    for i in range(samples):
        a = sv[i] if sv[i] is not None else 0.0
        b = nv[i] if nv[i] is not None else 0.0
        diff = abs(a - b)
        max_abs = max(max_abs, diff)
        ref_max = max(ref_max, abs(b))
        sum_abs += diff

    mean_abs = sum_abs / samples if samples else max_abs
    if ref_max == 0:
        pct = 0.0 if mean_abs == 0 else 100.0
    else:
        pct = mean_abs / ref_max * 100.0

    return {
        "compared_samples": samples,
        "mean_absolute_difference": _round6(mean_abs),
        "max_absolute_difference": _round6(max_abs),
        "reference_max_magnitude": _round6(ref_max),
        "percentage_difference": _round6(pct),
    }


def compare_voltage_levels(spicey_graphs: list, ngspice_graphs: list) -> dict:
    ngspice_map = {_normalize_graph_name(_graph_name(g)): g
                   for g in ngspice_graphs}
    nodes: dict[str, dict] = {}
    unmatched_spicey: list[str] = []
    total_pct = 0.0
    counted = 0

    for sg in spicey_graphs:
        norm = _normalize_graph_name(_graph_name(sg))
        ng = ngspice_map.get(norm)
        if ng is None:
            unmatched_spicey.append(_graph_name(sg))
            continue
        comparison = _compare_node(sg, ng)
        nodes[norm] = comparison
        total_pct += comparison["percentage_difference"]
        counted += 1

    unmatched_ngspice = [
        name for name in
        (_normalize_graph_name(_graph_name(g)) for g in ngspice_graphs)
        if name not in nodes
    ]

    return {
        "overall_average_percentage_difference":
            _round6(total_pct / counted) if counted else 0,
        "nodes": nodes,
        "unmatched_spicey_nodes": unmatched_spicey,
        "unmatched_ngspice_nodes": unmatched_ngspice,
    }
