"""circuit-json interop: transient results -> SimulationTransientVoltageGraph.

Contract: spicey/lib/formatting/formatToVGraph.ts:11-66. Output is a
list of plain dicts shaped exactly like the tscircuit `circuit-json` elements
(seconds -> milliseconds timestamps, ``stvg_<experiment>_<node>`` ids,
``V(<node>)`` names, ngspice variant suffixed ``" (ngspice)"``).
"""

from __future__ import annotations

import numpy as np


def spicey_tran_to_vgraphs(tran_result: object, ckt: object,
                           simulation_experiment_id: str) -> list[dict]:
    if tran_result is None or ckt.tran is None:
        return []
    dt = ckt.tran.dt
    tstop = ckt.tran.tstop
    times = np.asarray(tran_result.times, dtype=np.float64)
    graphs = []
    for node_name, series in tran_result.node_voltages.items():
        graphs.append({
            "type": "simulation_transient_voltage_graph",
            "simulation_transient_voltage_graph_id":
                f"stvg_{simulation_experiment_id}_{node_name}",
            "simulation_experiment_id": simulation_experiment_id,
            "timestamps_ms": [float(t) * 1000 for t in times],
            "voltage_levels": [float(v) for v in np.asarray(series)],
            "time_per_step": dt * 1000,
            "start_time_ms": 0,
            "end_time_ms": tstop * 1000,
            "name": f"V({node_name})",
        })
    return graphs


def eec_engine_tran_to_vgraphs(tran_result: dict, ckt: object,
                               simulation_experiment_id: str) -> list[dict]:
    """ngspice-style {time_s, voltages} record -> vgraphs
    (formatToVGraph.ts:41-66)."""
    if ckt.tran is None:
        return []
    dt = ckt.tran.dt
    tstop = ckt.tran.tstop
    graphs = []
    for node_name, series in tran_result["voltages"].items():
        graphs.append({
            "type": "simulation_transient_voltage_graph",
            "simulation_transient_voltage_graph_id":
                f"stvg_{simulation_experiment_id}_{node_name}_eec",
            "simulation_experiment_id": simulation_experiment_id,
            "timestamps_ms": [float(t) * 1000 for t in tran_result["time_s"]],
            "voltage_levels": [float(v) for v in series],
            "time_per_step": dt * 1000,
            "start_time_ms": 0,
            "end_time_ms": tstop * 1000,
            "name": f"V({node_name}) (ngspice)",
        })
    return graphs
