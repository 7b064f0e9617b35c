"""Result containers.

Shapes mirror the reference's return records:
  - AC:   {freqs, nodeVoltages, elementCurrents} with per-frequency phasors
          (spicey/lib/analysis/simulateAC.ts:129)
  - TRAN: {times, nodeVoltages, elementCurrents}
          (spicey/lib/analysis/simulateTRAN.ts:251)
The extended analyses' results (OPResult, DCResult, TFResult, NoiseResult,
PZResult, SensResult, FourierResult, and the batched BatchACResult,
BatchTranResult, BatchOPResult) live beside their analyses, as in the JAX
package; ``.step`` gathers the batched ones in a StepResult.
Series are NumPy arrays instead of JS number lists; dict insertion order
matches the reference's recording order (nodes in discovery order, then
element currents in R, C, L, V[, S, D] stamp order).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ACResult:
    freqs: np.ndarray  # (F,) float64
    node_voltages: dict[str, np.ndarray]  # name -> (F,) complex128
    element_currents: dict[str, np.ndarray] = field(default_factory=dict)

    # camelCase views for drop-in familiarity with the reference API
    @property
    def nodeVoltages(self):
        return self.node_voltages

    @property
    def elementCurrents(self):
        return self.element_currents


@dataclass
class TranResult:
    times: np.ndarray  # (S+1,) float64
    node_voltages: dict[str, np.ndarray]  # name -> (S+1,) float64
    element_currents: dict[str, np.ndarray] = field(default_factory=dict)
    state: object | None = None  # TranState checkpoint (return_state=True)

    @property
    def nodeVoltages(self):
        return self.node_voltages

    @property
    def elementCurrents(self):
        return self.element_currents


@dataclass
class StepResult:
    """Extended ``.step``: every step value is one lane of a batched run.

    ``ac``/``tran``/``op`` are the Batch* results (lane order follows
    ``values``); ``meas`` maps each .meas tran name to its per-step array
    (``analysis/meas.py:meas_batch`` over the batched transient)."""

    param: str
    values: np.ndarray                 # (S,) step values
    ac: object | None = None           # BatchACResult
    tran: object | None = None         # BatchTranResult
    op: object | None = None           # BatchOPResult
    meas: dict | None = None           # {name: (S,)}


@dataclass
class SimulationResult:
    circuit: object
    ac: ACResult | None
    tran: TranResult | None
    op: object | None = None  # OPResult when the extended .op directive ran
    dc: object | None = None  # DCResult when the extended .dc directive ran
    tf: object | None = None  # TFResult when the extended .tf directive ran
    noise: object | None = None  # NoiseResult when the extended .noise ran
    four: object | None = None  # FourierResult when the extended .four ran
    meas: dict | None = None  # {name: value} when extended .meas lines ran
    pz: object | None = None  # PZResult when the extended .pz directive ran
    sens: object | None = None  # SensResult when the extended .sens ran
    step: object | None = None  # StepResult when the extended .step ran
    control_output: str | None = None  # .control print/echo text (extended)
