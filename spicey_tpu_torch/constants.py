"""Numeric constants shared across the engine.

Behavioral contract mirrors the reference:
  - EPS:       spicey/lib/constants/EPS.ts:1        (singularity / clamp floor)
  - VT_300K:   spicey/lib/constants/physics.ts:1    (thermal voltage kT/q at 300 K)
  - GMIN:      spicey/lib/analysis/simulateTRAN.ts:95 (diode conductance floor)
  - Diode voltage limits: spicey/lib/analysis/simulateTRAN.ts:89-91
  - MAX_NR_ITERS: spicey/lib/analysis/simulateTRAN.ts:151 (20 inner iterations)
  - DEFAULT_TRAN_STEPS: spicey/lib/analysis/simulateTRAN.ts:15 (dt<=EPS => tstop/1000)
"""

EPS = 1e-15
VT_300K = 0.02585
GMIN = 1e-12

DIODE_VD_MAX = 0.8
DIODE_VD_MIN = -1.0

MAX_NR_ITERS = 20
DEFAULT_TRAN_STEPS = 1000

# physical constants for the extended-dialect .noise analysis (the reference
# has no noise analysis; T chosen so kT/q matches VT_300K = 0.02585 V)
K_BOLTZMANN = 1.380649e-23   # J/K
Q_ELECTRON = 1.602176634e-19  # C
T_NOISE = VT_300K * Q_ELECTRON / K_BOLTZMANN  # ~300 K, consistent with VT
