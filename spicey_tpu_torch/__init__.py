"""spicey_tpu_torch — the SPICE engine of ``spicey_tpu`` in PyTorch + CUDA.

A port of the JAX package beside it, for one NVIDIA H100. It imports
torch and never jax. Plain tensor code is PyTorch; every Pallas kernel of
the JAX package becomes a kernel written by hand for Hopper in
``csrc/``, built with nvcc at first use (ops/_build.py). A CUDA tensor
always goes through the kernel; a CPU tensor runs the kernel's plain
PyTorch version, which is what the CPU tests exercise.

It carries the AC and transient main paths: ``simulate()`` for ``.ac``
and ``.tran`` decks (the basics01 golden, the reference's transient
fixtures), the Monte-Carlo AC yield (``mc_ac_stats``/``mc_ac_sampled``)
through kernels K1 (complex Gauss-Jordan) and K5 (fused
assemble-and-solve), and the Monte-Carlo transient
(``mc_tran_stats``/``mc_tran_sampled``) through K2 (real Gauss-Jordan,
every Newton pass), K3 (the factor-once inverse of linear decks), K8
(the fused linear whole transient) and K9 (the fused nonlinear one), and
the DC operating point and the analyses built on it: ``.op``, ``.dc``,
``op_batch`` and ``.tf`` (K2), AC ``linearize="op"`` (K1) and ``.noise``
through K4 (the complex inverse), and the batched corner sweeps:
``simulate_ac_batch`` (full solutions; K7, the fused full-solution
kernel, or K1), ``simulate_tran_batch`` (K2, K3) and ``.step`` in
``simulate()``, and the post-analyses on top of them: ``.pz`` and
``.sens`` at the shared operating point, ``.four`` and ``.meas`` over the
finished sweeps (``meas_batch`` over a ``.step`` transient's lanes), a
``.control`` block's print/let/wrdata/write tail, the ngspice rawfile and
``python -m spicey_tpu_torch``, and the analyses that differentiate or
choose their own steps: ``sensitivity_ac``/``sensitivity_tran``
(forward-mode tangents), ``fit_ac`` (reverse mode) and ``fit_tran``
through the derivative rules of K1, K2 and K3 (ops/linsolve.py), and the
LTE-controlled ``simulate_tran_adaptive`` (K2), and the device mesh:
``make_mesh`` and ``sharder`` split the variants (and the batched AC's
frequencies) of ``mc_ac_stats``, ``mc_tran_stats``,
``simulate_ac_batch`` and ``simulate_tran_batch`` over devices
(``device_put=``), each piece on the route and kernels an unsharded call
takes (parallel/mesh.py). ``warmup`` pays the card's first round trip
up front and, with ``full=True``, builds every kernel library. The host
layer (parsing, IR, formatting, the post-analyses) is a jax-free copy of
the JAX package's. Public entry points run on the CUDA card unless
called with ``device="cpu"``, and state float64 or float32 at every
tensor creation.

Every public name of ``spicey_tpu`` is here. The JAX package's TPU-only
machinery (its compile cache, device placement tiers and
float32-with-refinement wrappers) has no counterpart.
"""

from __future__ import annotations

from .analysis.ac import simulate_ac
from .analysis.adaptive import AdaptiveTranResult, simulate_tran_adaptive
from .analysis.batch import (BatchACResult, BatchTranResult,
                             simulate_ac_batch, simulate_tran_batch)
from .analysis.fit import FitResult, fit_ac, fit_tran
from .analysis.four import FourierProbe, FourierResult, simulate_four
from .analysis.mc import (MCStats, mc_ac_sampled, mc_ac_stats,
                          mc_tran_sampled, mc_tran_stats)
from .analysis.meas import (MeasSpec, evaluate_meas, evaluate_meas_batch,
                            meas_batch, simulate_meas)
from .analysis.noise import NoiseResult, simulate_noise
from .analysis.op import (BatchOPResult, DCResult, OPResult, op_batch,
                          simulate_dc, simulate_op)
from .analysis.pz import PZResult, format_pz_result, simulate_pz
from .analysis.results import (ACResult, SimulationResult, StepResult,
                               TranResult)
from .analysis.sens import SensResult, format_sens_result, simulate_sens
from .analysis.sensitivity import sensitivity_ac, sensitivity_tran
from .analysis.simulate import simulate
from .analysis.tf import TFResult, simulate_tf
from .analysis.tran import TranState, simulate_tran
from .constants import EPS, VT_300K
from .formatting.jsnum import to_precision
from .formatting.compare import compare_voltage_levels
from .formatting.rawfile import format_rawfile, read_rawfile, write_rawfile
from .formatting.svg import convert_simulation_graphs_to_svg
from .formatting.text import (format_ac_result, format_dc_result,
                              format_four_result, format_noise_result,
                              format_op_result, format_tf_result,
                              format_tran_result)
from .formatting.vgraph import (eec_engine_tran_to_vgraphs,
                                spicey_tran_to_vgraphs)
from .ir.circuit import CircuitTensors, build_tensors, from_jax_tensors
from .math_complex import Complex
from .parallel.mesh import make_mesh, sharder
from .parsing.netlist import ParsedCircuit, parse_netlist
from .parsing.numbers import parse_number_with_units
from .parsing.waveforms import (PulseSpec, parse_pulse_args, parse_pwl_args,
                                pulse_value, pwl_value)
from .utils.device import warmup
from .utils.profiling import count, profiled, report, span

# camelCase aliases matching the reference's npm surface (lib/index.ts:1-12)
parseNetlist = parse_netlist
simulateAC = simulate_ac
simulateTRAN = simulate_tran
formatAcResult = format_ac_result
formatTranResult = format_tran_result
spiceyTranToVGraphs = spicey_tran_to_vgraphs
eecEngineTranToVGraphs = eec_engine_tran_to_vgraphs

__all__ = [
    "ACResult",
    "AdaptiveTranResult",
    "BatchACResult",
    "BatchOPResult",
    "BatchTranResult",
    "CircuitTensors",
    "Complex",
    "DCResult",
    "EPS",
    "FitResult",
    "FourierResult",
    "MCStats",
    "MeasSpec",
    "NoiseResult",
    "OPResult",
    "PZResult",
    "ParsedCircuit",
    "PulseSpec",
    "SensResult",
    "SimulationResult",
    "StepResult",
    "TFResult",
    "TranResult",
    "TranState",
    "VT_300K",
    "build_tensors",
    "compare_voltage_levels",
    "convert_simulation_graphs_to_svg",
    "count",
    "eecEngineTranToVGraphs",
    "eec_engine_tran_to_vgraphs",
    "fit_ac",
    "fit_tran",
    "formatAcResult",
    "formatTranResult",
    "format_ac_result",
    "format_dc_result",
    "format_four_result",
    "format_noise_result",
    "format_op_result",
    "format_pz_result",
    "format_rawfile",
    "format_sens_result",
    "format_tf_result",
    "format_tran_result",
    "from_jax_tensors",
    "make_mesh",
    "mc_ac_sampled",
    "mc_ac_stats",
    "mc_tran_sampled",
    "mc_tran_stats",
    "meas_batch",
    "op_batch",
    "parseNetlist",
    "parse_netlist",
    "parse_number_with_units",
    "parse_pulse_args",
    "parse_pwl_args",
    "pulse_value",
    "pwl_value",
    "read_rawfile",
    "sensitivity_ac",
    "sensitivity_tran",
    "sharder",
    "simulate",
    "simulateAC",
    "simulateTRAN",
    "simulate_ac",
    "simulate_ac_batch",
    "simulate_dc",
    "simulate_four",
    "simulate_meas",
    "simulate_noise",
    "simulate_op",
    "simulate_pz",
    "simulate_sens",
    "simulate_tf",
    "simulate_tran",
    "simulate_tran_adaptive",
    "simulate_tran_batch",
    "spiceyTranToVGraphs",
    "spicey_tran_to_vgraphs",
    "to_precision",
    "warmup",
    "write_rawfile",
]
