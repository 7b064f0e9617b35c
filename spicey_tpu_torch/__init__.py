"""spicey_tpu_torch — the SPICE engine of ``spicey_tpu`` in PyTorch + CUDA.

A port of the JAX package beside it, for one NVIDIA H100. It imports
torch and never jax. Plain tensor code is PyTorch; every Pallas kernel of
the JAX package becomes a kernel written by hand for Hopper in
``csrc/``, built with nvcc at first use (ops/_build.py). A CUDA tensor
always goes through the kernel; a CPU tensor runs the kernel's plain
PyTorch version, which is what the CPU tests exercise.

This first slice carries the AC main path: ``simulate()`` for ``.ac``
decks (the basics01 golden), and the Monte-Carlo AC yield
(``mc_ac_stats``/``mc_ac_sampled``) through kernels K1 (complex
Gauss-Jordan) and K5 (fused assemble-and-solve). The host layer
(parsing, IR, formatting) is a jax-free copy of the JAX package's.
Public entry points take an explicit ``device=`` and state float64 or
float32 at every tensor creation.
"""

from __future__ import annotations

from .analysis.ac import simulate_ac
from .analysis.mc import MCStats, mc_ac_sampled, mc_ac_stats
from .analysis.results import ACResult, SimulationResult
from .analysis.simulate import simulate
from .constants import EPS, VT_300K
from .formatting.jsnum import to_precision
from .formatting.text import format_ac_result
from .ir.circuit import CircuitTensors, build_tensors, from_jax_tensors
from .parsing.netlist import ParsedCircuit, parse_netlist

# camelCase aliases matching the reference's npm surface (lib/index.ts:1-12)
parseNetlist = parse_netlist
simulateAC = simulate_ac
formatAcResult = format_ac_result

__all__ = [
    "ACResult",
    "CircuitTensors",
    "EPS",
    "MCStats",
    "ParsedCircuit",
    "SimulationResult",
    "VT_300K",
    "build_tensors",
    "format_ac_result",
    "formatAcResult",
    "from_jax_tensors",
    "mc_ac_sampled",
    "mc_ac_stats",
    "parseNetlist",
    "parse_netlist",
    "simulate",
    "simulateAC",
    "simulate_ac",
    "to_precision",
]
