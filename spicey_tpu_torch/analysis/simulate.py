"""Universal entry point: parse -> AC.

Contract: spicey/lib/analysis/simulate.ts:5-10. This package runs the AC
analysis; a deck that asks for an analysis not ported yet raises
``NotImplementedError`` naming the ROADMAP item that brings it, rather
than returning ``None`` for it.
"""

from __future__ import annotations

import torch

from ..ir.circuit import build_tensors
from ..parsing.netlist import ParsedCircuit, parse_netlist
from .ac import simulate_ac
from .results import SimulationResult

# analysis -> ROADMAP §1 item that ports it
_NOT_PORTED = (
    (".tran", "item 4", lambda c: c.tran is not None),
    (".op", "item 5", lambda c: c.op),
    (".dc", "item 5", lambda c: c.dc is not None),
    (".tf", "item 8", lambda c: c.tf is not None),
    (".noise", "item 8", lambda c: c.noise is not None),
    (".pz", "item 8", lambda c: c.pz is not None),
    (".sens", "item 8", lambda c: c.sens is not None),
    (".four", "item 8", lambda c: c.four is not None),
    (".step", "item 6", lambda c: c.step is not None),
    (".control", "item 8", lambda c: bool(c.control)),
)


def _require_ported(circuit: ParsedCircuit) -> None:
    for name, item, asked in _NOT_PORTED:
        if asked(circuit):
            raise NotImplementedError(
                f"{name} is not ported to spicey_tpu_torch yet "
                f"(ROADMAP §1 {item})")


def simulate(netlist_text: str, method: str = "gj",
             dialect: str = "spicey",
             ac_linearize: str | None = None,
             base_dir: str | None = None,
             device: torch.device | str = "cpu") -> SimulationResult:
    """Parse and run every requested analysis on ``device``.

    ``ac_linearize="op"`` (or ``.options acop``) needs the operating
    point and raises until it is ported. ``base_dir`` resolves relative
    ``.include``/``.lib`` paths (extended dialect)."""
    circuit = parse_netlist(netlist_text, dialect=dialect, base_dir=base_dir)
    _require_ported(circuit)
    tensors = build_tensors(circuit)
    if ac_linearize is None and circuit.options.get("acop"):
        ac_linearize = "op"
    ac = simulate_ac(circuit, tensors=tensors, method=method,
                     linearize=ac_linearize, device=device)
    return SimulationResult(circuit=circuit, ac=ac, tran=None)
