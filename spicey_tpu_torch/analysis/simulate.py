"""Universal entry point: parse -> [OP] -> DC -> TF -> NOISE -> AC -> TRAN
-> STEP.

Contract: spicey/lib/analysis/simulate.ts:5-10, with the JAX package's
extended analyses (spicey_tpu/analysis/simulate.py:38-115): the operating
point is solved once and shared by ``.op``, ``.tf`` and ``.noise``; a
``.step`` sweep runs each of ``.ac``, ``.tran`` and ``.op`` once more as a
batched call with one lane per step value. A deck that asks for an
analysis not ported yet raises ``NotImplementedError`` naming the ROADMAP
item that brings it, rather than returning ``None`` for it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir.circuit import build_tensors
from ..parsing.netlist import ParsedCircuit, parse_netlist
from ..utils.device import resolve_device
from .ac import simulate_ac
from .batch import simulate_ac_batch, simulate_tran_batch
from .noise import simulate_noise
from .op import op_batch, simulate_dc, simulate_op
from .results import SimulationResult, StepResult
from .tf import simulate_tf
from .tran import simulate_tran

# analysis -> ROADMAP §1 item that ports it
_NOT_PORTED = (
    (".pz", "item 8", lambda c: c.pz is not None),
    (".sens", "item 8", lambda c: c.sens is not None),
    (".four", "item 8", lambda c: c.four is not None),
    (".control", "item 8", lambda c: bool(c.control)),
)


def _require_ported(circuit: ParsedCircuit) -> None:
    for name, item, asked in _NOT_PORTED:
        if asked(circuit):
            raise NotImplementedError(
                f"{name} is not ported to spicey_tpu_torch yet "
                f"(ROADMAP §1 {item})")


def _tran_options(options: dict) -> dict:
    """``.options reltol/itl4/vntol/abstol`` as Newton toggles: reltol
    implies iterate-to-convergence (the reference default is the
    break-on-switch-stability loop); vntol/abstol are per-unknown floors
    and imply convergence with ngspice's default reltol when not given."""
    kw = {}
    if "reltol" in options:
        kw = dict(nr="converged", nr_tol=options["reltol"])
    if "itl4" in options:
        kw["max_nr"] = int(options["itl4"])
    if "vntol" in options or "abstol" in options:
        kw.setdefault("nr", "converged")
        kw.setdefault("nr_tol", options.get("reltol", 1e-3))
        kw["nr_vntol"] = options.get("vntol")
        kw["nr_abstol"] = options.get("abstol")
    return kw


def simulate(netlist_text: str, method: str = "gj",
             dialect: str = "spicey",
             ac_linearize: str | None = None,
             base_dir: str | None = None,
             device: torch.device | str | None = None) -> SimulationResult:
    """Parse and run every requested analysis on ``device`` (the card
    unless ``device="cpu"``).

    ``ac_linearize="op"`` (or ``.options acop``; the argument wins when
    given) makes the AC sweep linearize nonlinear devices around the DC
    operating point; the default keeps the reference's behaviour of not
    stamping them. ``base_dir`` resolves relative ``.include``/``.lib``
    paths (extended dialect)."""
    device = resolve_device(device)
    circuit = parse_netlist(netlist_text, dialect=dialect, base_dir=base_dir)
    _require_ported(circuit)
    tensors = build_tensors(circuit)
    # .tf and .noise both linearize at the operating point: solve it once
    # and share it rather than re-running Newton per analysis
    need_op = (circuit.op or circuit.tf is not None
               or circuit.noise is not None)
    op_point = (simulate_op(circuit, tensors=tensors, method=method,
                            device=device) if need_op else None)
    dc = simulate_dc(circuit, tensors=tensors, method=method, device=device)
    tf = simulate_tf(circuit, tensors=tensors, method=method, op=op_point,
                     device=device)
    noise = simulate_noise(circuit, tensors=tensors, method=method,
                           op=op_point, device=device)
    if ac_linearize is None and circuit.options.get("acop"):
        ac_linearize = "op"
    ac = simulate_ac(circuit, tensors=tensors, method=method,
                     linearize=ac_linearize, device=device)
    tran = simulate_tran(circuit, tensors=tensors, method=method,
                         device=device, **_tran_options(circuit.options))
    return SimulationResult(circuit=circuit, ac=ac, tran=tran,
                            op=op_point if circuit.op else None, dc=dc,
                            tf=tf, noise=noise,
                            step=_step(circuit, method, device))


def _step(circuit: ParsedCircuit, method: str,
          device: torch.device) -> StepResult | None:
    """Extended ``.step``: each value is one lane of a batched run of
    ``.ac``, ``.tran`` and ``.op``; the single-circuit results keep the
    base element values. ``.meas`` is refused when the deck is parsed
    (ROADMAP §1 item 8), so ``meas`` stays None."""
    if circuit.step is None:
        return None
    vals = np.asarray(circuit.step.values, dtype=np.float64)
    ov = {circuit.step.param: vals}
    kw = dict(method=method, device=device)
    return StepResult(
        param=circuit.step.param, values=vals,
        ac=(simulate_ac_batch(circuit, ov, **kw)
            if circuit.ac is not None else None),
        tran=(simulate_tran_batch(circuit, ov, **kw)
              if circuit.tran is not None else None),
        op=op_batch(circuit, ov, **kw) if circuit.op else None)
