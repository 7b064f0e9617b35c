"""Universal entry point: parse -> [OP] -> DC -> TF -> NOISE -> PZ -> SENS
-> AC -> TRAN -> FOUR -> MEAS -> STEP -> CONTROL.

Contract: spicey/lib/analysis/simulate.ts:5-10, with the JAX package's
extended analyses in its order (spicey_tpu/analysis/simulate.py:22-126):
the operating point is solved once and shared by ``.op``, ``.tf``,
``.noise``, ``.pz`` and ``.sens``; ``.four`` and ``.meas`` read the
finished sweeps; a ``.step`` sweep runs each of ``.ac``, ``.tran`` and
``.op`` once more as a batched call with one lane per step value, and its
``.meas tran`` lines over the batched transient; a ``.control`` block's
post-processing tail runs last. Each analysis runs inside a
``utils/profiling.span`` of the JAX package's name.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir.circuit import build_tensors
from ..parsing.netlist import ParsedCircuit, parse_netlist
from ..utils.device import resolve_device
from ..utils.profiling import span
from .ac import simulate_ac
from .batch import simulate_ac_batch, simulate_tran_batch
from .control import run_control
from .four import simulate_four
from .meas import meas_batch, simulate_meas
from .noise import simulate_noise
from .op import op_batch, simulate_dc, simulate_op
from .pz import simulate_pz
from .results import SimulationResult, StepResult
from .sens import simulate_sens
from .tf import simulate_tf
from .tran import simulate_tran


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
    paths (extended dialect) and the output files of a ``.control``
    block."""
    device = resolve_device(device)
    kw = dict(method=method, device=device)
    with span("parse"):
        circuit = parse_netlist(netlist_text, dialect=dialect,
                                base_dir=base_dir)
        tensors = build_tensors(circuit)
    with span("op"):
        # .tf, .noise, .pz and .sens all linearize at the operating point:
        # solve it once and share it rather than re-running Newton per
        # analysis
        need_op = (circuit.op or circuit.tf is not None
                   or circuit.noise is not None or circuit.pz is not None
                   or circuit.sens is not None)
        op_point = (simulate_op(circuit, tensors=tensors, **kw)
                    if need_op else None)
    with span("dc"):
        dc = simulate_dc(circuit, tensors=tensors, **kw)
    with span("tf"):
        tf = simulate_tf(circuit, tensors=tensors, op=op_point, **kw)
    with span("noise"):
        noise = simulate_noise(circuit, tensors=tensors, op=op_point, **kw)
    with span("pz"):
        pz = simulate_pz(circuit, tensors=tensors, op=op_point, **kw)
    with span("sens"):
        sens = simulate_sens(circuit, tensors=tensors, op=op_point, **kw)
    with span("ac"):
        if ac_linearize is None and circuit.options.get("acop"):
            ac_linearize = "op"
        ac = simulate_ac(circuit, tensors=tensors, linearize=ac_linearize,
                         **kw)
    with span("tran"):
        tran = simulate_tran(circuit, tensors=tensors, **kw,
                             **_tran_options(circuit.options))
    with span("four"):
        four = simulate_four(circuit, tran)
    with span("meas"):
        meas = simulate_meas(circuit, tran, ac=ac, dc=dc)
    with span("step"):
        step = _step(circuit, method, device)
    res = SimulationResult(circuit=circuit, ac=ac, tran=tran,
                           op=op_point if circuit.op else None, dc=dc,
                           tf=tf, four=four, noise=noise, meas=meas, pz=pz,
                           sens=sens, step=step)
    if circuit.control:
        # the .control block's post-processing tail (print/echo/let/write/
        # wrdata): host work after every analysis
        with span("control"):
            res.control_output = run_control(res, base_dir=base_dir)
    return res


def _step(circuit: ParsedCircuit, method: str,
          device: torch.device) -> StepResult | None:
    """Extended ``.step``: each value is one lane of a batched run of
    ``.ac``, ``.tran`` and ``.op``, and every ``.meas tran`` line is
    evaluated over the lanes of the batched transient; the single-circuit
    results keep the base element values."""
    if circuit.step is None:
        return None
    vals = np.asarray(circuit.step.values, dtype=np.float64)
    ov = {circuit.step.param: vals}
    kw = dict(method=method, device=device)
    ac = (simulate_ac_batch(circuit, ov, **kw)
          if circuit.ac is not None else None)
    tran = (simulate_tran_batch(circuit, ov, **kw)
            if circuit.tran is not None else None)
    return StepResult(
        param=circuit.step.param, values=vals, ac=ac, tran=tran,
        op=op_batch(circuit, ov, **kw) if circuit.op else None,
        meas=(meas_batch(circuit, tran)
              if circuit.meas and tran is not None else None))
