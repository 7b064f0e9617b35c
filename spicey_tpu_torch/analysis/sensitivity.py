"""Sensitivity analysis by forward-mode automatic differentiation.

A port of spicey_tpu/analysis/sensitivity.py. The JAX package takes
``jax.jacfwd`` through its assemble-and-solve programs; here the same
derivatives come from ``torch.autograd.forward_ad`` dual tensors through
the port's own ``_ac_sweep_core`` (analysis/ac.py) and ``_tran_core``
(analysis/tran.py). The solves carry their tangents through the
derivative rules of ``ops/linsolve.py``: each tangent is one more launch
of the kernel the primal solve runs (K1 on the AC sweep, K2 every Newton
pass, K3's inverse by products), never a native pass through the plain
elimination.

The P parameter directions ride the variants axis of the cores (``lead =
(P,)``, lane p carrying the one-hot tangent e_p), so each solve is one
primal launch plus one tangent launch whatever P is, and the host reads
the cores make (a Newton loop's ``done``) see primal values only.

APIs:
  sensitivity_ac(ckt, node, wrt)   -> {name: d|V(node)|/dvalue, (F,)}
  sensitivity_tran(ckt, node, wrt) -> {name: dV(node,t)/dvalue, (S+1,)}

``wrt`` names R/C/L element values and V-source DC levels (case-
insensitive); a V target of the transient drives its waveform-less grid
column, as in the JAX package (the AC sweep does not read a DC level, so
there its derivative is zero). Sensitivities are exact derivatives of the
discretized response.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..ir.circuit import (CircuitTensors, build_tensors, effective_time_step,
                          ext_arrays, lk_arrays, sample_source_values,
                          tl_arrays)
from ..parsing.netlist import ParsedCircuit
from ..utils.device import resolve_device
from .ac import (_ac_sweep_core, ac_vsource_arrays, batched_tl,
                 build_frequency_array, index_tensor)
from .tran import _tran_core, tran_arrays, vt_scale_of

_F64 = torch.float64


def _wrt_slots(tensors: CircuitTensors, wrt) -> list[tuple[str, int]]:
    """Resolve wrt names to (group, index) slots; raises on unknowns."""
    groups = {
        "r": [n.upper() for n in tensors.r_names],
        "c": [n.upper() for n in tensors.c_names],
        "l": [n.upper() for n in tensors.l_names],
        "v": [n.upper() for n in tensors.v_names],
    }
    slots = []
    for name in wrt:
        key = name.upper()
        for g, names in groups.items():
            if key in names:
                slots.append((g, names.index(key)))
                break
        else:
            raise ValueError(f"unknown sensitivity target {name!r}")
    return slots


def _base(tensors: CircuitTensors) -> dict[str, np.ndarray]:
    return {"r": tensors.r_vals, "c": tensors.c_vals, "l": tensors.l_vals,
            "v": tensors.v_dc}


def _theta0(tensors: CircuitTensors, slots) -> np.ndarray:
    base = _base(tensors)
    return np.asarray([float(base[g][i]) for g, i in slots], np.float64)


def _apply(tensors: CircuitTensors, slots, cols: torch.Tensor
           ) -> dict[str, torch.Tensor]:
    """The value arrays (L, n) of L lanes with target j's column set to
    ``cols[:, j]`` (L, P), in wrt order (a repeated target: the last
    wins, as the JAX package's ``.at[].set`` sequence does)."""
    lanes = cols.shape[0]
    vals = {g: torch.as_tensor(np.asarray(a, np.float64), dtype=_F64,
                               device=cols.device).expand(lanes, len(a))
            for g, a in _base(tensors).items()}
    for j, (g, i) in enumerate(slots):
        vals[g] = vals[g].clone()
        vals[g][:, i] = cols[:, j]
    return vals


def _lanes(theta: np.ndarray, device: torch.device) -> torch.Tensor:
    """theta (P,) as P lanes of dual numbers, lane p's tangent e_p. Call
    inside ``fwAD.dual_level()``."""
    p = theta.shape[0]
    primal = torch.as_tensor(theta, dtype=_F64, device=device)
    return fwAD.make_dual(primal.expand(p, p).clone(),
                          torch.eye(p, dtype=_F64, device=device))


def _tangent(out: torch.Tensor) -> torch.Tensor:
    """The tangent of a response, zeros where no target reached it."""
    t = fwAD.unpack_dual(out).tangent
    return torch.zeros_like(fwAD.unpack_dual(out).primal) if t is None else t


def _node_index(tensors: CircuitTensors, node: str) -> int:
    return [n.upper() for n in tensors.node_names].index(node.upper())


def _ac_setup(ckt: ParsedCircuit, tensors: CircuitTensors,
              device: torch.device) -> dict:
    """The AC sweep's fixed inputs, as ``simulate_ac`` assembles them: B
    sources as 0 V small-signal shorts, T lines as their phasor stamps."""
    freqs = build_frequency_array(ckt.ac.mode, ckt.ac.N, ckt.ac.f1, ckt.ac.f2)
    v_idx_ac, v_re, v_im = ac_vsource_arrays(ckt, tensors)
    iph = tensors.i_ac_phase_deg * math.pi / 180.0

    def vals(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), dtype=_F64,
                               device=device)

    ext = ext_arrays(tensors, device, _F64)
    return dict(
        freqs=freqs, f=vals(freqs),
        r_idx=index_tensor(tensors.r_idx, device),
        c_idx=index_tensor(tensors.c_idx, device),
        l_idx=index_tensor(tensors.l_idx, device),
        v_idx=index_tensor(v_idx_ac, device), v_re=vals(v_re)[None],
        v_im=vals(v_im)[None],
        ext={k: (v if k.endswith("idx") else v[None]) for k, v in ext.items()},
        i_re=vals(tensors.i_ac_mag * np.cos(iph)),
        i_im=vals(tensors.i_ac_mag * np.sin(iph)),
        lk=lk_arrays(tensors, device, _F64),
        tl=batched_tl(tl_arrays(tensors, device, _F64)),
        nvar=tensors.nvar)


def _ac_mag(s: dict, vals: dict, node_idx: int, method: str) -> torch.Tensor:
    """|V(node, f)| of every lane, (L, F)."""
    x_re, x_im, _valid = _ac_sweep_core(
        s["f"], s["r_idx"], vals["r"], s["c_idx"], vals["c"], s["l_idx"],
        vals["l"], s["v_idx"], s["v_re"], s["v_im"], s["nvar"],
        method=method, ext=s["ext"], i_re=s["i_re"], i_im=s["i_im"],
        lk=s["lk"], tl=s["tl"])
    return torch.sqrt(x_re[..., node_idx] ** 2 + x_im[..., node_idx] ** 2)


def _tran_setup(ckt: ParsedCircuit, tensors: CircuitTensors, nr: str
                ) -> tuple[float, np.ndarray, np.ndarray, str]:
    """(dt, times, the sampled source grid, nr): M/Q decks iterate Newton
    to convergence, as ``simulate_tran`` runs them."""
    dt, steps = effective_time_step(ckt.tran.dt, ckt.tran.tstop)
    times = np.arange(steps + 1, dtype=np.float64) * dt
    if (tensors.n_m or tensors.n_q) and nr == "spicey":
        nr = "converged"
    return dt, times, sample_source_values(ckt, times), nr


def _tran_xs(ckt: ParsedCircuit, tensors: CircuitTensors, vals: dict,
             vs: torch.Tensor, dt: float, times: np.ndarray, node_idx: int,
             method: str, integration: str, nr: str) -> torch.Tensor:
    """V(node, t) of every lane through the transient core, (S+1, L)."""
    device = vs.device
    lanes = vals["r"].shape[0]
    arr = tran_arrays(tensors, device, _F64, r_vals=vals["r"],
                      c_vals=vals["c"], l_vals=vals["l"], ckt=ckt, dt=dt)
    xs, _sw, _valid, _fin = _tran_core(
        vs, dt, arr, tensors.nvar, method=method, integration=integration,
        nr=nr, lead=(lanes,), record=node_idx,
        vt_scale=vt_scale_of(tensors, device, _F64), times=times)
    return xs


def sensitivity_ac(
    ckt: ParsedCircuit,
    node: str,
    wrt,
    tensors: CircuitTensors | None = None,
    method: str = "gj",
    device: torch.device | str | None = None,
) -> dict[str, np.ndarray]:
    """d|V(node, f)|/d(value) for each element named in ``wrt``, on
    ``device`` (the card unless ``device="cpu"``): (F,) arrays keyed by
    the original wrt spellings, from one forward-mode pass over the sweep
    (one K1 launch for the values, one for the P tangents)."""
    device = resolve_device(device)
    if ckt.ac is None:
        raise ValueError("netlist has no .ac analysis")
    if tensors is None:
        tensors = build_tensors(ckt)
    slots = _wrt_slots(tensors, wrt)
    node_idx = _node_index(tensors, node)
    s = _ac_setup(ckt, tensors, device)
    if not slots:
        return {}
    with fwAD.dual_level():
        vals = _apply(tensors, slots, _lanes(_theta0(tensors, slots), device))
        jac = _tangent(_ac_mag(s, vals, node_idx, method)).cpu().numpy()
    return {name: jac[j] for j, name in enumerate(wrt)}


def sensitivity_tran(
    ckt: ParsedCircuit,
    node: str,
    wrt,
    tensors: CircuitTensors | None = None,
    method: str = "gj",
    integration: str = "be",
    nr: str = "spicey",
    device: torch.device | str | None = None,
) -> dict[str, np.ndarray]:
    """dV(node, t)/d(value) over the whole transient, per wrt element, on
    ``device``: the tangents flow through the time loop, the Newton
    passes (each one more K2 launch for the P tangents), the companion
    commits and the switch hysteresis masks, the derivative of exactly
    what the engine computes."""
    device = resolve_device(device)
    if ckt.tran is None:
        raise ValueError("netlist has no .tran analysis")
    if tensors is None:
        tensors = build_tensors(ckt)
    slots = _wrt_slots(tensors, wrt)
    node_idx = _node_index(tensors, node)
    dt, times, vs_grid, nr = _tran_setup(ckt, tensors, nr)
    if not slots:
        return {}
    has_wave = np.concatenate([tensors.v_has_waveform,
                               tensors.i_has_waveform])
    grid = torch.as_tensor(vs_grid, dtype=_F64, device=device)
    with fwAD.dual_level():
        cols = _lanes(_theta0(tensors, slots), device)
        vals = _apply(tensors, slots, cols)
        # a V-source target drives the whole (waveform-less) grid column
        v_cols = [(j, i) for j, (g, i) in enumerate(slots)
                  if g == "v" and not has_wave[i]]
        vs = grid
        if v_cols:
            vs = grid[:, None, :].expand(grid.shape[0], len(slots),
                                         grid.shape[1]).clone()
            for j, i in v_cols:
                vs[:, :, i] = cols[:, j]
        xs = _tran_xs(ckt, tensors, vals, vs, dt, times, node_idx, method,
                      integration, nr)
        jac = _tangent(xs).cpu().numpy()  # (S+1, P)
    return {name: jac[:, j] for j, name in enumerate(wrt)}
