"""Gradient-based circuit fitting / design optimization.

A port of spicey_tpu/analysis/fit.py: element values are solved for by
gradient descent through the simulation, so a target response (a measured
frequency response, a desired transient trace) gives the R/C/L/V values
that produce it. Parameters are optimized in log-space (element values
are positive and span decades) by the JAX package's inline Adam (b1 0.9,
b2 0.999, eps 1e-8), in float64 on the host.

The gradients go through the derivative rules of ``ops/linsolve.py``:
``fit_ac`` is reverse mode, ``loss.backward()`` through the AC sweep (per
step one K1 launch for the sweep and one for its adjoint, A^H); ``fit_tran``
is forward mode, as in the JAX package (the Newton loop reads its
iterates on the host), with the P parameters riding the transient's
variants axis, one tangent each (analysis/sensitivity.py).

API:
  fit_ac(ckt, node, target, wrt)    -> FitResult (fitted values, loss curve)
  fit_tran(ckt, node, target, wrt)  -> FitResult
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..ir.circuit import CircuitTensors, build_tensors
from ..parsing.netlist import ParsedCircuit
from ..utils.device import resolve_device
from .sensitivity import (_ac_mag, _ac_setup, _apply, _lanes, _node_index,
                          _tangent, _theta0, _tran_setup, _tran_xs,
                          _wrt_slots)

_F64 = torch.float64


@dataclass
class FitResult:
    values: dict[str, float]      # fitted element values
    loss: float                   # final loss
    loss_history: np.ndarray      # (steps,)
    converged: bool               # loss decreased and is finite


def _adam_fit(vg, theta0_log: np.ndarray, steps: int, lr: float
              ) -> tuple[np.ndarray, np.ndarray]:
    """Inline Adam in log-parameter space over ``vg(p) -> (loss, grad)``.
    Returns (theta_log, history)."""
    m = np.zeros_like(theta0_log)
    v = np.zeros_like(theta0_log)
    p = np.asarray(theta0_log, np.float64)
    b1, b2, eps = 0.9, 0.999, 1e-8
    history = []
    for k in range(1, steps + 1):
        val, g = vg(p)
        history.append(val)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** k)
        vh = v / (1 - b2 ** k)
        p = p - lr * mh / (np.sqrt(vh) + eps)
    return p, np.asarray(history)


def _start(tensors: CircuitTensors, slots, wrt, x0) -> np.ndarray:
    """The starting values: the netlist's, each named in ``x0`` replaced
    (a name not in ``wrt`` raises KeyError, as in the JAX package)."""
    th0 = _theta0(tensors, slots)
    if x0:
        lower = {n.upper(): j for j, n in enumerate(wrt)}
        for name, val in x0.items():
            th0[lower[name.upper()]] = float(val)
    return th0


def _result(wrt, p: np.ndarray, history: np.ndarray) -> FitResult:
    fitted = np.exp(p)
    return FitResult(
        values={name: float(fitted[j]) for j, name in enumerate(wrt)},
        loss=float(history[-1]),
        loss_history=history,
        converged=bool(np.isfinite(history[-1])
                       and history[-1] <= history[0]),
    )


def fit_ac(
    ckt: ParsedCircuit,
    node: str,
    target_mag: np.ndarray,
    wrt,
    tensors: CircuitTensors | None = None,
    x0: dict[str, float] | None = None,
    steps: int = 200,
    lr: float = 0.05,
    method: str = "gj",
    device: torch.device | str | None = None,
) -> FitResult:
    """Fit the named element values so |V(node, f)| matches ``target_mag``
    (one value per frequency of the netlist's .ac grid) on ``device`` (the
    card unless ``device="cpu"``). Loss = mean squared relative error;
    optimization in log-space via Adam, gradients in reverse mode."""
    device = resolve_device(device)
    if ckt.ac is None:
        raise ValueError("netlist has no .ac analysis")
    if tensors is None:
        tensors = build_tensors(ckt)
    slots = _wrt_slots(tensors, wrt)
    s = _ac_setup(ckt, tensors, device)
    if len(target_mag) != len(s["freqs"]):
        raise ValueError(
            f"target has {len(target_mag)} points, grid has "
            f"{len(s['freqs'])}")
    node_idx = _node_index(tensors, node)
    target = torch.as_tensor(np.array(target_mag, np.float64), dtype=_F64,
                             device=device)

    def vg(p: np.ndarray) -> tuple[float, np.ndarray]:
        theta = torch.tensor(p, dtype=_F64, device=device,
                             requires_grad=True)
        with torch.enable_grad():
            vals = _apply(tensors, slots, torch.exp(theta)[None])
            mag = _ac_mag(s, vals, node_idx, method)[0]
            rel = (mag - target) / (target.abs() + 1e-12)
            loss = torch.mean(rel * rel)
            loss.backward()
        return float(loss.detach()), theta.grad.cpu().numpy()

    p, history = _adam_fit(vg, np.log(_start(tensors, slots, wrt, x0)),
                           steps, lr)
    return _result(wrt, p, history)


def fit_tran(
    ckt: ParsedCircuit,
    node: str,
    target: np.ndarray,
    wrt,
    tensors: CircuitTensors | None = None,
    x0: dict[str, float] | None = None,
    steps: int = 150,
    lr: float = 0.05,
    method: str = "gj",
    integration: str = "be",
    nr: str = "spicey",
    device: torch.device | str | None = None,
) -> FitResult:
    """Fit element values so V(node, t) matches ``target`` over the .tran
    grid (steps+1 points) on ``device``; forward-mode gradients through
    the time loop, one tangent lane per parameter. (A V-source target
    gets no gradient: the JAX package's loss reads the sampled grid.)"""
    device = resolve_device(device)
    if ckt.tran is None:
        raise ValueError("netlist has no .tran analysis")
    if tensors is None:
        tensors = build_tensors(ckt)
    slots = _wrt_slots(tensors, wrt)
    node_idx = _node_index(tensors, node)
    dt, times, vs_grid, nr = _tran_setup(ckt, tensors, nr)
    if len(target) != len(times):
        raise ValueError(
            f"target has {len(target)} points, grid has {len(times)}")
    vs = torch.as_tensor(vs_grid, dtype=_F64, device=device)
    tgt = torch.as_tensor(np.array(target, np.float64), dtype=_F64,
                          device=device)
    scale = torch.clamp(tgt.abs().max(), min=1e-12)

    def vg(p: np.ndarray) -> tuple[float, np.ndarray]:
        with fwAD.dual_level():
            vals = _apply(tensors, slots, torch.exp(_lanes(p, device)))
            xs = _tran_xs(ckt, tensors, vals, vs, dt, times, node_idx,
                          method, integration, nr)
            rel = (xs - tgt[:, None]) / scale
            loss = torch.mean(rel * rel, dim=0)    # (P,): lane p, e_p
            val = float(fwAD.unpack_dual(loss).primal[0])
            grad = _tangent(loss).cpu().numpy()
        return val, grad

    p, history = _adam_fit(vg, np.log(_start(tensors, slots, wrt, x0)),
                           steps, lr)
    return _result(wrt, p, history)
