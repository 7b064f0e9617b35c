"""Adaptive-timestep transient analysis with local-truncation-error control.

A port of spicey_tpu/analysis/adaptive.py. The reference is strictly
fixed-step (SURVEY §2.10, simulateTRAN.ts:14-19); this engine chooses its
own step sizes by step-doubling error estimation:

  - every attempt takes one backward-Euler step of size dt AND two of
    size dt/2 from the same state; their difference estimates the local
    truncation error;
  - the step is accepted when ``max |x_h - x_f| / (atol + rtol*|x_h|) <= 1``
    (or dt already at dt_min), advancing with the Richardson-extrapolated
    linear companion states; otherwise it is rejected and retried smaller;
  - dt then scales by the order-1 controller ``clip(0.9/err, 0.2, 2.0)``,
    clamped to [dt_min, dt_max] and to the remaining horizon.

The JAX package scans a fixed ``max_steps`` attempt budget with accept
masks (XLA cannot grow arrays). Here the controller runs on the host, in
the same float64 arithmetic, over device solves: each attempt's error is
one scalar read, and the loop stops once t reaches tstop, where the JAX
scan runs on with every later attempt masked. The result is the same:
``n_attempts`` is the budget, as the JAX package reports it. Sources
evaluate at the adaptive time points (ir/sources.py).

Newton runs to convergence here (the reference's one-step-diode quirk
makes no sense under error control) through ``ops/linsolve.solve``
(kernel K2 on the card), reusing the fixed-step engine's stamps,
companions and switch hysteresis (analysis/tran.py), with the port's
16-ulp floor on the tolerance in place of the JAX package's measured
``newton_tol_floor`` (ROADMAP item 10). Transmission lines read a
time-stamped history of the accepted port waves, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import EPS
from ..ir.circuit import CircuitTensors, build_tensors
from ..ir.sources import eval_sources, source_program
from ..ops.linsolve import solve
from ..ops.stamps import pad_solution
from ..parsing.netlist import ParsedCircuit
from ..utils.device import resolve_device
from .tran import (_bjt_junction_charge, _charge_slots, _diode_charge, _l_mv,
                   _mutual_inv, _stamp_setup, _stamp_system, _switch_update,
                   _vdrop, prepare_bsources, tran_arrays, vt_scale_of)


@dataclass
class AdaptiveTranResult:
    times: np.ndarray                      # (nAccepted+1,) incl. t=0 record
    node_voltages: dict[str, np.ndarray]
    n_accepted: int
    n_rejected: int
    n_attempts: int
    exhausted: bool                        # budget ran out before tstop


class _TlineHistory:
    """The accepted trajectory's port waves w = v + Z0 i, time-stamped
    (adaptive.py tl_read / tl_write of the JAX package): H = budget + 2
    slots of (time, waves), the written prefix [0, cnt) strictly
    increasing, slot cnt a speculative write, +inf beyond."""

    def __init__(self, tl: dict, budget: int, dtype: torch.dtype,
                 device: torch.device) -> None:
        self.tl = tl
        n_t = tl["t_idx"].shape[0]
        self.h_t = torch.full((budget + 2,), float("inf"), dtype=dtype,
                              device=device)
        self.h_w = torch.zeros((budget + 2, n_t, 2), dtype=dtype,
                               device=device)
        self.lines = torch.arange(n_t, device=device)
        self.cnt = 0

    def read(self, t_eval: float) -> torch.Tensor:
        """The delayed far-end sources (nT, 2) = (E1, E2) at ``t_eval``:
        linear interpolation at t_eval - Td, clamped to the newest accepted
        sample and to w = 0 before t = 0."""
        h_t, h_w, tl = self.h_t, self.h_w, self.tl
        newest = max(self.cnt - 1, 0)
        tq = torch.minimum(t_eval - tl["td"], h_t[newest])
        k = torch.searchsorted(h_t, tq, right=True) - 1
        before = k < 0
        k_c = torch.clamp(k, 0, h_t.shape[0] - 1)
        k1 = torch.clamp(k_c + 1, max=newest)
        t_k, t_k1 = h_t[k_c], h_t[k1]
        frac = torch.clamp((tq - t_k) / torch.clamp(t_k1 - t_k, min=EPS),
                           0.0, 1.0)[:, None]
        w = torch.where(before[:, None], 0.0,
                        h_w[k_c, self.lines] * (1.0 - frac)
                        + h_w[k1, self.lines] * frac)
        # E1 mirrors the far end's w2, E2 the near end's w1
        return torch.stack([w[:, 1], w[:, 0]], dim=-1)

    def write(self, t_new: float, x_pad: torch.Tensor, advance: bool) -> None:
        """Write slot cnt unconditionally; advance the count on accept."""
        t_idx, z0 = self.tl["t_idx"], self.tl["z0"]
        w1 = x_pad[t_idx[:, 0]] - x_pad[t_idx[:, 1]] + z0 * x_pad[t_idx[:, 4]]
        w2 = x_pad[t_idx[:, 2]] - x_pad[t_idx[:, 3]] + z0 * x_pad[t_idx[:, 5]]
        self.h_t[self.cnt] = t_new
        self.h_w[self.cnt] = torch.stack([w1, w2], dim=-1)
        self.cnt += int(advance)


def _adaptive_core(ckt: ParsedCircuit, tensors: CircuitTensors,
                   device: torch.device, tstop: float, dt0: float,
                   dt_min: float, dt_max: float, rtol: float, atol: float,
                   method: str, max_steps: int, max_nr: int, nr_tol: float
                   ) -> tuple:
    """The attempt loop. Returns (x0, accepted times, accepted x_rec
    (nA, nvar) on the host, rejected count, done, ok)."""
    f64 = torch.float64
    nvar = tensors.nvar
    arr = tran_arrays(tensors, device, f64, ckt=ckt, dt=dt0)
    arr = dict(arr, bsrc_t=prepare_bsources(arr["bsrc"], device))
    minv = None
    if arr["lk"] is not None:
        minv = arr["minv"] = _mutual_inv(arr["l_vals"], arr["lk"])[0]
    arr["stamps"] = _stamp_setup(arr, nvar)
    vt_scale = vt_scale_of(tensors, device, f64)
    pos_d, pos_q = _charge_slots(arr)
    nl = arr["nl"]
    prog = source_program(ckt, device)
    hist = (None if arr["tl"] is None
            else _TlineHistory(arr["tl"], max_steps, f64, device))

    def z(*shape: int) -> torch.Tensor:
        return torch.zeros(shape, dtype=f64, device=device)

    n_c, n_l, n_d = (arr[k].shape[0] for k in ("c_idx", "l_idx", "d_idx"))
    n_m, n_q = nl["m_idx"].shape[0], nl["q_idx"].shape[0]
    # a linear deck's system does not depend on the iterate: the JAX
    # loop's second pass re-solves it to the same x and stops, so one pass
    # is the same answer
    linear = not (arr["s_idx"].shape[0] or n_d or n_m or n_q
                  or arr["bsrc_t"])

    def newton(state: tuple, dt_step: float, t_eval: float, is_first: bool
               ) -> tuple:
        """One BE step of size dt_step evaluated at absolute time t_eval.
        Returns (x, new_state, ok)."""
        (v_prev_c, i_prev_l, vd_prev_d, vm_prev, vq_prev, q_prev_d, q_prev_q,
         sw_on) = state
        carry = [v_prev_c, z(n_c), i_prev_l, z(n_l), vd_prev_d, vm_prev,
                 vq_prev, sw_on, z(n_c), z(n_l)]
        if pos_d is not None:
            carry.append(q_prev_d)
        if pos_q is not None:
            carry.append(q_prev_q)
        vs_t = eval_sources(prog, t_eval)
        e_t = hist.read(t_eval) if hist is not None else None
        x = z(nvar)
        sw = sw_on
        ok = torch.ones((), dtype=torch.bool, device=device)
        for it in range(max_nr):
            A, b = _stamp_system(arr, nvar, dt_step, vs_t, x, it, carry, sw,
                                 "be", is_first, False, vt_scale, e_t=e_t,
                                 t=t_eval)
            x_new, solve_ok = solve(A, b, method=method)
            new_on = _switch_update(arr["s_idx"], arr["s_von"],
                                    arr["s_voff"], sw,
                                    pad_solution(x_new, nvar))
            settled = ~torch.any(new_on != sw)
            if nvar:
                delta = (x_new - x).abs().max()
                settled = settled & (delta <= nr_tol
                                     * (1.0 + x_new.abs().max()))
            ok = ok & solve_ok
            x, sw = x_new, new_on
            if linear or bool(settled):
                break
        x_pad = pad_solution(x, nvar)
        dt_c = max(dt_step, EPS)
        vd_new = _vdrop(x_pad, arr["d_idx"])
        q_d_new = (_diode_charge(vd_new, arr, vt_scale) if pos_d is not None
                   else q_prev_d)
        if pos_q is not None:
            q_be, _, q_bc, _, _, _ = _bjt_junction_charge(x_pad, nl,
                                                          arr["qchg"])
            q_q_new = torch.stack([q_be, q_bc], dim=-1)
        else:
            q_q_new = q_prev_q
        m_idx, q_idx = nl["m_idx"], nl["q_idx"]
        new_state = (
            _vdrop(x_pad, arr["c_idx"]),
            i_prev_l + _l_mv(dt_c, arr["l_vals"], minv,
                             _vdrop(x_pad, arr["l_idx"])),
            vd_new,
            torch.stack([x_pad[m_idx[:, 1]] - x_pad[m_idx[:, 2]],
                         x_pad[m_idx[:, 0]] - x_pad[m_idx[:, 2]]], dim=-1),
            torch.stack([x_pad[q_idx[:, 1]] - x_pad[q_idx[:, 2]],
                         x_pad[q_idx[:, 1]] - x_pad[q_idx[:, 0]]], dim=-1),
            q_d_new, q_q_new, sw)
        return x, new_state, ok

    # t = 0 record: the TRUE rest state, the dt -> 0 limit of the BE
    # bootstrap (capacitors pinned at 0 V, inductors open); the fixed-step
    # engines keep the reference's one-dt0-step-from-rest quirk instead
    state0 = (z(n_c), z(n_l), z(n_d), z(n_m, 2), z(n_q, 2), z(n_d),
              z(n_q, 2),
              torch.zeros((arr["s_idx"].shape[0],), dtype=torch.bool,
                          device=device))
    x0, state, ok = newton(state0, tstop * 1e-12, 0.0, True)
    if hist is not None:
        hist.write(0.0, pad_solution(x0, nvar), True)

    t, dt, done = 0.0, dt0, False
    times, recs, n_rej = [], [], 0
    for _ in range(max_steps):
        if done:
            break
        dt_eff = min(max(min(dt, tstop - t), dt_min), dt_max)
        t_new = t + dt_eff
        x_f, st_f, _ok_f = newton(state, dt_eff, t_new, False)
        _x_h1, st_h, ok_h1 = newton(state, dt_eff / 2, t + dt_eff / 2, False)
        x_h, st_h2, ok_h2 = newton(st_h, dt_eff / 2, t_new, False)
        err = (float((x_h - x_f).abs().div(atol + rtol * x_h.abs()).max())
               if nvar else 0.0)
        # Richardson extrapolation: 2*half - full cancels BE's O(dt) term
        x_rec = 2.0 * x_h - x_f
        # only the LINEAR companion states (capacitor voltage, inductor
        # current) extrapolate; the nonlinear states stay a consistent
        # (v, q(v)) pair from the half-step chain
        (vc_h, il_h, vd_h, vm_h, vq_h, qd_h, qq_h, sw_h) = st_h2
        st_adv = (2.0 * vc_h - st_f[0], 2.0 * il_h - st_f[1],
                  vd_h, vm_h, vq_h, qd_h, qq_h, sw_h)
        at_floor = dt_eff <= dt_min * 1.0000001
        accept = err <= 1.0 or at_floor
        fac = min(max(0.9 / max(err, 1e-12), 0.2), 2.0)
        dt = min(max(dt_eff * fac, dt_min), dt_max)
        if hist is not None:
            # the slot write is unconditional, only the count is
            # accept-gated (a rejected write is overwritten by the next)
            hist.write(t_new, pad_solution(x_rec, nvar), accept)
        if accept:
            t, state = t_new, st_adv
            ok = ok & ok_h1 & ok_h2
            times.append(t_new)
            recs.append(x_rec)
        else:
            n_rej += 1
        done = t >= tstop * (1.0 - 1e-12)
    sols = torch.stack([x0] + recs).cpu().numpy()
    return sols, np.asarray([0.0] + times), n_rej, done, bool(ok)


def simulate_tran_adaptive(
    ckt: ParsedCircuit,
    tensors: CircuitTensors | None = None,
    rtol: float = 1e-4,
    atol: float = 1e-9,
    dt_min: float | None = None,
    dt_max: float | None = None,
    max_steps: int = 4096,
    method: str = "gj",
    max_nr: int = 50,
    nr_tol: float = 1e-9,
    device: torch.device | str | None = None,
) -> AdaptiveTranResult | None:
    """LTE-controlled transient on ``device`` (the card unless
    ``device="cpu"``): the .tran spec supplies the initial step (``dt``)
    and the horizon (``tstop``); the engine then picks its own steps.
    ``exhausted`` reports a budget that ran out before tstop."""
    device = resolve_device(device)
    if ckt.tran is None:
        return None
    # floor the Newton tolerance at 16 ulps of float64 (the JAX package's
    # measured exp() floor is inert on exact backends, item 10)
    nr_tol = max(float(nr_tol), 16.0 * float(np.finfo(np.float64).eps))
    if tensors is None:
        tensors = build_tensors(ckt)
    tstop = ckt.tran.tstop
    dt0 = ckt.tran.dt if ckt.tran.dt > EPS else tstop / 1000.0
    if dt_min is None:
        dt_min = tstop * 1e-9
    if dt_max is None:
        dt_max = tstop / 10.0
    sols, times, n_rej, done, ok = _adaptive_core(
        ckt, tensors, device, tstop, dt0, dt_min, dt_max, rtol, atol, method,
        max_steps, max_nr, nr_tol)
    if not ok:
        raise ValueError("Singular matrix in adaptive TRAN solve")
    node_voltages = {
        name: sols[:, i] for i, name in enumerate(tensors.node_names)
    }
    if ckt.tran_probes:
        upper = {p.upper() for p in ckt.tran_probes}
        node_voltages = {
            name: series for name, series in node_voltages.items()
            if name.upper() in upper
        }
    return AdaptiveTranResult(
        times=times,
        node_voltages=node_voltages,
        n_accepted=len(times) - 1,
        n_rejected=n_rej,
        n_attempts=max_steps,
        exhausted=not done,
    )
