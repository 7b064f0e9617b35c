"""DC operating point (.op), DC sweeps (.dc) and batched DC corners
(``op_batch``) on torch tensors.

Contract: spicey_tpu/analysis/op.py, an extension (the reference has no DC
analysis; its ``.op`` lines land in ``skipped``):

  - R as conductance; C open; L as an ideal 0 V source (extra branch
    unknowns after the V-source branches carry the DC inductor currents);
  - V/I sources at their DC values;
  - diodes and BJT junctions by Newton on the Shockley companion with
    SPICE3's pnjlim (relative, logarithmic step limiting) instead of the
    transient engine's absolute clamp, MOSFETs by Newton on the level-1
    companion, run to convergence: |dx| <= tol * (1 + |x|) and no switch
    toggled;
  - switches by the transient engine's hysteresis update, starting OFF;
  - T lines at DC: the theta -> 0 Branin steady state, a differential
    short (the port rows plus the far-end coupling at c = -1);
  - B sources at t = 0, linearized every pass as in the transient
    (tran._stamp_bsources); K couplings change nothing at DC, where the
    inductors are shorts.

The JAX ``while_loop`` is a Python loop of at most ``max_iters`` passes
with a per-lane ``done`` mask, shaped like the transient's Newton loop: one
batched real solve per pass (kernel K2 on the card, ops/linsolve.solve), so
one core serves one circuit (``lead=()``) and a batch of sweep points or
corners (``lead=(B,)``). ``simulate_op`` keeps the JAX package's
convergence aids, tried in order when plain Newton fails: gmin stepping
(a shunt from every node to ground, 1e-2 S down to 0), then source
stepping (10% to 100%), each stage seeded from the last; ``.nodeset`` seeds
the first Newton iterate. ``op_batch`` gives the lanes its batched Newton
leaves invalid the same aids, lane by lane in one batched ladder, where the
JAX package's ``op_batch`` leaves them invalid.

The structured tier (ops/schur.py, the op-space plan
``plan_partition_op``: nodes, branches and the L shorts) routes the
solves as the JAX package routes them: forced by ``method="schur"``, taken
by ``method="gj"`` on a subcircuit board past 128 op unknowns, and retried
dense where a block pivot fails (``simulate_op`` before its homotopy
ladder, ``simulate_dc`` over the whole sweep, ``op_batch`` lane by lane
before its ladder); ``method="pallas"`` stays dense. A flat deck past N = 128
solves dense (K2 in a global workspace where a system overflows shared
memory).

The JAX package's host interp tier and its measured ``newton_tol_floor``
probe are TPU machinery (item 10): the tolerance floor keeps its dtype
term, 16 ulps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import EPS, GMIN, VT_300K
from ..ir.circuit import (CircuitTensors, bsrc_refs, bsrc_static,
                          build_tensors, ext_arrays, nl_arrays, tl_arrays)
from ..models.devices import bjt_ebers_moll, mos_level1
from ..ops.linsolve import solve
from ..ops.schur import plan_for
from ..ops.stamps import (pad_solution, stamp_admittance, stamp_current,
                          stamp_extended, stamp_tline_coupling,
                          stamp_tline_ports, stamp_voltage_source)
from ..parsing.netlist import ParsedCircuit
from ..utils.device import resolve_device
from ..utils.profiling import count, span
from .tran import (_host, _nl_index_sets, _stamp_bsources, _stamp_nonlinear,
                   _switch_update, prepare_bsources)


@dataclass
class OPResult:
    node_voltages: dict[str, float]
    element_currents: dict[str, float]
    switch_states: dict[str, bool] = None  # converged hysteresis states

    @property
    def nodeVoltages(self):
        return self.node_voltages

    @property
    def elementCurrents(self):
        return self.element_currents


def _pnjlim(vnew: torch.Tensor, vold: torch.Tensor, vt: torch.Tensor,
            vcrit: torch.Tensor) -> torch.Tensor:
    """SPICE3's pn-junction Newton limiter (devsup.c pnjlim): above vcrit,
    a voltage move larger than 2 vt shrinks logarithmically relative to
    the last-used junction voltage, so Newton walks up the exponential
    without overflowing and converges to the true solution (the absolute
    [-1, +0.8] clamp of the transient would park a power junction at a
    wrong stationary point)."""
    arg = 1.0 + (vnew - vold) / vt
    v_pos = torch.where(arg > 0.0,
                        vold + vt * torch.log(arg.clamp_min(1e-300)), vcrit)
    v_neg = vt * torch.log(vnew.clamp_min(1e-300) / vt)
    v_lim = torch.where(vold > 0.0, v_pos, v_neg)
    limit = (vnew > vcrit) & ((vnew - vold).abs() > 2.0 * vt)
    return torch.where(limit, v_lim, vnew)


def _op_core(arr: dict, v_dc: torch.Tensor, i_dc: torch.Tensor,
             r_vals: torch.Tensor, nvar_op: int, max_iters: int = 100,
             tol: float = 1e-12, method: str = "gj", lead: tuple = (),
             x0: torch.Tensor | None = None, gshunt: float | None = None,
             plan: dict | None = None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
    """Newton/hysteresis iteration to the DC solution.

    ``arr`` holds the op-system index tensors (``_op_arrays``); value
    tensors may lead with the batch axis when ``lead=(B,)``: v_dc (B, nV),
    i_dc (B, nI), r_vals (B, nR), the ext and nl values (B, nX). Each pass
    is one (..., N, N) solve; a lane's state freezes once it is done.
    ``gshunt``: the gmin-stepping shunt from every node to ground;
    ``plan``: the structured tier's op-space plan. Returns (x, switch
    states, valid, Newton passes per lane)."""
    dtype, dev = v_dc.dtype, v_dc.device
    nl = arr["nl"]
    sets = _nl_index_sets(nl)
    d_idx, s_idx = arr["d_idx"], arr["s_idx"]
    n_s, n_d, n_q = s_idx.shape[0], d_idx.shape[0], nl["q_idx"].shape[0]
    v_th = arr["d_n"] * VT_300K
    v_crit = v_th * torch.log(v_th / (math.sqrt(2.0)
                                      * arr["d_is"].clamp_min(1e-300)))
    vt_q = nl["vt"]
    v_crit_q = vt_q * torch.log(vt_q / (math.sqrt(2.0)
                                        * nl["q_is"].clamp_min(1e-300)))
    s_on_r = 1.0 / arr["s_ron"].abs().clamp_min(EPS)
    s_off_r = 1.0 / arr["s_roff"].abs().clamp_min(EPS)
    l_zero = torch.zeros(arr["l_bidx"].shape[0], dtype=dtype, device=dev)
    tl = arr.get("tl")
    tl_c = None if tl is None else -torch.ones_like(tl["z0"])
    bsrc = arr.get("bsrc_t", [])

    def assemble(x, sw_on, vjd, vjq):
        A = torch.zeros(lead + (nvar_op + 1, nvar_op + 1), dtype=dtype,
                        device=dev)
        b = torch.zeros(lead + (nvar_op + 1,), dtype=dtype, device=dev)
        stamp_admittance(A, arr["r_idx"], 1.0 / r_vals)
        if gshunt is not None:
            # gmin-stepping homotopy: node-to-ground shunts (the dump slot
            # is ground, so only the node diagonals survive the slice)
            stamp_admittance(A, arr["shunt_idx"],
                             torch.full((arr["shunt_idx"].shape[0],), gshunt,
                                        dtype=dtype, device=dev))
        stamp_voltage_source(A, b, arr["l_bidx"], l_zero)
        stamp_voltage_source(A, b, arr["v_idx"], v_dc)
        stamp_current(b, arr["ext"]["i_idx"], i_dc)
        stamp_extended(A, arr["ext"])
        if tl is not None:
            # a line at DC: the theta -> 0 steady state, a differential
            # short (v and i equal across the ports)
            stamp_tline_ports(A, tl["t_idx"], tl["z0"])
            stamp_tline_coupling(A, tl["t_idx"], tl["z0"], tl_c)
        stamp_admittance(A, s_idx[:, :2], torch.where(sw_on, s_on_r, s_off_r))
        x_pad = pad_solution(x, nvar_op)
        vd = x_pad[..., d_idx[:, 0]] - x_pad[..., d_idx[:, 1]]
        vd_lim = _pnjlim(vd, vjd, v_th, v_crit)
        ev = torch.exp(vd_lim / v_th)
        i_d = arr["d_is"] * (ev - 1.0)
        g_d = ((arr["d_is"] / v_th) * ev).clamp_min(GMIN)
        stamp_admittance(A, d_idx, g_d)
        stamp_current(b, d_idx, i_d - g_d * vd_lim)
        vq_lim = None
        if n_q:
            q_idx, s_q = nl["q_idx"], nl["q_pol"]
            vbe_r = s_q * (x_pad[..., q_idx[:, 1]] - x_pad[..., q_idx[:, 2]])
            vbc_r = s_q * (x_pad[..., q_idx[:, 1]] - x_pad[..., q_idx[:, 0]])
            vq_lim = torch.stack(
                [_pnjlim(vbe_r, vjq[..., 0], vt_q, v_crit_q),
                 _pnjlim(vbc_r, vjq[..., 1], vt_q, v_crit_q)], dim=-1)
        # MOSFET/BJT companions at the current iterate (it=1: no
        # previous-timestep seed)
        _stamp_nonlinear(A, b, nl, sets, x_pad, 1, None, None, vq_lim=vq_lim)
        if bsrc:  # behavioral sources at t = 0
            _stamp_bsources(A, b, bsrc, x_pad, 0.0)
        return (A[..., :nvar_op, :nvar_op], b[..., :nvar_op], vd_lim,
                vq_lim)

    if x0 is None:  # .nodeset seeds the Newton iterate; default is rest
        x = torch.zeros(lead + (nvar_op,), dtype=dtype, device=dev)
    else:
        x = torch.as_tensor(x0, dtype=dtype, device=dev).expand(
            lead + (nvar_op,)).clone()
    sw = torch.zeros(lead + (n_s,), dtype=torch.bool, device=dev)
    vjd = torch.zeros(lead + (n_d,), dtype=dtype, device=dev)
    vjq = torch.zeros(lead + (n_q, 2), dtype=dtype, device=dev)
    done = torch.zeros(lead, dtype=torch.bool, device=dev)
    ok = torch.ones(lead, dtype=torch.bool, device=dev)
    passes = torch.zeros(lead, dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        A, b, vd_used, vq_used = assemble(x, sw, vjd, vjq)
        x_new, solve_ok = solve(A, b, method=method, plan=plan)
        new_on = _switch_update(s_idx, arr["s_von"], arr["s_voff"], sw,
                                pad_solution(x_new, nvar_op))
        switched = torch.any(new_on != sw, dim=-1)
        if nvar_op:
            delta = (x_new - x).abs().amax(dim=-1)
            scale = 1.0 + x_new.abs().amax(dim=-1)
            settled = ~switched & (delta <= tol * scale)
        else:
            settled = ~switched
        # masked commit: once done, the lane is frozen
        mask = done[..., None]
        x = torch.where(mask, x, x_new)
        sw = torch.where(mask, sw, new_on)
        vjd = torch.where(mask, vjd, vd_used)
        if n_q:
            vjq = torch.where(mask[..., None], vjq, vq_used)
        ok = ok & (done | solve_ok)
        passes = passes + (~done).to(torch.int32)
        done = done | settled
        if bool(done.all()):
            break
    return x, sw, ok & done, passes


def _op_indices(tensors: CircuitTensors):
    """Index marshaling for the op system: unknown ordering is nodes,
    then V/E/H branches (identical to the first tensors.nvar tran/AC
    unknowns), then extra 0V-short branches carrying DC inductor currents.
    Returns (nvar_op, remap, l_bidx, v_idx_op)."""
    n_l = tensors.n_l
    nvar_op = tensors.nvar + n_l
    dump = nvar_op

    def remap(idx):
        """Re-target dump-slot indices from the tran/AC system size."""
        return np.where(idx == tensors.nvar, dump, idx).astype(np.int32)

    l_bidx = np.concatenate(
        [
            remap(tensors.l_idx),
            (tensors.nvar + np.arange(n_l, dtype=np.int32))[:, None],
        ],
        axis=1,
    ) if n_l else np.zeros((0, 3), np.int32)
    v_idx_op = np.concatenate(
        [remap(tensors.v_idx[:, :2]), tensors.v_idx[:, 2:]], axis=1
    ).astype(np.int32) if tensors.n_v else np.zeros((0, 3), np.int32)
    return nvar_op, remap, l_bidx, v_idx_op


def _op_arrays(ckt: ParsedCircuit, tensors: CircuitTensors,
               device: torch.device, dtype: torch.dtype,
               ext: dict | None = None, nl: dict | None = None) -> dict:
    """The op system's index tensors (int64, remapped to its dump slot)
    and its fixed value tensors, the T lines and the prepared B sources
    of ``ckt``; ``ext``/``nl`` default to the netlist's (unbatched),
    ``op_batch`` passes batched ones."""
    nvar_op, remap, l_bidx, v_idx_op = _op_indices(tensors)
    dump = nvar_op

    def idx(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def val(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    nodes = np.arange(tensors.n_node_vars)
    return {
        "r_idx": idx(remap(tensors.r_idx)),
        "l_bidx": idx(l_bidx), "v_idx": idx(v_idx_op),
        "s_idx": idx(remap(tensors.s_idx)),
        "s_ron": val(tensors.s_ron), "s_roff": val(tensors.s_roff),
        "s_von": val(tensors.s_von), "s_voff": val(tensors.s_voff),
        "d_idx": idx(remap(tensors.d_idx)),
        "d_is": val(tensors.d_is), "d_n": val(tensors.d_n),
        "shunt_idx": idx(np.stack([nodes, np.full_like(nodes, dump)],
                                  axis=1)),
        "ext": (ext_arrays(tensors, device, dtype, dump=dump) if ext is None
                else ext),
        "nl": (nl_arrays(tensors, device, dtype, dump=dump) if nl is None
               else nl),
        "tl": tl_arrays(tensors, device, dtype, dump=dump),
        "bsrc_t": prepare_bsources(bsrc_static(ckt, nvar_op), device),
    }


def _run_op_core(ckt: ParsedCircuit, tensors: CircuitTensors,
                 v_dc: np.ndarray,
                 i_dc: np.ndarray, r_vals: np.ndarray, max_iters: int,
                 tol: float, method: str, device: torch.device,
                 ext: dict | None = None, nl: dict | None = None,
                 batch: int | None = None, x0: np.ndarray | None = None,
                 gshunt: float | None = None, plan: dict | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Host values to device tensors, then ``_op_core`` in float64."""
    f64 = torch.float64

    def val(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), dtype=f64,
                               device=device)

    return _op_core(
        _op_arrays(ckt, tensors, device, f64, ext=ext, nl=nl), val(v_dc),
        val(i_dc), val(r_vals), tensors.nvar + tensors.n_l,
        max_iters=max_iters, tol=tol, method=method,
        lead=() if batch is None else (batch,),
        x0=None if x0 is None else val(x0), gshunt=gshunt, plan=plan)


# the convergence aids' schedule (simulate_op, op_batch's ladder): gmin
# stepping's node-to-ground shunts, then source stepping's scales
GMIN_STEPS = (1e-2, 1e-3, 1e-4, 1e-5, 1e-6, 1e-8, 1e-10, 1e-12, 0.0)
SOURCE_STEPS = tuple(float(c) for c in np.linspace(0.1, 1.0, 10))


def _tol_floor(tol: float) -> float:
    """The Newton tolerance floored at 16 ulps of float64 (the dtype half
    of the JAX package's ``newton_tol_floor``)."""
    return max(float(tol), 16.0 * float(np.finfo(np.float64).eps))


def simulate_op(
    ckt: ParsedCircuit,
    tensors: CircuitTensors | None = None,
    method: str = "gj",
    max_iters: int = 100,
    tol: float = 1e-12,
    device: torch.device | str | None = None,
) -> OPResult:
    """Solve the DC operating point in float64 on ``device`` (the card
    unless ``device="cpu"``)."""
    device = resolve_device(device)
    if tensors is None:
        tensors = build_tensors(ckt)
    nvar_op, remap, _l_bidx, _v_idx_op = _op_indices(tensors)

    x0 = None
    if getattr(ckt, "nodeset", None):
        # .nodeset: initial Newton guess for the named node voltages
        # (selects the basin of attraction for multi-stable circuits)
        ns = {k.upper(): v for k, v in ckt.nodeset.items()}
        x0 = np.zeros(nvar_op)
        for i, name in enumerate(tensors.node_names):
            x0[i] = ns.get(name.upper(), 0.0)
    tol = _tol_floor(tol)
    # the structured tier (op-space plan): forced by "schur", auto past
    # 128 op unknowns for "gj"; a failed Schur attempt retries dense before
    # the homotopy ladder
    plan = plan_for(method, ckt, tensors, nvar_op, device, op=True)
    solve_method = "gj" if method == "schur" else method

    def attempt(x_seed, v_scale=1.0, gshunt=None):
        x_a, sw_a, ok_a, _ = _run_op_core(
            ckt, tensors, tensors.v_dc * v_scale, tensors.i_dc * v_scale,
            tensors.r_vals, max_iters, tol, solve_method, device, x0=x_seed,
            gshunt=gshunt, plan=plan)
        # one device->host transfer of [x | switch states | ok]
        packed_a = torch.cat([x_a, sw_a.to(x_a.dtype),
                              ok_a.to(x_a.dtype).reshape(1)]).cpu().numpy()
        return packed_a, bool(packed_a[-1] > 0.5)

    packed, ok = attempt(x0)
    if not ok and plan is not None:
        # block-local pivoting (or a vanished-C structural hole) failed
        # where global pivoting may not: retry dense, then the ladder
        plan = None
        packed, ok = attempt(x0)
    if not ok:
        # ngspice-style convergence aids, tried in order (each stage seeds
        # the next from its converged solution):
        # 1. gmin stepping: shunt every node with a conductance stepped
        #    from 1e-2 S down to 0;
        # 2. source stepping: ramp every independent source 10% -> 100%.
        seed = x0
        for g in GMIN_STEPS:
            packed, ok = attempt(seed, gshunt=g)
            if not ok:
                break
            seed = packed[:nvar_op]
        if not ok:
            seed = x0
            for scale in SOURCE_STEPS:
                packed, ok = attempt(seed, v_scale=scale)
                if not ok:
                    break
                seed = packed[:nvar_op]
    if not ok:
        raise ValueError("DC operating point did not converge")
    x = packed[:nvar_op]
    sw_on = packed[nvar_op:nvar_op + tensors.n_s] > 0.5
    return _op_epilogue(ckt, tensors, x, sw_on, remap)


def _op_epilogue(ckt: ParsedCircuit, tensors: CircuitTensors, x: np.ndarray,
                 sw_on: np.ndarray, remap) -> OPResult:
    """Host-side OPResult assembly: element currents recovered from the
    solution in the JAX package's order."""
    n_node = tensors.n_node_vars
    x_pad = np.concatenate([x, [0.0]])
    node_voltages = {
        name: float(x[i]) for i, name in enumerate(tensors.node_names)
    }
    currents: dict[str, float] = {}
    ri = remap(tensors.r_idx)
    for k, name in enumerate(tensors.r_names):
        currents[name] = float(
            (x_pad[ri[k, 0]] - x_pad[ri[k, 1]]) / tensors.r_vals[k]
        )
    for name in tensors.c_names:
        currents[name] = 0.0  # open at DC
    for k, name in enumerate(tensors.l_names):
        currents[name] = float(x[tensors.nvar + k])
    for k, name in enumerate(tensors.v_names):
        currents[name] = float(x[n_node + k])
    sw_np = np.asarray(sw_on)
    si = remap(tensors.s_idx)
    for k, name in enumerate(tensors.s_names):
        rv = tensors.s_ron[k] if sw_np[k] else tensors.s_roff[k]
        currents[name] = float(
            (x_pad[si[k, 0]] - x_pad[si[k, 1]]) / max(abs(rv), EPS)
        )
    di = remap(tensors.d_idx)
    for k, name in enumerate(tensors.d_names):
        vd = x_pad[di[k, 0]] - x_pad[di[k, 1]]
        v_th = tensors.d_n[k] * VT_300K
        currents[name] = float(tensors.d_is[k] * (np.exp(vd / v_th) - 1.0))
    for k, name in enumerate(tensors.i_names):
        currents[name] = float(tensors.i_dc[k])
    switch_states = {
        name: bool(sw_np[k]) for k, name in enumerate(tensors.s_names)
    }
    gi = remap(tensors.g_idx)
    for k, name in enumerate(tensors.g_names):
        vc = x_pad[gi[k, 2]] - x_pad[gi[k, 3]]
        currents[name] = float(tensors.g_gm[k] * vc)
    for k, name in enumerate(tensors.e_names):
        currents[name] = float(x[tensors.e_idx[k, 2]])
    for k, name in enumerate(tensors.f_names):
        currents[name] = float(tensors.f_gain[k] * x[tensors.f_idx[k, 2]])
    for k, name in enumerate(tensors.h_names):
        currents[name] = float(x[tensors.h_idx[k, 2]])
    if tensors.n_m:
        mi = remap(tensors.m_idx)
        vgs = x_pad[mi[:, 1]] - x_pad[mi[:, 2]]
        vds = x_pad[mi[:, 0]] - x_pad[mi[:, 2]]
        i_m = _host(mos_level1, vgs, vds, tensors.m_beta, tensors.m_vto,
                    tensors.m_lambda, tensors.m_polarity)[3]
        for k, name in enumerate(tensors.m_names):
            currents[name] = float(i_m[k])
    if tensors.n_q:
        qi = remap(tensors.q_idx)
        vbe = x_pad[qi[:, 1]] - x_pad[qi[:, 2]]
        vbc = x_pad[qi[:, 1]] - x_pad[qi[:, 0]]
        # record at the TRUE junction voltages (the op converged there;
        # the default clamp would misreport power devices)
        i_c = _host(bjt_ebers_moll, vbe, vbc, tensors.q_is, tensors.q_bf,
                    tensors.q_br, tensors.q_polarity, tensors.vt,
                    tensors.q_polarity * vbe, tensors.q_polarity * vbc)[7]
        for k, name in enumerate(tensors.q_names):
            currents[name] = float(i_c[k])
    # behavioral sources: a V-kind source's current is its branch
    # unknown, an I-kind source's its expression at the solution (t = 0)
    for b_el in ckt.B:
        if b_el.kind == "v":
            currents[b_el.name] = float(x[b_el.index])
        else:
            refs = np.asarray(bsrc_refs(b_el, len(x)), np.int64).reshape(-1, 2)
            currents[b_el.name] = float(
                b_el.fn(x_pad[refs[:, 0]] - x_pad[refs[:, 1]], 0.0))
    for k, name in enumerate(tensors.t_names):
        currents[name] = float(x[tensors.t_idx[k, 4]])
        currents[f"{name}#p2"] = float(x[tensors.t_idx[k, 5]])
    return OPResult(node_voltages=node_voltages, element_currents=currents,
                    switch_states=switch_states)


@dataclass
class DCResult:
    """DC sweep result: per-sweep-point node voltages (extended dialect).

    For a 2D sweep (two sources), every array keeps the flattened (B1*B2,)
    layout with the SECOND source as the slow (outer) axis, ngspice-style;
    ``sweep2`` holds the outer source's value per point and ``shape2d``
    gives (B2, B1) for reshaping. ``passes``: the Newton passes each point
    ran."""

    sweep: np.ndarray                       # (B,) swept source values
    node_voltages: dict[str, np.ndarray]    # name -> (B,)
    element_currents: dict[str, np.ndarray]
    valid: np.ndarray                       # (B,) convergence per point
    sweep2: np.ndarray | None = None        # (B,) outer source values (2D)
    shape2d: tuple[int, int] | None = None  # (B2, B1) when 2D
    passes: np.ndarray | None = None        # (B,) Newton passes per point


def _batched_op(ckt: ParsedCircuit, tensors: CircuitTensors,
                v_dc: np.ndarray, i_dc: np.ndarray,
                r_vals: np.ndarray, B: int, max_iters: int, tol: float,
                method: str, device: torch.device, ext: dict | None = None,
                nl: dict | None = None, plan: dict | None = None,
                x0: np.ndarray | None = None, gshunt: float | None = None
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One batched Newton over B lanes (from ``x0``, (B, nvar_op), else
    rest; ``gshunt`` as ``_op_core``'s), in a ``solve`` span; one
    device->host transfer of [x | valid | passes], in a ``fetch`` span.
    Returns host (x (B, nvar_op), valid, passes)."""
    nvar_op = tensors.nvar + tensors.n_l
    with span("solve"):
        x, _sw, valid, passes = _run_op_core(
            ckt, tensors, v_dc, i_dc, r_vals, max_iters, tol,
            "gj" if method == "schur" else method, device, ext=ext, nl=nl,
            batch=B, x0=x0, gshunt=gshunt, plan=plan)
    with span("fetch"):
        packed = torch.cat([x, valid[:, None].to(x.dtype),
                            passes[:, None].to(x.dtype)],
                           dim=1).cpu().numpy()
    return (packed[:, :nvar_op], packed[:, nvar_op] > 0.5,
            packed[:, nvar_op + 1].astype(np.int64))



def simulate_dc(
    ckt: ParsedCircuit,
    tensors: CircuitTensors | None = None,
    method: str = "gj",
    max_iters: int = 100,
    tol: float = 1e-12,
    device: torch.device | str | None = None,
) -> DCResult | None:
    """.dc sweep (extended dialect) in float64 on ``device`` (the card
    unless ``device="cpu"``): every sweep point is one lane of a single
    batched Newton solve, the second source of a 2D sweep the slow axis."""
    device = resolve_device(device)
    if ckt.dc is None:
        return None
    if tensors is None:
        tensors = build_tensors(ckt)
    spec = ckt.dc
    n1 = int(np.floor((spec.stop - spec.start) / spec.step + 0.5)) + 1
    grid1 = spec.start + spec.step * np.arange(n1)

    v_names = [n.upper() for n in tensors.v_names]
    i_names = [n.upper() for n in tensors.i_names]

    def place(col, key, label):
        if key in v_names:
            v_dc[:, v_names.index(key)] = col
        elif key in i_names:
            i_dc[:, i_names.index(key)] = col
        else:
            raise ValueError(f"Unknown .dc source {label}")

    sweep2 = shape2d = None
    if spec.src2 is not None:
        # 2D nested sweep: source 2 is the slow (outer) axis; all
        # (B2 x B1) corners solve in ONE batched Newton call
        n2 = int(np.floor((spec.stop2 - spec.start2) / spec.step2 + 0.5)) + 1
        grid2 = spec.start2 + spec.step2 * np.arange(n2)
        sweep = np.tile(grid1, n2)
        sweep2 = np.repeat(grid2, n1)
        shape2d = (n2, n1)
        B = n1 * n2
    else:
        sweep = grid1
        B = n1
    v_dc = np.broadcast_to(tensors.v_dc, (B, tensors.n_v)).copy()
    i_dc = np.broadcast_to(tensors.i_dc, (B, tensors.n_i)).copy()
    place(sweep, spec.src.upper(), spec.src)
    if spec.src2 is not None:
        place(sweep2, spec.src2.upper(), spec.src2)

    nvar_op, remap, _l_bidx, _v_idx_op = _op_indices(tensors)
    # the structured tier (see simulate_op); lanes the block pivoting fails
    # retry dense as a whole sweep before they surface invalid
    plan = plan_for(method, ckt, tensors, nvar_op, device, op=True)
    x, valid, passes = _batched_op(ckt, tensors, v_dc, i_dc, tensors.r_vals,
                                   B, max_iters, _tol_floor(tol), method,
                                   device, plan=plan)
    if plan is not None and not bool(valid.all()):
        x, valid, passes = _batched_op(ckt, tensors, v_dc, i_dc,
                                       tensors.r_vals, B, max_iters,
                                       _tol_floor(tol), method, device)
    x_pad = np.concatenate([x, np.zeros((B, 1))], axis=1)

    node_voltages = {
        name: x[:, i] for i, name in enumerate(tensors.node_names)
    }
    currents: dict[str, np.ndarray] = {}
    ri = remap(tensors.r_idx)
    for k, name in enumerate(tensors.r_names):
        currents[name] = (x_pad[:, ri[k, 0]] - x_pad[:, ri[k, 1]]) \
            / tensors.r_vals[k]
    for k, name in enumerate(tensors.v_names):
        currents[name] = x[:, tensors.n_node_vars + k]
    for k, name in enumerate(tensors.i_names):
        currents[name] = i_dc[:, k]
    if tensors.n_m:
        mi = remap(tensors.m_idx)
        vgs = x_pad[:, mi[:, 1]] - x_pad[:, mi[:, 2]]
        vds = x_pad[:, mi[:, 0]] - x_pad[:, mi[:, 2]]
        i_m = _host(mos_level1, vgs, vds, tensors.m_beta[None, :],
                    tensors.m_vto[None, :], tensors.m_lambda[None, :],
                    tensors.m_polarity[None, :])[3]
        for k, name in enumerate(tensors.m_names):
            currents[name] = i_m[:, k]
    if tensors.n_q:
        qi = remap(tensors.q_idx)
        vbe = x_pad[:, qi[:, 1]] - x_pad[:, qi[:, 2]]
        vbc = x_pad[:, qi[:, 1]] - x_pad[:, qi[:, 0]]
        pol = tensors.q_polarity[None, :]
        i_c = _host(bjt_ebers_moll, vbe, vbc, tensors.q_is[None, :],
                    tensors.q_bf[None, :], tensors.q_br[None, :], pol,
                    tensors.vt, pol * vbe, pol * vbc)[7]
        for k, name in enumerate(tensors.q_names):
            currents[name] = i_c[:, k]
    return DCResult(sweep=sweep, node_voltages=node_voltages,
                    element_currents=currents, valid=valid,
                    sweep2=sweep2, shape2d=shape2d, passes=passes)


def _op_ladder(stage, n: int, nvar_op: int, retry: bool = False
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``simulate_op``'s convergence aids over ``n`` lanes at once, lane by
    lane: where ``retry``, a plain dense Newton first; then gmin stepping
    over ``GMIN_STEPS``, a lane's chain ending at its first failed stage;
    then, for the lanes still unsolved, source stepping over
    ``SOURCE_STEPS`` alike. Every chain starts from rest and seeds each
    stage with the last one's answer, and each stage runs only on the
    lanes still in its chain. ``stage(lanes, seed, scale=, gshunt=)``
    runs one stage's batched Newton on ``lanes`` (indices into the n) and
    returns host (x, valid, passes). Returns host (x, solved, passes each
    lane ran over every stage); x of an unsolved lane is 0."""
    x = np.zeros((n, nvar_op))
    solved = np.zeros(n, dtype=bool)
    passes = np.zeros(n, dtype=np.int64)

    def chain(lanes: np.ndarray, kws: list[dict]) -> None:
        seed = np.zeros((len(lanes), nvar_op))
        for kw in kws:
            if not len(lanes):
                return
            got, ok, p = stage(lanes, seed, **kw)
            passes[lanes] += p
            lanes, seed = lanes[ok], got[ok]
        x[lanes] = seed
        solved[lanes] = True

    for kws in ([{}] if retry else [],
                [{"gshunt": g} for g in GMIN_STEPS],
                [{"scale": c} for c in SOURCE_STEPS]):
        if kws:
            chain(np.flatnonzero(~solved), kws)
    return x, solved, passes


@dataclass
class BatchOPResult:
    node_names: tuple[str, ...]
    x: np.ndarray      # (B, nvar_op)
    valid: np.ndarray  # (B,)
    passes: np.ndarray | None = None  # (B,) Newton passes per variant

    def node_voltage(self, name: str) -> np.ndarray:
        i = [n.upper() for n in self.node_names].index(name.upper())
        return self.x[..., i]


def op_batch(
    circuit: ParsedCircuit | str,
    overrides: dict[str, np.ndarray],
    tensors: CircuitTensors | None = None,
    method: str = "gj",
    max_iters: int = 100,
    tol: float = 1e-12,
    dialect: str = "spicey",
    device: torch.device | str | None = None,
) -> BatchOPResult:
    """Batched DC corners in float64 on ``device`` (the card unless
    ``device="cpu"``): one Newton solve over all parameter variants.

    overrides sweep element values by name (R resistance, V/I DC level,
    controlled-source gains, M beta, Q Is), exactly like the other batch
    APIs.

    A variant that the batched Newton leaves invalid takes
    ``simulate_op``'s convergence aids (``_op_ladder``): the variants left
    invalid, and only they, run as one batch through the structured
    tier's dense retry where it had a plan, then gmin stepping, then
    source stepping, each stage seeded from the last, and their answers
    are scattered back. A variant the Newton solves keeps its answer and
    its passes; a rescued variant's passes count the Newton's and every
    stage's it ran; one that no stage solves stays invalid, with the
    Newton's answer.

    Spans (``profiling.profiled()``): ``op_batch``, and in it ``prepare``
    (the deck's tensors and the variants' values), ``solve`` (the batched
    Newton), ``fetch`` (its one transfer to the host) and ``ladder`` (the
    aids, only when a variant takes them; a ``solve`` and a ``fetch`` in
    it for each stage). Counters: ``op.newton_passes``
    (the Newton's batched passes), ``op.lane_passes`` (its passes summed
    over the variants), ``op.ladder_lanes`` (the variants it left to the
    aids), ``op.ladder_rescued`` (those the aids solved),
    ``op.ladder_passes`` (the aids' batched passes), ``sync.newton_done``
    (each batched pass's ``bool(done.all())``) and ``sync.fetch`` (each
    transfer to the host). The counts are read from the passes that come
    back with the answers: counting adds no transfer."""
    from .batch import (_batch_size, _batch_values, _batched_ext,
                        _batched_nl, _consumed, _resolve)

    with span("op_batch"):
        with span("prepare"):
            device = resolve_device(device)
            ckt = _resolve(circuit, dialect=dialect)
            if tensors is None:
                tensors = build_tensors(ckt)
            B = _batch_size(overrides)
            _consumed([tensors.r_names, tensors.c_names, tensors.l_names,
                       tensors.v_names, tensors.i_names, tensors.g_names,
                       tensors.e_names, tensors.f_names, tensors.h_names,
                       tensors.m_names, tensors.q_names], overrides)
            dump = tensors.nvar + tensors.n_l
            f64 = torch.float64
            tol = _tol_floor(tol)

            def remapped(arrays: dict) -> dict:
                return {k: (torch.where(v == tensors.nvar, dump, v)
                            if k.endswith("idx") else v)
                        for k, v in arrays.items()}

            def values(over: dict, n: int) -> dict:
                """The batched Newton's inputs for ``n`` variants."""
                return dict(
                    r_vals=_batch_values(tensors.r_vals, tensors.r_names,
                                         over, n),
                    v_dc=_batch_values(tensors.v_dc, tensors.v_names, over,
                                       n),
                    i_dc=_batch_values(tensors.i_dc, tensors.i_names, over,
                                       n),
                    ext=remapped(_batched_ext(tensors, over, n, device,
                                              f64)),
                    nl=remapped(_batched_nl(tensors, over, n, device, f64)))

            # the structured tier (see simulate_op); a lane whose block
            # pivots fail retries dense in the ladder
            plan = plan_for(method, ckt, tensors, dump, device, op=True)
            inputs = values(overrides, B)
        x, valid, passes = _batched_op(
            ckt, tensors, B=B, max_iters=max_iters, tol=tol, method=method,
            device=device, plan=plan, **inputs)
        newton = int(passes.max(initial=0))
        count("op.newton_passes", newton)
        count("op.lane_passes", int(passes.sum()))
        count("sync.newton_done", newton)
        count("sync.fetch")
        bad = np.flatnonzero(~valid)
        count("op.ladder_lanes", len(bad))
        if len(bad):
            with span("ladder"):
                def stage(lanes, seed, scale=1.0, gshunt=None):
                    """One stage of the aids: the batched Newton over the
                    variants ``bad[lanes]``, dense."""
                    sub = bad[lanes]
                    got = values({k: np.asarray(v, np.float64)[sub]
                                  for k, v in overrides.items()}, len(sub))
                    got["v_dc"] = got["v_dc"] * scale
                    got["i_dc"] = got["i_dc"] * scale
                    out = _batched_op(
                        ckt, tensors, B=len(sub), max_iters=max_iters,
                        tol=tol, method=method, device=device, x0=seed,
                        gshunt=gshunt, **got)
                    count("op.ladder_passes", int(out[2].max()))
                    count("sync.newton_done", int(out[2].max()))
                    count("sync.fetch")
                    return out

                x_l, ok_l, passes_l = _op_ladder(stage, len(bad), dump,
                                                 retry=plan is not None)
                count("op.ladder_rescued", int(ok_l.sum()))
                x[bad[ok_l]] = x_l[ok_l]
                valid[bad] = ok_l
                passes[bad] += passes_l
    return BatchOPResult(node_names=tensors.node_names, x=x, valid=valid,
                         passes=passes)
