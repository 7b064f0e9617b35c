"""Transient analysis: companion models under a time loop on torch tensors.

Contract: spicey/lib/analysis/simulateTRAN.ts:14-252, as the JAX package
carries it (spicey_tpu/analysis/tran.py). The JAX ``lax.scan`` over time
is a Python loop over steps here, and its Newton ``while_loop`` a loop of
at most ``max_nr`` passes with the per-lane ``done`` mask, so the same
core serves one circuit (``lead=()``) and a batch of Monte-Carlo
variants (``lead=(B,)``):

  - x is seeded to zero each step (:149); each pass rebuilds A and b and
    solves them (kernel K2 on the card, ops/linsolve.solve); a lane is
    done as soon as no switch toggled (:159-161; ``nr="converged"`` also
    asks |dx| <= tol * (1 + |x|)), so diodes get one Newton step per
    switch-stable pass, seeded from the previous step's vd on pass 0
    (:81-85);
  - a linear circuit (no S/D/M/Q, reference Newton) factors once: the inverse
    of the time-invariant matrix (kernel K3, ops/linsolve.inverse), then
    per step x = Ainv b plus one refinement pass;
  - source values are precomputed over the grid (ir/circuit.py);
  - element currents are recovered after the loop from the stacked
    solutions on the host (C from the step-to-step voltage delta, L as a
    cumulative sum of companion updates; :173-219).

Device models (simulateTRAN.ts:25-106): C: Gc = C/max(dt, EPS), Ieq =
-Gc vPrev; L: Gl = max(dt, EPS)/L, Norton current iPrev; S: R = Ron|Roff
by hysteresis state, |R| >= EPS; V: waveform(t) | dc; D: Shockley
companion, vd clamped to [-1.0, 0.8] * vt/VT_300K, gd >= GMIN. The
extended devices are the JAX package's (models/devices.py): MOSFETs
(level 1; JFETs lower to them) and BJTs (Ebers-Moll) seeded from the
previous step's junction voltages on pass 0, diode TT/CJO and BJT
TF/TR/CJE/CJC junction charge as backward-Euler charge companions with
the split Newton anchor (diffusion at the clamped voltage, depletion at
the true one). A deck with MOSFETs or BJTs iterates to convergence
(``nr="converged"``), as in the JAX package. The improvement toggles
``integration="trap"|"gear2"`` and ``nr="converged"`` are the JAX
package's.

The extended K, T and B elements are the JAX package's too:
  - K-coupled inductors: the per-inductor companion c/L becomes the
    matrix companion c * M^{-1}, M = diag(L) + k sqrt(L_a L_b) on the
    coupled pairs, inverted once per run per variant (``_mutual_inv``,
    kernel K3 on the card); a singular M (perfect coupling, |k| = 1)
    flags the run invalid;
  - T lines (Branin's method of characteristics): two port-current
    unknowns per line, Z0 rows in the matrix and the delayed far-end
    Thevenin sources in the RHS, read by linear interpolation from a
    circular history buffer of the port waves w = v + Z0 i (``(lead, H,
    nT, 2)``, H covering the longest delay); a batch may sweep each
    line's Z0 and Td;
  - B sources: each Newton pass linearizes the expression at the iterate,
    its value and per-reference partials (parsing/bexpr.py) stamping as
    VCCS rows plus a current injection (I-kind) or as the branch row of
    v(n+) - v(n-) = f (V-kind); a deck with B sources iterates Newton to
    convergence and never factors once.

The structured tier (ops/schur.py) routes the solves as the JAX package
routes them: forced by ``method="schur"`` (a ``ValueError`` on a circuit
with no block structure), taken by the default ``method="gj"`` on a
subcircuit board past N = 128 (the AC plan: the companions stamp only
node pairs the static patterns already cover), and the whole run retried
dense when a block pivot fails; ``method="pallas"`` stays dense. Under a
plan every Newton pass is a Schur solve, and a linear deck's factor-once
A^-1 is the Schur solve of the identity's columns (one multi-RHS call),
not the inverse kernel, as the JAX package's ``inv_of`` does. A flat deck
past N = 128 solves dense (K2 or K3 in a global workspace where a system
overflows shared memory).

The JAX package's host interp tier, placement and ``accurate_exp`` have
no counterpart (item 10): on the card the device path is the path, and
only the dtype half of the Newton tolerance floor (16 ulps) is kept.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (DIODE_VD_MAX, DIODE_VD_MIN, EPS, GMIN, MAX_NR_ITERS,
                         VT_300K)
from ..ir.circuit import (CircuitTensors, bsrc_refs, bsrc_static,
                          build_tensors, dchg_arrays, effective_time_step,
                          ext_arrays, lk_arrays, nl_arrays, qchg_arrays,
                          sample_source_values, tl_arrays)
from ..models.devices import bjt_ebers_moll, diode_charge_cap, mos_level1
from ..ops.linsolve import inverse, solve
from ..ops.schur import plan_for, schur_solve_multi
from ..ops.stamp_real import StampPlan, assemble, build_plan
from ..ops.stamp_real import apply as apply_stamps
from ..ops.stamps import (pad_solution, stamp_admittance, stamp_current,
                          stamp_extended, stamp_mutual, stamp_tline_ports,
                          stamp_voltage_source)
from ..parsing.bexpr import bexpr_partials
from ..parsing.netlist import ParsedCircuit
from ..utils.device import resolve_device
from ..utils.profiling import count
from .results import TranResult


@dataclass
class TranState:
    """Checkpoint of a transient run: the loop carry + the end time.

    ``simulate_tran(..., return_state=True)`` hands it back as
    ``result.state``; ``simulate_tran(..., state=...)`` continues exactly
    where it stopped, the netlist's .tran spec giving the next segment's
    length. ``carry`` is the JAX package's layout (v_prev_c, i_prev_c,
    i_prev_l, v_prev_l, vd_prev_d, vm_prev, vq_prev, sw_on, v_prev2_c,
    i_prev2_l[, q_prev_d][, q_prev_q][, w_hist, t_cnt]), the charges
    present when the deck stores diode or BJT junction charge, the T-line
    history buffer and its step counter when it has lines, as host NumPy
    arrays, so a JAX checkpoint resumes here and the other way round."""

    carry: tuple
    t: float
    dt: float


def _vdrop(x_pad: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x_pad[..., idx[:, 0]] - x_pad[..., idx[:, 1]]


def _mutual_inv(l_vals: torch.Tensor, lk: dict
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse inductance matrix of K-coupled inductors.

    M = diag(L) + offdiag(k_ab * sqrt(L_a * L_b)) over the coupled pairs;
    returns (M^{-1}, ok) over the broadcast leading dims of ``l_vals``
    (..., nL) and the coefficients (..., nK), ``ok`` per variant. The
    inverse is ``ops/linsolve.inverse``: kernel K3 on a CUDA tensor (its
    register form at the nL <= 8 of a deck's windings), the plain
    Gauss-Jordan on the CPU."""
    k_vals = lk["k_vals"]
    n_l = l_vals.shape[-1]
    lead = torch.broadcast_shapes(l_vals.shape[:-1], k_vals.shape[:-1])
    lv = l_vals.expand(lead + (n_l,))
    a, b = lk["k_pairs"][:, 0], lk["k_pairs"][:, 1]
    m = (k_vals * torch.sqrt(lv[..., a] * lv[..., b])).to(l_vals.dtype)
    M = torch.diag_embed(lv)
    flat = M.view(lead + (n_l * n_l,))
    flat.index_add_(-1, a * n_l + b, m.expand(lead + a.shape))
    flat.index_add_(-1, b * n_l + a, m.expand(lead + a.shape))
    return inverse(M)


def _factor(A: torch.Tensor, plan: dict | None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """A^-1 of every system and its flag: the inverse (K3 on the card),
    or under a Schur plan the structured solves of the identity's columns
    in one multi-RHS call, as the JAX package's ``inv_of`` builds it."""
    if plan is None:
        return inverse(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return schur_solve_multi(A, eye.expand(A.shape), plan["blk_ix"],
                             plan["blk_mask"], plan["if_ix"])


def _l_stamp(A_pad: torch.Tensor, l_idx: torch.Tensor, c: float,
             l_vals: torch.Tensor,
             minv: torch.Tensor | None = None) -> torch.Tensor:
    """Inductor companion admittance: c/L per element, or the matrix
    companion c * M^{-1} when mutual couplings are present."""
    if minv is None:
        return stamp_admittance(A_pad, l_idx, c / l_vals)
    return stamp_mutual(A_pad, l_idx, c * minv)


def _l_mv(c: float, l_vals: torch.Tensor, minv: torch.Tensor | None,
          v: torch.Tensor) -> torch.Tensor:
    """(c/L) * v per element, or c * M^{-1} @ v with mutual couplings."""
    if minv is None:
        return (c / l_vals) * v
    return c * (minv * v[..., None, :]).sum(dim=-1)


def tline_hist_len(td: np.ndarray, dt: float) -> int:
    """Circular-buffer length covering the longest line delay (+2 slots
    for the interpolation pair and the in-flight write), from the host
    values of every line's (and every variant's) Td; 0 without lines."""
    td = np.asarray(td, np.float64)
    if td.size == 0:
        return 0
    return int(np.ceil(max(float(td.max()) / max(dt, EPS), 1.0))) + 2


def _tline_read(w_hist: torch.Tensor, cnt: int,
                td_steps: torch.Tensor) -> torch.Tensor:
    """The delayed far-end Thevenin sources (..., nT, 2) = (E1, E2) at the
    step about to be solved, by linear interpolation on the circular
    buffer ``w_hist`` (..., H, nT, 2), zeros before the wave arrives.
    ``td_steps``: each line's delay in steps, (nT,) or batch-swept
    (..., nT)."""
    hist_len = w_hist.shape[-3]
    p = float(cnt) - td_steps
    k = torch.floor(p)
    frac = (p - k)[..., None]
    ki = k.to(torch.int64)
    lead = w_hist.shape[:-3]
    n_t = w_hist.shape[-2]

    def gather(kk: torch.Tensor) -> torch.Tensor:
        idx = kk.expand(lead + (n_t,))[..., None, :, None].expand(
            lead + (1, n_t, 2))
        return torch.gather(w_hist, -3, idx)[..., 0, :, :]

    w_k = torch.where((ki >= 0)[..., None], gather(ki % hist_len), 0.0)
    w_k1 = torch.where((ki >= -1)[..., None], gather((ki + 1) % hist_len),
                       0.0)
    w = w_k * (1.0 - frac) + w_k1 * frac
    # E1 mirrors the far end's w2, E2 the near end's w1
    return torch.stack([w[..., 1], w[..., 0]], dim=-1)


def _tline_write(tl: dict, w_hist: torch.Tensor, cnt: int,
                 x_pad: torch.Tensor) -> None:
    """Record the accepted step's port waves w = v + Z0 i in place."""
    t_idx = tl["t_idx"]
    w1 = (x_pad[..., t_idx[:, 0]] - x_pad[..., t_idx[:, 1]]
          + tl["z0"] * x_pad[..., t_idx[:, 4]])
    w2 = (x_pad[..., t_idx[:, 2]] - x_pad[..., t_idx[:, 3]]
          + tl["z0"] * x_pad[..., t_idx[:, 5]])
    w_hist[..., cnt % w_hist.shape[-3], :, :] = torch.stack([w1, w2],
                                                            dim=-1)


def _bsource_sets(bsrc: tuple) -> list[dict]:
    """The index patterns of ``ir.circuit.bsrc_static``'s entries as host
    arrays: the reference pairs (a_j, b_j), an I-kind source's VCCS rows
    [i1, i2, a_j, b_j] and current pair, a V-kind source's +1 / -1 branch
    pattern and the (row, column) pairs of its gradient couplings."""
    def idx(rows: object, width: int) -> np.ndarray:
        return np.asarray(rows, np.int64).reshape(-1, width)

    out = []
    for kind, _fn, i1, i2, br, refs in bsrc:
        src = {"pairs": idx(refs, 2)}
        if kind == "i":
            src["vccs"] = idx([[i1, i2, a, b] for a, b in refs], 4)
            src["pair"] = idx([[i1, i2]], 2)
        else:
            src["plus"] = idx([[i1, br], [br, i1]], 2)
            src["minus"] = idx([[i2, br], [br, i2]], 2)
            src["br"] = idx([br], 1)[:, 0]
            src["grad_a"] = idx([[br, a] for a, _ in refs], 2)
            src["grad_b"] = idx([[br, b] for _, b in refs], 2)
        out.append(src)
    return out


def prepare_bsources(bsrc: tuple, device: torch.device) -> list[dict]:
    """``ir.circuit.bsrc_static``'s entries with their index patterns
    (``_bsource_sets``) as tensors on ``device``, built once per run, and
    each source's kind and compiled expression, the reference gathers
    (ra, rb) the pairs' columns."""
    out = []
    for entry, sets in zip(bsrc, _bsource_sets(bsrc)):
        src = {k: torch.as_tensor(v, device=device) for k, v in sets.items()}
        src.update(kind=entry[0], fn=entry[1], ra=src["pairs"][:, 0],
                   rb=src["pairs"][:, 1])
        out.append(src)
    return out


def _bsrc_layout(bsrc: list[dict]) -> list[tuple]:
    """The B sources' stamps (``_stamp_bsources``), source k's index sets
    and values under "b<k>.": an I-kind source's VCCS rows and current
    injection, a V-kind source's branch row (+1 / -1 couplings, the
    gradient couplings, the constant term in the RHS)."""
    out = []
    for k, src in enumerate(bsrc):
        p = f"b{k}."
        if src["kind"] == "i":
            out += [("vccs", p + "vccs", p + "g", 1),
                    ("cur", p + "pair", p + "lin", 1)]
        else:
            out += [("pattern", p + "plus", None, 1),
                    ("pattern", p + "minus", None, -1),
                    ("pattern", p + "grad_a", p + "g", -1),
                    ("pattern", p + "grad_b", p + "g", 1),
                    ("vec", p + "br", p + "lin", 1)]
    return out


def _bsrc_index(bsrc: list[dict]) -> dict:
    """The B sources' index sets by ``_bsrc_layout``'s keys."""
    return {f"b{k}.{name}": v for k, src in enumerate(bsrc)
            for name, v in src.items()
            if name not in ("kind", "fn", "ra", "rb")}


def _bsrc_values(bsrc: list[dict], x_pad: torch.Tensor, t: float) -> dict:
    """Behavioral-source Newton companions (spicey_tpu/analysis/tran.py:
    242-280). Each source linearizes as f(vals) ~ f0 + sum_j g_j (vals_j -
    vals0_j) with vals_j = x[a_j] - x[b_j], the partials by forward-mode
    AD (``bexpr_partials``): "b<k>.g" the partials (..., nRef), "b<k>.lin"
    the constant term f0 - sum_j g_j vals_j (..., 1)."""
    out = {}
    for k, src in enumerate(bsrc):
        vals = x_pad[..., src["ra"]] - x_pad[..., src["rb"]]  # (..., nRef)
        f0, gs = bexpr_partials(src["fn"], vals, t)
        lin = f0
        for j, g in enumerate(gs):
            lin = lin - g * vals[..., j]
        out[f"b{k}.g"] = (torch.stack(gs, dim=-1) if gs
                          else vals.new_zeros(vals.shape[:-1] + (0,)))
        out[f"b{k}.lin"] = lin[..., None]
    return out


def _stamp_bsources(A: torch.Tensor, b: torch.Tensor, bsrc: list[dict],
                    x_pad: torch.Tensor, t: float) -> None:
    """The B sources' companions (``_bsrc_values``) through ops/stamps.py
    into the padded (A, b): an I-kind source stamps per-reference VCCS rows
    plus a current injection, a V-kind source its branch row v(n+) - v(n-)
    - f = 0 with the gradient couplings."""
    apply_stamps(A, b, _bsrc_layout(bsrc), _bsrc_index(bsrc),
                 _bsrc_values(bsrc, x_pad, t))


def _zeros(lead: tuple, n: int, dtype: torch.dtype,
           device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.zeros(lead + (n, n), dtype=dtype, device=device),
            torch.zeros(lead + (n,), dtype=dtype, device=device))


def _c_conductance(c_vals: torch.Tensor, dt_c: float, integration: str,
                   first: bool, second: bool) -> torch.Tensor:
    """Companion conductance of the capacitors: C/dt (backward Euler,
    simulateTRAN.ts:41-53), 2C/dt (trap) or 1.5C/dt (gear2). The first
    step of a fresh run is backward Euler (trap is not self-starting), and
    gear2's second too (it needs two history points)."""
    if integration == "trap" and not first:
        return 2.0 * c_vals / dt_c
    if integration == "gear2" and not (first or second):
        return 1.5 * c_vals / dt_c
    return c_vals / dt_c


def _l_factor(dt_c: float, integration: str, first: bool,
              second: bool) -> float:
    """c of the inductors' companion conductance c/L: dt (backward
    Euler), dt/2 (trap) or dt/1.5 (gear2), with the same startup steps."""
    if integration == "trap" and not first:
        return dt_c / 2.0
    if integration == "gear2" and not (first or second):
        return dt_c / 1.5
    return dt_c


def _companion_currents(arr: dict, dt_c: float, integration: str,
                        first: bool, second: bool, carry: list,
                        g_c: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The stamp_current values of the C and L companions:
      trap   C: -(G v_n + i_n)             L: i_n + (c/L) v_n
      gear2  C: -(C/dt)(2 v_n - 0.5 v_n-1)  L: (2 i_n - 0.5 i_n-1) / 1.5
      BE     C: -G v_n                      L: i_n
    (c/L becomes c M^{-1} with mutual couplings, ``arr["minv"]``). ``g_c``:
    ``_c_conductance``'s G when the caller has it."""
    (v_prev_c, i_prev_c, i_prev_l, v_prev_l, _vd, _vm, _vq, _sw,
     v_prev2_c, i_prev2_l) = carry[:10]
    c_vals, l_vals = arr["c_vals"], arr["l_vals"]
    if g_c is None:
        g_c = _c_conductance(c_vals, dt_c, integration, first, second)
    c_l = _l_factor(dt_c, integration, first, second)
    startup = first or second
    if integration == "trap":
        return (-(g_c * v_prev_c + i_prev_c),
                i_prev_l + _l_mv(c_l, l_vals, arr.get("minv"), v_prev_l))
    if integration == "gear2" and not startup:
        return (-(c_vals / dt_c) * (2.0 * v_prev_c - 0.5 * v_prev2_c),
                (2.0 * i_prev_l - 0.5 * i_prev2_l) / 1.5)
    return -g_c * v_prev_c, i_prev_l


def _charge_slots(arr: dict) -> tuple[int | None, int | None]:
    """Carry positions of the committed diode and BJT junction charges
    (after the ten fixed entries, each present only with its charge)."""
    pos_d = 10 if arr.get("dchg") is not None else None
    pos_q = (10 + (pos_d is not None) if arr.get("qchg") is not None
             else None)
    return pos_d, pos_q


def _nl_index_sets(nl: dict) -> dict:
    """The terminal pairs the MOSFET/BJT stamps scatter through, gathered
    once per run: (d, s) and the gm pattern (d, s, g, s); (b, e), (b, c),
    (c, e) and the transport patterns (c, e, b, e) and (c, e, b, c)."""
    m, q = nl["m_idx"], nl["q_idx"]
    return {"m_ds": m[:, [0, 2]], "m_gm": m[:, [0, 2, 1, 2]],
            "q_be": q[:, [1, 2]], "q_bc": q[:, [1, 0]], "q_ce": q[:, [0, 2]],
            "q_gmf": q[:, [0, 2, 1, 2]], "q_gmr": q[:, [0, 2, 1, 0]]}


def _nl_layout(n_m: int, n_q: int) -> list[tuple]:
    """The MOSFET/BJT companions' stamps (``_nl_values``), each present
    only with its devices."""
    out = []
    if n_m:
        out += [("adm", "m_ds", "gds", 1), ("vccs", "m_gm", "gm", 1),
                ("cur", "m_ds", "i_eq", 1)]
    if n_q:
        out += [("adm", "q_be", "gbe", 1), ("adm", "q_bc", "gbc", 1),
                ("vccs", "q_gmf", "gmf", 1), ("vccs", "q_gmr", "gmr", -1),
                ("cur", "q_be", "ibe_eq", 1), ("cur", "q_bc", "ibc_eq", 1),
                ("cur", "q_ce", "ict_eq", 1)]
    return out


def _nl_values(nl: dict, x_pad: torch.Tensor, it: int,
               vm_prev: torch.Tensor | None, vq_prev: torch.Tensor | None,
               vq_lim: torch.Tensor | None = None) -> dict:
    """MOSFET/BJT Newton companions (spicey_tpu/analysis/tran.py:152-198).
    Seeds follow the diode convention: the previous step's junction
    voltages on pass 0, the current iterate after (the operating point
    passes ``it=1``). ``vq_lim``: (..., nQ, 2) reflected-frame
    pnjlim-limited (vbe, vbc) from the operating-point Newton (op.py), in
    place of the absolute clamp."""
    m_idx, q_idx = nl["m_idx"], nl["q_idx"]
    out = {}
    if m_idx.shape[0]:
        if it == 0:
            vgs, vds = vm_prev[..., 0], vm_prev[..., 1]
        else:
            vgs = x_pad[..., m_idx[:, 1]] - x_pad[..., m_idx[:, 2]]
            vds = x_pad[..., m_idx[:, 0]] - x_pad[..., m_idx[:, 2]]
        out["gm"], out["gds"], out["i_eq"], _ = mos_level1(
            vgs, vds, nl["m_beta"], nl["m_vto"], nl["m_lambda"], nl["m_pol"])
    if q_idx.shape[0]:
        if it == 0:
            vbe, vbc = vq_prev[..., 0], vq_prev[..., 1]
        else:
            vbe = x_pad[..., q_idx[:, 1]] - x_pad[..., q_idx[:, 2]]
            vbc = x_pad[..., q_idx[:, 1]] - x_pad[..., q_idx[:, 0]]
        (out["gbe"], out["gbc"], out["gmf"], out["gmr"], out["ibe_eq"],
         out["ibc_eq"], out["ict_eq"], _, _) = bjt_ebers_moll(
            vbe, vbc, nl["q_is"], nl["q_bf"], nl["q_br"], nl["q_pol"],
            vt=nl["vt"],
            vbe_lim=None if vq_lim is None else vq_lim[..., 0],
            vbc_lim=None if vq_lim is None else vq_lim[..., 1])
    return out


def _stamp_nonlinear(A: torch.Tensor, b: torch.Tensor, nl: dict, sets: dict,
                     x_pad: torch.Tensor, it: int,
                     vm_prev: torch.Tensor | None,
                     vq_prev: torch.Tensor | None,
                     vq_lim: torch.Tensor | None = None) -> None:
    """The MOSFET/BJT companions (``_nl_values``) through ops/stamps.py
    into the padded (A, b), scattered through ``sets``
    (``_nl_index_sets``)."""
    apply_stamps(A, b, _nl_layout(nl["m_idx"].shape[0], nl["q_idx"].shape[0]),
                 sets, _nl_values(nl, x_pad, it, vm_prev, vq_prev, vq_lim))


def _bjt_junction_charge(x_pad: torch.Tensor, nl: dict, qchg: dict
                         ) -> tuple[torch.Tensor, ...]:
    """Junction charges and capacitances (q_be, c_be, q_bc, c_bc, cv_be,
    cv_bc) at the current iterate (spicey_tpu/analysis/tran.py:201-239).
    Each junction is the diode charge model in the reflected frame: b-e
    with (TF, CJE, VJE, MJE), b-c with (TR, CJC, VJC, MJC). Diffusion at
    the clamped voltage, depletion at the true one; ``cv`` is the split
    Newton anchor, so the b-stamp is (q - q_prev - cv)/dt beside the
    A-stamp c/dt."""
    q_idx = nl["q_idx"]
    s = nl["q_pol"]
    vt = nl["vt"]
    tscale = vt / VT_300K
    u_be = s * (x_pad[..., q_idx[:, 1]] - x_pad[..., q_idx[:, 2]])
    u_bc = s * (x_pad[..., q_idx[:, 1]] - x_pad[..., q_idx[:, 0]])
    lo, hi = DIODE_VD_MIN * tscale, DIODE_VD_MAX * tscale
    i_s = nl["q_is"]

    def one(u: torch.Tensor, tt: torch.Tensor, cjo: torch.Tensor,
            vj: torch.Tensor, m: torch.Tensor) -> tuple:
        u_lim = torch.clamp(u, lo, hi)
        ev = torch.exp(u_lim / vt)
        g_diff = (i_s / vt * ev).clamp_min(GMIN)
        q_r, c = diode_charge_cap(u, i_s * (ev - 1.0), g_diff, tt, cjo, vj,
                                  m, qchg["fc"])
        cv = tt * g_diff * (s * u_lim) + (c - tt * g_diff) * (s * u)
        return s * q_r, c, cv

    q_be, c_be, cv_be = one(u_be, qchg["tf"], qchg["cje"], qchg["vje"],
                            qchg["mje"])
    q_bc, c_bc, cv_bc = one(u_bc, qchg["tr"], qchg["cjc"], qchg["vjc"],
                            qchg["mjc"])
    return q_be, c_be, q_bc, c_bc, cv_be, cv_bc


def _diode_charge(vd: torch.Tensor, arr: dict,
                  vt_scale: torch.Tensor | float) -> torch.Tensor:
    """The diode charge committed at an accepted solution: diffusion at
    the clamped voltage (consistent with the stamping), depletion at the
    true one (spicey_tpu/analysis/tran.py:773-788)."""
    dchg = arr["dchg"]
    vd_c = torch.clamp(vd, DIODE_VD_MIN * vt_scale, DIODE_VD_MAX * vt_scale)
    v_th = arr["d_n"] * VT_300K
    ev_c = torch.exp(vd_c / v_th)
    q, _ = diode_charge_cap(vd, arr["d_is"] * (ev_c - 1.0),
                            ((arr["d_is"] / v_th) * ev_c).clamp_min(GMIN),
                            dchg["tt"], dchg["cjo"], dchg["vj"], dchg["m"],
                            dchg["fc"])
    return q


def _stamp_layout(arr: dict) -> list[tuple]:
    """One Newton pass's stamps in assembly order (ops/stamp_real.py's
    layouts), each value named as ``_pass_values`` names it: R, C and its
    companion current, L (c/L, or the matrix companion c * M^{-1} with
    couplings, ``arr["minv"]``) and its companion current, switches, V
    sources, extended I sources, the T lines' ports and far-end sources,
    the extended G/E/F/H sources, the diodes and their charge companions,
    the MOSFET/BJT companions and the BJT charge, the B sources."""
    out = [("adm", "r", "g_r", 1), ("adm", "c", "g_c", 1),
           ("cur", "c", "ieq_c", 1),
           ("mutual" if arr.get("minv") is not None else "adm", "l", "g_l",
            1),
           ("cur", "l", "isrc_l", 1), ("adm", "s", "g_s", 1),
           ("vsrc", "v", "vs", 1), ("cur", "i", "i_src", 1)]
    if arr.get("tl") is not None:
        out += [("tline", "t", "z0", 1), ("vec", "t_br1", "e_1", 1),
                ("vec", "t_br2", "e_2", 1)]
    out += [("vccs", "g", "g_gm", 1), ("vcvs", "e", "e_gain", 1),
            ("cccs", "f", "f_gain", 1), ("ccvs", "h", "h_r", 1),
            ("adm", "d", "g_d", 1), ("cur", "d", "i_deq", 1)]
    if arr.get("dchg") is not None:
        out += [("adm", "d", "c_d", 1), ("cur", "d", "i_qd", 1)]
    nl = arr.get("nl")
    if nl is not None and (nl["m_idx"].shape[0] or nl["q_idx"].shape[0]):
        out += _nl_layout(nl["m_idx"].shape[0], nl["q_idx"].shape[0])
        if arr.get("qchg") is not None:
            out += [("adm", "q_be", "c_qbe", 1), ("cur", "q_be", "i_qbe", 1),
                    ("adm", "q_bc", "c_qbc", 1), ("cur", "q_bc", "i_qbc", 1)]
    return out + _bsrc_layout(arr.get("bsrc_t") or [])


def _stamp_index(idx: dict, bsets: list[dict]) -> dict:
    """The index sets the layout scatters through, from the deck's index
    arrays under ``tran_arrays``' names (``idx``: tensors, or their host
    arrays) and the B sources' sets (``bsets``)."""
    out = {"r": idx["r_idx"], "c": idx["c_idx"], "l": idx["l_idx"],
           "s": idx["s_idx"][:, :2], "v": idx["v_idx"], "i": idx["i_idx"],
           "g": idx["g_idx"], "e": idx["e_idx"], "f": idx["f_idx"],
           "h": idx["h_idx"], "d": idx["d_idx"]}
    t_idx = idx.get("t_idx")
    if t_idx is not None:
        out.update(t=t_idx, t_br1=t_idx[:, 4], t_br2=t_idx[:, 5])
    out.update(_nl_index_sets(idx))
    out.update(_bsrc_index(bsets))
    return out


@dataclass
class _Stamps:
    """A run's assembly, set up once: the layout, its index tensors (the
    CPU path's scatters) and, on the card, K11's plan."""

    layout: list
    index: dict
    plan: StampPlan | None


def stamp_plan(arr: dict, nvar: int) -> StampPlan:
    """K11's plan of ``arr``'s deck, from the host index arrays that
    ``tran_arrays`` keeps (``arr["index_host"]``): no read back from the
    card. ``arr`` as ``_tran_core`` prepares it (B sources under
    "bsrc_t", the couplings' M^{-1} under "minv")."""
    bsets = _bsource_sets(arr["bsrc"]) if arr.get("bsrc_t") else []
    return build_plan(_stamp_layout(arr),
                      _stamp_index(arr["index_host"], bsets), nvar)


def _stamp_setup(arr: dict, nvar: int) -> _Stamps:
    """``arr``'s assembly (prepared as for ``stamp_plan``), once a run."""
    nl = arr["nl"]
    dev = arr["r_idx"].device
    idx = dict(arr, **arr["ext"], m_idx=nl["m_idx"], q_idx=nl["q_idx"],
               t_idx=None if arr.get("tl") is None else arr["tl"]["t_idx"])
    return _Stamps(_stamp_layout(arr),
                   _stamp_index(idx, arr.get("bsrc_t") or []),
                   stamp_plan(arr, nvar) if dev.type == "cuda" else None)


def _pass_values(arr: dict, nvar: int, dt: float, vs_t: torch.Tensor,
                 x: torch.Tensor, it: int, carry: list, sw_on: torch.Tensor,
                 integration: str, first: bool, second: bool,
                 vt_scale: torch.Tensor | float, e_t: torch.Tensor | None,
                 t: float) -> dict:
    """The values of one Newton pass's stamps, by ``_stamp_layout``'s
    names (simulateTRAN.ts:25-106 and the extended devices). The values
    that do not change within a run (1/R, the C and L companion
    conductances of each integration phase, the diode's thermal voltage,
    clamp window and Is/Vt) are kept in ``arr["memo"]`` when the run gives
    one (``_tran_core``: one dt a run), so a pass computes them once."""
    memo = arr.get("memo")

    def once(key: tuple, make: Callable[[], torch.Tensor]) -> torch.Tensor:
        if memo is None:
            return make()
        if key not in memo:
            memo[key] = make()
        return memo[key]

    dt_c = max(dt, EPS)
    phase = (integration, first, second)
    g_c = once(("g_c",) + phase, lambda: _c_conductance(
        arr["c_vals"], dt_c, integration, first, second))
    ieq_c, isrc_l = _companion_currents(arr, dt_c, integration, first,
                                        second, carry, g_c)
    c_l = _l_factor(dt_c, integration, first, second)
    minv = arr.get("minv")
    # switches by their hysteresis state
    r_sw = torch.where(sw_on, arr["s_ron"], arr["s_roff"])
    n_v = arr["v_idx"].shape[0]
    ext = arr["ext"]
    out = {"g_r": once(("g_r",), lambda: 1.0 / arr["r_vals"]),
           "g_c": g_c, "ieq_c": ieq_c,
           "g_l": once(("g_l",) + phase, lambda: (
               c_l / arr["l_vals"] if minv is None else c_l * minv)),
           "isrc_l": isrc_l,
           "g_s": 1.0 / torch.clamp(r_sw.abs(), min=EPS),
           "vs": vs_t[..., :n_v],
           # extended-dialect current sources: direct RHS injection
           "i_src": vs_t[..., n_v:],
           "g_gm": ext["g_gm"], "e_gain": ext["e_gain"],
           "f_gain": ext["f_gain"], "h_r": ext["h_r"]}
    tl = arr.get("tl")
    if tl is not None:
        # T lines: near-end topology + the delayed far-end Thevenin
        # sources from the history buffer (Branin)
        out.update(z0=tl["z0"], e_1=e_t[..., 0], e_2=e_t[..., 1])
    # diode Shockley companions; the clamp window scales with T/300
    vd = carry[4] if it == 0 else _vdrop(pad_solution(x, nvar),
                                         arr["d_idx"])
    vd_lim = torch.clamp(vd, once(("vd_lo",), lambda: DIODE_VD_MIN
                                  * vt_scale),
                         once(("vd_hi",), lambda: DIODE_VD_MAX * vt_scale))
    v_th = once(("v_th",), lambda: arr["d_n"] * VT_300K)
    exp_val = torch.exp(vd_lim / v_th)
    i_d = arr["d_is"] * (exp_val - 1.0)
    g_d = torch.clamp(once(("is_vt",), lambda: arr["d_is"] / v_th)
                      * exp_val, min=GMIN)
    out.update(g_d=g_d, i_deq=i_d - g_d * vd_lim)
    pos_d, pos_q = _charge_slots(arr)
    if pos_d is not None:
        # charge companion (BE): i = (q(v) - q_prev)/dt with the split
        # anchor, diffusion linearized at vd_lim, depletion at the true vd
        dchg = arr["dchg"]
        q_d, c_d = diode_charge_cap(vd, i_d, g_d, dchg["tt"], dchg["cjo"],
                                    dchg["vj"], dchg["m"], dchg["fc"])
        c_dep = c_d - dchg["tt"] * g_d
        out.update(c_d=c_d / dt_c,
                   i_qd=(q_d - carry[pos_d] - dchg["tt"] * g_d * vd_lim
                         - c_dep * vd) / dt_c)
    nl = arr.get("nl")
    if nl is not None and (nl["m_idx"].shape[0] or nl["q_idx"].shape[0]):
        x_pad = pad_solution(x, nvar)
        out.update(_nl_values(nl, x_pad, it, carry[5], carry[6]))
        if pos_q is not None:
            # BJT junction-charge companions (BE), at the current iterate
            q_be, c_be, q_bc, c_bc, cv_be, cv_bc = _bjt_junction_charge(
                x_pad, nl, arr["qchg"])
            q_prev = carry[pos_q]
            out.update(c_qbe=c_be / dt_c,
                       i_qbe=(q_be - q_prev[..., 0] - cv_be) / dt_c,
                       c_qbc=c_bc / dt_c,
                       i_qbc=(q_bc - q_prev[..., 1] - cv_bc) / dt_c)
    if arr.get("bsrc_t"):
        out.update(_bsrc_values(arr["bsrc_t"], pad_solution(x, nvar), t))
    return out


def _stamp_system(arr: dict, nvar: int, dt: float, vs_t: torch.Tensor,
                  x: torch.Tensor, it: int, carry: list, sw_on: torch.Tensor,
                  integration: str = "be", first: bool = False,
                  second: bool = False, vt_scale: torch.Tensor | float = 1.0,
                  e_t: torch.Tensor | None = None, t: float = 0.0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Assemble one Newton pass's (A, b), (..., nvar, nvar) and (...,
    nvar). ``arr`` carries the MOSFET/BJT arrays under "nl", the junction
    charges under "dchg"/"qchg", the coupled inductors' M^{-1} under
    "minv", the T lines under "tl" (with their far-end sources ``e_t``
    (..., nT, 2) at this step) and the prepared B sources under "bsrc_t",
    evaluated at time ``t`` (each None or empty when absent), and the
    run's assembly under "stamps" (``_stamp_setup``; set up here when
    absent). The values are ``_pass_values``; on a CUDA tensor K11 writes
    the system once from the plan (ops/stamp_real.py), on the CPU the
    layout runs through ops/stamps.py's scatters into a padded system whose
    ground row and column are sliced off."""
    stamps = arr.get("stamps") or _stamp_setup(arr, nvar)
    vals = _pass_values(arr, nvar, dt, vs_t, x, it, carry, sw_on,
                        integration, first, second, vt_scale, e_t, t)
    lead = x.shape[:-1]
    if x.is_cuda:
        return assemble(stamps.plan, vals, lead, x.dtype, x.device)
    A, b = _zeros(lead, nvar + 1, x.dtype, x.device)
    apply_stamps(A, b, stamps.layout, stamps.index, vals)
    return A[..., :nvar, :nvar], b[..., :nvar]


def linear_system_matrix(nvar: int, lead: tuple, dtype: torch.dtype,
                         arr: dict, g_c: torch.Tensor, c_l: float
                         ) -> torch.Tensor:
    """The (sliced) time-invariant matrix of a linear circuit: R +
    C companion (g_c) + L companion (c_l/L, or c_l M^{-1} with couplings,
    ``arr["minv"]``) + V-source rows + extended controlled sources (+ the
    T lines' port rows, ``arr["tl"]``: a line is linear, its Z0 rows
    time-invariant)."""
    dev = arr["r_vals"].device
    A, b_dummy = _zeros(lead, nvar + 1, dtype, dev)
    stamp_admittance(A, arr["r_idx"], 1.0 / arr["r_vals"])
    stamp_admittance(A, arr["c_idx"], g_c)
    _l_stamp(A, arr["l_idx"], c_l, arr["l_vals"], arr.get("minv"))
    stamp_voltage_source(A, b_dummy, arr["v_idx"],
                         torch.zeros(arr["v_idx"].shape[:1], dtype=dtype,
                                     device=dev))
    stamp_extended(A, arr["ext"])
    tl = arr.get("tl")
    if tl is not None:
        stamp_tline_ports(A, tl["t_idx"], tl["z0"])
    return A[..., :nvar, :nvar]


def _switch_update(s_idx: torch.Tensor, s_von: torch.Tensor,
                   s_voff: torch.Tensor, sw_on: torch.Tensor,
                   x_pad: torch.Tensor) -> torch.Tensor:
    """Hysteresis state transition (simulateTRAN.ts:108-128)."""
    vctrl = x_pad[..., s_idx[:, 2]] - x_pad[..., s_idx[:, 3]]
    return torch.where(sw_on, ~(vctrl < s_voff), vctrl > s_von)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matvec as multiply + reduce: at (1M, 3, 3) a batched
    ``matmul`` became 48 cuBLAS gemv launches per product on the card
    (534 ms of a 593 ms run, tools/profile_torch_tran.py)."""
    return (M * v[..., None, :]).sum(dim=-1)


def _init_carry(lead: tuple, n: dict, dtype: torch.dtype,
                device: torch.device, d_chg: bool = False,
                q_chg: bool = False) -> list:
    """A fresh run's carry: every companion state at rest, the committed
    junction charges (q(0) = 0) appended when the deck stores them (the
    T-line history is appended by ``_tran_core``)."""
    def z(*shape: int) -> torch.Tensor:
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    carry = [z(n["c"]), z(n["c"]), z(n["l"]), z(n["l"]), z(n["d"]),
             z(n["m"], 2), z(n["q"], 2),
             torch.zeros(lead + (n["s"],), dtype=torch.bool, device=device),
             z(n["c"]), z(n["l"])]
    if d_chg:
        carry.append(z(n["d"]))
    if q_chg:
        carry.append(z(n["q"], 2))
    return carry


def _tran_core(vs_grid: torch.Tensor, dt: float, arr: dict, nvar: int,
               method: str = "gj", integration: str = "be",
               nr: str = "spicey", nr_tol: float = 1e-9,
               max_nr: int | None = None, lead: tuple = (),
               record: int | None = None, init_state: tuple | None = None,
               resume: bool = False, nr_floor: torch.Tensor | None = None,
               vt_scale: torch.Tensor | float = 1.0,
               times: np.ndarray | None = None, plan: dict | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, list]:
    """The time loop; returns (xs, sw_states, valid, final carry).

    ``arr`` holds the index tensors (int64) and value tensors: values
    lead with the variants axis when ``lead=(B,)`` (r/c/l (B, nE), ext
    values (B, nX), the couplings' k (B, nK), the lines' Z0/Td (B, nT))
    or are unbatched. ``vs_grid`` is (S+1, nSrc) or (S+1, B, nSrc).
    ``record=i`` stacks only unknown i per step, (S+1, [B]) instead of
    (S+1, [B], nvar). ``init_state`` with ``resume=True`` continues a
    checkpoint: no step is re-marked as the t = 0 bootstrap. ``times``:
    each step's absolute time, which behavioral sources read (k * dt in
    the working precision by default). ``plan``: a ``SchurPlan.arrays()``
    routing every solve, and the factor-once A^-1, through the structured
    tier."""
    dtype, dev = vs_grid.dtype, vs_grid.device
    nl = arr["nl"]
    n = {"c": arr["c_idx"].shape[0], "l": arr["l_idx"].shape[0],
         "s": arr["s_idx"].shape[0], "d": arr["d_idx"].shape[0],
         "m": nl["m_idx"].shape[0], "q": nl["q_idx"].shape[0]}
    bsrc = arr.get("bsrc", ())
    arr = dict(arr, bsrc_t=prepare_bsources(bsrc, dev))
    pos_d, pos_q = _charge_slots(arr)
    n_chg = (pos_d is not None) + (pos_q is not None)
    if max_nr is None:
        max_nr = MAX_NR_ITERS if nr == "spicey" else 50
    linear = (n["s"] == 0 and n["d"] == 0 and n["m"] == 0 and n["q"] == 0
              and not bsrc and nr == "spicey")
    dt_c = max(dt, EPS)
    n_v = arr["v_idx"].shape[0]
    ext = arr["ext"]

    valid_all = torch.ones(lead, dtype=torch.bool, device=dev)
    # K-coupled inductors: M^{-1} is fixed for the whole run (L and k do
    # not change mid-run), so it is inverted once here; a singular M
    # flags the lane
    minv = None
    if arr.get("lk") is not None:
        minv, minv_ok = _mutual_inv(arr["l_vals"], arr["lk"])
        arr["minv"] = minv
        valid_all = valid_all & minv_ok.expand(lead)
    tl = arr.get("tl")
    if tl is not None:
        # each line's delay in steps, clamped >= 1 (a line shorter than
        # the step cannot be causal on a fixed grid); Td may be (nT,) or
        # batch-swept (B, nT)
        td_steps = torch.clamp(tl["td"] / dt_c, min=1.0)
    if not linear:
        # the assembly of every pass, set up once: on the card K11's plan,
        # copied to the card here and never inside the loop; the values
        # that stay the same all run long, computed at their first pass
        arr["stamps"] = _stamp_setup(arr, nvar)
        arr["memo"] = {}
    if linear:
        # the matrix is time-invariant (per integration phase): factor
        # ONCE, then each step is a multiply by the inverse plus one
        # refinement pass, not a fresh elimination
        def assemble(first: bool, second: bool) -> torch.Tensor:
            return linear_system_matrix(
                nvar, lead, dtype, arr,
                _c_conductance(arr["c_vals"], dt_c, integration, first,
                               second),
                _l_factor(dt_c, integration, first, second))

        A_main = assemble(False, False)
        Ainv_main, factor_ok = _factor(A_main, plan)
        if integration in ("trap", "gear2"):
            A_start = assemble(True, False)
            Ainv_start, ok_start = _factor(A_start, plan)
            factor_ok = factor_ok & ok_start
        else:
            A_start, Ainv_start = A_main, Ainv_main

    if init_state is None:
        carry = _init_carry(lead, n, dtype, dev, pos_d is not None,
                            pos_q is not None)
        if tl is not None:
            w_hist = torch.zeros(lead + (arr["hist_len"], tl["t_idx"].shape[0],
                                         2), dtype=dtype, device=dev)
        t_cnt = 0
    else:
        carry = [torch.tensor(np.asarray(a), device=dev)
                 for a in init_state[:10 + n_chg]]
        if tl is not None:
            w_hist = torch.tensor(np.asarray(init_state[10 + n_chg]),
                                  dtype=dtype, device=dev)
            t_cnt = int(init_state[11 + n_chg])
    carry = [a if a.dtype == torch.bool else a.to(dtype) for a in carry]
    n_steps = vs_grid.shape[0]
    if times is None:
        np_dt = np.float32 if dtype == torch.float32 else np.float64
        times = np.arange(n_steps, dtype=np_dt) * np_dt(dt)
    xs = torch.empty((n_steps,) + lead + (() if record is not None
                                          else (nvar,)),
                     dtype=dtype, device=dev)
    sw_states = torch.empty((n_steps,) + lead + (n["s"],), dtype=torch.bool,
                            device=dev)
    tol_eff = max(float(nr_tol), 16.0 * float(torch.finfo(dtype).eps))
    # Newton passes (one solve and one host sync each), counted here and
    # handed to the counters once per call
    passes = 0
    for s in range(n_steps):
        vs_t = vs_grid[s]
        first = s == 0 and not resume
        second = s == 1 and not resume
        (v_prev_c, i_prev_c, i_prev_l, v_prev_l, vd_prev_d, vm_prev,
         vq_prev, sw_on, v_prev2_c, i_prev2_l) = carry[:10]
        charges = carry[10:]
        e_t = (_tline_read(w_hist, t_cnt, td_steps) if tl is not None
               else None)
        if linear:
            b = torch.zeros(lead + (nvar + 1,), dtype=dtype, device=dev)
            ieq_c, isrc_l = _companion_currents(arr, dt_c, integration,
                                                first, second, carry)
            stamp_current(b, arr["c_idx"], ieq_c)
            stamp_current(b, arr["l_idx"], isrc_l)
            b.index_add_(-1, arr["v_idx"][:, 2],
                         vs_t[..., :n_v].expand(lead + (n_v,)))
            stamp_current(b, ext["i_idx"], vs_t[..., n_v:])
            if tl is not None:
                b.index_add_(-1, tl["t_idx"][:, 4], e_t[..., 0])
                b.index_add_(-1, tl["t_idx"][:, 5], e_t[..., 1])
            b = b[..., :nvar]
            startup = first or (second and integration == "gear2")
            Ainv, A_t = ((Ainv_start, A_start) if startup
                         else (Ainv_main, A_main))
            x = _mv(Ainv, b)
            x = x + _mv(Ainv, b - _mv(A_t, x))
            step_ok = factor_ok
        else:
            x = torch.zeros(lead + (nvar,), dtype=dtype, device=dev)
            sw = sw_on
            done = torch.zeros(lead, dtype=torch.bool, device=dev)
            step_ok = torch.ones(lead, dtype=torch.bool, device=dev)
            for it in range(max_nr):
                A, b = _stamp_system(arr, nvar, dt, vs_t, x, it, carry, sw,
                                     integration, first, second, vt_scale,
                                     e_t=e_t, t=float(times[s]))
                x_new, solve_ok = solve(A, b, method=method, plan=plan)
                passes += 1
                new_on = _switch_update(arr["s_idx"], arr["s_von"],
                                        arr["s_voff"], sw,
                                        pad_solution(x_new, nvar))
                settled = ~torch.any(new_on != sw, dim=-1)
                if nr == "converged":
                    # floor the relative tolerance at 16 ulps of the
                    # working dtype (an unfloored f32 run never settles)
                    if nr_floor is not None:
                        # ngspice's per-unknown criterion (.options
                        # vntol/abstol)
                        conv = torch.all((x_new - x).abs()
                                         <= tol_eff * x_new.abs() + nr_floor,
                                         dim=-1)
                    elif nvar:
                        delta = (x_new - x).abs().amax(dim=-1)
                        scale = 1.0 + x_new.abs().amax(dim=-1)
                        conv = delta <= tol_eff * scale
                    else:
                        conv = torch.ones_like(settled)
                    settled = settled & conv
                # masked commit: once done, the lane is frozen
                mask = done[..., None]
                x = torch.where(mask, x, x_new)
                sw = torch.where(mask, sw, new_on)
                step_ok = step_ok & (done | solve_ok)
                done = done | settled
                if bool(done.all()):
                    break
            sw_on = sw
        x_pad = pad_solution(x, nvar)
        # state commit (simulateTRAN.ts:221-237; trap carries the companion
        # current, gear2 two-step history)
        if n["c"]:
            vd_c = _vdrop(x_pad, arr["c_idx"])
            if integration == "trap":
                c_vals = arr["c_vals"]
                i_prev_c = ((c_vals / dt_c) * (vd_c - v_prev_c) if first
                            else (2.0 * c_vals / dt_c) * (vd_c - v_prev_c)
                            - i_prev_c)
            v_prev2_c = v_prev_c
            v_prev_c = vd_c
        if n["l"]:
            vd_l = _vdrop(x_pad, arr["l_idx"])
            l_vals = arr["l_vals"]
            i_prev2_l_new = i_prev_l
            if integration == "trap":
                i_prev_l = i_prev_l + (
                    _l_mv(dt_c, l_vals, minv, vd_l) if first
                    else _l_mv(dt_c / 2.0, l_vals, minv, v_prev_l + vd_l))
                v_prev_l = vd_l
            elif integration == "gear2":
                i_prev_l = (i_prev_l + _l_mv(dt_c, l_vals, minv, vd_l)
                            if first or second
                            else _l_mv(dt_c / 1.5, l_vals, minv, vd_l)
                            + (2.0 * i_prev_l - 0.5 * i_prev2_l) / 1.5)
            else:
                i_prev_l = i_prev_l + _l_mv(dt_c, l_vals, minv, vd_l)
            i_prev2_l = i_prev2_l_new
        if n["d"]:
            vd_prev_d = _vdrop(x_pad, arr["d_idx"])
        if pos_d is not None:
            charges[0] = _diode_charge(vd_prev_d, arr, vt_scale)
        if pos_q is not None:
            q_be, _, q_bc, _, _, _ = _bjt_junction_charge(x_pad, nl,
                                                          arr["qchg"])
            charges[-1] = torch.stack([q_be, q_bc], dim=-1)
        if n["m"]:
            m_idx = nl["m_idx"]
            vm_prev = torch.stack(
                [x_pad[..., m_idx[:, 1]] - x_pad[..., m_idx[:, 2]],
                 x_pad[..., m_idx[:, 0]] - x_pad[..., m_idx[:, 2]]], dim=-1)
        if n["q"]:
            q_idx = nl["q_idx"]
            vq_prev = torch.stack(
                [x_pad[..., q_idx[:, 1]] - x_pad[..., q_idx[:, 2]],
                 x_pad[..., q_idx[:, 1]] - x_pad[..., q_idx[:, 0]]], dim=-1)
        if tl is not None:
            _tline_write(tl, w_hist, t_cnt, x_pad)
            t_cnt += 1
        valid_all = valid_all & step_ok
        carry = [v_prev_c, i_prev_c, i_prev_l, v_prev_l, vd_prev_d, vm_prev,
                 vq_prev, sw_on, v_prev2_c, i_prev2_l] + charges
        xs[s] = x if record is None else x[..., record]
        sw_states[s] = sw_on
    if tl is not None:
        carry = carry + [w_hist, torch.tensor(t_cnt, dtype=torch.int32)]
    count("tran.steps", n_steps)
    if not linear:
        count("tran.newton_passes", passes)
        count("sync.newton_done", passes)
    return xs, sw_states, valid_all, carry


# the index arrays of a deck (``CircuitTensors`` fields, ``tran_arrays``'
# keys)
_INDEX_KEYS = ("r_idx", "c_idx", "l_idx", "v_idx", "s_idx", "d_idx", "i_idx",
               "g_idx", "e_idx", "f_idx", "h_idx", "m_idx", "q_idx", "t_idx")


def tran_arrays(tensors: CircuitTensors, device: torch.device,
                dtype: torch.dtype, r_vals: torch.Tensor | None = None,
                c_vals: torch.Tensor | None = None,
                l_vals: torch.Tensor | None = None,
                ext: dict | None = None, nl: dict | None = None,
                lk: dict | None = None, tl: dict | None = None,
                ckt: ParsedCircuit | None = None,
                dt: float | None = None) -> dict:
    """The index and value tensors ``_tran_core`` reads. The r/c/l values,
    ``ext``, the MOSFET/BJT arrays ``nl``, the couplings ``lk`` and the T
    lines ``tl`` default to the netlist's (unbatched); the batch and
    Monte-Carlo analyses pass batched ones. "dchg" and "qchg" hold the
    junction charges, "lk" and "tl" the couplings and lines (each None
    when the deck has none), "bsrc" the B sources of ``ckt``
    (``ir.circuit.bsrc_static``; none without ``ckt``) and "hist_len" the
    lines' history length at step ``dt`` (read once from the Td values);
    "index_host" the host arrays of every index tensor, which K11's plan
    is built from (``stamp_plan``) without a read back from the card."""
    def idx(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def val(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    if tl is None:
        tl = tl_arrays(tensors, device, dtype)
    hist_len = 0
    if tl is not None:
        count("sync.tline_td")
        hist_len = tline_hist_len(tl["td"].cpu().numpy(), dt)
    return {
        "r_idx": idx(tensors.r_idx),
        "r_vals": val(tensors.r_vals) if r_vals is None else r_vals,
        "c_idx": idx(tensors.c_idx),
        "c_vals": val(tensors.c_vals) if c_vals is None else c_vals,
        "l_idx": idx(tensors.l_idx),
        "l_vals": val(tensors.l_vals) if l_vals is None else l_vals,
        "v_idx": idx(tensors.v_idx),
        "s_idx": idx(tensors.s_idx),
        "s_ron": val(tensors.s_ron), "s_roff": val(tensors.s_roff),
        "s_von": val(tensors.s_von), "s_voff": val(tensors.s_voff),
        "d_idx": idx(tensors.d_idx),
        "d_is": val(tensors.d_is), "d_n": val(tensors.d_n),
        "ext": ext_arrays(tensors, device, dtype) if ext is None else ext,
        "nl": nl_arrays(tensors, device, dtype) if nl is None else nl,
        "dchg": dchg_arrays(tensors, device, dtype),
        "qchg": qchg_arrays(tensors, device, dtype),
        "lk": lk_arrays(tensors, device, dtype) if lk is None else lk,
        "tl": tl,
        "bsrc": () if ckt is None else bsrc_static(ckt, tensors.nvar),
        "hist_len": hist_len,
        "index_host": {k: np.asarray(getattr(tensors, k), np.int64)
                       for k in _INDEX_KEYS},
    }


def vt_scale_of(tensors: CircuitTensors, device: torch.device,
                dtype: torch.dtype) -> torch.Tensor:
    """The junction clamp window's scale vt / VT_300K (1 at 300 K)."""
    return torch.as_tensor(tensors.vt, dtype=dtype, device=device) / VT_300K


def _element_currents(tensors: CircuitTensors, xs: np.ndarray,
                      sw_states: np.ndarray, dt: float,
                      integration: str = "be",
                      src_grid: np.ndarray | None = None,
                      state0: tuple | None = None,
                      resumed: bool | None = None) -> dict[str, np.ndarray]:
    """Per-step element currents recovered from the stacked solutions on
    the host (simulateTRAN.ts:173-219); the C/L companion recurrences
    unroll into (alternating-sign) cumulative sums.

    ``state0``: the carry the loop started from, for resumed segments and
    fresh .ic runs; ``resumed`` tells them apart (a fresh run keeps the BE
    bootstrap rows of trap/gear2, a resumed segment does not repeat
    them)."""
    xs_pad = np.concatenate([xs, np.zeros((xs.shape[0], 1))], axis=1)
    dt_c = max(dt, EPS)
    out: dict[str, np.ndarray] = {}
    has0 = state0 is not None
    if resumed is None:
        resumed = has0

    def s0(k: int, n: int) -> np.ndarray:
        return np.asarray(state0[k]) if has0 else np.zeros(n)

    v_prev_c0, i_prev_c0 = s0(0, tensors.n_c), s0(1, tensors.n_c)
    i_prev_l0, v_prev_l0 = s0(2, tensors.n_l), s0(3, tensors.n_l)
    v_prev2_c0, i_prev2_l0 = s0(8, tensors.n_c), s0(9, tensors.n_l)

    def vdrop(idx: np.ndarray) -> np.ndarray:
        return xs_pad[:, idx[:, 0]] - xs_pad[:, idx[:, 1]]  # (S+1, nE)

    if tensors.n_r:
        i_r = vdrop(tensors.r_idx) / tensors.r_vals[None, :]
        for k, name in enumerate(tensors.r_names):
            out[name] = i_r[:, k]
    if tensors.n_c:
        vd = vdrop(tensors.c_idx)
        cv = tensors.c_vals
        prev = np.concatenate([v_prev_c0[None, :], vd[:-1]], axis=0)
        if integration == "trap":
            # i_k = (2C/dt)(v_k - v_{k-1}) - i_{k-1} telescopes to an
            # alternating cumulative sum; a fresh run's step 0 is BE
            a = 2.0 * cv[None, :] * (vd - prev) / dt_c
            if not resumed:
                a[0] = cv * (vd[0] - v_prev_c0) / dt_c
            sign = (-1.0) ** np.arange(a.shape[0])[:, None]
            i_c = sign * np.cumsum(sign * a, axis=0)
            if has0:
                i_c = i_c - sign * i_prev_c0[None, :]
        elif integration == "gear2":
            prev2 = np.concatenate([v_prev2_c0[None, :], prev[:-1]], axis=0)
            i_c = (cv[None, :] / dt_c) * (1.5 * vd - 2.0 * prev + 0.5 * prev2)
            if not resumed:
                i_c[0] = cv * (vd[0] - v_prev_c0) / dt_c
                if vd.shape[0] > 1:
                    i_c[1] = cv * (vd[1] - vd[0]) / dt_c
        else:
            i_c = cv[None, :] * (vd - prev) / dt_c
        for k, name in enumerate(tensors.c_names):
            out[name] = i_c[:, k]
    if tensors.n_l:
        vd = vdrop(tensors.l_idx)
        # K-coupled: companion updates are c * M^{-1} @ vd (the host
        # analog of the loop's _l_mv)
        minv_h = _mutual_inv(
            torch.as_tensor(np.asarray(tensors.l_vals, np.float64)),
            lk_arrays(tensors, "cpu"))[0].numpy() if tensors.n_k else None

        def lmv(c: float, v: np.ndarray) -> np.ndarray:
            if minv_h is not None:
                return c * (v @ minv_h.T)
            return (c / tensors.l_vals) * v

        if integration == "trap":
            prev = np.concatenate([v_prev_l0[None, :], vd[:-1]], axis=0)
            inc = lmv(dt_c / 2.0, prev + vd)
            if not resumed:
                inc[0] = lmv(dt_c, vd[0])  # BE first step
            i_l = i_prev_l0[None, :] + np.cumsum(inc, axis=0)
        elif integration == "gear2":
            i_l = np.zeros_like(vd)
            im1, im2 = i_prev_l0, i_prev2_l0
            for k in range(vd.shape[0]):
                if not resumed and k < 2:
                    ik = im1 + lmv(dt_c, vd[k])
                else:
                    ik = lmv(dt_c / 1.5, vd[k]) + (2.0 * im1 - 0.5 * im2) / 1.5
                i_l[k] = ik
                im2, im1 = im1, ik
        else:
            i_l = i_prev_l0[None, :] + np.cumsum(lmv(dt_c, vd), axis=0)
        for k, name in enumerate(tensors.l_names):
            out[name] = i_l[:, k]
    for k, name in enumerate(tensors.v_names):
        out[name] = xs[:, tensors.v_idx[k, 2]]
    if tensors.n_g:
        vc = xs_pad[:, tensors.g_idx[:, 2]] - xs_pad[:, tensors.g_idx[:, 3]]
        i_g = tensors.g_gm[None, :] * vc
        for k, name in enumerate(tensors.g_names):
            out[name] = i_g[:, k]
    for k, name in enumerate(tensors.e_names):
        out[name] = xs[:, tensors.e_idx[k, 2]]
    for k, name in enumerate(tensors.f_names):
        out[name] = tensors.f_gain[k] * xs[:, tensors.f_idx[k, 2]]
    for k, name in enumerate(tensors.h_names):
        out[name] = xs[:, tensors.h_idx[k, 2]]
    if tensors.n_i and src_grid is not None:
        for k, name in enumerate(tensors.i_names):
            out[name] = np.asarray(src_grid[:, tensors.n_v + k])
    if tensors.n_s:
        r_sw = np.where(sw_states, tensors.s_ron[None, :],
                        tensors.s_roff[None, :])
        i_s = vdrop(tensors.s_idx[:, :2]) / np.maximum(np.abs(r_sw), EPS)
        for k, name in enumerate(tensors.s_names):
            out[name] = i_s[:, k]
    if tensors.n_d:
        vd = vdrop(tensors.d_idx)
        v_th = tensors.d_n[None, :] * VT_300K
        with np.errstate(over="ignore"):
            i_d = tensors.d_is[None, :] * (np.exp(vd / v_th) - 1.0)
        if tensors.has_d_charge:
            # the capacitive current (q_k - q_{k-1})/dt on top, q formed
            # as the loop committed it
            tsc = tensors.vt / VT_300K
            ev_c = np.exp(np.clip(vd, DIODE_VD_MIN * tsc,
                                  DIODE_VD_MAX * tsc) / v_th)
            q = _host(diode_charge_cap, vd, tensors.d_is * (ev_c - 1.0),
                      np.maximum(tensors.d_is / v_th * ev_c, GMIN),
                      tensors.d_tt, tensors.d_cjo, tensors.d_vj, tensors.d_m,
                      tensors.d_fc)[0]
            q_prev = np.concatenate([s0(10, tensors.n_d)[None, :], q[:-1]],
                                    axis=0)
            i_d = i_d + (q - q_prev) / dt_c
        for k, name in enumerate(tensors.d_names):
            out[name] = i_d[:, k]
    if tensors.n_m:
        m_idx = tensors.m_idx
        vgs = xs_pad[:, m_idx[:, 1]] - xs_pad[:, m_idx[:, 2]]
        vds = xs_pad[:, m_idx[:, 0]] - xs_pad[:, m_idx[:, 2]]
        i_m = _host(mos_level1, vgs, vds, tensors.m_beta, tensors.m_vto,
                    tensors.m_lambda, tensors.m_polarity)[3]
        for k, name in enumerate(tensors.m_names):
            out[name] = i_m[:, k]
    if tensors.n_q:
        q_idx, pol = tensors.q_idx, tensors.q_polarity
        vbe = xs_pad[:, q_idx[:, 1]] - xs_pad[:, q_idx[:, 2]]
        vbc = xs_pad[:, q_idx[:, 1]] - xs_pad[:, q_idx[:, 0]]
        # the full nonlinear currents without the Newton clamp, as the
        # reference records its diode (simulateTRAN.ts:207-219)
        i_c = _host(bjt_ebers_moll, vbe, vbc, tensors.q_is, tensors.q_bf,
                    tensors.q_br, pol, tensors.vt, pol * vbe, pol * vbc)[7]
        if tensors.has_q_charge:
            # the collector loses the b-c junction's charge current
            # dq_bc/dt (clamped diffusion, true depletion, as committed)
            g = tensors.q_chg
            tsc = tensors.vt / VT_300K
            u_bc = pol * vbc
            ev = np.exp(np.clip(u_bc, DIODE_VD_MIN * tsc, DIODE_VD_MAX * tsc)
                        / tensors.vt)
            q_bc = pol * _host(
                diode_charge_cap, u_bc, tensors.q_is * (ev - 1.0),
                np.maximum(tensors.q_is / tensors.vt * ev, GMIN), g[:, 1],
                g[:, 5], g[:, 6], g[:, 7], g[:, 8])[0]
            pos = 10 + int(tensors.has_d_charge)
            q0 = (np.asarray(state0[pos])[:, 1] if has0
                  else np.zeros(tensors.n_q))
            q_prev = np.concatenate([q0[None, :], q_bc[:-1]], axis=0)
            i_c = i_c - (q_bc - q_prev) / dt_c
        for k, name in enumerate(tensors.q_names):
            out[name] = i_c[:, k]
    # T lines: the port currents are branch unknowns; <name> is port 1,
    # <name>#p2 port 2
    for k, name in enumerate(tensors.t_names):
        out[name] = xs_pad[:, tensors.t_idx[k, 4]]
        out[f"{name}#p2"] = xs_pad[:, tensors.t_idx[k, 5]]
    return out


def _host(fn, *args: object) -> tuple[np.ndarray, ...]:
    """Run a device model of models/devices.py on host float64 arrays (the
    result epilogue is NumPy); returns NumPy arrays."""
    outs = fn(*(torch.as_tensor(np.asarray(a, np.float64)) for a in args))
    return tuple(o.numpy() for o in outs)


def _ic_carry(ckt: ParsedCircuit, tensors: CircuitTensors,
              dt: float) -> tuple:
    """The starting carry of a fresh run with extended .ic / element
    ``ic=``: each capacitor's companion state at its initial voltage
    (unspecified nodes at 0), each inductor's at its initial current. The
    reference has no .ic support (simulateTRAN.ts:149 starts from rest)."""
    ic = {k.upper(): v for k, v in ckt.initial_conditions.items()}
    node_v = np.zeros(tensors.nvar + 1)
    for i, name in enumerate(tensors.node_names):
        node_v[i] = ic.get(name.upper(), 0.0)
    v_ic = node_v[tensors.c_idx[:, 0]] - node_v[tensors.c_idx[:, 1]]
    for k, c in enumerate(ckt.C):
        if c.ic is not None:
            v_ic[k] = c.ic
    i_l0 = np.zeros(tensors.n_l)
    for k, el in enumerate(ckt.L):
        if el.ic is not None:
            i_l0[k] = el.ic
    z = np.zeros
    carry = (v_ic, z(tensors.n_c), i_l0, z(tensors.n_l), z(tensors.n_d),
             z((tensors.n_m, 2)), z((tensors.n_q, 2)),
             np.zeros(tensors.n_s, bool), v_ic.copy(), i_l0.copy())
    if tensors.has_d_charge:
        carry += (z(tensors.n_d),)
    if tensors.has_q_charge:
        carry += (z((tensors.n_q, 2)),)
    if tensors.n_t:
        carry += (z((tline_hist_len(tensors.t_td, dt), tensors.n_t, 2)),
                  np.int32(0))
    return carry


def simulate_tran(
    ckt: ParsedCircuit,
    tensors: CircuitTensors | None = None,
    method: str = "gj",
    integration: str = "be",
    nr: str = "spicey",
    nr_tol: float = 1e-9,
    max_nr: int | None = None,
    state: TranState | None = None,
    return_state: bool = False,
    nr_vntol: float | None = None,
    nr_abstol: float | None = None,
    device: torch.device | str | None = None,
) -> TranResult | None:
    """Transient analysis in float64 on ``device`` (the card unless
    ``device="cpu"``). Defaults reproduce the reference; see _tran_core for
    the ``integration``/``nr`` toggles.

    Checkpoint/resume: ``return_state=True`` attaches the final state
    (``result.state``); passing it back via ``state=`` runs the netlist's
    .tran spec as the NEXT segment of the same run: times continue from
    the checkpoint, sources are sampled at absolute time, and no quasi-DC
    bootstrap step is repeated."""
    device = resolve_device(device)
    if ckt.tran is None:
        return None
    if integration not in ("be", "trap", "gear2"):
        raise ValueError("integration must be 'be', 'trap', or 'gear2'")
    if nr not in ("spicey", "converged"):
        raise ValueError("nr must be 'spicey' or 'converged'")
    if tensors is None:
        tensors = build_tensors(ckt)
    # MOSFET/BJT devices and behavioral sources need Newton iteration: the
    # reference's break-on-switch-stability rule is upgraded, as in the
    # JAX package
    if (tensors.n_m or tensors.n_q or ckt.B) and nr == "spicey":
        nr = "converged"

    dt, steps = effective_time_step(ckt.tran.dt, ckt.tran.tstop)
    if state is None:
        times = np.arange(steps + 1, dtype=np.float64) * dt
    else:
        if abs(state.dt - dt) > EPS:
            raise ValueError(
                f"resume dt {dt} differs from checkpoint dt {state.dt}")
        # rebuild the absolute grid from the integer step count: state.t +
        # k*dt accumulates rounding that can move a sample across a
        # nanosecond PULSE edge
        step0 = round(state.t / dt)
        times = (step0 + np.arange(1, steps + 1, dtype=np.float64)) * dt
    vs_grid = sample_source_values(ckt, times)  # (S+1, nV+nI)

    init_carry = None  # fresh-run .ic carry, also for element currents
    init_state = None
    if state is not None:
        init_state = state.carry
    elif (ckt.initial_conditions or any(c.ic is not None for c in ckt.C)
          or any(el.ic is not None for el in ckt.L)):
        init_carry = _ic_carry(ckt, tensors, dt)
        init_state = init_carry

    f64 = torch.float64
    nr_floor = None
    if nr_vntol is not None or nr_abstol is not None:
        # ngspice's per-unknown floors: node-voltage rows then branch rows
        nr_floor = torch.as_tensor(np.where(
            np.arange(tensors.nvar) < tensors.n_node_vars,
            1e-6 if nr_vntol is None else nr_vntol,
            1e-12 if nr_abstol is None else nr_abstol), dtype=f64,
            device=device)
    # the structured tier: forced by "schur", auto past N = 128 for "gj"
    plan = plan_for(method, ckt, tensors, tensors.nvar, device)

    def run(plan_arrays: dict | None) -> tuple[np.ndarray, list]:
        xs, sw_states, valid, fin = _tran_core(
            torch.as_tensor(vs_grid, dtype=f64, device=device), dt,
            tran_arrays(tensors, device, f64, ckt=ckt, dt=dt), tensors.nvar,
            method="gj" if method == "schur" else method,
            integration=integration, nr=nr, nr_tol=nr_tol, max_nr=max_nr,
            init_state=init_state, resume=state is not None,
            nr_floor=nr_floor, vt_scale=vt_scale_of(tensors, device, f64),
            times=times, plan=plan_arrays)
        # one device->host transfer of [solution | switch states | validity]
        return torch.cat([xs, sw_states.to(f64),
                          valid.to(f64).expand(xs.shape[0], 1)],
                         dim=1).cpu().numpy(), fin

    packed, fin = run(plan)
    if plan is not None and not bool(packed[0, -1] > 0.5):
        # block-local pivoting failed where global pivoting may not:
        # retry the whole run dense before declaring it singular
        packed, fin = run(None)
    if not bool(packed[0, -1] > 0.5):
        raise ValueError("Singular matrix in TRAN solve")
    xs_np = packed[:, :tensors.nvar]
    sw_np = packed[:, tensors.nvar:tensors.nvar + tensors.n_s] > 0.5
    return _tran_epilogue(ckt, tensors, xs_np, sw_np, times, vs_grid, dt,
                          integration, state, return_state,
                          [a.cpu().numpy() for a in fin] if return_state
                          else None, init_carry=init_carry)


def _tran_epilogue(ckt: ParsedCircuit, tensors: CircuitTensors,
                   xs: np.ndarray, sw_states: np.ndarray, times: np.ndarray,
                   vs_grid: np.ndarray, dt: float, integration: str,
                   state: TranState | None, return_state: bool,
                   fin_state: list | None,
                   init_carry: tuple | None = None) -> TranResult:
    """Host-side result assembly: element currents, probe filters, the
    record window, checkpoint packaging."""
    node_voltages = {
        name: xs[:, i] for i, name in enumerate(tensors.node_names)
    }
    element_currents = _element_currents(
        tensors, xs, sw_states, dt, integration=integration,
        src_grid=vs_grid,
        state0=state.carry if state is not None else init_carry,
        resumed=state is not None)
    # behavioral-source currents: a V-kind source's from its branch
    # unknown, an I-kind source's by evaluating its expression over the
    # trajectory (the parser's NumPy closure, on the host)
    xs_pad = np.concatenate([xs, np.zeros((xs.shape[0], 1))], axis=1)
    for b_el in ckt.B:
        if b_el.kind == "v":
            element_currents[b_el.name] = xs[:, b_el.index]
        else:
            refs = np.asarray(bsrc_refs(b_el, tensors.nvar),
                              np.int64).reshape(-1, 2)
            element_currents[b_el.name] = np.broadcast_to(
                b_el.fn(xs_pad[:, refs[:, 0]] - xs_pad[:, refs[:, 1]], times),
                times.shape).copy()
    # probe filter (simulateTRAN.ts:240-249): keep canonical-casing keys
    if ckt.tran_probes:
        upper = {p.upper() for p in ckt.tran_probes}
        node_voltages = {name: series for name, series in
                         node_voltages.items() if name.upper() in upper}
    if getattr(ckt, "tran_iprobes", None):
        # extended .print tran i(...): filter element currents (the
        # reference recognizes only v() probes and leaves currents whole)
        upper_i = {p.upper() for p in ckt.tran_iprobes}
        element_currents = {name: series for name, series in
                            element_currents.items()
                            if name.upper() in upper_i}
    # extended ngspice-style record window: integrate from 0, keep t >=
    # tstart (resumed segments start mid-run and keep everything)
    tstart = getattr(ckt.tran, "tstart", 0.0)
    if tstart > 0.0 and state is None:
        keep = times >= tstart - EPS
        times = times[keep]
        node_voltages = {k: v[keep] for k, v in node_voltages.items()}
        element_currents = {k: v[keep] for k, v in element_currents.items()}
    result = TranResult(times=times, node_voltages=node_voltages,
                        element_currents=element_currents)
    if return_state:
        result.state = TranState(carry=tuple(fin_state),
                                 t=float(times[-1]), dt=dt)
    return result
