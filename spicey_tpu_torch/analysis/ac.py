"""AC small-signal frequency sweep on torch tensors.

Contract: spicey/lib/analysis/simulateAC.ts:9-130. The reference loops
frequencies serially, refactorizing an O(Nvar^2) complex matrix per point.
Here assembly is batched over (variants, frequencies) with leading tensor
dimensions and the whole grid is ONE batched complex solve: kernel K1 on a
CUDA tensor (ops/gj.py), its plain version on the CPU.

The complex system A(f) = G + j*B(f) is kept as two real planes, as in the
JAX package, so both packages solve the same systems the same way; phasors
are reassembled host-side.

Stamp semantics per frequency f (simulateAC.ts:24-60):
  - R as Y = 1/R (R <= 0 raises);
  - C as Y = j*2*pi*f*C                               -> imaginary part;
  - L as Y = 1/(j*2*pi*f*L) = -j/(2*pi*f*L), open circuit when
    |2*pi*f*L| < EPS                                  -> imaginary part;
  - V as phasor fromPolar(acMag, acPhaseDeg) on its branch row.
Switches and diodes are NOT stamped in AC (no DC operating point / small-
signal linearization exists in the reference). ``linearize="op"`` (or
``.options acop``) is the JAX package's extension: the DC operating point
is solved first (op.py) and every diode/switch/MOSFET/BJT contributes its
small-signal conductances as extra VCCS rows, and its junction
capacitances as extra C rows (``small_signal_rows``,
``diode_smallsignal_caps``, shared with .tf and .noise).

The extended K and T elements are the JAX package's: K-coupled inductors
stamp the coupled branch admittance Y(w) = (j w M)^{-1} = -j M^{-1} / w
into the imaginary plane (M^{-1} inverted once per variant by
``tran._mutual_inv``, kernel K3 on the card; a singular M flags the
variant invalid), with the reference's open-at-DC rule per inductor; a T
line stamps its exact lossless phasor model, the near-end Z0 rows plus
the far-end coupling -e^{-j w Td} split across the planes. A V-kind B
source stamps as a 0 V short; with ``linearize="op"`` every B source adds
its gradients at the operating point (``_bsource_small_signal``).

The structured tier (ops/schur.py) routes the solve as the JAX package
routes it: forced by ``method="schur"`` (a ``ValueError`` on a circuit with
no block structure), taken by the default ``method="gj"`` on a
subcircuit board past N = 128, and retried dense over the whole sweep
when a block pivot fails; ``method="pallas"`` stays dense. A flat deck
past N = 128 solves dense (K1 in a global workspace where a system
overflows shared memory). The JAX package's host interp tier for tiny
decks has no counterpart: the device path is the path.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import DIODE_VD_MAX, DIODE_VD_MIN, EPS, GMIN, VT_300K
from ..ir.circuit import (CircuitTensors, bsrc_static, build_tensors,
                          bv_branch_rows, ext_arrays, lk_arrays, tl_arrays)
from ..ops.linsolve import solve_planes
from ..ops.schur import plan_for
from ..ops.stamps import (
    stamp_admittance,
    stamp_current,
    stamp_extended,
    stamp_mutual,
    stamp_tline_coupling,
    stamp_tline_ports,
    stamp_voltage_source,
)
from ..parsing.netlist import ParsedCircuit
from ..utils.device import resolve_device
from ..utils.logspace import linear_grid, logspace, octspace
from ..models.devices import bjt_ebers_moll, diode_charge_cap, mos_level1
from ..parsing.bexpr import bexpr_partials
from .results import ACResult
from .tran import _host, _mutual_inv


def build_frequency_array(mode: str, N: int, f1: float, f2: float) -> np.ndarray:
    if mode == "dec":
        return logspace(f1, f2, N)
    if mode == "oct":  # extended dialect (.ac oct parses only there)
        return octspace(f1, f2, N)
    return linear_grid(f1, f2, N)


def _inductor_susceptance(w: torch.Tensor, l_vals: torch.Tensor
                          ) -> torch.Tensor:
    """Imag part of Y_L = -1/(w*L), masked open when |w*L| < EPS.
    w: (F,); l_vals: (B, nL) -> (B, F, nL)."""
    wl = w[None, :, None] * l_vals[:, None, :]
    small = wl.abs() < EPS
    one = torch.ones((), dtype=wl.dtype, device=wl.device)
    return torch.where(small, torch.zeros_like(wl),
                       -1.0 / torch.where(small, one, wl))


def _assemble_grid(freqs: torch.Tensor, r_idx: torch.Tensor,
                   r_vals: torch.Tensor, c_idx: torch.Tensor,
                   c_vals: torch.Tensor, l_idx: torch.Tensor,
                   l_vals: torch.Tensor, v_idx: torch.Tensor,
                   v_re: torch.Tensor, v_im: torch.Tensor, nvar: int,
                   ext: dict | None = None,
                   i_re: torch.Tensor | None = None,
                   i_im: torch.Tensor | None = None,
                   minv: torch.Tensor | None = None,
                   tl: dict | None = None
                   ) -> tuple[torch.Tensor, ...]:
    """Batched MNA assembly over variants and frequencies.

    Value arrays lead with a variants axis B: r/c/l_vals (B, nE), v_re/v_im
    (B, nV), ext value arrays (B, nX); i_re/i_im (nI,) are shared. Index
    arrays are int64 tensors on the values' device. ``minv``: M^{-1} of
    K-coupled inductors per variant, (B, nL, nL) (``tran._mutual_inv``,
    frequency-independent, so inverted once by the caller); ``tl``: the T
    lines, Z0/Td (B, nT). Returns the planes
    (A_re, A_im, b_re, b_im) shaped (B, F, N, N) and (B, F, N), batch-first
    as K1 takes them. This one function plays the roles of the JAX
    package's ``_assemble_one``/``_assemble_grid`` (a batch dimension in
    place of ``vmap``) and of ``_assemble_grid_batchlast`` (the K1 route's
    assembly)."""
    B = r_vals.shape[0]
    F = freqs.shape[0]
    dtype = r_vals.dtype
    dev = r_vals.device
    n1 = nvar + 1
    A_re = torch.zeros((B, F, n1, n1), dtype=dtype, device=dev)
    A_im = torch.zeros((B, F, n1, n1), dtype=dtype, device=dev)
    b_re = torch.zeros((B, F, n1), dtype=dtype, device=dev)
    b_im = torch.zeros((B, F, n1), dtype=dtype, device=dev)

    w = (2.0 * math.pi) * freqs.to(dtype)
    stamp_admittance(A_re, r_idx, (1.0 / r_vals)[:, None, :])
    stamp_admittance(A_im, c_idx, w[None, :, None] * c_vals[:, None, :])
    if minv is None:
        stamp_admittance(A_im, l_idx, _inductor_susceptance(w, l_vals))
    else:
        # the coupled branch admittance -j M^{-1} / w, each inductor open
        # where |w L| < EPS (at k = 0 exactly the scalar stamp)
        keep = ((w[None, :, None] * l_vals[:, None, :]).abs()
                >= EPS).to(dtype)                          # (B, F, nL)
        w_safe = torch.where(w.abs() < EPS, torch.ones_like(w), w)
        S = ((-minv[:, None] / w_safe[None, :, None, None])
             * keep[..., :, None] * keep[..., None, :])
        stamp_mutual(A_im, l_idx, S)
    stamp_voltage_source(A_re, b_re, v_idx, v_re[:, None, :])
    b_im.index_add_(-1, v_idx[:, 2],
                    v_im[:, None, :].expand(B, F, v_idx.shape[0]))
    if ext is not None:
        # extended-dialect current sources: RHS phasor injection
        stamp_current(b_re, ext["i_idx"], i_re)
        stamp_current(b_im, ext["i_idx"], i_im)
        # controlled sources: real, frequency-independent stamps
        stamp_extended(A_re, {k: (v if k.endswith("idx") else v[:, None, :])
                              for k, v in ext.items()})
    if tl is not None:
        # T lines, the exact lossless phasor model: near-end Z0 rows plus
        # the far-end coupling -e^{-j w Td} split across the planes
        z0 = tl["z0"][:, None, :]
        theta = w[None, :, None] * tl["td"][:, None, :]   # (B, F, nT)
        stamp_tline_ports(A_re, tl["t_idx"], z0)
        stamp_tline_coupling(A_re, tl["t_idx"], z0, -torch.cos(theta))
        stamp_tline_coupling(A_im, tl["t_idx"], z0, torch.sin(theta))
    return (A_re[..., :nvar, :nvar], A_im[..., :nvar, :nvar],
            b_re[..., :nvar], b_im[..., :nvar])


def _ac_sweep_core(freqs: torch.Tensor, r_idx: torch.Tensor,
                   r_vals: torch.Tensor, c_idx: torch.Tensor,
                   c_vals: torch.Tensor, l_idx: torch.Tensor,
                   l_vals: torch.Tensor, v_idx: torch.Tensor,
                   v_re: torch.Tensor, v_im: torch.Tensor, nvar: int,
                   method: str = "gj", ext: dict | None = None,
                   i_re: torch.Tensor | None = None,
                   i_im: torch.Tensor | None = None,
                   lk: dict | None = None, tl: dict | None = None,
                   plan: dict | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Assemble + one batched solve over the whole grid. Values as in
    ``_assemble_grid``, the couplings ``lk`` (k (nK,) or (B, nK)) and the
    lines ``tl`` (Z0/Td (B, nT)) when the deck has them; ``plan`` (a
    ``SchurPlan.arrays()``) routes the solve through the structured tier,
    the assembly unchanged. Returns (x_re, x_im, valid) shaped (B, F, N),
    (B, F, N), (B, F), a variant whose inductance matrix is singular
    invalid at every frequency."""
    minv = minv_ok = None
    if lk is not None:
        minv, minv_ok = _mutual_inv(l_vals, lk)
    A_re, A_im, b_re, b_im = _assemble_grid(
        freqs, r_idx, r_vals, c_idx, c_vals, l_idx, l_vals, v_idx,
        v_re, v_im, nvar, ext=ext, i_re=i_re, i_im=i_im, minv=minv, tl=tl)
    x_re, x_im, valid = solve_planes(A_re, A_im, b_re, b_im, method=method,
                                     plan=plan)
    if minv_ok is not None:
        valid = valid & minv_ok.reshape(-1, 1)
    return x_re, x_im, valid


def _element_currents(tensors: CircuitTensors, freqs, x) -> dict[str, np.ndarray]:
    """Per-element current phasors, vectorized over the grid
    (simulateAC.ts:94-126). Host-side complex128 NumPy."""
    x_pad = np.concatenate(
        [x, np.zeros((x.shape[0], 1), dtype=x.dtype)], axis=1
    )
    w = 2.0 * np.pi * freqs  # (F,)
    out: dict[str, np.ndarray] = {}

    def vdrop(idx):
        return x_pad[:, idx[:, 0]] - x_pad[:, idx[:, 1]]  # (F, nE)

    if tensors.n_r:
        i_r = vdrop(tensors.r_idx) / tensors.r_vals[None, :]
        for k, name in enumerate(tensors.r_names):
            out[name] = i_r[:, k]
    if tensors.n_c:
        y_c = 1j * w[:, None] * tensors.c_vals[None, :]
        i_c = y_c * vdrop(tensors.c_idx)
        for k, name in enumerate(tensors.c_names):
            out[name] = i_c[:, k]
    if tensors.n_l:
        vd_l = vdrop(tensors.l_idx)
        if tensors.n_k:
            # coupled branch phasors: I = -j M^{-1} Vd / w, with the
            # per-inductor open-at-DC mask of the assembly
            minv_h = _mutual_inv(
                torch.as_tensor(np.asarray(tensors.l_vals, np.float64)),
                lk_arrays(tensors, "cpu"))[0].numpy()
            keep = (np.abs(w[:, None] * tensors.l_vals[None, :])
                    >= EPS).astype(np.float64)
            w_safe = np.where(np.abs(w) < EPS, 1.0, w)
            i_l = (-1j / w_safe[:, None]) * keep * (
                (vd_l * keep) @ minv_h.T)
        else:
            wl = w[:, None] * tensors.l_vals[None, :]
            y_l = np.where(np.abs(wl) < EPS, 0.0,
                           -1.0 / np.where(np.abs(wl) < EPS, 1.0, wl))
            i_l = (1j * y_l) * vd_l
        for k, name in enumerate(tensors.l_names):
            out[name] = i_l[:, k]
    for k, name in enumerate(tensors.v_names):
        out[name] = x[:, tensors.v_idx[k, 2]]
    if tensors.n_g:
        vc = (x_pad[:, tensors.g_idx[:, 2]]
              - x_pad[:, tensors.g_idx[:, 3]])
        i_g = tensors.g_gm[None, :] * vc
        for k, name in enumerate(tensors.g_names):
            out[name] = i_g[:, k]
    for k, name in enumerate(tensors.e_names):
        out[name] = x[:, tensors.e_idx[k, 2]]
    for k, name in enumerate(tensors.f_names):
        out[name] = tensors.f_gain[k] * x[:, tensors.f_idx[k, 2]]
    for k, name in enumerate(tensors.h_names):
        out[name] = x[:, tensors.h_idx[k, 2]]
    if tensors.n_i:
        iph = tensors.i_ac_phase_deg * np.pi / 180.0
        i_ph = tensors.i_ac_mag * np.exp(1j * iph)
        for k, name in enumerate(tensors.i_names):
            out[name] = np.full(x.shape[0], i_ph[k], dtype=np.complex128)
    # T lines: the port-current phasors are branch unknowns (Branin)
    for k, name in enumerate(tensors.t_names):
        out[name] = x[:, tensors.t_idx[k, 4]]
        out[f"{name}#p2"] = x[:, tensors.t_idx[k, 5]]
    return out


def ac_vsource_arrays(ckt: ParsedCircuit, tensors: CircuitTensors):
    """(v_idx, v_re, v_im) for the AC sweep: independent V phasors
    fromPolar(acMag, acPhaseDeg) (Complex.ts:16-19), plus V-kind behavioral
    sources' branch rows stamped as 0 V small-signal shorts so the system
    stays regular (matching the reference's policy of not stamping
    nonlinear devices)."""
    ph = tensors.v_ac_phase_deg * math.pi / 180.0
    v_re = tensors.v_ac_mag * np.cos(ph)
    v_im = tensors.v_ac_mag * np.sin(ph)
    v_idx = tensors.v_idx
    bv = bv_branch_rows(ckt, tensors.nvar)
    if bv.shape[0]:
        v_idx = np.concatenate([tensors.v_idx, bv], axis=0)
        z = np.zeros(bv.shape[0])
        v_re = np.concatenate([v_re, z])
        v_im = np.concatenate([v_im, z])
    return v_idx, v_re, v_im


def _op_voltage_pad(tensors: CircuitTensors, op) -> np.ndarray:
    """Node voltages of an OPResult laid out as a padded tran/AC-ordering
    solution vector (ground dump slot = 0 V)."""
    x_pad = np.zeros(tensors.nvar + 1)
    for i, name in enumerate(tensors.node_names):
        x_pad[i] = op.node_voltages[name]
    return x_pad


def find_input_source(tensors: CircuitTensors, name: str,
                      directive: str) -> tuple[int | None, int | None]:
    """Locate a named independent source for .tf/.noise input referencing.
    Returns (v_pos, i_pos) — exactly one is set — or raises."""
    key = name.upper()
    v_pos = next((k for k, n in enumerate(tensors.v_names)
                  if n.upper() == key), None)
    i_pos = next((k for k, n in enumerate(tensors.i_names)
                  if n.upper() == key), None)
    if v_pos is None and i_pos is None:
        raise ValueError(
            f"Unknown source {name} in {directive} (must be a V or I element)")
    return v_pos, i_pos


def format_out_spec(out_pos: str, out_neg: str | None) -> str:
    """``v(out)`` / ``v(out,ref)`` display string for .tf/.noise results."""
    return f"v({out_pos})" if out_neg is None else f"v({out_pos},{out_neg})"


def small_signal_rows(tensors: CircuitTensors, op
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Small-signal conductances of every nonlinear device at the DC
    operating point, expressed as VCCS rows ((n,4) idx, (n,) gm), on the
    host.

    An admittance g between (a, b) is the self-controlled VCCS
    [a, b, a, b]; the MOSFET gm is [d, s, g, s]; the BJT transport terms
    are [c, e, b, e] (+gmf) and [c, e, b, c] (-gmr)."""
    x_pad = _op_voltage_pad(tensors, op)
    rows: list[np.ndarray] = []
    vals: list[np.ndarray] = []

    def adm(idx2, g):
        rows.append(np.concatenate([idx2, idx2], axis=1))
        vals.append(np.asarray(g, np.float64))

    if tensors.n_d:
        vd = x_pad[tensors.d_idx[:, 0]] - x_pad[tensors.d_idx[:, 1]]
        tscale = tensors.vt / VT_300K  # see tran._stamp_system
        vd_lim = np.clip(vd, DIODE_VD_MIN * tscale, DIODE_VD_MAX * tscale)
        v_th = tensors.d_n * VT_300K
        g_d = np.maximum(tensors.d_is / v_th * np.exp(vd_lim / v_th), GMIN)
        adm(tensors.d_idx, g_d)
    if tensors.n_s:
        on = np.asarray([op.switch_states[n] for n in tensors.s_names])
        r_sw = np.where(on, tensors.s_ron, tensors.s_roff)
        adm(tensors.s_idx[:, :2], 1.0 / np.maximum(np.abs(r_sw), EPS))
    if tensors.n_m:
        mi = tensors.m_idx
        vgs = x_pad[mi[:, 1]] - x_pad[mi[:, 2]]
        vds = x_pad[mi[:, 0]] - x_pad[mi[:, 2]]
        gm, gds, _, _ = _host(mos_level1, vgs, vds, tensors.m_beta,
                              tensors.m_vto, tensors.m_lambda,
                              tensors.m_polarity)
        rows.append(mi[:, [0, 2, 1, 2]])
        vals.append(gm)
        adm(mi[:, [0, 2]], gds)
    if tensors.n_q:
        qi = tensors.q_idx
        vbe = x_pad[qi[:, 1]] - x_pad[qi[:, 2]]
        vbc = x_pad[qi[:, 1]] - x_pad[qi[:, 0]]
        gbe, gbc, gmf, gmr, *_ = _host(
            bjt_ebers_moll, vbe, vbc, tensors.q_is, tensors.q_bf,
            tensors.q_br, tensors.q_polarity, tensors.vt,
            tensors.q_polarity * vbe, tensors.q_polarity * vbc)
        adm(qi[:, [1, 2]], gbe)
        adm(qi[:, [1, 0]], gbc)
        rows.append(qi[:, [0, 2, 1, 2]])
        vals.append(gmf)
        rows.append(qi[:, [0, 2, 1, 0]])
        vals.append(-gmr)
    if not rows:
        return np.zeros((0, 4), np.int32), np.zeros((0,), np.float64)
    return (np.concatenate(rows, axis=0).astype(np.int32),
            np.concatenate(vals, axis=0))


def _bsource_small_signal(ckt: ParsedCircuit, tensors: CircuitTensors, op
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Small-signal rows of the behavioral sources at the operating point,
    shaped as VCCS rows so they ride the ext["g_*"] stamping, on the host.

    I-kind: each reference partial dI/d(vref) is one 4-point
    transconductance row across the source's nodes. V-kind: the source
    owns a branch row (stamped as a 0 V short by the AC path, v1 - v2 =
    0); its gradient couplings -dF/d(vref) target that row, as a VCCS
    whose current rows are [branch, dump]: the dump half is sliced off,
    leaving A[br, ref+-] -= g. Branch-current references read 0 here (the
    operating point's branch currents are not in this padded vector), as
    in the JAX package."""
    dump = tensors.nvar
    rows: list[list[int]] = []
    vals: list[float] = []
    for kind, i1, i2, br, refs, gs in bsource_gradients(ckt, tensors, op,
                                                        dump):
        for (a, b), g in zip(refs, gs):
            if kind == "i":
                rows.append([i1, i2, a, b])
                vals.append(g)
            else:
                rows.append([br, dump, a, b])
                vals.append(-g)
    if not rows:
        return np.zeros((0, 4), np.int32), np.zeros((0,))
    return np.asarray(rows, np.int32), np.asarray(vals, np.float64)


def bsource_gradients(ckt: ParsedCircuit, tensors: CircuitTensors, op,
                      dump: int) -> list[tuple]:
    """Each B source linearized at the operating point ``op``, in a system
    whose ground slot is ``dump`` (AC: tensors.nvar, .tf: the op system's):
    (kind, i1, i2, branch, refs, partials) with ``refs`` the reference
    pairs of ``ir.circuit.bsrc_static`` and ``partials`` one float per
    reference, ``bexpr_partials`` on float64 CPU tensors at the op's node
    voltages (a branch reference reads 0)."""
    x_pad = np.zeros(dump + 1)
    for i, name in enumerate(tensors.node_names):
        x_pad[i] = op.node_voltages[name]
    out = []
    for kind, fn, i1, i2, br, refs in bsrc_static(ckt, dump):
        v = torch.as_tensor([x_pad[a] - x_pad[b] for a, b in refs],
                            dtype=torch.float64)
        gs = [float(g) for g in bexpr_partials(fn, v, 0.0)[1]]
        out.append((kind, i1, i2, br, refs, gs))
    return out


def diode_smallsignal_caps(tensors: CircuitTensors, op
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Junction capacitances C(v) at the operating point — diode TT/CJO
    plus BJT TF/TR/CJE/CJC junctions — as extra linear C rows for
    op-linearized AC/noise. Returns (idx (n,2), c_vals); empty when no
    device stores charge."""
    rows: list[np.ndarray] = []
    caps: list[np.ndarray] = []
    x_pad = _op_voltage_pad(tensors, op)
    if tensors.has_d_charge:
        vd = x_pad[tensors.d_idx[:, 0]] - x_pad[tensors.d_idx[:, 1]]
        v_th = tensors.d_n * VT_300K
        # the op converged at the true junction voltage; cap the exponent
        # only against overflow (vd beyond ~2 V never happens at an op)
        vd_c = np.minimum(vd, 2.0)
        ev = np.exp(vd_c / v_th)
        _, c = _host(diode_charge_cap, vd_c, tensors.d_is * (ev - 1.0),
                     np.maximum(tensors.d_is / v_th * ev, GMIN),
                     tensors.d_tt, tensors.d_cjo, tensors.d_vj,
                     tensors.d_m, tensors.d_fc)
        rows.append(tensors.d_idx)
        caps.append(c)
    if tensors.has_q_charge:
        qi = tensors.q_idx
        s = tensors.q_polarity
        g = tensors.q_chg
        vt = tensors.vt
        for pair, v_r, tt, cjo, vj, m in (
            (qi[:, [1, 2]],
             s * (x_pad[qi[:, 1]] - x_pad[qi[:, 2]]),
             g[:, 0], g[:, 2], g[:, 3], g[:, 4]),
            (qi[:, [1, 0]],
             s * (x_pad[qi[:, 1]] - x_pad[qi[:, 0]]),
             g[:, 1], g[:, 5], g[:, 6], g[:, 7]),
        ):
            v_c = np.minimum(v_r, 2.0)
            ev = np.exp(v_c / vt)
            _, c = _host(diode_charge_cap, v_c, tensors.q_is * (ev - 1.0),
                         np.maximum(tensors.q_is / vt * ev, GMIN),
                         tt, cjo, vj, m, g[:, 8])
            rows.append(pair.astype(np.int32))
            caps.append(c)
    if not rows:
        return np.zeros((0, 2), np.int32), np.zeros((0,))
    return (np.concatenate(rows, axis=0).astype(np.int32),
            np.concatenate(caps))


def op_linearized_extras(ckt: ParsedCircuit, tensors: CircuitTensors, op
                         ) -> tuple[np.ndarray, ...]:
    """The small-signal VCCS rows (the devices' and the B sources') and
    the C rows with the junction capacitances added, at the operating
    point ``op``: (ss_idx, ss_g, c_idx, c_vals), host arrays. Shared by AC
    ``linearize="op"`` and .noise."""
    ss_idx, ss_g = small_signal_rows(tensors, op)
    if ckt.B:
        bs_idx, bs_g = _bsource_small_signal(ckt, tensors, op)
        ss_idx = np.concatenate([ss_idx, bs_idx], axis=0)
        ss_g = np.concatenate([ss_g, bs_g], axis=0)
    c_idx_eff, c_vals_eff = tensors.c_idx, tensors.c_vals
    cj_idx, cj_vals = diode_smallsignal_caps(tensors, op)
    if cj_idx.shape[0]:
        c_idx_eff = np.concatenate([tensors.c_idx, cj_idx], axis=0)
        c_vals_eff = np.concatenate([tensors.c_vals, cj_vals])
    return ss_idx, ss_g, c_idx_eff, c_vals_eff


def index_tensor(a: np.ndarray, device: torch.device | str) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def batched_tl(tl: dict | None) -> dict | None:
    """The netlist's T lines (``ir.circuit.tl_arrays``) with a variants
    axis of 1 on Z0/Td, as ``_assemble_grid`` takes them."""
    if tl is None:
        return None
    return {"t_idx": tl["t_idx"], "z0": tl["z0"][None], "td": tl["td"][None]}


def simulate_ac(
    ckt: ParsedCircuit,
    tensors: CircuitTensors | None = None,
    method: str = "gj",
    linearize: str | None = None,
    device: torch.device | str | None = None,
) -> ACResult | None:
    """AC sweep in float64 on ``device`` (the card unless
    ``device="cpu"``). ``linearize=None`` (default) keeps reference
    parity: nonlinear devices are NOT stamped (simulateAC.ts:24-60). With
    ``linearize="op"`` the DC operating point is solved first and every
    diode/switch/MOSFET/BJT contributes its small-signal conductances and
    junction capacitances."""
    device = resolve_device(device)
    if ckt.ac is None:
        return None
    for r in ckt.R:
        if r.R <= 0:
            raise ValueError(f"R {r.name} must be > 0")
    if tensors is None:
        tensors = build_tensors(ckt)
    if linearize not in (None, "op"):
        raise ValueError("linearize must be None or 'op'")
    freqs = build_frequency_array(ckt.ac.mode, ckt.ac.N, ckt.ac.f1, ckt.ac.f2)
    v_idx_ac, v_re, v_im = ac_vsource_arrays(ckt, tensors)
    iph = tensors.i_ac_phase_deg * math.pi / 180.0
    f64 = torch.float64

    def vals(a: np.ndarray) -> torch.Tensor:
        # one variant: a leading batch axis of 1
        return torch.as_tensor(np.asarray(a, np.float64), dtype=f64,
                               device=device)[None]

    ext = ext_arrays(tensors, device, f64)
    c_idx_eff, c_vals_eff = tensors.c_idx, tensors.c_vals
    if linearize == "op":
        from .op import simulate_op

        op = simulate_op(ckt, tensors=tensors, method=method, device=device)
        ss_idx, ss_g, c_idx_eff, c_vals_eff = op_linearized_extras(
            ckt, tensors, op)
        ext["g_idx"] = torch.cat([ext["g_idx"],
                                  index_tensor(ss_idx, device)])
        ext["g_gm"] = torch.cat([ext["g_gm"], vals(ss_g)[0]])

    # the structured tier: forced by "schur", auto past N = 128 for "gj"
    plan = plan_for(method, ckt, tensors, tensors.nvar, device)

    def run(plan_arrays: dict | None) -> np.ndarray:
        x_re, x_im, valid = _ac_sweep_core(
            torch.as_tensor(freqs, dtype=f64, device=device),
            index_tensor(tensors.r_idx, device), vals(tensors.r_vals),
            index_tensor(c_idx_eff, device), vals(c_vals_eff),
            index_tensor(tensors.l_idx, device), vals(tensors.l_vals),
            index_tensor(v_idx_ac, device), vals(v_re), vals(v_im),
            tensors.nvar, method="gj" if method == "schur" else method,
            ext={k: (v if k.endswith("idx") else v[None])
                 for k, v in ext.items()},
            i_re=vals(tensors.i_ac_mag * np.cos(iph))[0],
            i_im=vals(tensors.i_ac_mag * np.sin(iph))[0],
            lk=lk_arrays(tensors, device, f64),
            tl=batched_tl(tl_arrays(tensors, device, f64)),
            plan=plan_arrays,
        )
        # one device->host transfer of the packed result
        return torch.cat([x_re[0], x_im[0], valid[0][:, None].to(f64)],
                         dim=1).cpu().numpy()

    packed = run(plan)
    if plan is not None and not bool(np.all(packed[:, -1] > 0.5)):
        # block-local pivoting failed where global pivoting may not:
        # retry the whole sweep dense before declaring it singular
        packed = run(None)
    nv = tensors.nvar
    if not bool(np.all(packed[:, -1] > 0.5)):
        raise ValueError("Singular matrix in AC solve")
    x = packed[:, :nv] + 1j * packed[:, nv:2 * nv]  # (F, nvar) c128

    node_voltages = {
        name: x[:, i] for i, name in enumerate(tensors.node_names)
    }
    if getattr(ckt, "ac_probes", None):
        # extended .print ac v(...): filter like the reference's tran
        # probe filter (canonical-casing keys kept)
        upper = {p.upper() for p in ckt.ac_probes}
        node_voltages = {
            name: series for name, series in node_voltages.items()
            if name.upper() in upper
        }
    element_currents = _element_currents(tensors, freqs, x)
    return ACResult(
        freqs=freqs,
        node_voltages=node_voltages,
        element_currents=element_currents,
    )
