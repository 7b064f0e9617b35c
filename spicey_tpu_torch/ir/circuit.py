"""Static tensorized circuit IR.

The reference walks per-element object lists and scatter-adds into freshly
allocated dense matrices on every frequency/timestep
(spicey/lib/analysis/simulateAC.ts:24-60,
 spicey/lib/analysis/simulateTRAN.ts:25-106). The TPU-native design
parses once into *static, device-type-segregated index/value arrays* so the
whole assembly becomes a handful of vectorized scatter-adds inside one
compiled program, with no Python in the hot path.

Ground handling: the reference's stamps guard every write with
``matrixIndexOfNode != -1`` (lib/stamping/stampAdmittanceReal.ts:10-28). Here
ground maps to a *dump slot* at index ``nvar`` of an (nvar+1)-sized padded
system; contributions to the dump row/column are simply sliced off. This turns
per-entry branching into branch-free scatter-adds — the XLA-friendly
formulation of the same contract.

MNA unknown ordering matches the reference (parseNetlist.ts:455-459): node
voltages 1..N-1 first (matrix index = node id - 1), then voltage-source branch
currents at ``n_node_vars + i``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..parsing.netlist import ParsedCircuit


@dataclass(frozen=True)
class CircuitTensors:
    """Immutable array-of-struct view of a parsed circuit."""

    nvar: int
    n_node_vars: int
    node_names: tuple[str, ...]  # non-ground canonical names, id order

    # analysis temperature (extended .temp; 300 K default). ``vt`` is the
    # thermal voltage kT/q at temp_k, normalized so temp_k=300 gives the
    # reference's exact VT_300K constant.
    temp_k: float
    vt: float

    # 2-terminal elements: matrix indices (nE, 2) with ground -> nvar (dump)
    r_idx: np.ndarray
    r_vals: np.ndarray
    r_names: tuple[str, ...]

    c_idx: np.ndarray
    c_vals: np.ndarray
    c_names: tuple[str, ...]

    l_idx: np.ndarray
    l_vals: np.ndarray
    l_names: tuple[str, ...]

    # mutual couplings (extended K lines): pairs of positions into the L
    # arrays + coupling coefficients. M[a,b] = k * sqrt(L[a] * L[b]).
    k_pairs: np.ndarray  # (nK, 2) int32
    k_vals: np.ndarray   # (nK,)
    k_names: tuple[str, ...]

    # voltage sources: (nV, 3) = [i1, i2, branch]; branch never ground
    v_idx: np.ndarray
    v_dc: np.ndarray
    v_ac_mag: np.ndarray
    v_ac_phase_deg: np.ndarray
    v_has_waveform: np.ndarray  # bool (nV,)
    v_names: tuple[str, ...]

    # switches: (nS, 4) = [i1, i2, ic_pos, ic_neg] dump-mapped.
    # Extended-dialect W (current-controlled) switches are folded into the
    # same arrays: their control pair is [ctrl_V_branch, dump], so the
    # engines' vctrl = x[ic_pos] - x[ic_neg] reads the controlling branch
    # current directly (a branch current IS an MNA unknown), and the
    # thresholds are von = It + Ih, voff = It - Ih. One code path drives
    # both switch families in every engine.
    s_idx: np.ndarray
    s_ron: np.ndarray
    s_roff: np.ndarray
    s_von: np.ndarray
    s_voff: np.ndarray
    s_names: tuple[str, ...]

    # diodes: (nD, 2) = [i_plus, i_minus] dump-mapped.
    # d_n is the EFFECTIVE emission coefficient N * (temp_k / 300): every
    # engine computes v_th = d_n * VT_300K, so folding .temp in here makes
    # all of them temperature-correct without touching the compiled cores.
    d_idx: np.ndarray
    d_is: np.ndarray
    d_n: np.ndarray
    d_kf: np.ndarray  # flicker noise coefficient (extended; .noise)
    d_af: np.ndarray  # flicker noise exponent
    # charge storage (extended TT/CJO/VJ/M/FC; all-zero TT+CJO = the
    # reference's memoryless diode and every engine's fast path)
    d_tt: np.ndarray
    d_cjo: np.ndarray
    d_vj: np.ndarray
    d_m: np.ndarray
    d_fc: np.ndarray
    d_names: tuple[str, ...]

    @property
    def has_d_charge(self) -> bool:
        return bool(self.d_tt.any() or self.d_cjo.any())

    # current sources (extended dialect): (nI, 2) = [i1, i2] dump-mapped
    i_idx: np.ndarray
    i_dc: np.ndarray
    i_ac_mag: np.ndarray
    i_ac_phase_deg: np.ndarray
    i_has_waveform: np.ndarray
    i_names: tuple[str, ...]

    # VCCS (extended dialect): (nG, 4) = [i1, i2, ic_pos, ic_neg] dump-mapped
    g_idx: np.ndarray
    g_gm: np.ndarray
    g_names: tuple[str, ...]

    # VCVS (extended dialect): (nE, 5) = [i1, i2, branch, ic_pos, ic_neg];
    # branch indices follow the V-source branches (parser post-pass)
    e_idx: np.ndarray
    e_gain: np.ndarray
    e_names: tuple[str, ...]

    # CCCS (extended dialect): (nF, 3) = [i1, i2, ctrl_branch]
    f_idx: np.ndarray
    f_gain: np.ndarray
    f_names: tuple[str, ...]

    # CCVS (extended dialect): (nH, 4) = [i1, i2, branch, ctrl_branch]
    h_idx: np.ndarray
    h_r: np.ndarray
    h_names: tuple[str, ...]

    # MOSFETs (extended dialect): (nM, 3) = [d, g, s] dump-mapped.
    # JFET channels lower into these arrays (the level-1 JFET square law is
    # the MOS law with beta_mos = 2*Beta and, for PJF, vto_mos = -Vto so the
    # reflected-frame overdrive matches SPICE's vgs_eff - Vto convention);
    # m_beta_scale records the lowering factor (2 for J rows, 1 for M rows)
    # so by-name batch overrides keep sweeping the *model's* Beta.
    m_idx: np.ndarray
    m_beta: np.ndarray       # Kp * W / L (M rows) | 2 * Beta (J rows)
    m_beta_scale: np.ndarray
    m_vto: np.ndarray
    m_lambda: np.ndarray
    m_polarity: np.ndarray   # +1 nmos/njf, -1 pmos/pjf
    m_kf: np.ndarray         # flicker noise coefficient (extended; .noise)
    m_af: np.ndarray
    m_names: tuple[str, ...]

    # transmission lines (extended T): (nT, 6) = [i1, i2, i3, i4, br1, br2]
    # — port nodes dump-mapped, branch columns never ground (Branin model,
    # two port-current unknowns per line after the Bv branches)
    t_idx: np.ndarray
    t_z0: np.ndarray
    t_td: np.ndarray
    t_names: tuple[str, ...]

    # BJTs (extended dialect): (nQ, 3) = [c, b, e] dump-mapped
    q_idx: np.ndarray
    q_is: np.ndarray
    q_bf: np.ndarray
    q_br: np.ndarray
    q_polarity: np.ndarray   # +1 npn, -1 pnp
    q_kf: np.ndarray         # flicker noise coefficient (extended; .noise)
    q_af: np.ndarray
    # charge storage (extended TF/TR/CJE/CJC...): (nQ, 9) packed
    # [tf, tr, cje, vje, mje, cjc, vjc, mjc, fc]
    q_chg: np.ndarray
    q_names: tuple[str, ...]

    @property
    def has_q_charge(self) -> bool:
        return bool(self.q_chg[:, [0, 1, 2, 5]].any()) if self.q_chg.size \
            else False

    @property
    def n_k(self) -> int:
        return self.k_pairs.shape[0]

    @property
    def n_r(self) -> int:
        return self.r_idx.shape[0]

    @property
    def n_c(self) -> int:
        return self.c_idx.shape[0]

    @property
    def n_l(self) -> int:
        return self.l_idx.shape[0]

    @property
    def n_v(self) -> int:
        return self.v_idx.shape[0]

    @property
    def n_s(self) -> int:
        return self.s_idx.shape[0]

    @property
    def n_d(self) -> int:
        return self.d_idx.shape[0]

    @property
    def n_i(self) -> int:
        return self.i_idx.shape[0]

    @property
    def n_g(self) -> int:
        return self.g_idx.shape[0]

    @property
    def n_e(self) -> int:
        return self.e_idx.shape[0]

    @property
    def n_f(self) -> int:
        return self.f_idx.shape[0]

    @property
    def n_h(self) -> int:
        return self.h_idx.shape[0]

    @property
    def n_m(self) -> int:
        return self.m_idx.shape[0]

    @property
    def n_t(self) -> int:
        return self.t_idx.shape[0]

    @property
    def n_q(self) -> int:
        return self.q_idx.shape[0]


def _or0(x: float) -> float:
    """JS ``x || 0``: NaN (and ±0) coerce to 0."""
    return 0.0 if (x != x or x == 0.0) else x


def build_tensors(ckt: ParsedCircuit) -> CircuitTensors:
    n_node_vars = ckt.n_node_vars
    nvar = ckt.n_vars
    dump = nvar

    def midx(node_id: int) -> int:
        return dump if node_id == 0 else node_id - 1

    def two_term(elems, attr):
        idx = np.asarray(
            [[midx(e.n1), midx(e.n2)] for e in elems], dtype=np.int32
        ).reshape(-1, 2)
        vals = np.asarray([getattr(e, attr) for e in elems], dtype=np.float64)
        names = tuple(e.name for e in elems)
        return idx, vals, names

    r_idx, r_vals, r_names = two_term(ckt.R, "R")
    c_idx, c_vals, c_names = two_term(ckt.C, "C")
    l_idx, l_vals, l_names = two_term(ckt.L, "L")

    # MOSFET gate-overlap (CGSO/CGDO per width) and JFET gate (CGS/CGD)
    # capacitances lower onto LINEAR C entries — every engine (tran
    # companions, AC susceptance, batch sweeps) then handles device
    # charge loading with zero new code paths. Names <dev>#cgs / <dev>#cgd.
    c_rows, c_v, c_n = list(c_idx), list(c_vals), list(c_names)
    for m in ckt.M:
        for tag, cap, other in (("cgs", m.model.Cgso * m.W, m.ns),
                                ("cgd", m.model.Cgdo * m.W, m.nd)):
            if cap > 0.0:
                c_rows.append([midx(m.ng), midx(other)])
                c_v.append(cap)
                c_n.append(f"{m.name}#{tag}")
    for j in ckt.J:
        for tag, cap, other in (("cgs", j.model.Cgs, j.ns),
                                ("cgd", j.model.Cgd, j.nd)):
            if cap > 0.0:
                c_rows.append([midx(j.ng), midx(other)])
                c_v.append(cap)
                c_n.append(f"{j.name}#{tag}")
    if len(c_n) > len(c_names):
        c_idx = np.asarray(c_rows, dtype=np.int32).reshape(-1, 2)
        c_vals = np.asarray(c_v, dtype=np.float64)
        c_names = tuple(c_n)

    temp_k = ckt.temp_kelvin
    # resistor temperature coefficients (extended tc1=/tc2=): folded into
    # the IR values so every engine sees R(T)
    if ckt.R and temp_k != 300.0:
        d_t = temp_k - 300.0
        tc1 = np.asarray([r.tc1 for r in ckt.R], dtype=np.float64)
        tc2 = np.asarray([r.tc2 for r in ckt.R], dtype=np.float64)
        r_vals = r_vals * (1.0 + tc1 * d_t + tc2 * d_t * d_t)
    from ..constants import VT_300K
    vt = VT_300K * temp_k / 300.0

    k_pairs = np.asarray(
        [[kc.l1_pos, kc.l2_pos] for kc in ckt.K], dtype=np.int32
    ).reshape(-1, 2)
    k_vals = np.asarray([kc.k for kc in ckt.K], dtype=np.float64)
    k_names = tuple(kc.name for kc in ckt.K)

    v_idx = np.asarray(
        [[midx(v.n1), midx(v.n2), v.index] for v in ckt.V], dtype=np.int32
    ).reshape(-1, 3)
    v_dc = np.asarray([v.dc for v in ckt.V], dtype=np.float64)
    v_ac_mag = np.asarray([_or0(v.ac_mag) for v in ckt.V], dtype=np.float64)
    v_ac_phase = np.asarray([_or0(v.ac_phase_deg) for v in ckt.V], dtype=np.float64)
    v_has_wave = np.asarray([v.waveform is not None for v in ckt.V], dtype=bool)
    v_names = tuple(v.name for v in ckt.V)

    # S rows first, then W rows encoded as [i1, i2, ctrl_branch, dump]
    # (vctrl = x[branch] - 0 = the controlling current) with the CSW
    # hysteresis window mapped onto the Von/Voff thresholds.
    s_rows = [[midx(s.n1), midx(s.n2), midx(s.nc_pos), midx(s.nc_neg)]
              for s in ckt.S]
    s_rows += [[midx(w.n1), midx(w.n2), w.ctrl_index, dump] for w in ckt.W]
    s_idx = np.asarray(s_rows, dtype=np.int32).reshape(-1, 4)
    s_ron = np.asarray([s.model.Ron for s in ckt.S]
                       + [w.model.Ron for w in ckt.W], dtype=np.float64)
    s_roff = np.asarray([s.model.Roff for s in ckt.S]
                        + [w.model.Roff for w in ckt.W], dtype=np.float64)
    s_von = np.asarray([s.model.Von for s in ckt.S]
                       + [w.model.It + w.model.Ih for w in ckt.W],
                       dtype=np.float64)
    s_voff = np.asarray([s.model.Voff for s in ckt.S]
                        + [w.model.It - w.model.Ih for w in ckt.W],
                        dtype=np.float64)
    s_names = tuple(s.name for s in ckt.S) + tuple(w.name for w in ckt.W)

    # JFET gate junctions lower into the diode arrays: for NJF the
    # gate-channel PN junction's anode is the gate (conducts when vgs/vgd
    # go positive); PJF reverses anode/cathode. Synthetic names <j>#gs /
    # <j>#gd surface the gate currents in element-current results.
    d_rows = [[midx(d.n_plus), midx(d.n_minus)] for d in ckt.D]
    d_is_l = [d.model.Is for d in ckt.D]
    d_n_l = [d.model.N for d in ckt.D]
    d_kf_l = [d.model.KF for d in ckt.D]
    d_af_l = [d.model.AF for d in ckt.D]
    d_tt_l = [d.model.TT for d in ckt.D]
    d_cjo_l = [d.model.CJO for d in ckt.D]
    d_vj_l = [d.model.VJ for d in ckt.D]
    d_m_l = [d.model.M for d in ckt.D]
    d_fc_l = [d.model.FC for d in ckt.D]
    d_names_l = [d.name for d in ckt.D]
    for j in ckt.J:
        g, dnode, snode = midx(j.ng), midx(j.nd), midx(j.ns)
        for tag, chan in (("gs", snode), ("gd", dnode)):
            if j.model.polarity >= 0:
                d_rows.append([g, chan])
            else:
                d_rows.append([chan, g])
            d_is_l.append(j.model.Is)
            d_n_l.append(1.0)
            d_kf_l.append(0.0)
            d_af_l.append(1.0)
            d_tt_l.append(0.0)
            d_cjo_l.append(0.0)
            d_vj_l.append(1.0)
            d_m_l.append(0.5)
            d_fc_l.append(0.5)
            d_names_l.append(f"{j.name}#{tag}")
    d_idx = np.asarray(d_rows, dtype=np.int32).reshape(-1, 2)
    d_is = np.asarray(d_is_l, dtype=np.float64)
    if ckt.D and temp_k != 300.0:
        # SPICE Is(T) scaling (extended .temp): Is(T) = Is * (T/Tnom)^(XTI/N)
        # * exp(-EG/(N*vt(T)) * (1 - T/Tnom)); at Tnom=300 it is exactly Is.
        # Only real D elements scale (lowered JFET gate rows keep their Is).
        n_real_d = len(ckt.D)
        eg = np.asarray([d.model.EG for d in ckt.D])
        xti = np.asarray([d.model.XTI for d in ckt.D])
        n_em = np.asarray([d.model.N for d in ckt.D])
        ratio = temp_k / 300.0
        d_is[:n_real_d] = d_is[:n_real_d] * ratio ** (xti / n_em) * np.exp(
            -eg / (n_em * vt) * (1.0 - ratio))
    # effective N * (T/300): engines compute v_th = d_n * VT_300K, so this
    # folds .temp into every diode path (see CircuitTensors docstring)
    d_n = np.asarray(d_n_l, dtype=np.float64) * (temp_k / 300.0)
    d_kf = np.asarray(d_kf_l, dtype=np.float64)
    d_af = np.asarray(d_af_l, dtype=np.float64)
    d_tt = np.asarray(d_tt_l, dtype=np.float64)
    d_cjo = np.asarray(d_cjo_l, dtype=np.float64)
    d_vj = np.asarray(d_vj_l, dtype=np.float64)
    d_m = np.asarray(d_m_l, dtype=np.float64)
    d_fc = np.asarray(d_fc_l, dtype=np.float64)
    d_names = tuple(d_names_l)

    i_idx = np.asarray(
        [[midx(s.n1), midx(s.n2)] for s in ckt.I], dtype=np.int32
    ).reshape(-1, 2)
    i_dc = np.asarray([s.dc for s in ckt.I], dtype=np.float64)
    i_ac_mag = np.asarray([_or0(s.ac_mag) for s in ckt.I], dtype=np.float64)
    i_ac_phase = np.asarray(
        [_or0(s.ac_phase_deg) for s in ckt.I], dtype=np.float64
    )
    i_has_wave = np.asarray([s.waveform is not None for s in ckt.I], dtype=bool)
    i_names = tuple(s.name for s in ckt.I)

    g_idx = np.asarray(
        [[midx(g.n1), midx(g.n2), midx(g.nc_pos), midx(g.nc_neg)]
         for g in ckt.G], dtype=np.int32
    ).reshape(-1, 4)
    g_gm = np.asarray([g.gm for g in ckt.G], dtype=np.float64)
    g_names = tuple(g.name for g in ckt.G)

    e_idx = np.asarray(
        [[midx(e.n1), midx(e.n2), e.index, midx(e.nc_pos), midx(e.nc_neg)]
         for e in ckt.E], dtype=np.int32
    ).reshape(-1, 5)
    e_gain = np.asarray([e.gain for e in ckt.E], dtype=np.float64)
    e_names = tuple(e.name for e in ckt.E)

    f_idx = np.asarray(
        [[midx(f.n1), midx(f.n2), f.ctrl_index] for f in ckt.F],
        dtype=np.int32,
    ).reshape(-1, 3)
    f_gain = np.asarray([f.gain for f in ckt.F], dtype=np.float64)
    f_names = tuple(f.name for f in ckt.F)

    h_idx = np.asarray(
        [[midx(h.n1), midx(h.n2), h.index, h.ctrl_index] for h in ckt.H],
        dtype=np.int32,
    ).reshape(-1, 4)
    h_r = np.asarray([h.r for h in ckt.H], dtype=np.float64)
    h_names = tuple(h.name for h in ckt.H)

    m_idx = np.asarray(
        [[midx(m.nd), midx(m.ng), midx(m.ns)] for m in ckt.M]
        + [[midx(j.nd), midx(j.ng), midx(j.ns)] for j in ckt.J],
        dtype=np.int32,
    ).reshape(-1, 3)
    m_beta = np.asarray(
        [m.model.Kp * m.W / m.L for m in ckt.M]
        + [2.0 * j.model.Beta for j in ckt.J], dtype=np.float64)
    m_beta_scale = np.asarray(
        [1.0] * len(ckt.M) + [2.0] * len(ckt.J), dtype=np.float64)
    # PJF keeps SPICE's negative-as-given Vto but evaluates the overdrive on
    # reflected voltages (vov = -vgs - Vto); the MOS kernel's convention is
    # vov = s*vgs - s*vto, so J rows store s*Vto
    m_vto = np.asarray(
        [m.model.Vto for m in ckt.M]
        + [j.model.polarity * j.model.Vto for j in ckt.J], dtype=np.float64)
    m_lambda = np.asarray(
        [m.model.Lambda for m in ckt.M]
        + [j.model.Lambda for j in ckt.J], dtype=np.float64)
    m_polarity = np.asarray(
        [m.model.polarity for m in ckt.M]
        + [j.model.polarity for j in ckt.J], dtype=np.float64)
    m_kf = np.asarray(
        [m.model.KF for m in ckt.M]
        + [j.model.KF for j in ckt.J], dtype=np.float64)
    m_af = np.asarray(
        [m.model.AF for m in ckt.M]
        + [j.model.AF for j in ckt.J], dtype=np.float64)
    m_names = tuple(m.name for m in ckt.M) + tuple(j.name for j in ckt.J)

    t_idx = np.asarray(
        [[midx(tl.n1), midx(tl.n2), midx(tl.n3), midx(tl.n4),
          tl.index, tl.index + 1] for tl in ckt.T], dtype=np.int32,
    ).reshape(-1, 6)
    t_z0 = np.asarray([tl.z0 for tl in ckt.T], dtype=np.float64)
    t_td = np.asarray([tl.td for tl in ckt.T], dtype=np.float64)
    t_names = tuple(tl.name for tl in ckt.T)

    q_idx = np.asarray(
        [[midx(q.nc), midx(q.nb), midx(q.ne)] for q in ckt.Q],
        dtype=np.int32,
    ).reshape(-1, 3)
    q_is = np.asarray([q.model.Is for q in ckt.Q], dtype=np.float64)
    if ckt.Q and temp_k != 300.0:
        # BJT Is(T): same SPICE law as the diode with emission N = 1
        eg_q = np.asarray([q.model.EG for q in ckt.Q])
        xti_q = np.asarray([q.model.XTI for q in ckt.Q])
        ratio = temp_k / 300.0
        q_is = q_is * ratio ** xti_q * np.exp(-eg_q / vt * (1.0 - ratio))
    q_bf = np.asarray([q.model.Bf for q in ckt.Q], dtype=np.float64)
    q_br = np.asarray([q.model.Br for q in ckt.Q], dtype=np.float64)
    q_polarity = np.asarray(
        [q.model.polarity for q in ckt.Q], dtype=np.float64)
    q_kf = np.asarray([q.model.KF for q in ckt.Q], dtype=np.float64)
    q_af = np.asarray([q.model.AF for q in ckt.Q], dtype=np.float64)
    q_chg = np.asarray(
        [[q.model.TF, q.model.TR, q.model.CJE, q.model.VJE, q.model.MJE,
          q.model.CJC, q.model.VJC, q.model.MJC, q.model.FC]
         for q in ckt.Q], dtype=np.float64).reshape(-1, 9)
    q_names = tuple(q.name for q in ckt.Q)

    return CircuitTensors(
        nvar=nvar,
        n_node_vars=n_node_vars,
        node_names=tuple(ckt.nodes.rev[1:]),
        temp_k=temp_k, vt=vt,
        r_idx=r_idx, r_vals=r_vals, r_names=r_names,
        c_idx=c_idx, c_vals=c_vals, c_names=c_names,
        l_idx=l_idx, l_vals=l_vals, l_names=l_names,
        k_pairs=k_pairs, k_vals=k_vals, k_names=k_names,
        v_idx=v_idx, v_dc=v_dc, v_ac_mag=v_ac_mag,
        v_ac_phase_deg=v_ac_phase, v_has_waveform=v_has_wave, v_names=v_names,
        s_idx=s_idx, s_ron=s_ron, s_roff=s_roff, s_von=s_von, s_voff=s_voff,
        s_names=s_names,
        d_idx=d_idx, d_is=d_is, d_n=d_n, d_kf=d_kf, d_af=d_af,
        d_tt=d_tt, d_cjo=d_cjo, d_vj=d_vj, d_m=d_m, d_fc=d_fc,
        d_names=d_names,
        i_idx=i_idx, i_dc=i_dc, i_ac_mag=i_ac_mag,
        i_ac_phase_deg=i_ac_phase, i_has_waveform=i_has_wave, i_names=i_names,
        g_idx=g_idx, g_gm=g_gm, g_names=g_names,
        e_idx=e_idx, e_gain=e_gain, e_names=e_names,
        f_idx=f_idx, f_gain=f_gain, f_names=f_names,
        h_idx=h_idx, h_r=h_r, h_names=h_names,
        m_idx=m_idx, m_beta=m_beta, m_beta_scale=m_beta_scale, m_vto=m_vto,
        m_lambda=m_lambda,
        m_polarity=m_polarity, m_kf=m_kf, m_af=m_af, m_names=m_names,
        t_idx=t_idx, t_z0=t_z0, t_td=t_td, t_names=t_names,
        q_idx=q_idx, q_is=q_is, q_bf=q_bf, q_br=q_br,
        q_polarity=q_polarity, q_kf=q_kf, q_af=q_af, q_chg=q_chg,
        q_names=q_names,
    )


def ext_arrays(tensors: CircuitTensors, device: torch.device | str,
               dtype: torch.dtype = torch.float64,
               dump: int | None = None) -> dict:
    """Extended-dialect element arrays as one dict of tensors on ``device``.

    ``dump`` re-targets the ground dump slot for systems sized differently
    from the tran/AC ordering (the .op system appends inductor branches);
    branch-index columns are never the dump slot, so a blanket remap is safe.
    Index arrays are int64 (torch's index type); value arrays are ``dtype``
    so precision tiers propagate.
    """
    def idx(a):
        if dump is not None:
            a = np.where(a == tensors.nvar, dump, a)
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def val(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    return {
        "i_idx": idx(tensors.i_idx),
        "g_idx": idx(tensors.g_idx), "g_gm": val(tensors.g_gm),
        "e_idx": idx(tensors.e_idx), "e_gain": val(tensors.e_gain),
        "f_idx": idx(tensors.f_idx), "f_gain": val(tensors.f_gain),
        "h_idx": idx(tensors.h_idx), "h_r": val(tensors.h_r),
    }


def bv_branch_rows(ckt: ParsedCircuit, dump: int) -> np.ndarray:
    """(nBv, 3) = [i1, i2, branch] rows for V-kind behavioral sources —
    the voltage-source stamp pattern their branch unknowns occupy (the AC
    sweep stamps them as 0 V small-signal shorts)."""
    def midx(node_id: int) -> int:
        return dump if node_id == 0 else node_id - 1

    rows = [[midx(b.n1), midx(b.n2), b.index]
            for b in ckt.B if b.kind == "v"]
    return np.asarray(rows, dtype=np.int32).reshape(-1, 3)


def bsrc_static(ckt: ParsedCircuit, dump: int) -> tuple:
    """The behavioral (B) sources for one system size, each as (kind, fn,
    i1, i2, branch_or_-1, ((ref_a, ref_b), ...)) with ``fn`` the
    expression compiled over torch functions (parsing/bexpr.py). Index
    pairs are computed against a system whose ground dump slot is ``dump``
    (tran/AC: tensors.nvar; .op: nvar_op), so the same parsed circuit
    serves every engine; references gather as vals[..., j] = x_pad[a_j] -
    x_pad[b_j] (a branch reference pairs with the dump slot, which reads
    0). An empty tuple when the deck has none."""
    from ..parsing.bexpr import compile_bexpr

    def midx(node_id: int) -> int:
        return dump if node_id == 0 else node_id - 1

    return tuple((b.kind, compile_bexpr(b.expr, backend="torch")[1],
                  midx(b.n1), midx(b.n2), b.index if b.kind == "v" else -1,
                  bsrc_refs(b, dump)) for b in ckt.B)


def bsrc_refs(b: object, dump: int) -> tuple:
    """A B source's references as index pairs ((a, b), ...) into a
    system whose ground dump slot is ``dump``: a node-pair reference
    gathers x_pad[a] - x_pad[b], a branch reference pairs its unknown with
    the dump slot, which reads 0."""
    def midx(node_id: int) -> int:
        return dump if node_id == 0 else node_id - 1

    return tuple((midx(a), midx(b2)) if kind == "nodes" else (a, dump)
                 for kind, a, b2 in b.ref_pairs)


def tl_arrays(tensors: CircuitTensors, device: torch.device | str,
              dtype: torch.dtype = torch.float64,
              dump: int | None = None) -> dict | None:
    """Transmission lines (extended T) as a dict of tensors on ``device``,
    or None when the deck has none (every engine's no-lines path): the
    (nT, 6) index rows [i1, i2, i3, i4, br1, br2] (int64, the ground slot
    re-targeted to ``dump`` as in ``ext_arrays``) and the Z0 and Td
    values."""
    if tensors.n_t == 0:
        return None
    idx = tensors.t_idx
    if dump is not None:
        idx = np.where(idx == tensors.nvar, dump, idx)
    return {
        "t_idx": torch.as_tensor(np.asarray(idx, np.int64), device=device),
        "z0": torch.as_tensor(np.asarray(tensors.t_z0, np.float64),
                              dtype=dtype, device=device),
        "td": torch.as_tensor(np.asarray(tensors.t_td, np.float64),
                              dtype=dtype, device=device),
    }


def lk_arrays(tensors: CircuitTensors, device: torch.device | str,
              dtype: torch.dtype = torch.float64) -> dict | None:
    """Mutual couplings (extended K) as a dict of tensors on ``device``,
    or None when the deck has none (the scalar per-inductor companion):
    the (nK, 2) pairs of positions into the L arrays (int64) and the
    coupling coefficients. A dict switches the engines to the matrix
    companion Gamma = c * M^{-1} (analysis/tran.py, analysis/ac.py)."""
    if tensors.n_k == 0:
        return None
    return {
        "k_pairs": torch.as_tensor(np.asarray(tensors.k_pairs, np.int64),
                                   device=device),
        "k_vals": torch.as_tensor(np.asarray(tensors.k_vals, np.float64),
                                  dtype=dtype, device=device),
    }


def from_jax_tensors(t: object) -> CircuitTensors:
    """The JAX package's ``CircuitTensors`` as this package's.

    Both IRs hold host NumPy arrays and Python scalars, so the conversion
    copies fields by name. The field sets must match exactly: drift in
    either IR raises here instead of silently dropping a field."""
    mine = [f.name for f in dataclasses.fields(CircuitTensors)]
    theirs = [f.name for f in dataclasses.fields(t)]
    if mine != theirs:
        raise ValueError(
            "CircuitTensors field sets differ: "
            f"only here {sorted(set(mine) - set(theirs))}, "
            f"only there {sorted(set(theirs) - set(mine))}")
    return CircuitTensors(**{n: getattr(t, n) for n in mine})


def nl_arrays(tensors: CircuitTensors, device: torch.device | str,
              dtype: torch.dtype = torch.float64,
              dump: int | None = None) -> dict:
    """Nonlinear extended-device arrays (MOSFET/BJT) as one dict, with the
    thermal voltage at the circuit's .temp (``vt``, which also scales the
    junction clamp window ``[-1.0, 0.8] * vt / VT_300K``). Index arrays
    are int64, values ``dtype``; ``dump`` re-targets the ground slot as in
    ``ext_arrays``."""
    def idx(a: np.ndarray) -> torch.Tensor:
        if dump is not None:
            a = np.where(a == tensors.nvar, dump, a)
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def val(a: object) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    return {
        "m_idx": idx(tensors.m_idx), "m_beta": val(tensors.m_beta),
        "m_vto": val(tensors.m_vto), "m_lambda": val(tensors.m_lambda),
        "m_pol": val(tensors.m_polarity),
        "q_idx": idx(tensors.q_idx), "q_is": val(tensors.q_is),
        "q_bf": val(tensors.q_bf), "q_br": val(tensors.q_br),
        "q_pol": val(tensors.q_polarity),
        "vt": val(tensors.vt),
    }


def dchg_arrays(tensors: CircuitTensors, device: torch.device | str,
                dtype: torch.dtype = torch.float64) -> dict | None:
    """Diode charge storage (TT, CJO, VJ, M, FC per diode), or None when
    every TT and CJO is 0: the reference's memoryless diode."""
    if not tensors.has_d_charge:
        return None
    return {k: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)
            for k, a in (("tt", tensors.d_tt), ("cjo", tensors.d_cjo),
                         ("vj", tensors.d_vj), ("m", tensors.d_m),
                         ("fc", tensors.d_fc))}


def qchg_arrays(tensors: CircuitTensors, device: torch.device | str,
                dtype: torch.dtype = torch.float64) -> dict | None:
    """BJT junction charge, or None when every TF/TR/CJE/CJC is 0: the
    columns of ``q_chg`` shaped for ``diode_charge_cap``, the b-e
    junction with (tf, cje, vje, mje), the b-c junction with (tr, cjc,
    vjc, mjc), fc shared."""
    if not tensors.has_q_charge:
        return None
    g = np.asarray(tensors.q_chg, np.float64)
    names = ("tf", "tr", "cje", "vje", "mje", "cjc", "vjc", "mjc", "fc")
    return {k: torch.as_tensor(g[:, i], dtype=dtype, device=device)
            for i, k in enumerate(names)}


def sample_source_values(ckt: ParsedCircuit, times: np.ndarray) -> np.ndarray:
    """Every independent-source value over the whole time grid.

    Mirrors ``vs.waveform ? vs.waveform(t) : vs.dc || 0``
    (spicey/lib/analysis/simulateTRAN.ts:66-69), vectorized so the time
    loop indexes a (steps+1, nV+nI) array instead of calling Python.
    Columns are V sources first, then extended-dialect I sources.
    """
    times = np.asarray(times, dtype=np.float64)
    cols = []
    for src in list(ckt.V) + list(ckt.I):
        if src.waveform is not None:
            cols.append(src.waveform.sample(times))
        else:
            cols.append(np.full(times.shape, _or0(src.dc), dtype=np.float64))
    if not cols:
        return np.zeros((times.shape[0], 0), dtype=np.float64)
    return np.stack(cols, axis=1)


def effective_time_step(dt_requested: float, tstop: float) -> tuple[float, int]:
    """Timestep policy (spicey/lib/analysis/simulateTRAN.ts:14-19)."""
    from ..constants import EPS

    dt_eff = dt_requested if dt_requested > EPS else max(tstop / 1000.0, EPS)
    steps = max(1, math.ceil(tstop / max(dt_eff, EPS)))
    dt = tstop / steps if steps > 0 else tstop
    return dt, steps
