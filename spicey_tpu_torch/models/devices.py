"""Nonlinear device linearizations: MOSFET level-1, BJT Ebers-Moll and the
diode junction charge, as plain torch functions.

The JAX package's spicey_tpu/models/devices.py:34-173, carried over
without its ``xp`` switch and its ``accurate_exp`` (a TPU lowering
workaround, ROADMAP §1 item 10): every function takes tensors of any
leading shape, ending in the device axis, and broadcasts. Python floats
never meet ``torch.maximum`` (it refuses them): floors are ``clamp_min``
and selects ``torch.where`` on tensors or scalars.

Conventions, as in the JAX package:
  - device polarity is a ±1 "type" tensor (NMOS/NPN = +1, PMOS/PNP = -1);
    the equations run in the reflected (+1) frame and currents map back
    by the type sign;
  - conductances get a GMIN floor (simulateTRAN.ts:95), so a device in
    cutoff never makes the system singular;
  - BJT junctions clamp to the diode window [-1.0, +0.8] V x T/300
    (simulateTRAN.ts:89-91) unless the caller passes limited voltages;
    the MOSFET square law needs no limiting.
"""

from __future__ import annotations

import torch

from ..constants import DIODE_VD_MAX, DIODE_VD_MIN, GMIN, VT_300K


def mos_level1(vgs: torch.Tensor, vds: torch.Tensor, beta: torch.Tensor,
               vto: torch.Tensor, lam: torch.Tensor, mtype: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """MOSFET level-1 (Shichman-Hodges) linearization.

    vgs, vds: (..., nM) gate-source and drain-source voltages; beta =
    Kp*W/L; vto the threshold; lam the channel-length modulation; mtype
    ±1. Returns (gm, gds, i_eq, i_d) with i_d(vgs, vds) ~ gm*vgs +
    gds*vds + i_eq (drain to source), drain and source swapped for
    vds < 0."""
    s = mtype
    vgs_r = s * vgs
    vds_r = s * vds
    swap = vds_r < 0
    vgs_e = torch.where(swap, vgs_r - vds_r, vgs_r)  # = vgd when swapped
    vds_e = vds_r.abs()
    # an enhancement PMOS carries Vto < 0 and conducts when s*vgs > s*vto
    vov = vgs_e - s * vto
    cutoff = vov <= 0.0
    sat = vds_e >= vov
    one_lam = 1.0 + lam * vds_e

    id_sat = 0.5 * beta * vov * vov * one_lam
    id_tri = beta * (vov - 0.5 * vds_e) * vds_e * one_lam
    i_fwd = torch.where(cutoff, 0.0, torch.where(sat, id_sat, id_tri))
    gm_sat = beta * vov * one_lam
    gm_tri = beta * vds_e * one_lam
    gm_e = torch.where(cutoff, 0.0, torch.where(sat, gm_sat, gm_tri))
    gds_sat = 0.5 * beta * vov * vov * lam
    gds_tri = (beta * (vov - vds_e) * one_lam
               + beta * (vov - 0.5 * vds_e) * vds_e * lam)
    gds_e = torch.where(cutoff, 0.0, torch.where(sat, gds_sat, gds_tri))

    # the swapped frame maps back as i_d = -i_fwd, gm = -gm_e,
    # gds = gm_e + gds_e (chain rule through vgs_e = vgs_r - vds_r)
    i_r = torch.where(swap, -i_fwd, i_fwd)
    gm_r = torch.where(swap, -gm_e, gm_e)
    gds_r = torch.where(swap, gm_e + gds_e, gds_e).clamp_min(GMIN)
    # reflect to the physical frame: conductances are sign-invariant
    i_d = s * i_r
    i_eq = i_d - gm_r * vgs - gds_r * vds
    return gm_r, gds_r, i_eq, i_d


def diode_charge_cap(vd: torch.Tensor, i_d: torch.Tensor, g_d: torch.Tensor,
                     tt: torch.Tensor, cjo: torch.Tensor, vj: torch.Tensor,
                     m: torch.Tensor, fc: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """SPICE junction charge q(vd) and capacitance C(vd) = dq/dvd.

    ``vd`` is the TRUE junction voltage (the depletion charge must see
    reverse swings past the clamp window); ``i_d``/``g_d`` are the
    Shockley current and conductance at the limited voltage. Diffusion
    charge TT*i_d plus depletion: below fc*vj the closed form
    CJO*VJ/(1-M)*(1-(1-v/VJ)^(1-M)), above it SPICE's quadratic
    extension, continuous in q and C. All-zero TT and CJO give q = C = 0.
    """
    fcv = fc * vj
    below = vd < fcv
    arg = (1.0 - torch.where(below, vd, 0.0) / vj).clamp_min(1e-12)
    q_dep_b = cjo * vj / (1.0 - m) * (1.0 - arg ** (1.0 - m))
    c_dep_b = cjo * arg ** (-m)
    f1 = cjo * vj / (1.0 - m) * (1.0 - (1.0 - fc) ** (1.0 - m))
    c0 = cjo * (1.0 - fc) ** (-(1.0 + m))
    q_dep_a = f1 + c0 * ((1.0 - fc * (1.0 + m)) * (vd - fcv)
                         + m / (2.0 * vj) * (vd * vd - fcv * fcv))
    c_dep_a = c0 * (1.0 - fc * (1.0 + m) + m * vd / vj)
    q = tt * i_d + torch.where(below, q_dep_b, q_dep_a)
    c = tt * g_d + torch.where(below, c_dep_b, c_dep_a)
    return q, c


def bjt_ebers_moll(vbe: torch.Tensor, vbc: torch.Tensor, i_s: torch.Tensor,
                   bf: torch.Tensor, br: torch.Tensor, qtype: torch.Tensor,
                   vt: torch.Tensor | float = VT_300K,
                   vbe_lim: torch.Tensor | None = None,
                   vbc_lim: torch.Tensor | None = None) -> tuple:
    """BJT Ebers-Moll (transport form) linearization.

    vbe, vbc: (..., nQ) junction voltages; i_s the saturation current;
    bf/br the forward/reverse betas; qtype ±1 (NPN/PNP); vt the thermal
    voltage at the circuit's temperature. ``vbe_lim``/``vbc_lim``:
    reflected-frame junction voltages already limited by the caller (the
    operating-point Newton's pnjlim), replacing the absolute clamp.

    Returns (gbe, gbc, gmf, gmr, ibe_eq, ibc_eq, ict_eq, i_c, i_b):
    base-emitter diode i = gbe*vbe + ibe_eq, base-collector diode
    i = gbc*vbc + ibc_eq, transport source c->e i = gmf*vbe - gmr*vbc +
    ict_eq, and the full nonlinear collector and base currents."""
    s = qtype
    if vbe_lim is not None:
        vbe_l, vbc_l = vbe_lim, vbc_lim
    else:
        tscale = vt / VT_300K  # the clamp window scales with T
        lo, hi = DIODE_VD_MIN * tscale, DIODE_VD_MAX * tscale
        vbe_l = torch.clamp(s * vbe, lo, hi)
        vbc_l = torch.clamp(s * vbc, lo, hi)
    ebe = torch.exp(vbe_l / vt)
    ebc = torch.exp(vbc_l / vt)

    ibe = (i_s / bf) * (ebe - 1.0)
    ibc = (i_s / br) * (ebc - 1.0)
    ict = i_s * (ebe - ebc)
    gbe = ((i_s / bf) / vt * ebe).clamp_min(GMIN)
    gbc = ((i_s / br) / vt * ebc).clamp_min(GMIN)
    gmf = (i_s / vt * ebe).clamp_min(GMIN)
    gmr = (i_s / vt * ebc).clamp_min(GMIN)

    # equivalent sources in the reflected frame, flipped by the type sign
    ibe_eq = s * (ibe - gbe * vbe_l)
    ibc_eq = s * (ibc - gbc * vbc_l)
    ict_eq = s * (ict - gmf * vbe_l + gmr * vbc_l)
    i_c = s * (ict - ibc)
    i_b = s * (ibe + ibc)
    return gbe, gbc, gmf, gmr, ibe_eq, ibc_eq, ict_eq, i_c, i_b
