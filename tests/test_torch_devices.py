"""The port's device models against the JAX package's, on the CPU.

``spicey_tpu_torch.models.devices`` (mos_level1, diode_charge_cap,
bjt_ebers_moll) against ``spicey_tpu.models.devices`` in float64 at rtol
1e-12, on voltage grids made from a seed with numpy. The grids cover
cutoff, saturation, triode and the drain/source swap, NMOS and PMOS (and
the JFET lowering's parameters), NPN and PNP inside and beyond the
junction clamp, the depletion charge below and above fc*vj, and the
all-zero TT/CJO diode.
"""

import numpy as np
import pytest
import torch

from spicey_tpu.models import devices as jdev
from spicey_tpu_torch.constants import VT_300K
from spicey_tpu_torch.models import devices as tdev

RTOL = 1e-12


def _close(got, want):
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=RTOL * float(np.abs(w).max() + 1e-300),
                                   err_msg=f"output {k}")


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


# (vto, beta, lambda, polarity): NMOS, PMOS (Vto < 0), an N-channel JFET
# lowered to level 1 (Vto < 0, beta 2x the model's), a lambda-free PMOS
MOS = {"nmos": (1.0, 2e-3, 0.02, 1.0), "pmos": (-1.0, 2e-3, 0.02, -1.0),
       "njf": (-2.0, 2e-4, 0.0, 1.0), "pmos_nolam": (-0.7, 5e-4, 0.0, -1.0)}


@pytest.mark.parametrize("kind", sorted(MOS))
def test_mos_level1_matches_jax(kind):
    vto, beta, lam, pol = MOS[kind]
    rng = np.random.default_rng(1)
    # (B, nM) grids over both signs: cutoff, saturation, triode, vds < 0
    vgs = rng.uniform(-6.0, 6.0, (64, 3))
    vds = rng.uniform(-6.0, 6.0, (64, 3))
    vgs[:4] = pol * np.array([[vto - 0.5], [vto + 1.0], [vto + 3.0],
                              [vto + 2.0]])
    vds[:4] = pol * np.array([[1.0], [2.0], [0.5], [-1.5]])
    p = [np.full(3, v) for v in (beta, vto, lam, pol)]
    got = tdev.mos_level1(_t(vgs), _t(vds), *[_t(a) for a in p])
    want = jdev.mos_level1(vgs, vds, *p)
    _close(got, want)
    # the three regions and the swap all occur on this grid
    vov = pol * vgs - pol * vto
    assert (vov <= 0).any() and (pol * vds < 0).any()
    fwd = (vov > 0) & (pol * vds > 0)
    assert (fwd & (pol * vds >= vov)).any() and (fwd & (pol * vds < vov)).any()


def test_mos_level1_takes_a_float_polarity():
    rng = np.random.default_rng(2)
    vgs, vds = rng.uniform(-5, 5, (2, 32))
    got = tdev.mos_level1(_t(vgs), _t(vds), _t(1e-3), _t(0.8), _t(0.01), 1.0)
    want = jdev.mos_level1(vgs, vds, 1e-3, 0.8, 0.01, 1.0)
    _close(got, want)


# (tt, cjo, vj, m, fc)
CHARGE = {"tt_and_cjo": (10e-9, 10e-12, 0.7, 0.5, 0.5),
          "cjo_only": (0.0, 2e-12, 0.8, 0.33, 0.5),
          "tt_only": (5e-9, 0.0, 1.0, 0.5, 0.5),
          "memoryless": (0.0, 0.0, 1.0, 0.5, 0.5),
          "steep_m": (1e-9, 5e-12, 0.6, 0.9, 0.8)}


@pytest.mark.parametrize("kind", sorted(CHARGE))
def test_diode_charge_cap_matches_jax(kind):
    tt, cjo, vj, m, fc = CHARGE[kind]
    rng = np.random.default_rng(3)
    vd = np.concatenate([rng.uniform(-8.0, 1.2, 200),
                         [fc * vj - 1e-6, fc * vj, fc * vj + 1e-6,
                          vj, 5 * vj]])[None, :].repeat(2, 0)
    is_, n = 1e-14, 1.0
    vd_l = np.clip(vd, -1.0, 0.8)
    ev = np.exp(vd_l / (n * VT_300K))
    i_d, g_d = is_ * (ev - 1.0), np.maximum(is_ / (n * VT_300K) * ev, 1e-12)
    args = [np.full(vd.shape[1], v) for v in (tt, cjo, vj, m, fc)]
    got = tdev.diode_charge_cap(_t(vd), _t(i_d), _t(g_d),
                                *[_t(a) for a in args])
    want = jdev.diode_charge_cap(vd, i_d, g_d, *args)
    _close(got, want)
    assert (vd < fc * vj).any() and (vd > fc * vj).any()
    if kind == "memoryless":
        assert not got[0].any() and not got[1].any()


# (polarity, vt, limited): NPN and PNP at 300 K, a hot NPN (the clamp
# window widens with T), and caller-limited junction voltages (.op)
BJT = {"npn": (1.0, VT_300K, False), "pnp": (-1.0, VT_300K, False),
       "npn_hot": (1.0, VT_300K * 400.0 / 300.0, False),
       "pnp_limited": (-1.0, VT_300K, True)}


@pytest.mark.parametrize("kind", sorted(BJT))
def test_bjt_ebers_moll_matches_jax(kind):
    pol, vt, limited = BJT[kind]
    rng = np.random.default_rng(4)
    # inside and beyond the [-1.0, 0.8] window, forward and reverse active
    vbe = pol * rng.uniform(-2.0, 1.3, (50, 2))
    vbc = pol * rng.uniform(-6.0, 1.1, (50, 2))
    p = [np.array([1e-15, 1e-16]), np.array([100.0, 50.0]),
         np.array([1.0, 2.0]), np.full(2, pol)]
    kw = {}
    if limited:
        kw = {"vbe_lim": np.clip(pol * vbe, -1.0, 0.75),
              "vbc_lim": np.clip(pol * vbc, -1.0, 0.75)}
    got = tdev.bjt_ebers_moll(_t(vbe), _t(vbc), *[_t(a) for a in p],
                              vt=vt, **{k: _t(v) for k, v in kw.items()})
    want = jdev.bjt_ebers_moll(vbe, vbc, *p, vt=vt, **kw)
    _close(got, want)
    assert (pol * vbe > 0.8 * vt / VT_300K).any()  # the clamp engages
    assert (pol * vbc < -1.0).any()


def test_bjt_takes_a_tensor_thermal_voltage():
    """The transient passes ``vt`` as a 0-d tensor (nl_arrays)."""
    rng = np.random.default_rng(5)
    vbe, vbc = rng.uniform(-1.5, 1.0, (2, 16, 1))
    p = [np.array([1e-15]), np.array([80.0]), np.array([3.0]),
         np.array([1.0])]
    vt = VT_300K * 350.0 / 300.0
    got = tdev.bjt_ebers_moll(_t(vbe), _t(vbc), *[_t(a) for a in p],
                              vt=torch.tensor(vt, dtype=torch.float64))
    want = jdev.bjt_ebers_moll(vbe, vbc, *p, vt=vt)
    _close(got, want)
