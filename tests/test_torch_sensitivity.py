"""The port's sensitivity_ac / sensitivity_tran against the JAX package.

Every deck of tests/test_sensitivity.py, the sensitivity cases of
tests/test_feature_interactions.py (B sources, T lines, POLY),
tests/test_coupling.py (the transformer, through M^-1) and
tests/test_bsource.py (the B-source smoke), and the boost converter with
three targets (switch, diode and Newton) go through
``spicey_tpu.sensitivity_*`` and ``spicey_tpu_torch.sensitivity_*(device=
"cpu")`` with the same tensors (``from_jax_tensors``); every
sensitivity is held at rtol 1e-9 with an atol of 1e-12 of the series'
largest |value|. The JAX package differentiates its plain Gauss-Jordan
natively; the port's tangents pass through the derivative rules of
ops/linsolve.py (one more solve with the same matrix), so the two agree
to rounding. The unknown-target and no-analysis errors are the JAX
package's.
"""

import numpy as np
import pytest

import spicey_tpu as sj
import spicey_tpu_torch as st
from spicey_tpu_torch import decks
from spicey_tpu_torch.ir.circuit import from_jax_tensors
from tests.test_feature_interactions import (BSRC_AC, BSRC_TRAN, TLINE_AC,
                                             TLINE_TRAN)

RC_AC = ("t\nv1 1 0 dc 0 ac 1\nr1 1 2 30\nc1 2 0 100u\n"
         ".ac dec 10 1 100\n")
RC_TRAN = ("t\nV1 1 0 PULSE(0 5 0 1n 1n 5u 10u)\nR1 1 2 1k\nC1 2 0 1u\n"
           ".tran 0.1u 20u\n")
POLY = ("x poly-loaded divider\n"
        "v1 in 0 dc 0 ac 1 PULSE(0 1 0 1u 1u 40u 100u)\n"
        "r1 in a 1k\n"
        "gp 0 a POLY(1) in 0 0 1m 2m\n"
        "c1 a 0 1u\n"
        ".tran 1u 20u\n"
        ".ac dec 5 10 1000\n"
        ".end\n")

# (deck, dialect, node, wrt, keyword arguments)
AC_CASES = {
    "rc_lowpass": (RC_AC, "spicey", "2", ["r1", "c1"], {}),
    "bsource": (BSRC_AC, "extended", "out", ["r1", "c1"], {}),
    "tline": (TLINE_AC, "extended", "b", ["rl", "rs"], {}),
    "poly": (POLY, "extended", "a", ["r1", "c1"], {}),
    "transformer": (decks.TRANSFORMER_AC, "extended", "s",
                    ["rload", "l1", "l2"], {}),
    "ladder_16": (decks.rc_ladder_netlist(16), "spicey", "n16",
                  ["r1", "c1", "r8", "c8", "r16", "c16", "v1"], {}),
}
TRAN_CASES = {
    "rc_pulse": (RC_TRAN, "spicey", "2", ["R1", "C1"], {}),
    "vsource_dc": ("t\nV1 1 0 dc 5\nR1 1 2 1k\nR2 2 0 1k\n.tran 1u 10u\n",
                   "spicey", "2", ["V1", "R2"], {}),
    "diode_rectifier": ("t\n.model dm d\nV1 in 0 PULSE(0 5 0 1u 1u 48u "
                        "100u)\nD1 in out dm\nR1 out 0 1k\n.tran 1u 100u\n",
                        "spicey", "out", ["R1"], {"nr": "converged"}),
    "bsource": (BSRC_TRAN, "extended", "out", ["r1", "c1"],
                {"nr": "converged"}),
    "bsource_smoke": ("t\nv1 in 0 1\nbl a 0 I=v(a)\nr1 in a 1\n"
                      ".tran 1u 10u\n.end\n", "extended", "a", ["r1"],
                      {"nr": "converged"}),
    "tline": (TLINE_TRAN, "extended", "b", ["rl"], {}),
    "poly": (POLY, "extended", "a", ["r1"], {"nr": "converged"}),
    "transformer": (decks.TRANSFORMER_TRAN.replace(".tran 2u 1m",
                                                   ".tran 2u 0.1m"),
                    "extended", "s", ["l1", "rload"], {}),
    "boost": (decks.BOOST_NET, "spicey", "N3", ["LL1", "CC1", "RR1"], {}),
    "rc_trap": (RC_TRAN, "spicey", "2", ["R1"], {"integration": "trap"}),
}


def _same(got: dict, want: dict, what: str) -> None:
    assert list(got) == list(want), what
    for name, w in want.items():
        w = np.asarray(w)
        g = np.asarray(got[name])
        assert g.shape == w.shape, f"{what} {name}"
        atol = 1e-12 * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=atol,
                                   err_msg=f"{what} {name}")


def _both(net: str, dialect: str):
    jc = sj.parse_netlist(net, dialect=dialect)
    return jc, st.parse_netlist(net, dialect=dialect), sj.build_tensors(jc)


@pytest.mark.parametrize("case", sorted(AC_CASES))
def test_sensitivity_ac_matches_jax(case):
    net, dialect, node, wrt, kw = AC_CASES[case]
    jc, tc, jt = _both(net, dialect)
    want = sj.sensitivity_ac(jc, node, wrt, tensors=jt, **kw)
    got = st.sensitivity_ac(tc, node, wrt, tensors=from_jax_tensors(jt),
                            device="cpu", **kw)
    _same(got, want, case)


@pytest.mark.parametrize("case", sorted(TRAN_CASES))
def test_sensitivity_tran_matches_jax(case):
    net, dialect, node, wrt, kw = TRAN_CASES[case]
    jc, tc, jt = _both(net, dialect)
    want = sj.sensitivity_tran(jc, node, wrt, tensors=jt, **kw)
    got = st.sensitivity_tran(tc, node, wrt, tensors=from_jax_tensors(jt),
                              device="cpu", **kw)
    _same(got, want, case)


def test_boost_sensitivities_at_the_end():
    """The boost converter's last values, as the JAX package gives them
    (3.54e-3, 452.0 and 2.67e-5)."""
    ckt = st.parse_netlist(decks.BOOST_NET)
    got = st.sensitivity_tran(ckt, "N3", ["LL1", "CC1", "RR1"], device="cpu")
    np.testing.assert_allclose([got[k][-1] for k in ("LL1", "CC1", "RR1")],
                               [3.5387e-3, 451.994, 2.66800e-5], rtol=1e-4)


def test_repeated_target_keeps_the_jax_semantics():
    """A name given twice: the JAX package's ``.at[].set`` sequence lets
    the last write win, so the first column is zero."""
    jc, tc, jt = _both(RC_AC, "spicey")
    want = sj.sensitivity_ac(jc, "2", ["r1", "R1"], tensors=jt)
    got = st.sensitivity_ac(tc, "2", ["r1", "R1"], device="cpu")
    _same(got, want, "repeated")
    assert not np.any(got["r1"]) and np.any(got["R1"])


def test_sensitivity_errors_match_jax():
    for mod, kw in ((sj, {}), (st, {"device": "cpu"})):
        with pytest.raises(ValueError, match="unknown sensitivity target"):
            mod.sensitivity_ac(mod.parse_netlist(RC_AC), "2", ["nope"], **kw)
        with pytest.raises(ValueError, match="netlist has no .tran"):
            mod.sensitivity_tran(mod.parse_netlist(RC_AC), "2", ["r1"], **kw)
        with pytest.raises(ValueError, match="netlist has no .ac"):
            mod.sensitivity_ac(mod.parse_netlist(RC_TRAN), "2", ["R1"], **kw)
