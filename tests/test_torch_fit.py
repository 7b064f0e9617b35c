"""The port's fit_ac / fit_tran against the JAX package on the CPU.

Every deck of tests/test_fit.py and the fit cases of
tests/test_feature_interactions.py (a T line's source resistor, a B-source
deck's resistor) go through ``spicey_tpu.fit_*`` and
``spicey_tpu_torch.fit_*(device="cpu")`` from the same start with the same
tensors. ``fit_ac`` is reverse mode in both packages (here through the
adjoint rule of K1's solve), ``fit_tran`` forward mode (one tangent lane
per parameter). Tolerances, stated: the loss history at rtol 1e-6 (the
JAX package's XLA arithmetic and torch's differ in the last bits of every
gradient, and Adam's steps carry that on), the fitted values at rtol 1e-7,
``converged`` equal. The transient fits run the decks' first
``TRAN_STEPS`` Adam steps (the port's forward-mode time loop costs ~0.3 s
a step on this CPU); ``chip_smoke.py`` phase 26 (e) runs 150 on the card.
"""

import numpy as np
import pytest

import spicey_tpu as sj
import spicey_tpu_torch as st
from spicey_tpu_torch.ir.circuit import from_jax_tensors
from tests.test_feature_interactions import BSRC_TRAN, TLINE_AC

TRAN_STEPS = 12
RC_AC_START = ("t\nv1 1 0 dc 0 ac 1\nr1 1 2 30\nc1 2 0 100u\n"
               ".ac dec 10 1 100\n")


def _target_ac(net, node, dialect="spicey"):
    return np.abs(sj.simulate_ac(sj.parse_netlist(
        net, dialect=dialect)).node_voltages[node])


def _target_tran(net, node, dialect="spicey"):
    return np.asarray(sj.simulate_tran(sj.parse_netlist(
        net, dialect=dialect)).node_voltages[node])


def _same(got, want, what):
    assert list(got.values) == list(want.values), what
    np.testing.assert_allclose(got.loss_history, want.loss_history,
                               rtol=1e-6, err_msg=f"{what} loss history")
    assert got.loss == got.loss_history[-1]
    for name, v in want.values.items():
        np.testing.assert_allclose(got.values[name], v, rtol=1e-7,
                                   err_msg=f"{what} {name}")
    assert got.converged == want.converged


AC_CASES = {
    "rc_product": (RC_AC_START, "spicey", "2",
                   ("t\nv1 1 0 dc 0 ac 1\nr1 1 2 47\nc1 2 0 220u\n"
                    ".ac dec 10 1 100\n"), ["r1", "c1"],
                   dict(steps=300, lr=0.05)),
    "single_param": (RC_AC_START.replace("r1 1 2 30", "r1 1 2 20"), "spicey",
                     "2", ("t\nv1 1 0 dc 0 ac 1\nr1 1 2 47\nc1 2 0 100u\n"
                           ".ac dec 10 1 100\n"), ["r1"],
                     dict(steps=250, lr=0.05)),
    "tline_source_resistor": (TLINE_AC, "extended", "b", TLINE_AC, ["rs"],
                              dict(x0={"rs": 80.0}, steps=120, lr=0.05)),
}
TRAN_CASES = {
    "capacitance": ("t\nV1 1 0 dc 5\nR1 1 2 1k\nC1 2 0 1u\n.tran 20u 5m\n",
                    "spicey", "2",
                    "t\nV1 1 0 dc 5\nR1 1 2 1k\nC1 2 0 2.2u\n.tran 20u 5m\n",
                    ["C1"], dict(lr=0.05)),
    "bsource_resistor": (BSRC_TRAN, "extended", "out", BSRC_TRAN, ["r1"],
                         dict(x0={"r1": 1.6e3}, lr=0.05, nr="converged")),
}


@pytest.mark.parametrize("case", sorted(AC_CASES))
def test_fit_ac_matches_jax(case):
    start, dialect, node, true_net, wrt, kw = AC_CASES[case]
    target = _target_ac(true_net, node, dialect)
    jc = sj.parse_netlist(start, dialect=dialect)
    jt = sj.build_tensors(jc)
    want = sj.fit_ac(jc, node, target, wrt, tensors=jt, **kw)
    got = st.fit_ac(st.parse_netlist(start, dialect=dialect), node, target,
                    wrt, tensors=from_jax_tensors(jt), device="cpu", **kw)
    _same(got, want, case)


@pytest.mark.parametrize("case", sorted(TRAN_CASES))
def test_fit_tran_matches_jax(case):
    start, dialect, node, true_net, wrt, kw = TRAN_CASES[case]
    target = _target_tran(true_net, node, dialect)
    jc = sj.parse_netlist(start, dialect=dialect)
    jt = sj.build_tensors(jc)
    want = sj.fit_tran(jc, node, target, wrt, tensors=jt, steps=TRAN_STEPS,
                       **kw)
    got = st.fit_tran(st.parse_netlist(start, dialect=dialect), node, target,
                      wrt, tensors=from_jax_tensors(jt), steps=TRAN_STEPS,
                      device="cpu", **kw)
    _same(got, want, case)


def test_fit_ac_recovers_rc_product_like_jax():
    """The physics of tests/test_fit.py on the port alone: the R*C product
    to 1e-5 from a mismatched start, the loss below 1e-10."""
    target = _target_ac("t\nv1 1 0 dc 0 ac 1\nr1 1 2 47\nc1 2 0 220u\n"
                        ".ac dec 10 1 100\n", "2")
    res = st.fit_ac(st.parse_netlist(RC_AC_START), "2", target,
                    ["r1", "c1"], steps=300, lr=0.05, device="cpu")
    assert res.converged and res.loss < 1e-10
    assert res.values["r1"] * res.values["c1"] == pytest.approx(
        47 * 220e-6, rel=1e-5)


def test_fit_errors_match_jax():
    net = "t\nv1 1 0 dc 0 ac 1\nr1 1 2 30\nc1 2 0 100u\n.ac dec 10 1 100\n"
    tran = "t\nV1 1 0 dc 5\nR1 1 2 1k\nC1 2 0 1u\n.tran 20u 5m\n"
    for mod, kw in ((sj, {}), (st, {"device": "cpu"})):
        with pytest.raises(ValueError, match="target has 3 points"):
            mod.fit_ac(mod.parse_netlist(net), "2", np.ones(3), ["r1"], **kw)
        with pytest.raises(ValueError, match="target has 3 points"):
            mod.fit_tran(mod.parse_netlist(tran), "2", np.ones(3), ["C1"],
                         **kw)
        with pytest.raises(ValueError, match="unknown sensitivity target"):
            mod.fit_ac(mod.parse_netlist(net), "2", np.ones(21), ["nope"],
                       **kw)
        with pytest.raises(KeyError):
            mod.fit_ac(mod.parse_netlist(net), "2", np.ones(21), ["r1"],
                       x0={"c1": 1e-4}, steps=1, **kw)
