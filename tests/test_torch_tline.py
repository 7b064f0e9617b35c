"""T (lossless transmission line) decks through the port against the JAX
package.

The literal decks of ``tests/test_tline.py`` (the matched line and its
open, shorted and mismatched loads, the quarter- and half-wave lines and
the matched line's delay phase in AC, the line at DC, a line inside a
subcircuit, the load sweep, and the distributed RC lines the parser lowers
to R/C ladders) go through ``spicey_tpu`` and
``spicey_tpu_torch`` (``device="cpu"``: the plain versions of kernels
K1-K4) and are held at rtol 1e-9 with an atol of 1e-12 of the largest value
of the field (node voltages, element currents, among them each line's
port currents ``t1`` and ``t1#p2``; a batch's solutions of their largest
value). Beyond those: trapezoidal and gear2 integration, the
``t1.z0``/``t1.td`` sweeps through the batch and Monte-Carlo entry points
(a batch-swept delay reads the history per variant), a ``.noise`` through
a line, a run resumed from a JAX checkpoint (the history buffer carried
over), and a ``method="pallas"`` line deck, which must not reach the
fused kernels.
"""

import numpy as np
import pytest

import spicey_tpu as sj
from spicey_tpu.analysis import batch as jbatch
from spicey_tpu.analysis import mc as jmc
import spicey_tpu_torch as st
from spicey_tpu_torch.analysis import batch as tbatch
from spicey_tpu_torch.analysis import mc as tmc
from tests.test_tline import MATCHED
from tests.test_torch_fuzz import _hold

RTOL, ATOL_OF_MAX = 1e-9, 1e-12
LOADS = {"matched": "rl b 0 50", "open": "rl b 0 50meg",
         "short": "rl b 0 1u", "mismatched": "rl b 0 150"}
_AC = """the {what}
v1 in 0 dc 0 ac 1
rs in a {rs}
t1 a 0 b 0 z0={z0} td={td}
rl b 0 50
.ac lin {n} {f1} {f2}
"""
AC_DECKS = {
    "quarter wave": _AC.format(what="quarter wave", rs=200, z0=100,
                               td="2.5n", n=2, f1="100meg", f2="100meg"),
    "half wave": _AC.format(what="half wave", rs=200, z0=100, td="5n", n=2,
                            f1="100meg", f2="100meg"),
    "matched delay": _AC.format(what="matched ac", rs=50, z0=50, td="5n",
                                n=5, f1="10meg", f2="90meg"),
}
DC_LINE = """the dc line
v1 in 0 dc 5
rs in a 200
t1 a 0 b 0 z0=100 td=2.5n
rl b 0 50
.op
"""
SUB_LINE = """the sub line
.subckt piece p1 p2
t1 p1 0 p2 0 z0=50 td=5n
.ends
v1 in 0 PULSE(0 1 0 1n 1n 50n 200n)
rs in a 50
x1 a b piece
rl b 0 50
.tran 0.5n 20n
"""
SWEEP = {"rl": np.array([25.0, 60.0, 150.0]),
         "t1.z0": np.array([45.0, 50.0, 55.0]),
         "t1.td": np.array([4e-9, 5e-9, 6e-9])}


def _x_close(got, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_OF_MAX * float(np.abs(want).max()))


def _stats_close(got, want, rtol=RTOL) -> None:
    assert got.n_valid == want.n_valid and got.n_total == want.n_total
    for f in ("mean", "std", "min", "max"):
        y = getattr(want, f)
        np.testing.assert_allclose(getattr(got, f), y, rtol=rtol,
                                   atol=rtol * float(np.abs(y).max()),
                                   err_msg=f)


@pytest.mark.parametrize("load", sorted(LOADS))
def test_line_transients_match_jax(load):
    net = MATCHED.replace("rl b 0 50", LOADS[load])
    got = st.simulate(net, dialect="extended", device="cpu").tran
    want = sj.simulate(net, dialect="extended").tran
    np.testing.assert_array_equal(got.times, want.times)
    _hold(got, want, f"line {load}")
    if load == "matched":
        k = np.argmin(np.abs(got.times - 15e-9))
        assert got.element_currents["t1"][k] == pytest.approx(0.01,
                                                              rel=1e-9)
        assert got.element_currents["t1#p2"][k] == pytest.approx(-0.01,
                                                                 rel=1e-9)


@pytest.mark.parametrize("integration", ["trap", "gear2"])
def test_line_second_order_integration_matches_jax(integration):
    net = MATCHED.replace("rl b 0 50", LOADS["mismatched"])
    got = st.simulate_tran(st.parse_netlist(net, dialect="extended"),
                           integration=integration, device="cpu")
    want = sj.simulate_tran(sj.parse_netlist(net, dialect="extended"),
                            integration=integration)
    _hold(got, want, f"line {integration}")


@pytest.mark.parametrize("deck", sorted(AC_DECKS))
def test_line_ac_matches_jax(deck):
    net = AC_DECKS[deck]
    got = st.simulate(net, dialect="extended", device="cpu").ac
    want = sj.simulate(net, dialect="extended").ac
    np.testing.assert_array_equal(got.freqs, want.freqs)
    _hold(got, want, deck)
    if deck == "matched delay":
        h = got.node_voltages["b"] / got.node_voltages["a"]
        np.testing.assert_allclose(np.abs(h), 1.0, rtol=1e-9)
        np.testing.assert_allclose(
            np.angle(h), np.angle(np.exp(-2j * np.pi * got.freqs * 5e-9)),
            atol=1e-9)


def test_line_dc_and_subcircuit_match_jax():
    got = st.simulate(DC_LINE, dialect="extended", device="cpu").op
    want = sj.simulate(DC_LINE, dialect="extended").op
    _hold(got, want, "dc line")
    assert got.element_currents["t1"] == pytest.approx(0.02, rel=1e-9)
    assert got.element_currents["t1#p2"] == pytest.approx(-0.02, rel=1e-9)
    got = st.simulate(SUB_LINE, dialect="extended", device="cpu").tran
    _hold(got, sj.simulate(SUB_LINE, dialect="extended").tran, "sub line")


def test_line_noise_matches_jax():
    net = AC_DECKS["matched delay"].replace(".ac lin 5",
                                            ".noise v(b) v1 lin 5")
    got = st.simulate(net, dialect="extended", device="cpu").noise
    want = sj.simulate(net, dialect="extended").noise
    for f in ("output_psd", "gain"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, atol=0.0, err_msg=f)
    for name, c in want.contributions.items():
        np.testing.assert_allclose(got.contributions[name], c, rtol=RTOL,
                                   err_msg=name)


def test_load_sweep_settles_to_the_divider():
    """test_tline.py's load sweep: every lane valid and equal to the JAX
    package, late-time v(b) = rl / (rs + rl)."""
    rl = np.asarray([25.0, 50.0, 100.0, 150.0])
    got = st.simulate_tran_batch(MATCHED, {"rl": rl}, dialect="extended",
                                 device="cpu")
    want = jbatch.simulate_tran_batch(MATCHED, {"rl": rl},
                                      dialect="extended")
    assert got.valid.all()
    _x_close(got.xs, want.xs)
    np.testing.assert_allclose(got.node_voltage("b")[:, -1],
                               rl / (50.0 + rl), rtol=1e-6)


def test_z0_td_sweeps_match_jax():
    """The ``t1.z0``/``t1.td`` override keys through the batch AC and
    transient and both Monte-Carlo statistics (each variant's delay reads
    its own place in the history)."""
    got = st.simulate_tran_batch(MATCHED, SWEEP, dialect="extended",
                                 device="cpu")
    want = jbatch.simulate_tran_batch(MATCHED, SWEEP, dialect="extended")
    assert got.valid.all()
    _x_close(got.xs, want.xs)
    net = AC_DECKS["matched delay"]
    got = st.simulate_ac_batch(net, SWEEP, dialect="extended", device="cpu")
    _x_close(got.x, jbatch.simulate_ac_batch(net, SWEEP,
                                             dialect="extended").x)
    _stats_close(st.mc_ac_stats(net, SWEEP, node="b", dialect="extended",
                                device="cpu"),
                 jmc.mc_ac_stats(net, SWEEP, node="b", dialect="extended"))
    _stats_close(st.mc_tran_stats(MATCHED, SWEEP, node="b",
                                  dialect="extended", device="cpu"),
                 jmc.mc_tran_stats(MATCHED, SWEEP, node="b",
                                   dialect="extended"))


def test_jax_checkpoint_with_history_resumes_in_the_port():
    """A JAX checkpoint carries the line's history buffer and step count;
    the port resumes it (and its own) to the JAX package's second
    segment."""
    first = MATCHED.replace(".tran 0.5n 40n", ".tran 0.5n 12n")
    ck_j = sj.simulate_tran(sj.parse_netlist(first, dialect="extended"),
                            return_state=True)
    ck_t = st.simulate_tran(st.parse_netlist(first, dialect="extended"),
                            return_state=True, device="cpu")
    for a, b in zip(ck_t.state.carry, ck_j.state.carry):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=1e-15)
    want = sj.simulate_tran(sj.parse_netlist(MATCHED, dialect="extended"),
                            state=ck_j.state)
    for state in (ck_j.state, ck_t.state):
        got = st.simulate_tran(st.parse_netlist(MATCHED, dialect="extended"),
                               state=state, device="cpu")
        np.testing.assert_array_equal(got.times, want.times)
        _hold(got, want, "resumed line")


def test_pallas_line_deck_skips_the_fused_kernels(monkeypatch):
    """``method="pallas"`` on a line deck takes the general routes, never
    K5, K7 or K8 (the JAX package's gates, mc.py:505, :617)."""
    def refuse(*_a, **_k):
        raise AssertionError("a fused kernel ran on a line deck")

    monkeypatch.setattr(tmc, "mc_ac_fused", refuse)
    monkeypatch.setattr(tbatch, "mc_ac_fused_x", refuse)
    monkeypatch.setattr(tmc.mtf, "mc_tran_fused", refuse)
    net = AC_DECKS["matched delay"]
    ov = {"rl": np.array([40.0, 60.0])}
    _x_close(st.simulate_ac_batch(net, ov, dialect="extended",
                                  method="pallas", device="cpu").x,
             jbatch.simulate_ac_batch(net, ov, dialect="extended",
                                      method="pallas", interpret=True).x)
    _stats_close(st.mc_ac_stats(net, ov, node="b", method="pallas",
                                dialect="extended", device="cpu"),
                 jmc.mc_ac_stats(net, ov, node="b", method="pallas",
                                 dialect="extended", interpret=True))
    tran = MATCHED.replace(".tran 0.5n 40n", ".tran 0.5n 10n")
    _stats_close(st.mc_tran_stats(tran, ov, node="b", method="pallas",
                                  precision="f32", dialect="extended",
                                  device="cpu"),
                 jmc.mc_tran_stats(tran, ov, node="b", method="pallas",
                                   precision="f32", dialect="extended",
                                   interpret=True), 2e-5)


URC = {
    "urc ladder dc": """x
.model um urc(k=1.5 rperl=10k cperl=1n)
v1 in 0 dc 1
u1 in out 0 um l=1 n=5
rl out 0 1meg
.op
""",
    "urc step": """x
.model um urc(k=1.5 rperl=10k cperl=1n)
v1 in 0 PULSE(0 1 0 1n 1n 1m 2m)
u1 in out 0 um l=1 n=20
.tran 0.2u 60u
""",
}


@pytest.mark.parametrize("deck", sorted(URC))
def test_urc_lines_match_jax(deck):
    """test_tline.py's distributed RC lines (lowered to R/C ladders by the
    parser), their operating point and step response."""
    net = URC[deck]
    got = st.simulate(net, dialect="extended", device="cpu")
    want = sj.simulate(net, dialect="extended")
    for an in ("op", "tran"):
        if getattr(want, an) is not None:
            _hold(getattr(got, an), getattr(want, an), f"{deck} {an}")
