"""The port's single-circuit transient against the JAX package on the CPU.

Every fixture deck of ``tests/test_tran.py`` runs through
``spicey_tpu_torch.simulate_tran`` (device="cpu": the plain versions of
kernels K2 and K3) and ``spicey_tpu.simulate_tran`` in be, trap and gear2
with the reference Newton loop (``nr="converged"`` is in
``test_torch_tran_converged.py``), held at ``tests/test_tran.py``'s
tolerances: 1e-9/1e-12 on the linear and switch decks, 1e-7/1e-9 on the
boost converter, 1e-6/1e-9 on the diode rectifier. The reference mode is
also held to the NumPy oracle (tests/oracle.py) step for step. The
extended nonlinear decks (MOSFET ring, BJT amplifiers NPN and PNP, a
JFET stage, diode TT/CJO and BJT junction charge) match at 1e-9/1e-12,
node voltages and element currents, fresh and resumed from a JAX
checkpoint.
"""

import numpy as np
import pytest
import torch

import spicey_tpu
from spicey_tpu_torch import (TranState, compare_voltage_levels, decks,
                              format_tran_result, formatTranResult,
                              parse_netlist, simulate, simulate_tran,
                              simulateTRAN, spicey_tran_to_vgraphs)
from tests.fixtures import netlists
from tests.oracle import oracle_tran

RC_DC = "The t\nV1 1 0 DC 5\nR1 1 2 1k\nC1 2 0 1u\n.tran 10u 5m\n.end\n"
RL = "The t\nV1 1 0 DC 1\nR1 1 2 10\nL1 2 0 1m\n.tran 1u 1m\n.end\n"
RECTIFIER = ("The t\n.model dm d(is=1e-12 n=1.2)\n"
             "V1 in 0 PULSE(-5 5 0 1u 1u 48u 100u)\n"
             "D1 in out dm\nR1 out 0 1k\nC1 out 0 1u\n"
             ".tran 1u 300u\n.end\n")
T0 = "The t\nV1 1 0 DC 5\nR1 1 2 1k\nC1 2 0 1u\n.tran 1u 10u\n.end\n"

LOOSE = (1e-7, 1e-9)
DECKS = {
    "rc_pulse": (netlists.RC_PULSE, None),
    "two_probes": (netlists.TWO_PROBES, None),
    "case_insensitive": (netlists.CASE_INSENSITIVE, None),
    "series_rlc": (netlists.SERIES_RLC, None),
    "switch_vt_vh": (netlists.SWITCH_VT_VH, None),
    "vswitch_pwl": (netlists.VSWITCH_PWL, None),
    "boost": (netlists.BOOST_CONVERTER, LOOSE),
    "diode_switch": (netlists.DIODE_SWITCH, None),
    "rc_dc": (RC_DC, None),
    "rl": (RL, None),
    "rectifier": (RECTIFIER, (1e-6, 1e-9)),
    "t0": (T0, None),
}

# an extended deck: I/G/E/F/H sources, .ic, element ic=, a record window
# and current probes
EXT = """* extended transient
I1 0 a PULSE(0 1m 0 1u 1u 5u 10u)
R1 a 0 1k
G1 0 b a 0 2m
R2 b 0 500
E1 c 0 b 0 3
R3 c d 100
C1 d 0 1u
V1 e 0 PULSE(0 5 0 1n 1n 5u 10u)
R4 e d 200
F1 0 b V1 0.5
H1 f 0 V1 50
R5 f d 300
L1 d g 10m ic=1m
R6 g 0 20
C2 g 0 2u ic=0.5
.ic v(d)=1
.print tran v(d) v(g) i(L1) i(C2)
.tran 0.1u 20u 2u
.end
"""


def _close(got, want, rtol=1e-9, atol=1e-12):
    np.testing.assert_array_equal(got.times, want.times)
    assert list(got.node_voltages) == list(want.node_voltages)
    assert list(got.element_currents) == list(want.element_currents)
    for series, ref in ((got.node_voltages, want.node_voltages),
                        (got.element_currents, want.element_currents)):
        for name, w in ref.items():
            np.testing.assert_allclose(series[name], w, rtol=rtol, atol=atol,
                                       err_msg=name)


def _jax(net, dialect="spicey", **kw):
    ckt = spicey_tpu.parse_netlist(net, dialect=dialect)
    return spicey_tpu.simulate_tran(ckt, **kw)


def _port(net, dialect="spicey", **kw):
    return simulate_tran(parse_netlist(net, dialect=dialect), device="cpu",
                         **kw)


@pytest.mark.parametrize("deck", sorted(DECKS))
@pytest.mark.parametrize("integration", ["be", "trap", "gear2"])
def test_reference_newton_matches_jax(deck, integration):
    net, tol = DECKS[deck]
    want = _jax(net, integration=integration)
    got = _port(net, integration=integration)
    _close(got, want, *(tol or ()))


@pytest.mark.parametrize("deck", ["rc_pulse", "series_rlc", "switch_vt_vh",
                                  "vswitch_pwl", "boost", "diode_switch"])
def test_reference_mode_matches_oracle(deck):
    net, tol = DECKS[deck]
    ckt = parse_netlist(net)
    got = simulate_tran(ckt, device="cpu")
    times, nv, ec = oracle_tran(ckt)
    rtol, atol = tol or (1e-9, 1e-12)
    np.testing.assert_array_equal(got.times, times)
    assert list(got.node_voltages) == list(nv)
    assert list(got.element_currents) == list(ec)
    for series, ref in ((got.node_voltages, nv), (got.element_currents, ec)):
        for name, w in ref.items():
            np.testing.assert_allclose(series[name], w, rtol=rtol, atol=atol,
                                       err_msg=name)


@pytest.mark.parametrize("method", ["gj", "pallas"])
def test_extended_deck_matches_jax(method):
    want = _jax(EXT, dialect="extended")
    got = _port(EXT, dialect="extended", method=method)
    assert got.times[0] >= 2e-6 - 1e-15 and "L1" in got.element_currents
    assert sorted(got.node_voltages) == ["d", "g"]
    _close(got, want)


@pytest.mark.parametrize("deck,integration", [("boost", "be"),
                                              ("boost", "trap"),
                                              ("rc_pulse", "trap"),
                                              ("switch_vt_vh", "gear2")])
def test_jax_checkpoint_resumes_in_the_port(deck, integration):
    """The first half runs in JAX with return_state=True; the port resumes
    its TranState and must equal the JAX full run's second half."""
    net, _tol = DECKS[deck]
    ckt = spicey_tpu.parse_netlist(net)
    tstop = ckt.tran.tstop
    ckt.tran.tstop = tstop / 2
    first = spicey_tpu.simulate_tran(ckt, integration=integration,
                                     return_state=True)
    ckt.tran.tstop = tstop
    full = spicey_tpu.simulate_tran(ckt, integration=integration)
    pckt = parse_netlist(net)
    pckt.tran.tstop = tstop / 2
    state = TranState(carry=first.state.carry, t=first.state.t,
                      dt=first.state.dt)
    second = simulate_tran(pckt, integration=integration, state=state,
                           device="cpu")
    # the half-length segment may round up to one more step than the full
    # run has left: compare where both have samples
    k = len(first.times)
    m = min(len(second.times), len(full.times) - k)
    assert m >= len(full.times) - k - 1
    np.testing.assert_allclose(second.times[:m], full.times[k:k + m],
                               rtol=1e-12)
    for name, w in full.node_voltages.items():
        np.testing.assert_allclose(second.node_voltages[name][:m],
                                   w[k:k + m], rtol=1e-9, atol=1e-12,
                                   err_msg=name)
    for name, w in full.element_currents.items():
        np.testing.assert_allclose(second.element_currents[name][:m],
                                   w[k:k + m], rtol=1e-9, atol=1e-12,
                                   err_msg=name)


def test_port_checkpoint_round_trips():
    net = netlists.BOOST_CONVERTER
    full = _port(net)
    ckt = parse_netlist(net)
    ckt.tran.tstop /= 2
    first = simulate_tran(ckt, return_state=True, device="cpu")
    assert isinstance(first.state, TranState)
    assert all(isinstance(a, np.ndarray) for a in first.state.carry)
    second = simulate_tran(ckt, state=first.state, device="cpu")
    k = len(first.times)
    m = min(len(second.times), len(full.times) - k)
    for name, w in full.node_voltages.items():
        np.testing.assert_allclose(second.node_voltages[name][:m],
                                   w[k:k + m], rtol=1e-12, atol=1e-15)
    bad = TranState(carry=first.state.carry, t=first.state.t,
                    dt=2 * first.state.dt)
    with pytest.raises(ValueError, match="resume dt"):
        simulate_tran(ckt, state=bad, device="cpu")


def test_simulate_and_formatting_match_jax():
    want = spicey_tpu.simulate(netlists.TWO_PROBES)
    got = simulate(netlists.TWO_PROBES, device="cpu")
    assert got.ac is None
    assert format_tran_result(got.tran) == spicey_tpu.format_tran_result(
        want.tran)
    assert formatTranResult is format_tran_result
    assert simulateTRAN is simulate_tran
    assert "t(s), 1:V, 2:V" in format_tran_result(got.tran)
    assert format_tran_result(None) == "No TRAN analysis.\n"


def test_boost_vgraphs_and_comparison_match_jax():
    """The reference's tran surface: circuit-json voltage graphs and the
    compare_voltage_levels metric, equal to the JAX package's (ROADMAP's
    transient gate)."""
    jckt = spicey_tpu.parse_netlist(netlists.BOOST_CONVERTER)
    pckt = parse_netlist(netlists.BOOST_CONVERTER)
    jg = spicey_tpu.spicey_tran_to_vgraphs(spicey_tpu.simulate_tran(jckt),
                                           jckt, "x")
    pg = spicey_tran_to_vgraphs(simulate_tran(pckt, device="cpu"), pckt, "x")
    assert [g["name"] for g in pg] == [g["name"] for g in jg]
    for a, b in zip(pg, jg):
        assert a["timestamps_ms"] == b["timestamps_ms"]
        np.testing.assert_allclose(a["voltage_levels"], b["voltage_levels"],
                                   rtol=1e-7, atol=1e-9)
    ng = [dict(g, name=g["name"] + " (ngspice)") for g in jg]
    assert compare_voltage_levels(pg, ng) == \
        spicey_tpu.compare_voltage_levels(jg, ng)


def test_options_map_to_newton_toggles():
    net = netlists.BOOST_CONVERTER.replace(
        ".tran", ".options reltol=1e-6 itl4=30\n.tran")
    want = spicey_tpu.simulate(net, dialect="extended").tran
    got = simulate(net, dialect="extended", device="cpu").tran
    _close(got, want, *LOOSE)
    net = netlists.SWITCH_VT_VH.replace(".tran",
                                        ".options vntol=1e-7 abstol=1e-13\n"
                                        ".tran")
    want = spicey_tpu.simulate(net, dialect="extended").tran
    got = simulate(net, dialect="extended", device="cpu").tran
    _close(got, want)


def test_singular_and_absent_tran():
    net = "The t\nV1 1 0 DC 5\nV2 1 0 DC 3\nR1 1 0 1k\n.tran 1u 10u\n.end\n"
    with pytest.raises(ValueError, match="Singular matrix in TRAN solve"):
        _port(net)
    ckt = parse_netlist("The t\nr1 1 0 1k\nv1 1 0 5\n.ac lin 2 1 10\n")
    assert simulate_tran(ckt, device="cpu") is None
    with pytest.raises(ValueError, match="integration"):
        _port(netlists.RC_PULSE, integration="euler")
    with pytest.raises(ValueError, match="nr must be"):
        _port(netlists.RC_PULSE, nr="newton")
    with pytest.raises(ValueError, match="unknown solve method"):
        _port(netlists.BOOST_CONVERTER, method="lax")


# the K, T and B decks the port refused before ROADMAP §1 item 2 was
# ported (the names keep the old tests' ids)
UNPORTED = {
    "mutual inductance": "* k\nv1 1 0 PULSE(0 1 0 1n 1n 5u 10u)\n"
                         "l1 1 0 1m\nl2 2 0 1m\nr1 2 0 1k\nk1 l1 l2 0.5\n"
                         ".tran 1u 10u\n.end\n",
    "transmission line": "tline deck\nV1 in 0 PULSE(0 1 0 1n 1n 50n 200n)\n"
                         "R1 in a 50\nT1 a 0 b 0 Z0=50 TD=10n\nR2 b 0 50\n"
                         ".tran 1n 200n\n.end\n",
    "behavioral source": "* b\nvin in 0 PULSE(0 2 0 1u 1u 40u 100u)\n"
                         "r1 in 0 1k\nbq out 0 I=1m*tanh(3*v(in))\n"
                         "rload out 0 2k\n.tran 1u 10u\n.end\n",
}

# the extended nonlinear devices: MOSFET/JFET (level 1), BJT (Ebers-Moll)
# and junction charge
NONLINEAR = {
    "mosfet": ("* m\n.model mn nmos(vto=1 kp=2m)\nvdd vdd 0 5\n"
               "vg g 0 PULSE(0 5 0 1u 1u 5u 10u)\nrd vdd d 1k\nm1 d g 0 mn\n"
               ".tran 1u 10u\n.end\n"),
    "bjt": ("* q\n.model qn npn(is=1e-16 bf=100)\nvcc vcc 0 5\n"
            "vin bs 0 SIN(0.7 0.005 100k)\nrc vcc c 1k\nq1 c bs 0 qn\n"
            ".tran 1u 10u\n.end\n"),
    "diode charge": ("* d\nV1 a 0 PULSE(0 5 0 1u 1u 40u 100u)\n"
                     "R1 a b 1k\nD1 b 0 DX\n"
                     ".model DX d(is=1e-14 tt=100n cjo=10p)\n"
                     ".tran 1u 10u\n.end\n"),
    "ring": decks.RING_NET,
    "bjt_net": decks.BJT_NET,
    "bjt charge": decks.QC_NET.replace(".tran 0.2u 40u", ".tran 0.2u 20u"),
    "jfet": decks.JFET_NET,
    "pnp": decks.PNP_NET,
    "varactor": decks.CJ_NET,
}


@pytest.mark.parametrize("what", sorted(UNPORTED))
def test_unported_devices_raise(what):
    """The K, T and B decks once refused (ROADMAP §1 item 2) now run and
    match the JAX package, node voltages and element currents (a line's
    port currents, a B source's current) at 1e-9/1e-12."""
    net = UNPORTED[what]
    _close(_port(net, dialect="extended"), _jax(net, dialect="extended"))


@pytest.mark.parametrize("deck,integration", [
    (d, "be") for d in sorted(NONLINEAR)] + [
    ("ring", "trap"), ("bjt_net", "gear2"), ("diode charge", "trap")])
def test_nonlinear_decks_match_jax(deck, integration):
    """MOSFET/JFET/BJT decks (Newton to convergence, as the JAX package
    upgrades them) and junction-charge decks, node voltages and element
    currents at 1e-9."""
    net = NONLINEAR[deck]
    want = _jax(net, dialect="extended", integration=integration)
    got = _port(net, dialect="extended", integration=integration)
    _close(got, want)


@pytest.mark.parametrize("deck", ["diode charge", "bjt charge", "ring",
                                  "pnp"])
def test_jax_nonlinear_checkpoint_resumes_in_the_port(deck):
    """A JAX checkpoint carries the junction seeds (vm_prev, vq_prev) and
    the committed junction charges (q_prev_d, q_prev_q); the port resumes
    it and must equal the JAX full run's second half."""
    net = NONLINEAR[deck]
    ckt = spicey_tpu.parse_netlist(net, dialect="extended")
    tstop = ckt.tran.tstop
    ckt.tran.tstop = tstop / 2
    first = spicey_tpu.simulate_tran(ckt, return_state=True)
    ckt.tran.tstop = tstop
    full = spicey_tpu.simulate_tran(ckt)
    pckt = parse_netlist(net, dialect="extended")
    pckt.tran.tstop = tstop / 2
    state = TranState(carry=first.state.carry, t=first.state.t,
                      dt=first.state.dt)
    second = simulate_tran(pckt, state=state, return_state=True,
                           device="cpu")
    assert len(second.state.carry) == len(first.state.carry)
    k = len(first.times)
    m = min(len(second.times), len(full.times) - k)
    assert m >= len(full.times) - k - 1
    for series, ref in ((second.node_voltages, full.node_voltages),
                        (second.element_currents, full.element_currents)):
        for name, w in ref.items():
            np.testing.assert_allclose(series[name][:m], w[k:k + m],
                                       rtol=1e-9, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("deck", ["ring", "bjt_amp"])
def test_simulate_runs_the_bench_nonlinear_decks(deck):
    """The JAX package's bench latency decks (bench.py:453-474) through
    ``simulate()``, formatted output equal to the JAX package's."""
    nets = {
        "ring": NONLINEAR["ring"].replace(".tran 0.1u 10u", ".tran 0.2u 30u"),
        "bjt_amp": NONLINEAR["bjt"].replace(".tran 1u 10u", ".tran 0.2u 20u"),
    }
    want = spicey_tpu.simulate(nets[deck], dialect="extended").tran
    got = simulate(nets[deck], dialect="extended", device="cpu")
    assert got.ac is None
    _close(got.tran, want)


def test_schur_method_raises():
    """RC_PULSE has no subcircuit structure: a forced Schur solve raises
    the JAX package's ValueError in both packages."""
    with pytest.raises(ValueError) as jerr:
        spicey_tpu.simulate_tran(spicey_tpu.parse_netlist(netlists.RC_PULSE),
                                 method="schur")
    with pytest.raises(ValueError) as terr:
        _port(netlists.RC_PULSE, method="schur")
    assert str(terr.value) == str(jerr.value)


def test_entry_points_refuse_to_run_on_the_cpu_unasked(monkeypatch):
    """With no CUDA device an entry point called without ``device``
    raises instead of running on the CPU."""
    import spicey_tpu_torch as st

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckt = parse_netlist(netlists.RC_PULSE)
    calls = [
        lambda: st.simulate(netlists.RC_PULSE),
        lambda: st.simulate_tran(ckt),
        lambda: st.simulate_ac(parse_netlist(netlists.BASICS01_AC)),
        lambda: st.mc_ac_stats(netlists.BASICS01_AC, {"r1": [30.0]},
                               node="2"),
        lambda: st.mc_ac_sampled(netlists.BASICS01_AC, {"r1": 0.1}, 2,
                                 node="2"),
        lambda: st.mc_tran_stats(netlists.RC_PULSE, {"R1": [1e3]}, node="2"),
        lambda: st.mc_tran_sampled(netlists.RC_PULSE, {"R1": 0.1}, 2,
                                   node="2"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
