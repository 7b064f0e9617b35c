"""The port's .sens against the JAX package on the CPU.

Every deck of tests/test_sens.py, and the uA741 amplifier
(``decks.UA741_PZ_SENS``), goes through ``spicey_tpu.simulate`` and
``spicey_tpu_torch.simulate(device="cpu")``; every sensitivity is held at
rtol 1e-9 with an atol on one scale for every unit (``sens_atol``: 1e-12
of the deck's largest |normalized| value, the volts per 1% change,
carried back through the entry's own p / 100), the parameters' values
exactly, and ``format_sens_result`` string-equal on the decks of
tests/test_sens.py. (On the uA741 the text is not compared: entries that
are rounding, such as d v(out) / d r2.xamp = 7e-26 V/ohm, print
differently in the two packages' last digits; their values are within
the atol, ROADMAP §3.) One value is held at its own recorded atol,
tighter than the rule's (``KNOWN_ATOL``, ROADMAP §3): d v(c) / d q1:is of
a BJT whose base current is forced is zero in exact arithmetic, and both
packages form it as the difference of two ~5e16 V/A terms, -5047.6875 in
``spicey_tpu`` and -5047.75 in the port. The MOSFET/JFET beta and vto and the BJT Is
and Bf partials, which the port takes by ``torch.func.jvp`` where the JAX
package takes ``jax.jvp``, are held against ``jax.jvp`` at 1e-12 in every
region of the device functions.
"""

import jax
import numpy as np
import pytest

import spicey_tpu as sj
import spicey_tpu_torch as st
from spicey_tpu.models.devices import bjt_ebers_moll as jax_bjt
from spicey_tpu.models.devices import mos_level1 as jax_mos
from spicey_tpu_torch import decks
from spicey_tpu_torch.analysis import sens as tsens
from spicey_tpu_torch.models.devices import bjt_ebers_moll, mos_level1

RTOL, ATOL = 1e-9, 1e-12
# (deck, parameter) -> atol: the recorded difference, 0.0625, x 4
KNOWN_ATOL = {("bjt_output", "q1:is"): 0.25}
# decks whose format_sens_result text is not compared: rounding-level
# entries print differently (the values are held above)
TEXT_UNCOMPARED = ("bjt_output", "ua741")

_DIODE = """the diode bias
.model dm d(is=1e-14)
v1 in 0 dc 5.0
r1 in out 1e3
d1 out 0 dm
.sens v(out)
"""

SENS_DECKS = {
    "divider": """the divider
v1 in 0 dc 10
r1 in out 6k
r2 out 0 4k
.sens v(out)
""",
    "diode_bias": _DIODE,
    "diode_bias_r1_up": _DIODE.replace("r1 in out 1e3", "r1 in out 1001.0"),
    "controlled_sources": """the ctl
v1 in 0 dc 2
vm m 0 dc 0
r0 in m 1k
g1 0 out in 0 1e-3
f1 0 out vm 0.5
r1 out 0 2k
.sens v(out)
""",
    "mosfet_and_bjt": """the active
.model mn nmos(vto=1 kp=2e-3)
.model qn npn(is=1e-16 bf=100.0)
vdd vdd 0 dc 5
vg g 0 dc 2
rd vdd d 1k
m1 d g 0 mn
rc vdd c 10k
ib 0 b dc 10u
q1 c b 0 qn
.sens v(d)
""",
    "bjt_output": """the active
.model mn nmos(vto=1 kp=2e-3)
.model qn npn(is=1e-16 bf=100.0)
vdd vdd 0 dc 5
vg g 0 dc 2
rd vdd d 1k
m1 d g 0 mn
rc vdd c 10k
ib 0 b dc 10u
q1 c b 0 qn
.sens v(c)
""",
    "njf": """the jfet sens
.model jm njf(vto=-2 beta=1e-4 lambda=0)
vdd p 0 dc 10
rd p d 10k
j1 d 0 0 jm
.sens v(d)
""",
    "pjf": """the pjf sens
.model jm pjf(vto=-2 beta=1e-4 lambda=0)
vss p 0 dc -10
rd p d 10k
j1 d 0 0 jm
.sens v(d)
""",
    "differential_out": """the divider
v1 in 0 dc 10
r1 in out 6k
r2 out 0 4k
.sens v(in,out)
""",
    "ua741": decks.UA741_PZ_SENS,
}


def sens_atol(res):
    """Each entry's atol: ATOL of the largest |normalized| value (volts per
    1% change, one scale for every unit) over the entry's |p| / 100; a
    parameter of value 0 is taken as 1 of its unit."""
    scale = ATOL * max(abs(v) for v in res.normalized.values())
    return {k: scale * 100.0 / (abs(p) or 1.0)
            for k, p in res.params.items()}


def same_sens(got, want, known=None):
    """Every value at RTOL with its ``sens_atol`` (``known``: parameter ->
    its own atol), the keys and parameter values exact."""
    assert list(got.values) == list(want.values)
    assert got.params == want.params and got.out_spec == want.out_spec
    atols = sens_atol(want)
    for name, v in want.values.items():
        atol = (known or {}).get(name, atols[name])
        assert abs(got.values[name] - v) <= RTOL * abs(v) + atol, (
            name, got.values[name], v)


@pytest.mark.parametrize("deck", sorted(SENS_DECKS))
def test_sens_matches_jax(deck):
    net = SENS_DECKS[deck]
    want = sj.simulate(net, dialect="extended").sens
    got = st.simulate(net, dialect="extended", device="cpu").sens
    same_sens(got, want, {k: a for (d, k), a in KNOWN_ATOL.items()
                          if d == deck})
    if deck not in TEXT_UNCOMPARED:
        assert (st.format_sens_result(got)
                == sj.analysis.sens.format_sens_result(want))


def test_sens_closed_forms():
    """tests/test_sens.py's divider algebra and JFET closed forms."""
    ext = dict(dialect="extended", device="cpu")
    s = st.simulate(SENS_DECKS["divider"], **ext).sens
    assert s.values["v1"] == pytest.approx(0.4, rel=1e-9)
    assert s.values["r1"] == pytest.approx(-10 * 4e3 / 1e4 ** 2, rel=1e-9)
    assert s.values["r2"] == pytest.approx(10 * 6e3 / 1e4 ** 2, rel=1e-9)
    assert s.normalized["r2"] == pytest.approx(
        s.values["r2"] * 4e3 / 100.0, rel=1e-12)
    j = st.simulate(SENS_DECKS["njf"], **ext).sens
    assert j.values["j1:beta"] == pytest.approx(-10e3 * 4.0, rel=1e-6)
    assert j.values["j1:vto"] == pytest.approx(4.0, rel=1e-6)
    p = st.simulate(SENS_DECKS["pjf"], **ext).sens
    assert p.values["j1:vto"] == pytest.approx(-4.0, rel=1e-6)
    assert p.params["j1:vto"] == pytest.approx(-2.0)


def test_sens_against_finite_difference_of_port_op():
    """d v(out) / d r1 of the diode bias against a central difference of
    two port operating points, as tests/test_sens.py:_fd_check does."""
    def vout(r1):
        net = _DIODE.replace("r1 in out 1e3", f"r1 in out {r1!r}")
        return st.simulate_op(st.parse_netlist(net, dialect="extended"),
                              device="cpu").node_voltages["out"]

    h = 1e3 * 1e-6
    fd = (vout(1e3 + h) - vout(1e3 - h)) / (2 * h)
    s = st.simulate(_DIODE, dialect="extended", device="cpu").sens
    assert s.values["r1"] == pytest.approx(fd, rel=1e-4)
    assert s.values["d1:is"] < 0 and "d1:n" in s.values


def test_sens_parse_and_errors_match_jax():
    net = "t\nv1 a 0 dc 1\nr1 a 0 1k\n.sens v(a)\n"
    assert st.parse_netlist(net).sens is None
    assert st.parse_netlist(net).skipped == sj.parse_netlist(net).skipped
    unknown = SENS_DECKS["divider"].replace(".sens v(out)", ".sens v(zz)")
    with pytest.raises(ValueError) as jax_err:
        sj.simulate(unknown, dialect="extended")
    with pytest.raises(ValueError) as port_err:
        st.simulate(unknown, dialect="extended", device="cpu")
    assert str(port_err.value) == str(jax_err.value)


def _mos_cases():
    """vgs, vds, beta, vto, lambda, type over cutoff, saturation, triode
    and the swapped (vds < 0) frame, NMOS and PMOS."""
    rng = np.random.default_rng(3)
    n = 64
    vgs = rng.uniform(-3, 3, n)
    vds = rng.uniform(-3, 3, n)
    beta = rng.uniform(1e-4, 5e-3, n)
    vto = rng.uniform(-1.5, 1.5, n)
    lam = rng.choice([0.0, 0.02], n)
    typ = rng.choice([-1.0, 1.0], n)
    return vgs, vds, beta, vto, lam, typ


def test_mos_partials_match_jax_jvp():
    vgs, vds, beta, vto, lam, typ = _mos_cases()
    t = tsens._t64
    for k, primal in ((2, beta), (3, vto)):
        def port(p):
            args = [t(a) for a in (vgs, vds, beta, vto, lam, typ)]
            args[k] = p
            return mos_level1(*args)[3]

        def ref(p):
            args = [vgs, vds, beta, vto, lam, typ]
            args[k] = p
            return jax_mos(*args)[3]

        got = tsens._jvp(port, primal).numpy()
        want = np.asarray(jax.jvp(ref, (primal,), (np.ones_like(primal),))[1])
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
        assert np.abs(want).max() > 0


def test_bjt_partials_match_jax_jvp():
    rng = np.random.default_rng(4)
    n = 64
    vbe = rng.uniform(-1.2, 0.9, n)
    vbc = rng.uniform(-1.2, 0.9, n)
    i_s = 10.0 ** rng.uniform(-17, -14, n)
    bf = rng.uniform(20, 300, n)
    br = rng.uniform(1, 5, n)
    typ = rng.choice([-1.0, 1.0], n)
    vt = 0.0285
    t = tsens._t64
    for k, primal in ((2, i_s), (3, bf)):
        def port(p):
            args = [t(a) for a in (vbe, vbc, i_s, bf, br, typ)]
            args[k] = p
            out = bjt_ebers_moll(*args, vt=vt)
            return out[7], out[8]

        def ref(p):
            args = [vbe, vbc, i_s, bf, br, typ]
            args[k] = p
            out = jax_bjt(*args, vt=vt)
            return out[7], out[8]

        got = tsens._jvp(port, primal)
        want = jax.jvp(ref, (primal,), (np.ones_like(primal),))[1]
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-12,
                                       atol=1e-12 * np.abs(w).max())
