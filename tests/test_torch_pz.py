"""The port's .pz against the JAX package on the CPU.

Every deck of tests/test_pz.py goes through ``spicey_tpu.simulate`` and
``spicey_tpu_torch.simulate(device="cpu")`` from the same netlist, and the
uA741 amplifier (N = 36, ``decks.UA741_PZ_SENS``) with them. Poles and
zeros are compared as sets (eigenvalue order is not part of the
contract): each of the port's is paired with its nearest unpaired
``spicey_tpu`` value and held at rtol 1e-9 with an atol of 1e-12 of the
field's largest |value|; ``format_pz_result`` is string-equal. The parse
errors and the transmission-line refusal are the JAX package's, word for
word.
"""

import numpy as np
import pytest
import torch

import spicey_tpu as sj
import spicey_tpu_torch as st
from chip_smoke import pair_nearest
from spicey_tpu_torch import decks

RTOL, ATOL = 1e-9, 1e-12

PZ_DECKS = {
    "rc_lowpass": """the rc lowpass
v1 in 0 dc 0 ac 1
r1 in out 10k
c1 out 0 10n
.pz in 0 out 0 vol pz
""",
    "rc_highpass": """the rc highpass
v1 in 0 dc 0 ac 1
c1 in out 10n
r1 out 0 10k
.pz in 0 out 0 vol pz
""",
    "rlc_overdamped": """the rlc overdamped
v1 in 0 dc 0 ac 1
r1 in a 100.0
l1 a out 0.001
c1 out 0 1e-06
.pz in 0 out 0 vol pol
""",
    "rlc_underdamped": """the rlc underdamped
v1 in 0 dc 0 ac 1
r1 in a 10.0
l1 a out 0.001
c1 out 0 1e-06
.pz in 0 out 0 vol pol
""",
    "cur_transimpedance": """the parallel rc
i1 0 out dc 0
r1 out 0 10k
c1 out 0 10n
.pz out 0 out 0 cur pol
""",
    "two_stage": """the two stage
v1 in 0 dc 0 ac 1
r1 in a 10k
c1 a 0 10n
e1 b 0 a 0 1
r2 b out 1k
c2 out 0 1u
.pz in 0 out 0 vol pol
""",
    "coupled_inductors": """the coupled rl
v1 in 0 dc 0 ac 1
r1 in a 100.0
l1 a b 0.001
l2 b 0 0.004
k1 l1 l2 0.5
.pz in 0 a 0 vol pol
""",
    "mosfet_cs": """the cs amp
.model mn nmos(vto=1 kp=2m)
vdd vdd 0 5
vg g 0 dc 2 ac 1
rd vdd d 1k
m1 d g 0 mn
cl d 0 1n
.pz g 0 d 0 vol pol
""",
    "miller_rhp_zero": """the miller stage
.model mn nmos(vto=1 kp=2m)
vdd vdd 0 5
vg g 0 dc 2 ac 1
rd vdd d 1k
m1 d g 0 mn
cgd g d 1p
.pz g 0 d 0 vol pz
""",
    "rc_pol_only": """the rc lowpass
v1 in 0 dc 0 ac 1
r1 in out 10k
c1 out 0 10n
.pz in 0 out 0 vol pol
""",
    "rc_zer_only": """the rc lowpass
v1 in 0 dc 0 ac 1
r1 in out 10k
c1 out 0 10n
.pz in 0 out 0 vol zer
""",
    "ua741": decks.UA741_PZ_SENS,
}


def same_eigs(got, want, what):
    got = pair_nearest(got, want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("deck", sorted(PZ_DECKS))
def test_pz_matches_jax(deck):
    net = PZ_DECKS[deck]
    want = sj.simulate(net, dialect="extended").pz
    got = st.simulate(net, dialect="extended", device="cpu").pz
    same_eigs(got.poles, want.poles, "poles")
    same_eigs(got.zeros, want.zeros, "zeros")
    assert (got.transfer, got.which, got.in_spec, got.out_spec) == (
        want.transfer, want.which, want.in_spec, want.out_spec)
    assert st.format_pz_result(got) == sj.format_pz_result(want)


def test_pz_closed_forms():
    """tests/test_pz.py's analytic checks, on the port's answers."""
    ext = dict(dialect="extended", device="cpu")
    r = st.simulate(PZ_DECKS["rc_lowpass"], **ext).pz
    np.testing.assert_allclose(r.poles, [-1e4], rtol=1e-9)
    assert r.zeros.size == 0
    r = st.simulate(PZ_DECKS["rlc_underdamped"], **ext).pz
    a, w = 10.0 / 2e-3, np.sqrt(1e9 - (10.0 / 2e-3) ** 2)
    np.testing.assert_allclose(sorted(r.poles, key=lambda s: s.imag),
                               [-a - 1j * w, -a + 1j * w], rtol=1e-9)
    np.testing.assert_allclose(np.abs(r.poles_hz),
                               np.abs(r.poles) / (2 * np.pi), rtol=1e-12)
    m = 0.5 * np.sqrt(1e-3 * 4e-3)
    r = st.simulate(PZ_DECKS["coupled_inductors"], **ext).pz
    np.testing.assert_allclose(r.poles, [-100.0 / (5e-3 + 2 * m)],
                               rtol=1e-9)
    r = st.simulate(PZ_DECKS["miller_rhp_zero"], **ext).pz
    np.testing.assert_allclose(r.zeros, [2e-3 / 1e-12], rtol=1e-6)
    assert "zeros" in st.format_pz_result(
        st.simulate(PZ_DECKS["rc_zer_only"], **ext).pz)


def test_pz_parse_matches_jax():
    """The reference dialect skips .pz; malformed lines raise the same
    ValueError in both packages."""
    net = "t\nv1 in 0 ac 1\nr1 in 0 1k\n.pz in 0 in 0 vol pz\n"
    got, want = st.parse_netlist(net), sj.parse_netlist(net)
    assert got.pz is None and got.skipped == want.skipped
    for bad in ("t\n.pz a 0 b 0 amp pol\n", "t\n.pz a 0 b 0 vol all\n",
                "t\n.pz a 0 b 0\n"):
        with pytest.raises(ValueError) as jax_err:
            sj.parse_netlist(bad, dialect="extended")
        with pytest.raises(ValueError) as port_err:
            st.parse_netlist(bad, dialect="extended")
        assert str(port_err.value) == str(jax_err.value)


def test_pz_refusals_match_jax():
    """A deck with a transmission line, and an unknown node, raise the
    JAX package's ValueError with its message."""
    tline = ("the line pz\nv1 in 0 ac 1\nrs in a 50\n"
             "t1 a 0 b 0 z0=50 td=5n\nrl b 0 50\n.pz in 0 b 0 vol pol\n")
    unknown = PZ_DECKS["rc_lowpass"].replace(".pz in 0 out", ".pz in 0 zz")
    for net in (tline, unknown):
        with pytest.raises(ValueError) as jax_err:
            sj.simulate(net, dialect="extended")
        with pytest.raises(ValueError) as port_err:
            st.simulate(net, dialect="extended", device="cpu")
        assert str(port_err.value) == str(jax_err.value)


def test_pz_shares_the_op_and_resolves_device():
    """simulate_pz given the JAX package's operating point gives the same
    pencil; without a card and without device="cpu" it raises."""
    net = PZ_DECKS["miller_rhp_zero"]
    ckt = st.parse_netlist(net, dialect="extended")
    op = sj.simulate_op(sj.parse_netlist(net, dialect="extended"))
    got = st.simulate_pz(ckt, op=op, device="cpu")
    want = sj.simulate(net, dialect="extended").pz
    same_eigs(got.zeros, want.zeros, "zeros")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            st.simulate_pz(ckt, op=op)
