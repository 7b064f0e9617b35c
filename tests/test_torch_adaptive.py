"""The port's simulate_tran_adaptive against the JAX package on the CPU.

Every deck of tests/test_adaptive.py and the adaptive cases of
tests/test_feature_interactions.py:202 (a matched T line),
tests/test_bsource.py:224 (the tanh B source) and tests/test_tline.py:206,
with the boost converter of ``spicey_tpu_torch.decks``, go through ``spicey_tpu.simulate_tran_adaptive``
and ``spicey_tpu_torch.simulate_tran_adaptive(device="cpu")`` with the
same tensors and the tests' own tolerances and budgets. ``n_accepted``,
``n_rejected``, ``n_attempts`` and ``exhausted`` must be equal; the
accepted times and every node voltage are held at rtol 1e-9 with an atol
of 1e-12 of the series' largest |value|.

Named exceptions (``AMPLIFIED``, ROADMAP §3): on four decks the step
controller amplifies the last-bit differences between the two packages'
arithmetic (XLA's exp against torch's, the eliminations' rounding) into
the step sizes. There the error estimate x_h - x_f cancels to a few
digits (a junction turning on from rest, the rest-state solve at dt =
tstop 1e-12 with charge companions C / dt), so a 1e-16 difference in x
moves the next dt by up to 1e-8 relative, and the times drift apart while
both runs stay LTE-controlled solutions of the same circuit with the same
counts. They are held to: counts and flags equal, the first and last times
at rtol 1e-9, and every node voltage of the port against the JAX series
interpolated at the port's times within the recorded gap x 4 of the
largest |node voltage| of the run.

Horizons: the port's controller runs on the host over one Newton loop per
half step, ~2.5 ms a pass on this CPU against the JAX package's compiled
scan, so the decks that take thousands of attempts run a cut ``.tran``
(named in ``CUT``; the deck, its rtol/atol and its budget unchanged): the
uA741 amplifier over its first nanosecond, 31 accepted and 27 rejected
attempts of the power-up transient. ``tools/profile_torch_adaptive.py``
runs the uA741 over its whole 50 us through both packages; the card runs
the boost converter at full length and the uA741's power-up (``chip_smoke.py``
phase 26 (f)), against the port's CPU path.
"""

import numpy as np
import pytest

import spicey_tpu as sj
import spicey_tpu_torch as st
from spicey_tpu_torch import decks
from spicey_tpu_torch.ir.circuit import from_jax_tensors
from tests.fixtures import netlists
from tests.test_feature_interactions import TLINE_TRAN
from tests.test_tline import MATCHED

RC_DC = "t\nV1 1 0 dc 5\nR1 1 2 1k\nC1 2 0 1u\n.tran 10u 10m\n"
SIN_RC = "t\nv1 1 0 SIN(0 1 1k)\nr1 1 2 1k\nc1 2 0 100n\n.tran 10u 2m\n"
RECTIFIER = ("t\n.model dm d\nV1 in 0 SIN(0 5 10k)\nD1 in out dm\n"
             "R1 out 0 10k\nC1 out 0 100n\n.tran 1u 200u\n")
TT_RECOVERY = """x
.model dr d(is=1e-14 tt=100n cjo=2p)
vs in 0 PWL(0 2 1u 2 1.01u -2)
rs in a 100
dr1 a 0 dr
.tran 2n 3u
"""
BJT_EDGE = """x
.model qn npn(is=1e-16 bf=100 cjc=5p cje=5p tf=5n)
vcc p 0 dc 5
rc p c 10k
vb bb 0 PULSE(0 0.8 0.1u 1n 1n 1u 3u)
rb bb b 10k
q1 c b 0 qn
.tran 1n 0.6u
"""
BSRC_SIN = ("* ad b\nv1 in 0 SIN(0 0.2 1k)\nrb in 0 1k\n"
            "bamp out 0 V=2*tanh(5*v(in))\nrl out 0 1k\n.tran 10u 1m\n.end\n")

# name -> (deck, dialect, keyword arguments)
CASES = {
    "rc_rtol_1e-3": (RC_DC, "spicey", dict(rtol=1e-3, atol=1e-9)),
    "rc_rtol_1e-4": (RC_DC, "spicey", dict(rtol=1e-4)),
    "rc_rtol_1e-5": (RC_DC, "spicey", dict(rtol=1e-5, atol=1e-9)),
    "rc_budget_16": (RC_DC, "spicey", dict(rtol=1e-6, max_steps=16)),
    "sin_rc": (SIN_RC, "extended", dict(rtol=1e-5)),
    "rectifier": (RECTIFIER, "extended", dict(rtol=1e-4)),
    "switch": (netlists.VSWITCH_PWL, "spicey", dict(rtol=1e-3,
                                                    max_steps=8192)),
    "diode_recovery": (TT_RECOVERY, "extended",
                       dict(rtol=1e-3, atol=1e-6, max_steps=8192)),
    "bjt_edge": (BJT_EDGE, "extended", dict(rtol=1e-5, atol=1e-9,
                                            max_steps=8192)),
    "tline": (TLINE_TRAN, "extended", dict(rtol=1e-5, atol=1e-9)),
    "tline_matched": (MATCHED, "extended", {}),
    "bsource_tanh": (BSRC_SIN, "extended", {}),
    "boost": (decks.BOOST_NET, "spicey", {}),
    "ua741": (decks.UA741_AMP, "extended", {}),
}
# the cut horizons (".tran" line -> the one run here)
CUT = {
    "sin_rc": (".tran 10u 2m", ".tran 10u 0.2m"),
    "rectifier": (".tran 1u 200u", ".tran 1u 4u"),
    "bjt_edge": (".tran 1n 0.6u", ".tran 1n 0.01u"),
    "boost": (".tran 0.001 0.1 uic", ".tran 0.001 0.02 uic"),
    "bsource_tanh": (".tran 10u 1m", ".tran 10u 0.2m"),
    "ua741": (".tran 1u 50u", ".tran 1u 0.001u"),
}

# name -> the recorded largest |port - JAX interpolated| / the largest
# |node voltage|, x 4
AMPLIFIED = {"diode_recovery": 1.6e-4, "bjt_edge": 4.2e-6,
             "rectifier": 6.4e-12, "ua741": 1.4e-9}


def _deck(name: str) -> tuple:
    net, dialect, kw = CASES[name]
    if name in CUT:
        old, new = CUT[name]
        assert old in net
        net = net.replace(old, new)
    return net, dialect, kw


def _close(got: np.ndarray, want: np.ndarray, what: str) -> None:
    atol = 1e-12 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_adaptive_matches_jax(name):
    net, dialect, kw = _deck(name)
    jc = sj.parse_netlist(net, dialect=dialect)
    jt = sj.build_tensors(jc)
    want = sj.simulate_tran_adaptive(jc, tensors=jt, **kw)
    got = st.simulate_tran_adaptive(st.parse_netlist(net, dialect=dialect),
                                    tensors=from_jax_tensors(jt),
                                    device="cpu", **kw)
    for f in ("n_accepted", "n_rejected", "n_attempts", "exhausted"):
        assert getattr(got, f) == getattr(want, f), f
    assert list(got.node_voltages) == list(want.node_voltages)
    if name in AMPLIFIED:
        _close(got.times[[0, 1, -1]], want.times[[0, 1, -1]],
               f"{name} times")
        assert np.all(np.diff(got.times) > 0)
        scale = max(float(np.abs(v).max())
                    for v in want.node_voltages.values())
        for node, v in want.node_voltages.items():
            ref = np.interp(got.times, want.times, v)
            gap = np.abs(got.node_voltages[node] - ref).max() / scale
            assert gap <= AMPLIFIED[name], f"{name} v({node}): {gap:.3e}"
        return
    _close(got.times, want.times, f"{name} times")
    for node, v in want.node_voltages.items():
        _close(got.node_voltages[node], v, f"{name} v({node})")


def test_adaptive_without_tran_and_singular():
    """No .tran: None, as in the JAX package; a floating node: the JAX
    package's error."""
    assert st.simulate_tran_adaptive(
        st.parse_netlist("t\nv1 1 0 1\nr1 1 0 1\n.ac dec 1 1 10\n"),
        device="cpu") is None
    net = "t\nv1 1 0 1\nr1 1 0 1k\nc1 2 3 1u\n.tran 1u 10u\n"
    for mod, kw in ((sj, {}), (st, {"device": "cpu"})):
        with pytest.raises(ValueError, match="Singular matrix in adaptive"):
            mod.simulate_tran_adaptive(mod.parse_netlist(net), **kw)


def test_source_program_matches_jax():
    """Every source kind at times on and off the breakpoints, with a
    single-breakpoint PWL, against the JAX package's evaluator."""
    import jax.numpy as jnp

    from spicey_tpu.ir import sources as jsrc
    from spicey_tpu_torch.ir import sources as tsrc

    net = ("t\nv1 1 0 PULSE(0 5 1u 2u 3u 4u 20u 3)\n"
           "v2 2 0 PWL(0 0 5u 1 5u 2 9u -1)\nv3 3 0 SIN(0.5 2 50k 3u 1e4 30)\n"
           "v4 4 0 EXP(0 3 2u 1u 8u 2u)\nv5 5 0 dc 1.5\nv6 6 0 PWL(4u 2)\n"
           "i1 7 0 PULSE(1m 2m 0 1u 1u 2u 6u)\n"
           + "".join(f"r{k} {k} 0 1k\n" for k in range(1, 8))
           + ".tran 1u 100u\n")
    jc = sj.parse_netlist(net, dialect="extended")
    tc = st.parse_netlist(net, dialect="extended")
    jp = {k: jnp.asarray(v) for k, v in jsrc.build_source_program(jc).items()}
    hp = tsrc.build_source_program(tc)
    for k, v in jsrc.build_source_program(jc).items():
        np.testing.assert_array_equal(hp[k], v)
    tp = tsrc.source_program(tc, "cpu")
    for t in np.concatenate([np.linspace(0, 80e-6, 161),
                             [1e-6, 3e-6, 5e-6, 9e-6, 4e-6, 7e-6]]):
        want = np.asarray(jsrc.eval_sources(jp, jnp.asarray(t)))
        got = tsrc.eval_sources(tp, float(t)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-15,
                                   err_msg=f"t = {t}")
