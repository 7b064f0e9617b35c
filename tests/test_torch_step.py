""".step through the port's ``simulate()`` against the JAX package on the CPU.

``tests/test_step.py``'s decks: every step value is one lane of
``simulate_ac_batch``, ``simulate_tran_batch`` and ``op_batch``, held to
``spicey_tpu.simulate``'s ``StepResult`` at rtol 1e-9 / atol 1e-12 and,
for the divider, to its closed form; its DECK's ``.meas`` line is added
back in ``test_step_with_meas_is_refused``, where ``StepResult.meas``
holds each ``.meas`` name's per-lane array (ROADMAP §1 item 8).
"""

import numpy as np
import pytest

import spicey_tpu
from spicey_tpu_torch import (BatchACResult, BatchOPResult, BatchTranResult,
                              StepResult, parse_netlist, simulate)
from tests.fixtures.ua741 import UA741

DECK = """x
v1 in 0 dc 1 ac 1 PULSE(0 1 0 1n 1n 5u 20u)
r1 in out 1k
c1 out 0 1n
.tran 0.2u 8u
.ac lin 3 1k 100k
"""

DIVIDER = """x
v1 in 0 dc 10
r1 in out 6k
r2 out 0 4k
.op
.step param r2 2k 8k 2k
"""


def test_step_parse_forms():
    for step in (".step param r1 500 2000 500\n",
                 ".step r1 list 100 1k 10k\n"):
        got = parse_netlist(DECK + step, dialect="extended").step
        want = spicey_tpu.parse_netlist(DECK + step, dialect="extended").step
        assert got.param == want.param == "r1"
        np.testing.assert_array_equal(got.values, want.values)
    with pytest.raises(ValueError, match="does not reach"):
        parse_netlist(DECK + ".step param r1 500 2000 -500\n",
                      dialect="extended")
    # reference dialect: skipped
    ckt0 = parse_netlist(DECK + ".step param r1 500 2000 500\n")
    assert ckt0.step is None
    assert any(".step" in s for s in ckt0.skipped)


@pytest.mark.parametrize("method", ["gj", "pallas"])
def test_step_sweeps_all_analyses(method):
    net = DECK + ".step param r1 500 2000 500\n"
    r = simulate(net, dialect="extended", method=method, device="cpu")
    want = spicey_tpu.simulate(net, dialect="extended").step
    s = r.step
    assert isinstance(s, StepResult) and s.meas is None and s.op is None
    assert isinstance(s.ac, BatchACResult)
    assert isinstance(s.tran, BatchTranResult)
    assert s.param == want.param
    np.testing.assert_array_equal(s.values, want.values)
    assert s.tran.xs.shape[0] == 4 and s.ac.x.shape[0] == 4
    np.testing.assert_allclose(s.ac.x, want.ac.x, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(s.tran.xs, want.tran.xs, rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_array_equal(s.tran.times, want.tran.times)
    assert s.ac.valid.all() and s.tran.valid.all()
    # AC at 100 kHz: |v(out)| falls as R rises (lower corner)
    assert np.all(np.diff(np.abs(s.ac.node_voltage("out")[:, -1])) < 0)
    # the single-circuit results keep the base value (r1 = 1k, lane 1)
    assert r.tran is not None and r.ac is not None
    np.testing.assert_allclose(r.ac.node_voltages["out"],
                               s.ac.node_voltage("out")[1], rtol=1e-12)


def test_step_op_lanes():
    r = simulate(DIVIDER, dialect="extended", device="cpu")
    s = r.step
    assert isinstance(s.op, BatchOPResult) and s.ac is None and s.tran is None
    expect = 10.0 * s.values / (6e3 + s.values)
    np.testing.assert_allclose(s.op.node_voltage("out"), expect, rtol=1e-9)
    want = spicey_tpu.simulate(DIVIDER, dialect="extended").step
    np.testing.assert_allclose(s.op.x, want.op.x, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(s.op.valid, want.op.valid)


def test_step_unknown_param_raises():
    with pytest.raises(ValueError, match="unknown elements"):
        simulate(DECK + ".step param nope 1 3 1\n", dialect="extended",
                 device="cpu")


def test_step_with_meas_is_refused():
    """.step with .meas ran in the JAX package only until ROADMAP §1 item 8
    came to the port: now StepResult.meas holds each .meas tran name's
    per-lane array, equal to spicey_tpu's at rtol 1e-9 / atol 1e-12."""
    deck = (DECK + ".meas tran vmax max v(out)\n"
            ".meas tran t50 when v(out)=0.5 rise=1\n"
            ".step param r1 500 2000 500\n")
    got = simulate(deck, dialect="extended", device="cpu").step
    want = spicey_tpu.simulate(deck, dialect="extended").step
    assert list(got.meas) == list(want.meas) == ["vmax", "t50"]
    for name, w in want.meas.items():
        assert got.meas[name].shape == (4,)
        np.testing.assert_allclose(got.meas[name], w, rtol=1e-9,
                                   atol=1e-12 * float(np.abs(w).max()))


def test_step_ua741_needs_b_sources():
    """The uA741 macromodel's behavioral sources (its POLY sources, lowered
    to B sources) run in the operating point since ROADMAP §1 item 2: the
    gain family of test_step.py steps through ``op_batch`` and matches the
    JAX package at 1e-9, each lane -rfb/rin x 0.05 within 5e-3."""
    deck = UA741 + """
vcc vcc 0 dc 15
vee vee 0 dc -15
vin in 0 dc 0.05
rin in minus 1k
rfb minus out 10k
xamp 0 minus vcc vee out ua741
.op
.step param rfb list 5k 10k 20k
"""
    got = simulate(deck, dialect="extended", device="cpu").step
    want = spicey_tpu.simulate(deck, dialect="extended").step
    assert got.op.valid.all() and np.asarray(want.op.valid).all()
    np.testing.assert_allclose(got.op.x, want.op.x, rtol=1e-9,
                               atol=1e-12 * float(np.abs(want.op.x).max()))
    np.testing.assert_allclose(got.op.node_voltage("out"),
                               [-0.25, -0.5, -1.0], rtol=5e-3)
