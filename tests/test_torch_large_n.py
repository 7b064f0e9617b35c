"""Flat decks past N = 128 through the port, against the JAX package on the CPU.

The JAX package solves a deck with no subcircuit structure densely at any
N (``plan_partition`` finds no blocks, so ``method="gj"`` stays dense:
``spicey_tpu/analysis/op.py:320-330``, ``ac.py:681-691``, ``tran.py``,
``mc.py``). The port does the same (K1-K4 past N = 128 in a global
workspace on the card; their plain versions here, ``device="cpu"``). Every
value is held at rtol 1e-9 / atol 1e-12, the repo's cross-tier tolerance,
on RC ladders of N = 129 unknowns (127 sections, the input node and the
source's branch current).
"""

import numpy as np
import pytest

import spicey_tpu as sj
from spicey_tpu.analysis.mc import mc_ac_stats as jax_mc_ac_stats
from spicey_tpu.analysis.op import simulate_op as jax_simulate_op
import spicey_tpu_torch as st
from spicey_tpu_torch.decks import rc_ladder_netlist

RTOL, ATOL = 1e-9, 1e-12
SECTIONS = 127
LADDER = rc_ladder_netlist(SECTIONS, 11)
# the same ladder driven by 1 V DC, for the operating point
LADDER_DC = LADDER.replace("v1 in 0 dc 0 ac 1", "v1 in 0 dc 1")
# the same ladder under a pulse, 20 steps of backward Euler
LADDER_TRAN = LADDER.replace(
    "v1 in 0 dc 0 ac 1", "v1 in 0 PULSE(0 5 0 1n 1n 50u 100u)").replace(
    ".ac lin 11 1 10k", ".tran 1u 20u")


def _same(got: dict, want: dict, what: str) -> None:
    assert list(got) == list(want), what
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {name}")


def test_ladder_is_past_the_old_limit():
    assert st.build_tensors(st.parse_netlist(LADDER)).nvar == 129
    assert ".tran 1u 20u" in LADDER_TRAN and "dc 1\n" in LADDER_DC


def test_op_past_128_matches_jax():
    """The port refused this operating point before (129 unknowns)."""
    got = st.simulate_op(st.parse_netlist(LADDER_DC), device="cpu")
    want = jax_simulate_op(sj.parse_netlist(LADDER_DC))
    _same(got.node_voltages, want.node_voltages, ".op")
    _same(got.element_currents, want.element_currents, ".op")


def test_ac_past_128_matches_jax():
    got = st.simulate(LADDER, device="cpu").ac
    want = sj.simulate(LADDER).ac
    np.testing.assert_array_equal(got.freqs, want.freqs)
    _same(got.node_voltages, want.node_voltages, ".ac")
    _same(got.element_currents, want.element_currents, ".ac")


def test_tran_past_128_matches_jax():
    got = st.simulate(LADDER_TRAN, device="cpu").tran
    want = sj.simulate(LADDER_TRAN).tran
    np.testing.assert_array_equal(got.times, want.times)
    assert len(got.times) == 21
    _same(got.node_voltages, want.node_voltages, ".tran")
    _same(got.element_currents, want.element_currents, ".tran")


def test_mc_ac_stats_past_128_matches_jax():
    rng = np.random.default_rng(0)
    ov = {"r1": 101.0 * (1 + 0.2 * rng.random(4))}
    got = st.mc_ac_stats(LADDER, ov, node=f"n{SECTIONS}", chunk=2,
                         device="cpu")
    want = jax_mc_ac_stats(LADDER, ov, node=f"n{SECTIONS}")
    assert got.n_valid == want.n_valid == 4
    for f in ("mean", "std", "min", "max"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, atol=ATOL, err_msg=f)


def test_schur_method_still_raises():
    """The flat ladder has no subcircuit structure, so no Schur plan: a
    forced ``method="schur"`` raises the same ValueError in both
    packages (a parity case since the Schur tier was ported)."""
    pairs = (
        (lambda: st.simulate_op(st.parse_netlist(LADDER_DC),
                                method="schur", device="cpu"),
         lambda: jax_simulate_op(sj.parse_netlist(LADDER_DC),
                                 method="schur")),
        (lambda: st.simulate_ac(st.parse_netlist(LADDER), method="schur",
                                device="cpu"),
         lambda: sj.simulate_ac(sj.parse_netlist(LADDER), method="schur")),
        (lambda: st.mc_ac_stats(LADDER, {"r1": [101.0]}, node="n1",
                                method="schur", device="cpu"),
         lambda: jax_mc_ac_stats(LADDER, {"r1": [101.0]}, node="n1",
                                 method="schur")))
    for port, ref in pairs:
        with pytest.raises(ValueError) as jerr:
            ref()
        with pytest.raises(ValueError) as terr:
            port()
        assert str(terr.value) == str(jerr.value)
        assert "method='schur' requires block structure" in str(terr.value)
