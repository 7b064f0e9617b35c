"""Decks with no unknowns (N = 0) through both packages, on the CPU.

A deck whose only node is ground has nothing to solve. ``spicey_tpu``
returns empty results for it: an ``OPResult`` with empty dicts, an
``ACResult`` with its frequency grid and no nodes, a ``TranResult`` with
its time grid. It does so through its host interp tier, its default for
such decks (``spicey_tpu/analysis/interp.py``), which the suite's
conftest turns off: its compiled engine raises on them ("attempt to get
argmax of an empty sequence"), so these tests turn the interp tier back
on for the JAX package's calls, as ``tests/test_interp.py`` does.

The port answers such systems in ``ops/linsolve.py``'s dispatch (every
system valid, an empty answer) before any kernel, which refuses N = 0.
Each deck runs through ``spicey_tpu.simulate`` and
``spicey_tpu_torch.simulate(device="cpu")`` (and the single-analysis entry
points), and every field of the results is compared: the same keys, the
same grids, equal values. Where ``spicey_tpu`` refuses a deck (a dialect
that does not parse it), the port must refuse it too.

The literal decks are the ones the JAX package's tests hold (a sweep of
their string literals found them reaching a solve with N = 0): the text of
an f-string outside its fields, or a short deck of a parser test.
"""

import numpy as np
import pytest

import spicey_tpu as sj
import spicey_tpu_torch as st

# the three decks of the fault as it was found (extended dialect)
FAULT_DECKS = {"op": "t\n.op\n", "ac oct": "t\n.ac oct 10 1 100\n",
               "tran": "t\n.tran 1u 1m\n"}
# tests/<file>:<line> -> the literal there
LITERALS = {
    "test_goldens.py:146": ")\n.op\n.end\n",
    "test_goldens.py:236": "\n.ac lin 12 1e6 5e7\n.end\n",
    "test_goldens.py:286": ")\n.ac lin 6 1e4 1e6\n.end\n",
    "test_goldens.py:315": "\n.tran 1u 3000u\n.four ",
    "test_parser.py:156": "t\n.ac oct 10 1 100\n",
    "test_parser.py:191": "t\n.print tran v(Out) v(OUT) v(out2)\n.tran 1u 1m\n",
    "test_tran_toggles.py:303": "\n.tran 0.05u 60u\n",
    "test_control.py:240": "\n.endc\n.op\n.end\n",
}
# the other analyses of an N = 0 deck: elements that touch only ground
OTHER_DECKS = {
    "r to ground": "t\nr1 0 0 1k\n.op\n.ac dec 10 1 100\n.tran 1u 1m\n",
    "dc sweep": "t\ni1 0 0 dc 1m\n.dc i1 0 1m 0.5m\n",
    "tf": "t\ni1 0 0 dc 1m\n.op\n.tf v(0) i1\n",
    "acop": "t\n.options acop\n.ac dec 2 1 10\n",
    "noise": "t\ni1 0 0 dc 1m ac 1\n.op\n.noise v(0) i1 dec 2 1 10\n",
    "trap": "t\n.tran 1u 1m\n.options method=trap\n",
}


def _same(got, want, what):
    """Field-by-field equality of two results of the two packages."""
    if want is None:
        assert got is None, f"{what}: {got!r} where spicey_tpu has None"
        return
    if isinstance(want, dict):
        assert list(got) == list(want), f"{what}: keys differ"
        for k in want:
            _same(got[k], want[k], f"{what}[{k!r}]")
        return
    if isinstance(want, (list, tuple, np.ndarray)) or hasattr(want,
                                                               "shape"):
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
        if w.dtype.kind in "fc":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0,
                                       err_msg=what)
        else:
            np.testing.assert_array_equal(g, w, err_msg=what)
        return
    if isinstance(want, (bool, int, float, str, complex, np.generic)):
        assert got == want, f"{what}: {got!r} != {want!r}"
        return
    # a result object: every field spicey_tpu fills, the circuit aside
    for name, value in vars(want).items():
        if name == "circuit":
            continue
        _same(getattr(got, name, None), value, f"{what}.{name}")


@pytest.fixture(autouse=True)
def _jax_default_tier(monkeypatch):
    monkeypatch.setenv("SPICEY_TPU_INTERP", "1")


def _both(deck, dialect):
    """(port's result, spicey_tpu's) of ``simulate``, or None where
    spicey_tpu raises ValueError and the port does too."""
    try:
        want = sj.simulate(deck, dialect=dialect)
    except ValueError:
        with pytest.raises(ValueError):
            st.simulate(deck, dialect=dialect, device="cpu")
        return None
    got = st.simulate(deck, dialect=dialect, device="cpu")
    assert st.build_tensors(got.circuit).nvar == 0
    return got, want


@pytest.mark.parametrize("name", list(FAULT_DECKS))
def test_fault_deck_returns_the_empty_result(name):
    got, want = _both(FAULT_DECKS[name], "extended")
    _same(got, want, name)
    res = {"op": got.op, "ac oct": got.ac, "tran": got.tran}[name]
    assert res is not None
    if name == "op":
        assert res.node_voltages == {} and res.element_currents == {}
    elif name == "ac oct":
        assert len(res.freqs) == 68 and res.node_voltages == {}
    else:
        assert len(res.times) == 1002 and res.node_voltages == {}


@pytest.mark.parametrize("dialect", ["spicey", "extended"])
@pytest.mark.parametrize("where", list(LITERALS))
def test_literal_deck_matches_spicey_tpu(where, dialect):
    pair = _both(LITERALS[where], dialect)
    if pair is not None:
        _same(*pair, where)


@pytest.mark.parametrize("name", list(OTHER_DECKS))
def test_other_analyses_of_an_empty_deck(name):
    got, want = _both(OTHER_DECKS[name], "extended")
    _same(got, want, name)


def test_single_analysis_entry_points():
    ckt_j = sj.parse_netlist("t\n.op\n.ac dec 10 1 100\n.tran 1u 1m\n",
                             dialect="extended")
    ckt_t = st.parse_netlist("t\n.op\n.ac dec 10 1 100\n.tran 1u 1m\n",
                             dialect="extended")
    _same(st.simulate_op(ckt_t, device="cpu"), sj.simulate_op(ckt_j), "op")
    _same(st.simulate_ac(ckt_t, device="cpu"), sj.simulate_ac(ckt_j), "ac")
    _same(st.simulate_tran(ckt_t, device="cpu"), sj.simulate_tran(ckt_j),
          "tran")
