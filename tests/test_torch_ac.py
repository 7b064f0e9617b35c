"""The port's single-circuit AC path against the JAX package on the CPU.

The basics01 golden is the reference's character-exact contract. The
other decks compare every node voltage and element current with the JAX
f64 plane-GJ engine at rtol 1e-9, the repo's cross-tier tolerance.
"""

import dataclasses
import os

import numpy as np
import pytest

import spicey_tpu
from spicey_tpu.analysis.ac import simulate_ac as jax_simulate_ac
from spicey_tpu_torch import (build_tensors, format_ac_result,
                              formatAcResult, from_jax_tensors,
                              parse_netlist, simulate, simulate_ac)

BASICS01 = """Demo of a simple AC circuit
v1 1 0 dc 0 ac 1
r1 1 2 30
c1 2 0 100u
.ac dec 100 1 100
.end
"""

RLC = """* series rlc
v1 1 0 ac 1 45
r1 1 2 10
l1 2 3 1m
c1 3 0 1u
.ac dec 3 100 1e5
.end
"""

EXT = """* controlled sources
I1 0 a 1m ac 2 30
R1 a 0 1k
G1 0 b a 0 2m
R2 b 0 500
E1 c 0 b 0 3
R3 c d 100
C1 d 0 1u
V1 e 0 ac 1
R4 e d 200
F1 0 b V1 0.5
H1 f 0 V1 50
R5 f d 300
L1 d 0 10m
.ac oct 1 10 1e4
.end
"""

# two ideal sources in parallel: identical branch rows
SINGULAR = """* parallel sources
v1 1 0 ac 1
v2 1 0 ac 1
r1 1 0 1k
.ac dec 2 1 100
.end
"""

DECKS = {"basics01": (BASICS01, "spicey"), "rlc": (RLC, "spicey"),
         "ext": (EXT, "extended")}


def test_basics01_golden_character_exact(fixtures_dir):
    with open(os.path.join(fixtures_dir, "basics01_golden.txt")) as fh:
        golden = fh.read()
    out = format_ac_result(simulate(BASICS01, device="cpu").ac)
    assert out == golden
    assert formatAcResult is format_ac_result


@pytest.mark.parametrize("deck", sorted(DECKS))
@pytest.mark.parametrize("method", ["gj", "pallas"])
def test_simulate_ac_matches_jax(deck, method):
    net, dialect = DECKS[deck]
    ref = jax_simulate_ac(spicey_tpu.parse_netlist(net, dialect=dialect),
                          method="gj")
    got = simulate_ac(parse_netlist(net, dialect=dialect), method=method,
                      device="cpu")
    np.testing.assert_array_equal(got.freqs, ref.freqs)
    assert list(got.node_voltages) == list(ref.node_voltages)
    assert list(got.element_currents) == list(ref.element_currents)
    for series, want in ((got.node_voltages, ref.node_voltages),
                         (got.element_currents, ref.element_currents)):
        for name, z in want.items():
            np.testing.assert_allclose(series[name], z, rtol=1e-9,
                                       atol=1e-12, err_msg=name)


def test_singular_deck_raises():
    with pytest.raises(ValueError, match="Singular matrix in AC solve"):
        jax_simulate_ac(spicey_tpu.parse_netlist(SINGULAR))
    with pytest.raises(ValueError, match="Singular matrix in AC solve"):
        simulate(SINGULAR, device="cpu")


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_from_jax_tensors_round_trips(deck):
    net, dialect = DECKS[deck]
    jt = spicey_tpu.build_tensors(spicey_tpu.parse_netlist(net,
                                                           dialect=dialect))
    ckt = parse_netlist(net, dialect=dialect)
    mine = build_tensors(ckt)
    conv = from_jax_tensors(jt)
    for f in dataclasses.fields(mine):
        a, b = getattr(conv, f.name), getattr(mine, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    # the converted IR drives the port's engine to the same answer
    a = simulate_ac(ckt, tensors=conv, device="cpu")
    b = simulate_ac(ckt, tensors=mine, device="cpu")
    for name in b.node_voltages:
        np.testing.assert_array_equal(a.node_voltages[name],
                                      b.node_voltages[name])


def test_from_jax_tensors_rejects_other_fields():
    @dataclasses.dataclass
    class Other:
        nvar: int

    with pytest.raises(ValueError, match="field sets differ"):
        from_jax_tensors(Other(nvar=1))


def test_unported_analyses_raise():
    """What the JAX package runs, the port runs with the same result, and
    what it rejects, the port rejects with its exception and message:
    .pz (here of a deck whose .pz names v(1), not a node, which both
    reject), .meas, .op/.dc/.tf/.noise, linearize="op" and .step are
    ported (``method="schur"`` too, tests/test_torch_schur.py)."""
    pz = BASICS01.replace(".end", ".pz v(1) v(0) v(2) v(0) vol pz\n.end")
    with pytest.raises(ValueError) as jax_err:
        spicey_tpu.simulate(pz, dialect="extended")
    with pytest.raises(ValueError) as port_err:
        simulate(pz, dialect="extended", device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    good = simulate(pz.replace("v(1) v(0) v(2) v(0)", "1 0 2 0"),
                    dialect="extended", device="cpu").pz
    want = spicey_tpu.simulate(pz.replace("v(1) v(0) v(2) v(0)", "1 0 2 0"),
                               dialect="extended").pz
    np.testing.assert_allclose(good.poles, want.poles, rtol=1e-9)
    np.testing.assert_allclose(good.poles, [-1.0 / (30 * 100e-6)],
                               rtol=1e-9)
    step = BASICS01.replace(".end", ".step param r1 10 30 10\n.end")
    stepped = simulate(step, dialect="extended", device="cpu").step
    assert stepped.ac.x.shape == (3, 201, 3) and stepped.ac.valid.all()
    dc = BASICS01.replace(".ac dec 100 1 100", ".dc v1 0 1 0.5")
    assert simulate(dc, dialect="extended", device="cpu").dc.valid.all()
    op = BASICS01.replace(".end", ".op\n.end")
    assert simulate(op, dialect="extended", device="cpu").op is not None
    lin = simulate(BASICS01, ac_linearize="op", device="cpu").ac
    plain = simulate(BASICS01, device="cpu").ac
    np.testing.assert_array_equal(lin.node_voltages["2"],
                                  plain.node_voltages["2"])
    meas = BASICS01.replace(".end", ".meas ac vmax max vm(2)\n.end")
    got = simulate(meas, dialect="extended", device="cpu").meas
    want = spicey_tpu.simulate(meas, dialect="extended").meas
    assert list(got) == ["vmax"]
    np.testing.assert_allclose(got["vmax"], want["vmax"], rtol=1e-9)
    assert parse_netlist(meas, dialect="extended").meas[0].acc == "vm"
    # a deck without .ac has no AC result, as in the JAX package
    assert simulate_ac(parse_netlist("* empty\nr1 1 0 1k\n.end\n"),
                       device="cpu") is None
