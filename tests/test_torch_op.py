"""The port's operating point, DC sweeps, op_batch and .tf against the JAX
package on the CPU.

The same netlists go through ``spicey_tpu`` (its host interp tier or its
compiled Newton on the CPU) and ``spicey_tpu_torch`` with
``device="cpu"`` (the plain version of kernel K2 in every Newton pass);
every node voltage and element current is held at rtol 1e-9 / atol 1e-12,
the repo's cross-tier tolerance. The decks are those of tests/test_op.py,
tests/test_op_convergence.py and tests/test_tf.py.
"""

import numpy as np
import pytest
import torch

import spicey_tpu as sj
from spicey_tpu.analysis.op import simulate_op as jax_simulate_op
from spicey_tpu.analysis.tf import simulate_tf as jax_simulate_tf
import spicey_tpu_torch as st
from spicey_tpu_torch import decks
from spicey_tpu_torch.analysis.op import GMIN_STEPS, SOURCE_STEPS

RTOL, ATOL = 1e-9, 1e-12

_SW = ("The t\n.model sm sw(ron=1 roff=1e9 von=2 voff=1)\n"
       "V1 1 0 DC 5\nVc c 0 DC {VC}\nR1 1 2 1k\nS1 2 0 c 0 sm\n")
_LATCH = """* latch
.model mn nmos(vto=1 kp=2m)
vdd vdd 0 5
r1 vdd q 10k
r2 vdd qb 10k
m1 q qb 0 mn
m2 qb q 0 mn
.op
{NS}.end
"""
_PBJT = ("x\n.model qn npn(is=1e-16 bf=100)\nvcc p 0 dc 10\nrc p c 5\n"
         "ib 0 b dc {IB}\nq1 c b 0 qn\n.op\n")

# name -> (netlist, dialect)
OP_DECKS = {
    "divider": ("The t\nV1 1 0 DC 10\nR1 1 2 1k\nR2 2 0 3k\n", "spicey"),
    "c_open": ("The t\nV1 1 0 DC 5\nR1 1 2 1k\nC1 2 0 1u\nR2 2 0 1k\n",
               "spicey"),
    "l_short": ("The t\nV1 1 0 DC 6\nR1 1 2 1k\nL1 2 3 10m\nR2 3 0 2k\n",
                "spicey"),
    "diode_fwd": ("The t\n.model dm d\nV1 1 0 DC 5\nR1 1 2 1k\nD1 2 0 dm\n",
                  "spicey"),
    "diode_rev": ("The t\n.model dm d\nV1 1 0 DC -5\nR1 1 2 1k\nD1 2 0 dm\n",
                  "spicey"),
    "switch_on": (_SW.format(VC=5), "spicey"),
    "switch_off": (_SW.format(VC=0), "spicey"),
    "current_source": ("The t\nI1 0 out dc 2m\nR1 out 0 1k\n", "extended"),
    "latch_q": (_LATCH.format(NS=".nodeset v(q)=5 v(qb)=0\n"), "extended"),
    "latch_qb": (_LATCH.format(NS=".nodeset v(q)=0 v(qb)=5\n"), "extended"),
    "power_diodes": ("x\n.model dm d(is=1e-14)\nv1 a 0 dc 100\nr1 a b 0.1\n"
                     "d1 b c dm\nd2 c d dm\nd3 d 0 dm\n.op\n", "extended"),
    "power_bjt": (_PBJT.format(IB="20m"), "extended"),
    "bjt_active": (_PBJT.format(IB="1m"), "extended"),
}


def _same_op(got, want):
    assert list(got.node_voltages) == list(want.node_voltages)
    assert list(got.element_currents) == list(want.element_currents)
    for series, ref in ((got.node_voltages, want.node_voltages),
                        (got.element_currents, want.element_currents)):
        for name, v in ref.items():
            np.testing.assert_allclose(series[name], v, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
    assert got.switch_states == want.switch_states


@pytest.mark.parametrize("deck", sorted(OP_DECKS))
def test_simulate_op_matches_jax(deck):
    net, dialect = OP_DECKS[deck]
    want = jax_simulate_op(sj.parse_netlist(net, dialect=dialect))
    got = st.simulate_op(st.parse_netlist(net, dialect=dialect),
                         device="cpu")
    _same_op(got, want)


def test_latch_nodeset_picks_the_basin():
    a = st.simulate(OP_DECKS["latch_q"][0], dialect="extended",
                    device="cpu").op
    b = st.simulate(OP_DECKS["latch_qb"][0], dialect="extended",
                    device="cpu").op
    assert a.node_voltages["q"] > 4.5 > 1.0 > a.node_voltages["qb"]
    assert b.node_voltages["qb"] > 4.5 > 1.0 > b.node_voltages["q"]


@pytest.mark.parametrize("deck,max_iters", [("diode_fwd", 8),
                                            ("latch_q", 5)])
def test_convergence_aids_match_jax(deck, max_iters):
    """With fewer passes than plain Newton needs (12 and 9 here), both
    packages walk the gmin then source-stepping ladder and take the same
    stages to the same answer; with 2 passes both give up."""
    net, dialect = OP_DECKS[deck]
    want = jax_simulate_op(sj.parse_netlist(net, dialect=dialect),
                           max_iters=max_iters)
    got = st.simulate_op(st.parse_netlist(net, dialect=dialect),
                         max_iters=max_iters, device="cpu")
    _same_op(got, want)
    if deck == "diode_fwd":
        with pytest.raises(ValueError, match="did not converge"):
            jax_simulate_op(sj.parse_netlist(net, dialect=dialect),
                            max_iters=2)
        with pytest.raises(ValueError, match="did not converge"):
            st.simulate_op(st.parse_netlist(net, dialect=dialect),
                           max_iters=2, device="cpu")


def test_singular_op_raises_as_in_jax():
    net = "The t\nV1 1 0 DC 5\nV2 1 0 DC 3\nR1 1 0 1k\n"
    with pytest.raises(ValueError, match="did not converge"):
        jax_simulate_op(sj.parse_netlist(net))
    with pytest.raises(ValueError, match="did not converge"):
        st.simulate_op(st.parse_netlist(net), device="cpu")


def test_unported_op_raises():
    # a B deck, refused before ROADMAP §1 item 2, matches the JAX package
    gmin = ("x\nv1 a 0 dc 1\nr1 a b 1\n"
            "b1 b 0 i=0.5*tanh(50*(v(b)-0.5))+0.5*v(b)\n.op\n")
    _same_op(st.simulate(gmin, dialect="extended", device="cpu").op,
             sj.simulate(gmin, dialect="extended").op)
    # method="schur" on a deck with no subcircuit structure: both packages
    # refuse it with the same ValueError (ROADMAP §1 item 6, ported)
    with pytest.raises(ValueError) as jerr:
        jax_simulate_op(sj.parse_netlist(OP_DECKS["divider"][0]),
                        method="schur")
    with pytest.raises(ValueError) as terr:
        st.simulate_op(st.parse_netlist(OP_DECKS["divider"][0]),
                       method="schur", device="cpu")
    assert str(terr.value) == str(jerr.value)
    # 131 unknowns of a flat divider chain: past N = 128 the port solves
    # dense, as the JAX package does on a deck with no subcircuit
    # structure (refused here before; tests/test_torch_large_n.py holds
    # such decks to the JAX package)
    big = "t\nv1 n0 0 dc 1\n" + "".join(
        f"r{i} n{i} n{i + 1} 1k\n" for i in range(129)) + "r129 n129 0 1k\n"
    op = st.simulate_op(st.parse_netlist(big), device="cpu")
    for k in (1, 65, 129):
        np.testing.assert_allclose(op.node_voltages[f"n{k}"], 1 - k / 130,
                                   rtol=RTOL, atol=ATOL)


# ---- .dc sweeps and op_batch ---------------------------------------------

DC_DECKS = {
    "divider": ("t\nv1 1 0 dc 1\nr1 1 2 1k\nr2 2 0 1k\n.dc v1 0 5 0.5\n"),
    "mos_transfer": ("t\n.model mn nmos(vto=1 kp=2m)\nvdd vdd 0 5\n"
                     "vg gt 0 1\nrd vdd d 1k\nm1 d gt 0 mn\n"
                     ".dc vg 0 3 0.25\n"),
    "current_source": "t\ni1 0 out 1m\nr1 out 0 1k\n.dc i1 0 5m 1m\n",
    "mos_output_2d": ("t\n.model mn nmos(vto=1 kp=2m lambda=0.02)\n"
                      "vds d 0 1\nvgs gt 0 1\nm1 d gt 0 mn\n"
                      ".dc vds 0 5 0.5 vgs 1 3 1\n"),
    "bjt_ib": ("t\n.model qn npn(is=1e-16 bf=100)\nvcc vcc 0 5\n"
               "ib 0 bs 10u\nrc vcc c 1k\nq1 c bs 0 qn\n.dc ib 2u 20u 2u\n"),
}


@pytest.mark.parametrize("deck", sorted(DC_DECKS))
def test_simulate_dc_matches_jax(deck):
    net = DC_DECKS[deck]
    want = sj.simulate(net, dialect="extended").dc
    got = st.simulate(net, dialect="extended", device="cpu").dc
    np.testing.assert_array_equal(got.sweep, want.sweep)
    np.testing.assert_array_equal(got.valid, want.valid)
    assert got.shape2d == want.shape2d
    if want.sweep2 is not None:
        np.testing.assert_array_equal(got.sweep2, want.sweep2)
    assert list(got.node_voltages) == list(want.node_voltages)
    assert list(got.element_currents) == list(want.element_currents)
    for series, ref in ((got.node_voltages, want.node_voltages),
                        (got.element_currents, want.element_currents)):
        for name, v in ref.items():
            np.testing.assert_allclose(series[name], v, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
    assert got.passes.shape == got.sweep.shape and (got.passes >= 1).all()
    assert st.format_dc_result(got) == sj.format_dc_result(want)


def test_dc_unknown_source_raises():
    net = "t\nv1 1 0 dc 1\nr1 1 0 1k\n.dc vmissing 0 1 0.1\n"
    with pytest.raises(ValueError, match="Unknown .dc source"):
        st.simulate(net, dialect="extended", device="cpu")


def test_op_batch_matches_dc_sweep_and_jax():
    net = DC_DECKS["bjt_ib"]
    ckt = st.parse_netlist(net, dialect="extended")
    dc = st.simulate(net, dialect="extended", device="cpu").dc
    ob = st.op_batch(ckt, {"ib": dc.sweep}, device="cpu")
    np.testing.assert_allclose(ob.node_voltage("c"), dc.node_voltages["c"],
                               rtol=1e-12)
    assert ob.valid.all()
    np.testing.assert_array_equal(ob.passes, dc.passes)
    want = sj.op_batch(sj.parse_netlist(net, dialect="extended"),
                       {"ib": dc.sweep})
    np.testing.assert_allclose(ob.x, np.asarray(want.x), rtol=RTOL,
                               atol=ATOL)


def test_op_batch_overrides_match_jax():
    """A resistor, a V source's DC level and a BJT's Is swept at once:
    the BJT_NET bias around VIN's pulse levels."""
    rng = np.random.default_rng(4)
    B = 12
    net = decks.BJT_NET
    over = {"Q1": 1e-15 * (1 + 0.2 * rng.random(B)),
            "RB": 1e4 * (1 + 0.1 * rng.random(B)),
            "VIN": 0.6 + 0.1 * rng.random(B)}
    want = sj.op_batch(net, over, dialect="extended")
    got = st.op_batch(net, over, dialect="extended", device="cpu")
    np.testing.assert_array_equal(got.valid, np.asarray(want.valid))
    np.testing.assert_allclose(got.x, np.asarray(want.x), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(ValueError, match="unknown elements"):
        st.op_batch(net, {"nope": np.ones(B)}, dialect="extended",
                    device="cpu")



# ---- op_batch on the uA741 .step: the reference, the ladder, the spans ---

def _ua741_rfb(B: int, seed: int) -> np.ndarray:
    """B feedback resistors drawn as the benchmark's cell draws them:
    U(0.5, 2.0) x 10k, the .step's range."""
    return 1e4 * np.random.default_rng(seed).uniform(0.5, 2.0, B)


def test_op_batch_ua741_step_matches_the_plain_reference():
    """16 seeded draws of the uA741 inverter's feedback resistor through
    op_batch equal portbench's plain reference (its own reader, MNA and
    Newton) within the cell's op_gap limit, every lane valid."""
    from portbench.core import manifest

    ref = manifest.module("reference", "ua741-step")
    deck = manifest.Cell("ua741-step-f64").deck_text
    rfb = _ua741_rfb(16, 2095434620)
    got = st.op_batch(deck, {"rfb": rfb}, dialect="extended", device="cpu")
    v, names, ok, _info = ref.operating_points(deck, {"rfb": rfb},
                                               torch.float64,
                                               torch.device("cpu"))
    assert got.valid.all() and bool(ok.all())
    want = v.numpy()
    x = np.stack([got.node_voltage(n) for n in names], axis=1)
    assert np.abs(x - want).max() / np.abs(want).max() <= 1e-10
    np.testing.assert_allclose(got.node_voltage("out"), -rfb / 1e3 * 0.05,
                               rtol=5e-3)


# a pass limit that leaves some of these lanes to the aids (they need up
# to 16 passes; the aids' stages converge within it)
LADDER_ITERS = 12
# feedback resistors in a narrow window (about 5510.43-5510.53 ohm) where
# the batched Newton from rest falls into a cycle and runs out its 100
# passes on the CPU and on the card alike; both drawn by the benchmark's
# cell (seed 2095434620, jobs 4 and 28), whose runs then failed
LIMIT_CYCLE_RFB = (5510.492746322804, 5510.495543018835)


def _newton_alone(rfb, max_iters):
    """The batched Newton without its aids on op_batch's inputs (what
    op_batch answered before it had them): host (x, valid, passes)."""
    from spicey_tpu_torch.analysis import batch, op

    ckt = st.parse_netlist(decks.UA741_STEP, dialect="extended")
    t = st.build_tensors(ckt)
    over, B, cpu = {"rfb": np.asarray(rfb)}, len(rfb), torch.device("cpu")
    dump = t.nvar + t.n_l

    def remapped(arrays):
        return {k: (torch.where(v == t.nvar, dump, v)
                    if k.endswith("idx") else v) for k, v in arrays.items()}

    return op._batched_op(
        ckt, t, batch._batch_values(t.v_dc, t.v_names, over, B),
        batch._batch_values(t.i_dc, t.i_names, over, B),
        batch._batch_values(t.r_vals, t.r_names, over, B), B, max_iters,
        op._tol_floor(1e-12), "gj", cpu,
        ext=remapped(batch._batched_ext(t, over, B, cpu, torch.float64)),
        nl=remapped(batch._batched_nl(t, over, B, cpu, torch.float64)))


def _ua741_op(rfb, max_iters=100):
    return st.op_batch(decks.UA741_STEP, {"rfb": np.asarray(rfb)},
                       dialect="extended", device="cpu", max_iters=max_iters)


def _simulate_op_at(rfb: float, max_iters: int = 100) -> np.ndarray:
    deck = decks.UA741_STEP.replace("rfb minus out 10k",
                                    f"rfb minus out {float(rfb)!r}")
    op = st.simulate_op(st.parse_netlist(deck, dialect="extended"),
                        max_iters=max_iters, device="cpu")
    return np.array(list(op.node_voltages.values()))


def test_op_batch_ladder_rescues_lanes_as_simulate_op():
    """Lanes the batched Newton leaves invalid (a pass limit under what
    they need) take simulate_op's aids: each ends valid, equal bit for bit
    to simulate_op of the same deck at the same limit, its passes the
    Newton's and every stage's."""
    rfb = _ua741_rfb(40, 7)
    _x0, valid0, passes0 = _newton_alone(rfb, LADDER_ITERS)
    got = _ua741_op(rfb, LADDER_ITERS)
    rescued = np.flatnonzero(~valid0)
    assert len(rescued) >= 2 and got.valid.all()
    assert (got.passes[rescued] > passes0[rescued]).all()
    for k in rescued[:2]:
        want = _simulate_op_at(rfb[k], LADDER_ITERS)
        np.testing.assert_array_equal(got.x[k, :len(want)], want)


def test_op_batch_plain_lanes_keep_their_answers_bit_for_bit():
    """The lanes the batched Newton solves keep its x and its passes bit
    for bit, whether or not other lanes take the aids."""
    rfb = _ua741_rfb(40, 7)
    for max_iters, aided in ((LADDER_ITERS, True), (100, False)):
        x0, valid0, passes0 = _newton_alone(rfb, max_iters)
        got = _ua741_op(rfb, max_iters)
        assert valid0.all() != aided and got.valid.all()
        np.testing.assert_array_equal(got.x[valid0], x0[valid0])
        np.testing.assert_array_equal(got.passes[valid0], passes0[valid0])


def test_op_batch_ladder_rescues_the_newton_limit_cycle():
    """The two draws of the limit cycle fail the batched Newton at its
    full pass limit; the aids solve them to simulate_op's answer, and the
    lane beside them keeps the Newton's."""
    rfb = np.array([LIMIT_CYCLE_RFB[0], 1e4, LIMIT_CYCLE_RFB[1]])
    x0, valid0, passes0 = _newton_alone(rfb, 100)
    np.testing.assert_array_equal(valid0, [False, True, False])
    np.testing.assert_array_equal(passes0[[0, 2]], [100, 100])
    got = _ua741_op(rfb)
    assert got.valid.all() and (got.passes[[0, 2]] > 100).all()
    np.testing.assert_array_equal(got.x[1], x0[1])
    want = _simulate_op_at(LIMIT_CYCLE_RFB[0])
    np.testing.assert_array_equal(got.x[0, :len(want)], want)
    np.testing.assert_allclose(got.node_voltage("out")[[0, 2]],
                               -np.array(LIMIT_CYCLE_RFB) / 1e3 * 0.05,
                               rtol=5e-3)


def test_op_batch_ladder_keeps_an_unsolved_lane_invalid():
    """A lane that no stage solves (a pass limit too small for every
    stage) is reported invalid with its answer, never dropped."""
    got = _ua741_op(_ua741_rfb(6, 11), max_iters=2)
    assert got.x.shape[0] == 6 and not got.valid.any()
    assert (got.passes > 2).all()


def test_op_batch_spans_and_counters():
    """Under profiled(): op_batch's span with prepare, solve, fetch and,
    when the Newton leaves lanes invalid, ladder (a solve and a fetch in
    it for each stage of the aids); the Newton's batched
    passes and its lanes' passes, the lanes it left to the aids and those
    they rescued, the aids' batched passes, one bool(...all()) a batched
    pass and one fetch a batched Newton. Outside, nothing is recorded and
    the answer is the same bit for bit."""
    from spicey_tpu_torch.utils import profiling

    rfb = _ua741_rfb(24, 7)
    _x0, valid0, passes0 = _newton_alone(rfb, LADDER_ITERS)
    plain = _ua741_op(rfb, LADDER_ITERS)
    with profiling.profiled():
        got = _ua741_op(rfb, LADDER_ITERS)
    names = [q for q, _s, _e in profiling.intervals()]
    c = profiling.counters()
    np.testing.assert_array_equal(got.x, plain.x)
    np.testing.assert_array_equal(got.passes, plain.passes)
    assert [q for q in names if q.count("/") <= 1] == [
        "op_batch/prepare", "op_batch/solve", "op_batch/fetch",
        "op_batch/ladder", "op_batch"]
    stages = [q for q in names if q.count("/") == 2]
    assert stages == ["op_batch/ladder/solve", "op_batch/ladder/fetch"] \
        * (len(stages) // 2)
    sent = int((~valid0).sum())
    assert sent >= 1 and c["op.ladder_lanes"] == c["op.ladder_rescued"] \
        == sent
    assert c["op.newton_passes"] == LADDER_ITERS == passes0.max()
    assert c["op.lane_passes"] == passes0.sum()
    ladder = c["op.ladder_passes"]
    assert 0 < ladder <= (plain.passes - passes0).sum()
    assert c["sync.newton_done"] == LADDER_ITERS + ladder
    # one fetch for the Newton and one for each stage of the aids
    assert c["sync.fetch"] == 1 + len(stages) // 2
    assert 2 <= c["sync.fetch"] <= 1 + len(GMIN_STEPS) + len(SOURCE_STEPS)
    with profiling.profiled():
        small = _ua741_op(rfb[:4])
    assert [q for q, _s, _e in profiling.intervals()] == [
        "op_batch/prepare", "op_batch/solve", "op_batch/fetch", "op_batch"]
    c = profiling.counters()
    assert c["op.ladder_lanes"] == 0 and "op.ladder_passes" not in c
    assert c["op.newton_passes"] == small.passes.max()
    assert c["sync.newton_done"] == small.passes.max()
    assert c["sync.fetch"] == 1
    before = profiling.counters()
    _ua741_op(rfb[:2])
    assert profiling.counters() == before


# ---- .tf -----------------------------------------------------------------

TF_DECKS = {
    "divider": ("the divider\nv1 in 0 dc 10\nr1 in out 1k\nr2 out 0 3k\n"
                ".tf v(out) v1\n"),
    "differential": ("the diff output\nv1 in 0 dc 1\nr1 in a 1k\n"
                     "r2 a b 1k\nr3 b 0 1k\n.tf v(a,b) v1\n"),
    "current_input": ("the norton\ni1 0 in 1m\nr1 in 0 2k\nr2 in out 1k\n"
                      "r3 out 0 1k\n.tf v(out) i1\n"),
    "l_short": ("the l short\nv1 in 0 dc 1\nl1 in mid 10m\nr1 mid out 1k\n"
                "r2 out 0 1k\n.tf v(out) v1\n"),
    "c_open": ("the c open\nv1 in 0 dc 1\nr1 in out 1k\nc1 in out 1u\n"
               "r2 out 0 1k\n.tf v(out) v1\n"),
    "vcvs": ("the amp\nv1 in 0 dc 0.1\nr1 in g 1k\nr2 g 0 1k\n"
             "e1 out 0 g 0 10\n.tf v(out) v1\n"),
    "diode": ("the diode bias\nv1 in 0 dc 5\nr1 in out 1k\nd1 out 0 dm\n"
              ".model dm d(is=1e-14)\n.tf v(out) v1\n"),
    "mosfet_cs": ("the cs amp\nvdd vdd 0 dc 5\nvin g 0 dc 1.5\n"
                  "rd vdd out 10k\nm1 out g 0 mn\n"
                  ".model mn nmos(vto=1 kp=2e-4)\n.tf v(out) vin\n"),
    "opdctf_bench": decks.OPDCTF_DECK,
}


@pytest.mark.parametrize("deck", sorted(TF_DECKS))
def test_simulate_tf_matches_jax(deck):
    net = TF_DECKS[deck]
    want = jax_simulate_tf(sj.parse_netlist(net, dialect="extended"))
    got = st.simulate(net, dialect="extended", device="cpu").tf
    for f in ("transfer_function", "input_impedance", "output_impedance"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    assert (got.out_spec, got.src_name) == (want.out_spec, want.src_name)
    assert st.format_tf_result(got) == sj.format_tf_result(want)


def test_tf_takes_the_jax_operating_point():
    """``op=`` carries the operating point across: the JAX package's
    OPResult is read as it is."""
    net = TF_DECKS["mosfet_cs"]
    jckt = sj.parse_netlist(net, dialect="extended")
    op = jax_simulate_op(jckt)
    want = jax_simulate_tf(jckt, op=op)
    ckt = st.parse_netlist(net, dialect="extended")
    got = st.simulate_tf(ckt, tensors=st.from_jax_tensors(
        sj.build_tensors(jckt)), op=op, device="cpu")
    np.testing.assert_allclose(got.transfer_function,
                               want.transfer_function, rtol=RTOL)
    np.testing.assert_allclose(got.output_impedance, want.output_impedance,
                               rtol=RTOL)
    assert got.input_impedance == want.input_impedance == float("inf")


@pytest.mark.parametrize("net,match", [
    ("t\nv1 1 0 dc 1\nr1 1 0 1k\n.tf v(1) vx\n", "Unknown source"),
    ("t\nv1 1 0 dc 1\nr1 1 0 1k\n.tf v(zz) v1\n", "Unknown node"),
])
def test_tf_bad_spec_raises(net, match):
    with pytest.raises(ValueError, match=match):
        sj.simulate(net, dialect="extended")
    with pytest.raises(ValueError, match=match):
        st.simulate(net, dialect="extended", device="cpu")
