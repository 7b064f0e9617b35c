"""The port's .four and .meas (single, batched and under .step) against
the JAX package on the CPU.

Every deck of tests/test_four.py and tests/test_meas.py goes through
``spicey_tpu.simulate`` and ``spicey_tpu_torch.simulate(device="cpu")``
from the same netlist: harmonic magnitudes, phases, normalized values and
THD at rtol 1e-9 with an atol of 1e-12 of the field's largest |value|
(the phases through the complex harmonics mag e^{j phase}, since the
angle of a harmonic near the waveform's rounding is that rounding over
its magnitude; THD, 100 |c_2..9| / |c_1|, at that atol times
100 / |c_1|), ``format_four_result`` string-equal (but on the uA741,
whose harmonics past the fundamental are ~1e-8 V);
every measurement at rtol 1e-9 with an atol of 1e-12 of the largest
|measurement| of the deck, NaN where the JAX package gives NaN. The
batched evaluation (``meas_batch`` over ``simulate_tran_batch``) and
``.step`` + ``.meas`` (``StepResult.meas``) are held the same way, and
the errors are the JAX package's, word for word.
"""

import math

import numpy as np
import pytest

import spicey_tpu as sj
import spicey_tpu_torch as st
from spicey_tpu.analysis.four import fourier_of_waveform as jax_fourier
from spicey_tpu_torch import decks
from spicey_tpu_torch.analysis.four import fourier_of_waveform

RTOL, ATOL = 1e-9, 1e-12
EXT = dict(dialect="extended")

FOUR_DECKS = {
    "sine_probe": """the sine probe
v1 in 0 SIN(0 1 1k)
r1 in out 1k
r2 out 0 1k
.tran 1u 5m
.four 1k v(out) v(in)
""",
    "diode_clipper": """the clipper
v1 in 0 SIN(0 2 1k)
r1 in out 1k
d1 out 0 dm
.model dm d(is=1e-12)
.tran 2u 4m
.four 1k v(out)
""",
    "ua741": decks.UA741_FOUR,
}

_RC = """the rc step for measures
v1 in 0 PWL(0 0 1u 1 10m 1)
r1 in out 1k
c1 out 0 1u
.tran 10u 10m
.meas tran vmax max v(out)
.meas tran vavg avg v(out) from=5m to=10m
.meas tran t63 when v(out)=0.632
.meas tran vat find v(out) at=1m
.meas tran d50 trig v(in)=0.5 rise=1 targ v(out)=0.5 rise=1
"""

MEAS_DECKS = {
    "rc_step": _RC,
    "sine_stats": """the sine stats
v1 out 0 SIN(1 2 1k)
r1 out 0 1k
.tran 1u 2m
.meas tran vpp pp v(out)
.meas tran vrms rms v(out) from=0 to=2m
.meas tran varea integ v(out) from=0 to=1m
.meas tran vmin min v(out)
""",
    "cross_counts": """the crossing counter
v1 out 0 SIN(0 1 1k)
r1 out 0 1k
.tran 1u 3m
.meas tran t2rise when v(out)=0 rise=2
.meas tran t2cross when v(out)=0 cross=2
.meas tran tfall when v(out)=0 fall=1
""",
    "missing_crossing": ("t\nv1 out 0 dc 1\nr1 out 0 1k\n.tran 1u 1m\n"
                         ".meas tran tx when v(out)=5\n"),
    "targ_before_trig": """the out-leads-in delay
v1 out 0 PWL(0 0 1m 1 10m 1)
v2 in 0 PWL(0 0 5m 0 6m 1 10m 1)
r1 out 0 1k
r2 in 0 1k
.tran 10u 10m
.meas tran d trig v(in)=0.5 rise=1 targ v(out)=0.5 rise=1
""",
    "window_edges": """the coarse ramp
v1 out 0 PWL(0 0 4m 4)
r1 out 0 1k
.tran 1m 4m
.meas tran a integ v(out) from=0.5m to=1.5m
.meas tran m avg v(out) from=0.5m to=1.5m
""",
    "simultaneous_crossing": """the instantaneous amplifier
v1 src 0 PWL(0 0 1m 1 10m 1)
e1 hi 0 src 0 10
rl hi 0 1k
.tran 10u 10m
.meas tran d trig v(src)=0.5 rise=1 targ v(hi)=5 rise=1
""",
    "ac_corner": """the rc lowpass for ac measures
v1 in 0 ac 1
r1 in out 1k
c1 out 0 159.154943092n
.ac dec 100 10 100k
.meas ac f3db when vdb(out)=-3.0102999566398
.meas ac gmax max vm(out)
.meas ac gmin min v(out)
.meas ac p3db find vp(out) at=1k
.meas ac re1 find vr(out) at=1k
.meas ac im1 find vi(out) at=1k
""",
    "dc_threshold": """the diode dc measure deck
V1 in 0 dc 0
R1 in a 1k
D1 a 0 DD
.model DD d(is=1e-14)
.dc V1 0 5 0.05
.meas dc von when v(a)=0.6
.meas dc vmax max v(a)
""",
    "ua741": decks.UA741_CONTROL.split(".control")[0],
}

_BATCH = """the mc rise time
v1 in 0 PWL(0 0 1u 1 10m 1)
r1 in out 1k
c1 out 0 1u
.tran 10u 10m
.meas tran trise trig v(in)=0.5 rise=1 targ v(out)=0.5 rise=1
.meas tran vrms rms v(out) from=1m to=10m
.meas tran tcross when v(out)=0.5 rise=1
.meas tran vmax max v(out)
.meas tran vat find v(out) at=2.5m
"""

_THRESHOLD = """the threshold yield
v1 in 0 PWL(0 0 1u 1 2m 1)
r1 in out 1k
c1 out 0 1u
.tran 10u 2m
.meas tran thit when v(out)=0.8 rise=1
"""


def same_values(got, want, what):
    """Arrays (or scalars) at RTOL with ATOL of the largest finite |value|,
    NaN exactly where ``want`` is NaN."""
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    fin = np.isfinite(want)
    scale = float(np.abs(want[fin]).max()) if fin.any() else 0.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL,
                               atol=ATOL * scale, err_msg=what)


def same_meas(got: dict, want: dict):
    assert list(got) == list(want)
    vals = np.asarray([want[k] for k in want], np.float64)
    fin = np.isfinite(vals)
    scale = float(np.abs(vals[fin]).max()) if fin.any() else 0.0
    for name, w in want.items():
        g = got[name]
        if math.isnan(w):
            assert math.isnan(g), name
        else:
            assert abs(g - w) <= RTOL * abs(w) + ATOL * scale, (name, g, w)


@pytest.mark.parametrize("deck", sorted(FOUR_DECKS))
def test_four_matches_jax(deck):
    net = FOUR_DECKS[deck]
    want = sj.simulate(net, **EXT).four
    got = st.simulate(net, device="cpu", **EXT).four
    assert got.fundamental == want.fundamental
    assert list(got.probes) == list(want.probes)
    for name, w in want.probes.items():
        g = got.probes[name]
        np.testing.assert_array_equal(g.freqs, w.freqs)
        for f in ("magnitude", "normalized"):
            same_values(getattr(g, f), getattr(w, f), f"{name} {f}")
        # the phases as the complex harmonics mag e^{j phase}: a small
        # harmonic's angle carries the waveform's rounding over |c_k|
        same_values(g.magnitude * np.exp(1j * np.radians(g.phase_deg)),
                    w.magnitude * np.exp(1j * np.radians(w.phase_deg)),
                    f"{name} harmonics")
        # THD is 100 |c_2..9| / |c_1|: the harmonics' atol carried over
        np.testing.assert_allclose(
            g.thd_percent, w.thd_percent, rtol=RTOL,
            atol=100.0 * ATOL * w.magnitude.max() / w.magnitude[1],
            err_msg=f"{name} thd")
    if deck != "ua741":
        assert st.format_four_result(got) == sj.format_four_result(want)


def test_four_of_waveform_matches_jax():
    """tests/test_four.py's pure sine and square wave through both
    packages' fourier_of_waveform."""
    t = np.linspace(0.0, 2e-3, 4001)
    sine = 0.5 + 2.0 * np.sin(2 * np.pi * 1000.0 * t + np.pi / 6)
    ts = np.linspace(0.0, 1e-3, 20001)
    square = np.sign(np.sin(2 * np.pi * 5000.0 * ts))
    for tt, y, f0 in ((t, sine, 1000.0), (ts, square, 5000.0)):
        got = fourier_of_waveform(tt, y, f0)
        want = jax_fourier(tt, y, f0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    mag, phase, _, thd = fourier_of_waveform(t, sine, 1000.0)
    assert mag[1] == pytest.approx(2.0, rel=1e-6) and thd < 1e-4
    assert phase[1] == pytest.approx(-60.0, abs=1e-3)


def test_four_physics_on_port():
    """The sine probe's divider, the clipper's distortion and the uA741's
    closed-loop gain of ~10 on a 20 mV drive (chip_smoke.py phase 24
    (b)'s bounds)."""
    r = st.simulate(FOUR_DECKS["sine_probe"], device="cpu", **EXT).four
    assert r.probes["in"].magnitude[1] == pytest.approx(1.0, rel=1e-3)
    assert r.probes["out"].magnitude[1] == pytest.approx(0.5, rel=1e-3)
    r = st.simulate(FOUR_DECKS["diode_clipper"], device="cpu", **EXT).four
    assert r.probes["out"].thd_percent > 5.0
    r = st.simulate(FOUR_DECKS["ua741"], device="cpu", **EXT).four
    assert r.probes["out"].magnitude[1] == pytest.approx(0.2, rel=0.03)
    assert r.probes["out"].thd_percent < 1.0
    assert st.format_four_result(None) == sj.format_four_result(None)


@pytest.mark.parametrize("deck", sorted(MEAS_DECKS))
def test_meas_matches_jax(deck):
    net = MEAS_DECKS[deck]
    want = sj.simulate(net, **EXT).meas
    got = st.simulate(net, device="cpu", **EXT).meas
    same_meas(got, want)


def test_meas_closed_forms():
    """tests/test_meas.py's RC step on the port: tau, ln 2 delay, NaN."""
    m = st.simulate(_RC, device="cpu", **EXT).meas
    assert m["t63"] == pytest.approx(1e-3, rel=0.02)
    assert m["d50"] == pytest.approx(1e-3 * math.log(2), rel=0.02)
    assert math.isnan(st.simulate(MEAS_DECKS["missing_crossing"],
                                  device="cpu", **EXT).meas["tx"])
    w = st.simulate(MEAS_DECKS["window_edges"], device="cpu", **EXT).meas
    assert w["a"] == pytest.approx(1e-3, rel=1e-9)


def test_meas_batch_matches_jax_and_single():
    """meas_batch over simulate_tran_batch: equal to the JAX package's
    distribution and, lane by lane, to the scalar path; an unmet crossing
    is NaN in its lane only."""
    r_vals = np.array([0.5e3, 1e3, 2e3, 4e3])
    got = st.meas_batch(st.parse_netlist(_BATCH, **EXT),
                        st.simulate_tran_batch(_BATCH, {"r1": r_vals},
                                               device="cpu", **EXT))
    jckt = sj.parse_netlist(_BATCH, **EXT)
    want = sj.meas_batch(jckt, sj.simulate_tran_batch(jckt, {"r1": r_vals}))
    assert list(got) == list(want)
    for name in want:
        same_values(got[name], want[name], name)
        assert got[name].shape == (4,)
    single = st.simulate(_BATCH.replace("r1 in out 1k", "r1 in out 2k"),
                         device="cpu", **EXT).meas
    for name, v in single.items():
        np.testing.assert_allclose(got[name][2], v, rtol=1e-9)
    thr = st.meas_batch(st.parse_netlist(_THRESHOLD, **EXT),
                        st.simulate_tran_batch(
                            _THRESHOLD, {"c1": np.array([1e-6, 1e-5])},
                            device="cpu", **EXT))["thit"]
    assert np.isfinite(thr[0]) and math.isnan(thr[1])


def test_step_meas_matches_jax():
    """.step + .meas fills StepResult.meas with one array per .meas tran
    name, equal to the JAX package's."""
    net = decks.STEP_MEAS.replace("100 1100 1", "100 1100 250")
    got = st.simulate(net, device="cpu", **EXT).step
    want = sj.simulate(net, **EXT).step
    assert list(got.meas) == list(want.meas) == ["vmax", "trise", "vavg"]
    for name, w in want.meas.items():
        same_values(got.meas[name], np.asarray(w), name)
        assert np.isfinite(got.meas[name]).all()


def test_meas_parse_and_errors_match_jax():
    """Parsing (the ``val=`` spelling, .meas ac/dc, the reference dialect)
    and every error of tests/test_meas.py, word for word."""
    spec = st.parse_netlist("t\nv1 out 0 dc 1\nr1 out 0 1k\n.tran 1u 1m\n"
                            ".measure tran tx when v(out) val=0.5 cross=3\n",
                            **EXT).meas[0]
    assert (spec.kind, spec.val, spec.edge, spec.k) == ("when", 0.5,
                                                         "cross", 3)
    plain = st.parse_netlist("t\nv1 1 0 dc 1\n.meas tran x max v(1)\n")
    assert plain.meas == [] and any(".meas" in s for s in plain.skipped)
    for bad in ("t\n.meas tran x bogus v(1)\n",
                "t\n.meas tran x when v(1)=0.5 cross=0\n"):
        with pytest.raises(ValueError) as jax_err:
            sj.parse_netlist(bad, **EXT)
        with pytest.raises(ValueError) as port_err:
            st.parse_netlist(bad, **EXT)
        assert str(port_err.value) == str(jax_err.value)
    for bad in ("t\nv1 1 0 dc 1\nr1 1 0 1k\n.meas tran x max v(1)\n",
                "t\nv1 1 0 dc 1\nr1 1 0 1k\n.tran 1u 1m\n"
                ".meas tran x max v(zz)\n",
                "the bad accessor deck\nv1 a 0 dc 1\nr1 a 0 1k\n"
                ".tran 1m 10m\n.meas tran x max vdb(a)\n",
                "the missing ac deck\nv1 a 0 dc 1\nr1 a 0 1k\n"
                ".tran 1m 10m\n.meas ac x max v(a)\n",
                "t\nv1 1 0 dc 1\nr1 1 0 1k\n.four 1k v(1)\n",
                "t\nv1 1 0 SIN(0 1 100)\nr1 1 0 1k\n.tran 1u 1m\n"
                ".four 100 v(1)\n",
                "t\nv1 1 0 SIN(0 1 1k)\nr1 1 0 1k\n.tran 1u 2m\n"
                ".four 1k v(zz)\n"):
        with pytest.raises(ValueError) as jax_err:
            sj.simulate(bad, **EXT)
        with pytest.raises(ValueError) as port_err:
            st.simulate(bad, device="cpu", **EXT)
        assert str(port_err.value) == str(jax_err.value)
