"""The rest of the port's public surface against the JAX package: the
reference's exported ``Complex``, the simulation-graph SVG, the
profiling spans, the waveform and number helpers, and
``__all__``.

``tests/test_complex.py``'s arithmetic runs on both packages' ``Complex``
with the same results bit for bit. ``tests/test_svg.py``'s renders (all
but the two comparison snapshots, which read recorded ngspice curves from
outside the repo) are made from the port's transients, string-equal to
the JAX package's render and to the committed snapshot. ``profiled()``
names the spans of every analysis a deck runs, as the JAX package's does.
"""

import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest

import spicey_tpu as sj
import spicey_tpu_torch as st
from spicey_tpu_torch import decks
from spicey_tpu_torch.utils import profiling
from tests.fixtures import netlists

SNAPSHOTS = Path(__file__).parent / "__snapshots__"


def test_complex_matches_jax():
    for pkg in (st, sj):
        a, b = pkg.Complex(1, 2), pkg.Complex(3, -1)
        assert a.add(b) == pkg.Complex(4, 1)
        assert a.sub(b) == pkg.Complex(-2, 3)
        assert a.mul(b) == pkg.Complex(5, 5)
        q, inv = a.div(b), b.inv()
        assert (q.re, q.im) == pytest.approx((0.1, 0.7))
        assert (inv.re, inv.im) == pytest.approx((0.3, 0.1))
        c = pkg.Complex.fromPolar(2.0, 90.0)
        assert c.re == pytest.approx(0.0, abs=1e-15) and c.abs() == 2.0
        assert c.phaseDeg() == pytest.approx(90.0)
        assert pkg.Complex.from_polar(1.0).re == 1.0
        assert complex(pkg.Complex(1, -2)) == 1 - 2j
        assert pkg.Complex(0.5, 0).clone() == pkg.Complex(0.5, 0)
        assert math.isclose(pkg.Complex(3, 4).abs(), 5.0)
        with pytest.raises(ZeroDivisionError):
            pkg.Complex(1, 0).div(pkg.Complex(0, 0))
        with pytest.raises(ZeroDivisionError):
            pkg.Complex(0, 0).inv()
    rng = np.random.default_rng(5)
    for re1, im1, re2, im2 in rng.standard_normal((50, 4)):
        for op in ("add", "sub", "mul", "div"):
            g = getattr(st.Complex(re1, im1), op)(st.Complex(re2, im2))
            w = getattr(sj.Complex(re1, im1), op)(sj.Complex(re2, im2))
            assert (g.re, g.im) == (w.re, w.im)
        assert (st.Complex(re1, im1).phase_deg()
                == sj.Complex(re1, im1).phase_deg())
        assert repr(st.Complex(re1, im1)) == repr(sj.Complex(re1, im1))


def _experiment(exp_id, name):
    return {"type": "simulation_experiment",
            "simulation_experiment_id": exp_id, "name": name,
            "experiment_type": "transient_simulation"}


SVG_CASES = {
    "transient01-rc-pulse": ("RC_PULSE", "rc_pulse_experiment",
                             "RC Circuit Pulse Response"),
    "vswitch-pwl-control": ("VSWITCH_PWL", "vswitch_pwl_spst",
                            "SPST switch under PWL control"),
    "switch-vt-vh-graph": ("SWITCH_VT_VH", "switch_vt_vh",
                           "Switch with Vt and Vh"),
    "two-probes-graph": ("TWO_PROBES", "two_probes", "Two Probes"),
}


def _render(pkg, net, exp_id, name):
    r = pkg.simulate(net, **({"device": "cpu"} if pkg is st else {}))
    graphs = pkg.spicey_tran_to_vgraphs(r.tran, r.circuit, exp_id)
    return pkg.convert_simulation_graphs_to_svg(
        [_experiment(exp_id, name), *graphs], exp_id)


@pytest.mark.parametrize("snap", sorted(SVG_CASES))
def test_svg_matches_jax_and_snapshot(snap):
    deck, exp_id, name = SVG_CASES[snap]
    net = getattr(netlists, deck)
    got = _render(st, net, exp_id, name)
    assert got == _render(sj, net, exp_id, name)
    assert got == (SNAPSHOTS / f"{snap}.snap.svg").read_text()
    assert got.startswith("<svg") and got.count("<polyline") >= 2


def test_svg_filters_experiments_and_empty():
    r = st.simulate(netlists.TWO_PROBES, device="cpu")
    graphs = st.spicey_tran_to_vgraphs(r.tran, r.circuit, "exp_a")
    other = st.spicey_tran_to_vgraphs(r.tran, r.circuit, "exp_b")
    cj = [_experiment("exp_a", "A"), *graphs, *other]
    svg = st.convert_simulation_graphs_to_svg(cj, "exp_a")
    assert svg.count("<polyline") == 2
    assert svg == st.convert_simulation_graphs_to_svg(cj, "exp_a")
    empty = [_experiment("empty", "Empty")]
    assert (st.convert_simulation_graphs_to_svg(empty, "empty")
            == sj.convert_simulation_graphs_to_svg(empty, "empty"))


def test_profiling_names_every_analysis_span(tmp_path):
    """simulate() inside profiled(): a span per analysis of the deck, each
    called once, named as the JAX package names them."""
    with st.profiled():
        st.simulate(decks.UA741_CONTROL, dialect="extended", device="cpu",
                    base_dir=str(tmp_path))
        with st.span("post"):
            pass
    rows = {line.split(", ")[0]: line.split(", ")[1:]
            for line in st.report().splitlines()[1:]}
    for name in ("parse", "op", "dc", "tf", "noise", "pz", "sens", "ac",
                 "tran", "four", "meas", "step", "control", "post"):
        assert rows[name][0] == "1", name
    # outside profiled() nothing is recorded
    before = st.report()
    with st.span("ignored"):
        pass
    assert st.report() == before
    with sj.profiled():
        sj.simulate(decks.UA741_CONTROL, dialect="extended",
                    base_dir=str(tmp_path))
    jax_spans = {line.split(", ")[0] for line in sj.report().splitlines()
                 if line.count(", ") == 3}
    port_spans = {line.split(", ")[0] for line in st.report().splitlines()
                  if line.count(", ") == 3} - {"post"}
    assert port_spans == jax_spans


def test_profiling_nests_spans():
    with profiling.profiled():
        with profiling.span("outer"):
            with profiling.span("inner"):
                pass
    names = [line.split(", ")[0] for line in profiling.report().splitlines()]
    assert names[1:] == ["outer", "outer/inner"]


def test_waveform_and_number_helpers_match_jax():
    for tok in ("1k", "2.2u", "10meg", "5", "-3m", "1e-9", "100n"):
        assert (st.parse_number_with_units(tok)
                == sj.parse_number_with_units(tok))
    args = "0 5 1u 1n 1n 5u 20u"
    gp, wp = st.parse_pulse_args(args), sj.parse_pulse_args(args)
    assert isinstance(gp, st.PulseSpec)
    assert dataclasses.astuple(gp) == dataclasses.astuple(wp)
    pwl = "0 0 1m 1 2m 0.5"
    assert st.parse_pwl_args(pwl) == sj.parse_pwl_args(pwl)
    for t in np.linspace(0, 40e-6, 81):
        assert st.pulse_value(gp, t) == sj.pulse_value(wp, t)
        assert (st.pwl_value(st.parse_pwl_args(pwl), t * 50)
                == sj.pwl_value(sj.parse_pwl_args(pwl), t * 50))


def test_all_covers_the_jax_surface():
    """Every public name of spicey_tpu is in the port's __all__, the mesh
    (make_mesh, sharder) and warmup included."""
    missing = set(sj.__all__) - set(st.__all__)
    assert missing == set()
    for name in st.__all__:
        assert hasattr(st, name), name


def test_public_attributes_cover_the_jax_package():
    """Every public module attribute of spicey_tpu (not only its __all__,
    which leaves out sensitivity_*, fit_*, FitResult,
    simulate_tran_adaptive, AdaptiveTranResult and count) is in the port,
    the mesh (make_mesh, sharder) and warmup included."""
    import types

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not isinstance(getattr(mod, n), types.ModuleType)}

    assert public(sj) - public(st) == set()
    for name in ("sensitivity_ac", "sensitivity_tran", "fit_ac", "fit_tran",
                 "FitResult", "simulate_tran_adaptive", "AdaptiveTranResult",
                 "count"):
        assert name in st.__all__, name


def test_profiling_counters_match_jax():
    """count() bumps a named counter inside profiled() only, and report()
    lists the counters after the spans as the JAX package does."""
    st.count("outside")
    reports = []
    for mod in (sj, st):
        with mod.profiled():
            with mod.span("s"):
                mod.count("solves")
                mod.count("solves", 2.5)
                mod.count("passes", 3)
        reports.append(mod.report().splitlines())
    jax_rep, port_rep = reports
    k = port_rep.index("counter, value")
    assert port_rep[k:] == jax_rep[jax_rep.index("counter, value"):]
    assert port_rep[k:] == ["counter, value", "passes, 3", "solves, 3.5"]
    with st.profiled():
        pass
    assert "counter, value" not in st.report()
