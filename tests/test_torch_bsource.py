"""B (behavioral) sources and POLY sources through the port against the JAX
package.

``parsing/bexpr.py``'s torch table and ``bexpr_partials`` (one forward-mode
pass per reference) are held to the JAX package's ``compile_bexpr`` and
``jax.jvp`` against unit tangents on every function of the table, at
1e-12, including ``abs`` at 0, ``min``/``max`` at ties and with a literal
argument, and a constant expression broadcast to the batch. Then the
literal decks of ``tests/test_bsource.py`` and ``tests/test_poly.py`` (POLY
sources lower to B sources) go through ``spicey_tpu`` and
``spicey_tpu_torch`` (``device="cpu"``) in every analysis they name, and
a B deck's ``.step`` lanes (.op, .ac, .tran), held
at rtol 1e-9 with an atol of 1e-12 of the largest value of the field (node
voltages, element currents, each B source's current among them), and the
uA741 macromodel's operating point once (the JAX package marks its uA741
tests slow; the .tran and .step forms run on the card, chip_smoke.py
phase 23). A ``method="pallas"`` f32 B deck must not reach the fused
kernels K8/K9, which know no expression.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spicey_tpu as sj
from spicey_tpu.analysis import batch as jbatch
from spicey_tpu.analysis import mc as jmc
from spicey_tpu.analysis.ac import simulate_ac as jax_simulate_ac
from spicey_tpu.parsing.bexpr import compile_bexpr as jax_compile
import spicey_tpu_torch as st
from spicey_tpu_torch.analysis import mc as tmc
from spicey_tpu_torch.parsing.bexpr import bexpr_partials, compile_bexpr
from tests.fixtures.ua741 import UA741
from tests.test_poly import BASE, OPAMP
from tests.test_torch_fuzz import _hold

RTOL, ATOL_OF_MAX = 1e-9, 1e-12

# every function of the table with two references; the points keep each
# in its domain and hit abs at 0 and the min/max ties
EXPRS = {
    "sqrt": "sqrt(v(a)) * v(b)", "exp": "exp(0.5 * v(a) - v(b))",
    "log": "log(v(a) * v(b))", "log10": "log10(v(a) + v(b))",
    "sin": "sin(3 * v(a)) + v(b)", "cos": "cos(v(a) * v(b))",
    "tan": "tan(0.3 * v(a)) * v(b)", "tanh": "2 * tanh(5 * v(a)) - v(b)",
    "sinh": "sinh(v(a) - v(b))", "cosh": "cosh(v(a)) / v(b)",
    "atan": "atan(v(a) / v(b))", "abs": "abs(v(a) - 1) * v(b)",
    "min": "min(v(a), v(b)) + min(v(a), 0.7)",
    "max": "max(v(a), v(b)) ** 2 - max(1.5, v(b))",
}
POINTS = np.array([[0.2, 0.7], [1.0, 1.0], [1.5, 0.3], [0.7, 1.5],
                   [2.0, 2.0]])
BV = ("* bv\nv1 in 0 SIN(0 0.2 1k)\nrb in 0 1k\n"
      "bamp out 0 V=2*tanh(5*v(in))\nrl out 0 1k\n.tran 10u 1m\n.end\n")
BQ = ("* b batch\nv1 in 0 5\nr1 in a 1k\nbload a 0 I=1m*v(a)**2\n"
      ".tran 10u 100u\n.end\n")
DECKS = {
    "bi_load_op": "* b\nv1 in 0 5\nr1 in a 1k\nbload a 0 I=1m*v(a)**2\n"
                  ".op\n.end\n",
    "bv_tanh_tran": BV,
    "time_dependent": "* tb\nbsrc a 0 I=-1m*(1+sin(6283.185307179586*time))"
                      "\nr1 a 0 1k\n.tran 10u 1m\n.end\n",
    "current_ref": "* mirror\nv1 in 0 5\nr1 in a 1k\nvsense a 0 0\n"
                   "bmir out 0 I=-2*i(vsense)\nrload out 0 100\n.op\n.end\n",
    "dc_sweep": "* b dc\nv1 in 0 5\nr1 in a 1k\nbload a 0 I=1m*v(a)**2\n"
                ".dc v1 0 5 1\n.end\n",
    "bv_short_in_ac": "* b ac\nv1 in 0 dc 1 ac 1\nr1 in out 1k\n"
                      "bamp out 0 V=2*tanh(5*v(in))\n.ac lin 2 1k 2k\n.end\n",
    "tf_gain": "* tf bamp\nv1 in 0 dc 0\nrb in 0 1k\n"
               "bamp out 0 V=2*tanh(5*v(in))\nrl out 0 1k\n"
               ".tf v(out) v1\n.end\n",
    "tf_gain_biased": "* tf bamp\nv1 in 0 dc 0.2\nrb in 0 1k\n"
                      "bamp out 0 V=2*tanh(5*v(in))\nrl out 0 1k\n"
                      ".tf v(out) v1\n.end\n",
    "noise": "* b noise\nv1 in 0 dc 5\nr1 in a 1k\nbload a 0 I=1m*v(a)**2\n"
             ".noise v(a) v1 lin 2 1k 2k\n.end\n",
    "tran_batch_deck": BQ,
}
_POLY2 = ("x\nva a 0 dc 1.5\nvb b 0 dc 2.5\ne1 out 0 POLY(2) a 0 b 0 {C}\n"
          "rl out 0 1k\n.op\n")
POLY = {
    "e_poly1": BASE.format(src="e1 out 0 POLY(1) in 0 0 3"),
    "g_poly1": BASE.format(src="g1 0 out POLY(1) in 0 0 2m"),
    "g_quadratic": BASE.format(src="g1 0 out POLY(1) in 0 0 0 1m"),
    "poly2_sum": _POLY2.format(C="0 1 1"),
    "poly2_product": _POLY2.format(C="0 0 0 0 1 0"),
    "f_poly1": "x\nv1 in 0 dc 2\nr0 in 0 1k\nf1 0 out POLY(1) v1 0 -2\n"
               "rl out 0 1k\n.op\n",
    "h_poly1": "x\nv1 in 0 dc 2\nr0 in 0 1k\nh1 out 0 POLY(1) v1 1 500\n"
               "rl out 0 1k\n.op\n",
    "subckt": "x\n.subckt dbl in out\ne1 out 0 POLY(1) in 0 0 2\n"
              "rl out 0 10k\n.ends\nv1 a 0 dc 1.5\nx1 a b dbl\n.op\n",
    "opamp_limits": OPAMP + "\nvin in 0 dc 2\nxo1 in fb out opamp\n"
                    "rf out fb 9k\nrg fb 0 1k\n.op\n",
    "opamp_closed_loop": OPAMP + "\nvin in 0 dc 0.01 ac 1\n"
                         "xo1 in fb out opamp\nrf out fb 9k\nrg fb 0 1k\n"
                         ".op\n.ac dec 10 10 10meg\n.options acop\n",
}
UA741_OP = UA741 + """
vcc vcc 0 dc 15
vee vee 0 dc -15
vin in 0 dc 0.1 ac 1
rin in minus 1k
rfb minus out 10k
xamp 0 minus vcc vee out ua741
.op
"""


def _same(got, want, what: str) -> None:
    """Every analysis ``want`` ran, held field by field."""
    for an in ("op", "ac", "tran", "dc"):
        w = getattr(want, an)
        if w is not None:
            _hold(getattr(got, an), w, f"{what} {an}")
    if want.tf is not None:
        for f in ("transfer_function", "input_impedance",
                  "output_impedance"):
            np.testing.assert_allclose(getattr(got.tf, f),
                                       getattr(want.tf, f), rtol=RTOL,
                                       atol=1e-12, err_msg=f)
    if want.noise is not None:
        for f in ("output_psd", "gain"):
            np.testing.assert_allclose(getattr(got.noise, f),
                                       getattr(want.noise, f), rtol=RTOL,
                                       atol=0.0, err_msg=f)


@pytest.mark.parametrize("fn", sorted(EXPRS))
def test_partials_match_jax_jvp(fn):
    """Value and per-reference partials of every table function against
    ``jax.jvp`` with unit tangents (the JAX package's linearization)."""
    expr = EXPRS[fn]
    refs, f_t = compile_bexpr(expr, backend="torch")
    j_refs, f_j = jax_compile(expr)
    assert refs == j_refs
    f0, gs = bexpr_partials(f_t, torch.as_tensor(POINTS), 0.0)
    vals = jnp.asarray(POINTS)
    want0 = f_j(vals, 0.0)
    # atol: a few ulps of the O(1) terms (2 tanh(10) - 2 cancels to 1e-8)
    np.testing.assert_allclose(f0.numpy(), np.asarray(want0), rtol=1e-12,
                               atol=1e-15)
    for j, g in enumerate(gs):
        e = jnp.zeros_like(vals).at[:, j].set(1.0)
        _, gj = jax.jvp(lambda v: f_j(v, 0.0), (vals,), (e,))
        # atol: 10 d tanh(5 v)/dv = 10 (1 - tanh^2) at v = 2 cancels to
        # 8e-8 in both packages, an ulp of tanh apart (2.2e-15)
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-12,
                                   atol=1e-14, err_msg=f"d/dref{j}")


def test_expression_forms():
    """A constant and a time-only expression broadcast to the batch; the
    NumPy closure (the host epilogues') equals the torch one; the
    parser's errors are the JAX package's."""
    for expr, want in (("sqrt(2)*3", np.sqrt(2.0) * 3), ("5", 5.0)):
        _, fn = compile_bexpr(expr, backend="torch")
        f0, gs = bexpr_partials(fn, torch.zeros((4, 0), dtype=torch.float64),
                                0.0)
        assert f0.shape == (4,) and gs == []
        np.testing.assert_allclose(f0.numpy(), want, rtol=1e-15)
    expr = "-1m*(1+sin(6283.185307179586*time)) + 2*v(a)"
    _, f_np = compile_bexpr(expr)
    _, f_t = compile_bexpr(expr, backend="torch")
    v = np.array([[0.1], [0.3]])
    np.testing.assert_allclose(f_t(torch.as_tensor(v), 1e-4).numpy(),
                               f_np(v, 1e-4), rtol=1e-15)
    for bad, match in (("v(a,b,c)", "malformed"), ("foo + 1", "unknown name"),
                       ("__import__('os').system('x')",
                        "unsupported|malformed")):
        with pytest.raises(ValueError, match=match):
            compile_bexpr(bad, backend="torch")
    with pytest.raises(ValueError, match="backend"):
        compile_bexpr("1", backend="jnp")


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_bsource_decks_match_jax(deck):
    net = DECKS[deck]
    _same(st.simulate(net, dialect="extended", device="cpu"),
          sj.simulate(net, dialect="extended"), deck)


@pytest.mark.parametrize("deck", sorted(POLY))
def test_poly_decks_match_jax(deck):
    net = POLY[deck]
    _same(st.simulate(net, dialect="extended", device="cpu"),
          sj.simulate(net, dialect="extended"), deck)


def test_ua741_operating_point_matches_jax():
    """The unmodified uA741 macromodel (POLY(2)/POLY(5) sources lowered to
    B sources, a BJT pair, diode clamps): inverting x10 on +-15 V."""
    got = st.simulate(UA741_OP, dialect="extended", device="cpu").op
    _hold(got, sj.simulate(UA741_OP, dialect="extended").op, "ua741 op")
    assert got.node_voltages["out"] == pytest.approx(-1.0, rel=5e-3)


def test_bi_linearized_ac_matches_jax():
    """An I-kind source's op-point conductance in ``linearize="op"`` AC:
    g = 2m * v = 4 mS at v = 2."""
    net = ("* bi ac linearized\nv1 in 0 dc 2 ac 1\nbload in 0 I=1m*v(in)**2\n"
           ".ac lin 2 1k 2k\n.end\n")
    got = st.simulate_ac(st.parse_netlist(net, dialect="extended"),
                         linearize="op", device="cpu")
    want = jax_simulate_ac(sj.parse_netlist(net, dialect="extended"),
                           linearize="op")
    _hold(got, want, "bi acop")
    np.testing.assert_allclose(np.abs(got.element_currents["v1"]), 4e-3,
                               rtol=1e-9)


def test_batched_paths_match_jax():
    """The nonlinear load per variant through ``simulate_tran_batch`` and
    ``mc_tran_stats``, and the V-kind short through the batch AC."""
    rs = np.array([1e3, 2e3])
    got = st.simulate_tran_batch(BQ, {"r1": rs}, dialect="extended",
                                 device="cpu")
    want = jbatch.simulate_tran_batch(BQ, {"r1": rs}, dialect="extended")
    assert got.valid.all()
    np.testing.assert_allclose(got.xs, np.asarray(want.xs), rtol=RTOL,
                               atol=ATOL_OF_MAX * float(np.abs(want.xs).max()))
    ov = {"r1": np.linspace(1e3, 2e3, 8)}
    got = st.mc_tran_stats(BQ, ov, node="a", dialect="extended",
                           device="cpu")
    want = jmc.mc_tran_stats(BQ, ov, node="a", dialect="extended")
    assert got.n_valid == want.n_valid == 8
    for f in ("mean", "std", "min", "max"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, err_msg=f)
    net = DECKS["bv_short_in_ac"]
    got = st.simulate_ac_batch(net, {"r1": rs}, dialect="extended",
                               device="cpu")
    want = jbatch.simulate_ac_batch(net, {"r1": rs}, dialect="extended")
    assert got.valid.all()
    np.testing.assert_allclose(got.x, np.asarray(want.x), rtol=RTOL,
                               atol=1e-12)


def test_pallas_f32_b_deck_skips_the_fused_kernels(monkeypatch):
    """``method="pallas", precision="f32"`` on a B deck runs the batched
    loop (K2 every pass on the card), never K8/K9 (the JAX package's gate,
    mc.py:505): the same statistics as ``method="gj"`` at f32, bit for bit,
    and the JAX package's pallas tier at the f32 tolerance."""
    def refuse(*_a, **_k):
        raise AssertionError("a fused kernel ran on a B deck")

    monkeypatch.setattr(tmc.mtf, "mc_tran_fused", refuse)
    ckt = st.parse_netlist(BV, dialect="extended")
    assert tmc._fused_tran_pattern(ckt, st.build_tensors(ckt), "pallas",
                                   "f32", "be", False, "cpu") is None
    net = BV.replace(".tran 10u 1m", ".tran 10u 0.2m")
    ov = {"rl": 1e3 * np.array([0.9, 1.0, 1.1])}
    kw = dict(node="out", precision="f32", dialect="extended")
    got = st.mc_tran_stats(net, ov, method="pallas", device="cpu", **kw)
    ref = st.mc_tran_stats(net, ov, method="gj", device="cpu", **kw)
    for f in ("mean", "std", "min", "max"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    want = jmc.mc_tran_stats(net, ov, method="pallas", interpret=True, **kw)
    assert got.n_valid == want.n_valid == 3
    for f in ("mean", "min", "max"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=2e-5, atol=2e-5, err_msg=f)


def test_step_lanes_of_a_b_deck_match_jax():
    """``.step`` over a B deck: its .op, .ac (the V-kind source a 0 V
    short) and .tran lanes (Newton to convergence) against the JAX
    package's."""
    net = ("* b step\nv1 in 0 dc 0.1 ac 1 SIN(0.1 0.1 1k)\nrb in 0 1k\n"
           "bamp out 0 V=2*tanh(5*v(in))\nrl out 0 1k\n.op\n"
           ".ac lin 3 1k 3k\n.tran 50u 1m\n.step param rl 500 1500 500\n")
    got = st.simulate(net, dialect="extended", device="cpu").step
    want = sj.simulate(net, dialect="extended").step
    for an, x in (("op", "x"), ("ac", "x"), ("tran", "xs")):
        g, w = getattr(got, an), getattr(want, an)
        assert g.valid.all() and np.asarray(w.valid).all(), an
        w_x = np.asarray(getattr(w, x))
        np.testing.assert_allclose(getattr(g, x), w_x, rtol=RTOL,
                                   atol=ATOL_OF_MAX * float(np.abs(w_x).max()),
                                   err_msg=an)
