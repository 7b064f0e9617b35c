"""K (mutual inductance) decks through the port against the JAX package.

The literal decks of ``tests/test_coupling.py`` (the transformer in AC and
in the transient, the k -> 0 limit, perfect coupling, a K inside a
subcircuit, three windings, the batch and Monte-Carlo entry points and the
K-element override) go through ``spicey_tpu`` and ``spicey_tpu_torch``
(``device="cpu"``: the plain versions of kernels K1-K4) and are held to
the north star's f64 tolerance: rtol 1e-9 with an atol of 1e-12 of the
largest value of the field (node voltages, element currents; a batch's
solutions, which hold volts and amps in one x, of their largest value).
The JAX package's batch and Monte-Carlo transients run their sequential
scan (``time_parallel="never"``; the port has no time-parallel core yet,
ROADMAP §1 item 3). The coupled-inductance inverse ``tran._mutual_inv``
is held to the JAX package's at 1e-12 with its per-variant ``ok`` flags,
and a ``method="pallas"`` K deck must not reach the fused kernels (K5,
K7, K8), which know no coupled inductance.
"""

import numpy as np
import pytest
import torch

import spicey_tpu as sj
from spicey_tpu.analysis import batch as jbatch
from spicey_tpu.analysis import mc as jmc
from spicey_tpu.analysis.tran import _mutual_inv as jax_mutual_inv
import spicey_tpu_torch as st
from spicey_tpu_torch.analysis import batch as tbatch
from spicey_tpu_torch.analysis import mc as tmc
from spicey_tpu_torch.analysis.tran import _mutual_inv
from tests.test_coupling import (TRANSFORMER_AC, TRANSFORMER_TRAN,
                                 _analytic_transformer)
from tests.test_torch_fuzz import _hold

RTOL, ATOL_OF_MAX = 1e-9, 1e-12
XFMR = TRANSFORMER_TRAN.format(K="k1 l1 l2 0.9\n")
THREE = """* three winding
v1 in 0 dc 0 ac 1
r1 in p 10
l1 p 0 1m
l2 s1 0 1m
l3 s2 0 1m
k12 l1 l2 0.6
k13 l1 l3 0.6
k23 l2 l3 0.3
ra s1 0 50
rb s2 0 50
.ac lin 3 1k 3k
.end
"""
SUBCKT = """* coupled sub
.subckt xfmr pin sout
l1 pin 0 1m
l2 sout 0 4m
k1 l1 l2 0.9
.ends
v1 in 0 dc 0 ac 1 SIN(0 1 1k)
r1 in p 10
x1 p s xfmr
rload s 0 100
.tran 2u 5m
.end
"""


def _x_close(got, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_OF_MAX * float(np.abs(want).max()))


def _stats_close(got, want, rtol=RTOL) -> None:
    assert got.n_valid == want.n_valid and got.n_total == want.n_total
    for f in ("mean", "std", "min", "max"):
        y = getattr(want, f)
        np.testing.assert_allclose(getattr(got, f), y, rtol=rtol,
                                   atol=rtol * float(np.abs(y).max()),
                                   err_msg=f)


def test_ac_transformer_matches_jax_and_analytic():
    got = st.simulate(TRANSFORMER_AC, dialect="extended", device="cpu").ac
    want = sj.simulate(TRANSFORMER_AC, dialect="extended").ac
    np.testing.assert_array_equal(got.freqs, want.freqs)
    _hold(got, want, "transformer ac")
    ref = _analytic_transformer(got.freqs)
    for k, node in enumerate(("p", "s")):
        np.testing.assert_allclose(got.node_voltages[node], ref[:, k],
                                   rtol=1e-12, atol=1e-14)
    # the secondary current returns through the load
    np.testing.assert_allclose(got.element_currents["l2"],
                               -got.node_voltages["s"] / 100.0, rtol=1e-10,
                               atol=1e-16)


@pytest.mark.parametrize("integration", ["be", "trap", "gear2"])
def test_tran_transformer_matches_jax(integration):
    got = st.simulate_tran(st.parse_netlist(XFMR, dialect="extended"),
                           integration=integration, device="cpu")
    want = sj.simulate_tran(sj.parse_netlist(XFMR, dialect="extended"),
                            integration=integration)
    np.testing.assert_array_equal(got.times, want.times)
    _hold(got, want, f"transformer {integration}")


def test_k_zero_limit_and_subckt_scope_match_jax():
    """k = 1e-9 (the scalar limit) and a K inside a subcircuit."""
    for net in (TRANSFORMER_TRAN.format(K="k1 l1 l2 1e-9\n"), SUBCKT):
        got = st.simulate(net, dialect="extended", device="cpu").tran
        _hold(got, sj.simulate(net, dialect="extended").tran, "k tran")
    np.testing.assert_allclose(
        got.node_voltages["s"],
        st.simulate(XFMR, dialect="extended", device="cpu")
        .tran.node_voltages["s"], atol=1e-12)


def test_three_windings_match_jax():
    got = st.simulate(THREE, dialect="extended", device="cpu").ac
    _hold(got, sj.simulate(THREE, dialect="extended").ac, "three winding")
    np.testing.assert_allclose(np.abs(got.node_voltages["s1"]),
                               np.abs(got.node_voltages["s2"]), rtol=1e-10)


def test_perfect_coupling_is_flagged_singular():
    """k = 1 makes M singular: ``simulate`` raises as the JAX package
    does, and the batch entry points flag that lane invalid, the others
    equal to the JAX package's."""
    net = TRANSFORMER_TRAN.format(K="k1 l1 l2 1\n")
    with pytest.raises(ValueError, match="[Ss]ingular"):
        sj.simulate(net, dialect="extended")
    with pytest.raises(ValueError, match="[Ss]ingular"):
        st.simulate(net, dialect="extended", device="cpu")
    ks = {"k1": np.array([0.5, 1.0])}
    got = st.simulate_ac_batch(TRANSFORMER_AC, ks, dialect="extended",
                               device="cpu")
    want = jbatch.simulate_ac_batch(TRANSFORMER_AC, ks, dialect="extended")
    np.testing.assert_array_equal(got.valid, np.asarray(want.valid))
    assert got.valid[0].all() and not got.valid[1].any()
    _x_close(got.x[0], want.x[0])
    short = XFMR.replace(".tran 2u 5m", ".tran 2u 0.2m")
    got = st.simulate_tran_batch(short, ks, dialect="extended", device="cpu")
    want = jbatch.simulate_tran_batch(short, ks, dialect="extended",
                                      time_parallel="never")
    np.testing.assert_array_equal(got.valid, [True, False])
    np.testing.assert_array_equal(got.valid, np.asarray(want.valid))
    _x_close(got.xs[0], np.asarray(want.xs)[0])


def test_noise_with_coupling_matches_jax():
    net = TRANSFORMER_AC.replace(".ac lin 5 1k 5k",
                                 ".noise v(s) v1 lin 5 1k 5k")
    got = st.simulate(net, dialect="extended", device="cpu").noise
    want = sj.simulate(net, dialect="extended").noise
    for f in ("output_psd", "gain"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, atol=0.0, err_msg=f)
    assert list(got.contributions) == list(want.contributions)
    for name, c in want.contributions.items():
        np.testing.assert_allclose(got.contributions[name], c, rtol=RTOL,
                                   err_msg=name)
    bad = net.replace("k1 l1 l2 0.9", "k1 l1 l2 1")
    for sim in (lambda: sj.simulate(bad, dialect="extended"),
                lambda: st.simulate(bad, dialect="extended", device="cpu")):
        with pytest.raises(ValueError, match="Singular coupled-inductance"):
            sim()


@pytest.mark.parametrize("key,vals", [("rload", [100.0, 200.0]),
                                      ("k1", [0.3, 0.9])])
def test_batch_apis_match_jax(key, vals):
    """The batch AC and transient with a load or a K coefficient swept
    (the coupling override), as test_coupling.py's batch tests run them."""
    ov = {key: np.asarray(vals)}
    got = st.simulate_ac_batch(TRANSFORMER_AC, ov, dialect="extended",
                               device="cpu")
    want = jbatch.simulate_ac_batch(TRANSFORMER_AC, ov, dialect="extended")
    assert got.valid.all()
    _x_close(got.x, want.x)
    net = XFMR.replace(".tran 2u 5m", ".tran 2u 1m")
    got = st.simulate_tran_batch(net, ov, dialect="extended", device="cpu")
    want = jbatch.simulate_tran_batch(net, ov, dialect="extended",
                                      time_parallel="never")
    assert got.valid.all()
    _x_close(got.xs, want.xs)
    if key == "k1":
        ref03 = _analytic_transformer(
            st.simulate(TRANSFORMER_AC, dialect="extended",
                        device="cpu").ac.freqs, k=0.3)
        s_col = [n.upper() for n in got.node_names].index("S")
        np.testing.assert_allclose(
            st.simulate_ac_batch(TRANSFORMER_AC, ov, dialect="extended",
                                 device="cpu").x[0, :, s_col],
            ref03[:, 1], rtol=1e-10)


def test_mc_stats_match_jax():
    rng = np.random.default_rng(0)
    over = {"rload": 100.0 * (0.9 + 0.2 * rng.random(8)),
            "l2": 4e-3 * (0.9 + 0.2 * rng.random(8))}
    got = st.mc_ac_stats(TRANSFORMER_AC, over, node="s", dialect="extended",
                         device="cpu")
    _stats_close(got, jmc.mc_ac_stats(TRANSFORMER_AC, over, node="s",
                                      dialect="extended"))
    assert got.n_valid == 8
    net = XFMR.replace(".tran 2u 5m", ".tran 2u 1m")
    got = st.mc_tran_stats(net, over, node="s", dialect="extended",
                           device="cpu")
    _stats_close(got, jmc.mc_tran_stats(net, over, node="s",
                                        dialect="extended",
                                        time_parallel="never"))
    assert got.n_valid == 8


def test_mutual_inv_matches_jax():
    """M^{-1} per variant (ops/linsolve.inverse, K3's plain version here)
    against the JAX package's column solves at 1e-12, with a singular
    (k = 1) variant flagged in both."""
    rng = np.random.default_rng(3)
    B, n_l = 6, 3
    l_vals = 1e-3 * (0.5 + rng.random((B, n_l)))
    pairs = np.array([[0, 1], [0, 2], [1, 2]], np.int32)
    k_vals = rng.uniform(-0.6, 0.6, (B, 3))
    k_vals[2] = [1.0, 0.0, 0.0]
    lk = {"k_pairs": torch.as_tensor(pairs, dtype=torch.int64),
          "k_vals": torch.as_tensor(k_vals)}
    got, ok = _mutual_inv(torch.as_tensor(l_vals), lk)
    want, want_ok = jax_mutual_inv(l_vals, {"k_pairs": pairs,
                                            "k_vals": k_vals})
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    assert not ok[2] and ok.sum() == B - 1
    np.testing.assert_allclose(got.numpy()[ok.numpy()],
                               np.asarray(want)[ok.numpy()], rtol=1e-12)


def test_pallas_k_deck_skips_the_fused_kernels(monkeypatch):
    """``method="pallas"`` on a K deck takes the general routes (K1 with
    K3's M^{-1}; the loop with K3), never K5, K7 or K8, as the JAX package
    gates them (mc.py:505, :617): the statistics equal the JAX package's
    pallas tier, f32 at the fused tier's 2e-5."""
    def refuse(*_a, **_k):
        raise AssertionError("a fused kernel ran on a K deck")

    for name in ("mc_ac_fused", "mc_ac_fused_x"):
        monkeypatch.setattr(tmc if name == "mc_ac_fused" else tbatch, name,
                            refuse)
    monkeypatch.setattr(tmc.mtf, "mc_tran_fused", refuse)
    ckt = st.parse_netlist(TRANSFORMER_AC, dialect="extended")
    assert tbatch._fused_pattern(ckt, st.build_tensors(ckt), "pallas",
                                 "cpu") is None
    ov = {"rload": np.array([90.0, 110.0])}
    got = st.simulate_ac_batch(TRANSFORMER_AC, ov, dialect="extended",
                               method="pallas", device="cpu")
    _x_close(got.x, jbatch.simulate_ac_batch(
        TRANSFORMER_AC, ov, dialect="extended", method="pallas",
        interpret=True).x)
    for precision, rtol in (("f64", RTOL), ("f32", 2e-5)):
        got = st.mc_ac_stats(TRANSFORMER_AC, ov, node="s", method="pallas",
                             precision=precision, dialect="extended",
                             device="cpu")
        _stats_close(got, jmc.mc_ac_stats(
            TRANSFORMER_AC, ov, node="s", method="pallas",
            precision=precision, dialect="extended", interpret=True), rtol)
    net = XFMR.replace(".tran 2u 5m", ".tran 2u 0.1m")
    got = st.mc_tran_stats(net, ov, node="s", method="pallas",
                           precision="f32", dialect="extended", device="cpu")
    _stats_close(got, jmc.mc_tran_stats(
        net, ov, node="s", method="pallas", precision="f32",
        dialect="extended", time_parallel="never", interpret=True), 2e-5)
