"""The port's Monte-Carlo AC path against the JAX package on the CPU.

The fused tier's plain version (the CPU version of kernel K5) is held to
the Pallas kernel ``mc_ac_fused_f32`` in interpret mode at rtol 2e-5, the
tolerance ``tests/test_pallas_fused.py`` sets for the f32 fused tier. The
f64 statistics are held to the JAX f64 plane-GJ tier at rtol 1e-9, the
repo's cross-tier tolerance. Inputs are made with numpy from a seed and
handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spicey_tpu.analysis.mc as jmc
from spicey_tpu import parse_netlist as jparse
from spicey_tpu.ir.circuit import build_tensors as jbuild
from spicey_tpu.ops import pallas_mc_ac as jfused
from spicey_tpu_torch import mc_ac_sampled, mc_ac_stats, parse_netlist
from spicey_tpu_torch.analysis import mc as tmc
from spicey_tpu_torch.ir.circuit import build_tensors
from spicey_tpu_torch.ops import mc_ac_fused as tfused

RC_NET = ("fused tier rc\nv1 1 0 dc 0 ac 1\nr1 1 2 30\nc1 2 0 100u\n"
          ".ac dec 5 1 100\n.end\n")

EXT_NET = """an extended fused-tier deck
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
.ac dec 2 10 1e5
.end
"""

# node 2 hangs between two capacitors: zeroing both in one lane leaves it
# floating, a singular system
SINGULAR_NET = ("* cap divider\nv1 1 0 ac 1\nc1 1 2 1u\nc2 2 0 1u\n"
                ".ac dec 2 1 100\n.end\n")

DECKS = {"rc": (RC_NET, "2", ("r1", "c1")),
         "ext": (EXT_NET, "d", ("R1", "C1", "L1", "R4"))}


def _overrides(net, names, B, seed):
    """Each named R/C/L element at its netlist value times U(1, 1.2)."""
    rng = np.random.default_rng(seed)
    t = build_tensors(parse_netlist(net))
    base = dict(zip([n.lower() for n in t.r_names + t.c_names + t.l_names],
                    np.concatenate([t.r_vals, t.c_vals, t.l_vals])))
    return {n: base[n.lower()] * (1 + 0.2 * rng.random(B)) for n in names}


def _stats_close(a, b, rtol):
    for f in ("mean", "std", "min", "max"):
        x, y = getattr(a, f), getattr(b, f)
        np.testing.assert_allclose(x, y, rtol=rtol,
                                   atol=rtol * float(np.max(np.abs(y))),
                                   err_msg=f)
    for q in b.quantiles:
        np.testing.assert_allclose(a.quantiles[q], b.quantiles[q], rtol=rtol,
                                   err_msg=f"q{q}")
    assert a.n_valid == b.n_valid and a.n_total == b.n_total


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_stamp_pattern_equals_jax(deck):
    net, _node, _names = DECKS[deck]
    jt = jbuild(jparse(net))
    t = build_tensors(parse_netlist(net))
    ext_idx = {k: getattr(jt, k) for k in
               ("i_idx", "g_idx", "e_idx", "f_idx", "h_idx")}
    want = jfused.build_stamp_pattern(jt.nvar, jt.r_idx, jt.c_idx, jt.l_idx,
                                      jt.v_idx, ext_idx)
    got = tfused.build_stamp_pattern(t.nvar, t.r_idx, t.c_idx, t.l_idx,
                                     t.v_idx, {k: getattr(t, k)
                                               for k in ext_idx})
    assert got == want
    packed = tfused.pack_pattern(got, t.nvar, "cpu")
    n_terms = sum(len(ts) for _ij, ts in want[1] + want[2])
    assert packed.terms.shape == (n_terms, 3)
    # every position of both planes is either an entry or zeroed
    assert packed.ent.shape[0] + packed.zeros.shape[0] \
        == 2 * t.nvar * (t.nvar + 1)


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_plain_fused_f32_matches_pallas_kernel(deck):
    net, node, names = DECKS[deck]
    B = 40
    ov = _overrides(net, names, B, seed=3)
    ckt = parse_netlist(net)
    t = build_tensors(ckt)
    f32 = torch.float32
    ext = tmc._batched_ext(t, ov, B, "cpu", f32)
    iph = np.deg2rad(t.i_ac_phase_deg)
    ph = np.deg2rad(t.v_ac_phase_deg)

    def vals(base, names_):
        return torch.as_tensor(tmc._batch_values(base, names_, ov, B),
                               dtype=f32)

    v_re = torch.as_tensor(t.v_ac_mag * np.cos(ph), dtype=f32).expand(B, -1)
    v_im = torch.as_tensor(t.v_ac_mag * np.sin(ph), dtype=f32).expand(B, -1)
    i_re = torch.as_tensor(t.i_ac_mag * np.cos(iph), dtype=f32)
    i_im = torch.as_tensor(t.i_ac_mag * np.sin(iph), dtype=f32)
    values = tfused.combine_values(
        vals(t.r_vals, t.r_names), vals(t.c_vals, t.c_names),
        vals(t.l_vals, t.l_names), v_re, v_im, ext=ext, i_re=i_re,
        i_im=i_im, dtype=f32)
    # the JAX row stacking of the same arrays is identical
    jvals = jfused.combine_values(
        *(jnp.asarray(a.numpy()) for a in (
            vals(t.r_vals, t.r_names), vals(t.c_vals, t.c_names),
            vals(t.l_vals, t.l_names), v_re, v_im)),
        ext={k: jnp.asarray(v.numpy()) for k, v in ext.items()},
        i_re=jnp.asarray(i_re.numpy()), i_im=jnp.asarray(i_im.numpy()))
    np.testing.assert_array_equal(values.numpy(), np.asarray(jvals))

    freqs = tmc.build_frequency_array(ckt.ac.mode, ckt.ac.N, ckt.ac.f1,
                                      ckt.ac.f2)
    node_idx = [n.upper() for n in t.node_names].index(node.upper())
    pattern = tfused.build_stamp_pattern(
        t.nvar, t.r_idx, t.c_idx, t.l_idx, t.v_idx,
        {k: getattr(t, k) for k in ("i_idx", "g_idx", "e_idx", "f_idx",
                                   "h_idx")})
    mag, valid = tfused.mc_ac_fused(
        torch.as_tensor(freqs, dtype=f32), values,
        tfused.pack_pattern(pattern, t.nvar, "cpu"), node_idx)
    jmag, jvalid = jfused.mc_ac_fused_f32(
        jnp.asarray(freqs, jnp.float32), jnp.asarray(values.numpy()),
        t.nvar, node_idx, pattern, interpret=True)
    assert mag.shape == (B, len(freqs)) and mag.dtype == f32
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(mag.numpy(), np.asarray(jmag), rtol=2e-5)


@pytest.mark.parametrize("deck", sorted(DECKS))
@pytest.mark.parametrize("method", ["gj", "pallas"])
def test_f64_stats_match_jax_gj(deck, method):
    net, node, names = DECKS[deck]
    ov = _overrides(net, names, 32, seed=5)
    ref = jmc.mc_ac_stats(jparse(net), ov, node=node, method="gj",
                          precision="f64")
    got = mc_ac_stats(net, ov, node=node, method=method, precision="f64",
                      device="cpu")
    _stats_close(got, ref, rtol=1e-9)


def test_f32_fused_close_to_f64_reference():
    net, node, names = DECKS["rc"]
    ov = _overrides(net, names, 48, seed=0)
    ref = jmc.mc_ac_stats(jparse(net), ov, node=node, method="gj",
                          precision="f64")
    got = mc_ac_stats(net, ov, node=node, method="pallas", precision="f32",
                      device="cpu")
    for f in ("mean", "std", "min", "max"):
        np.testing.assert_allclose(
            getattr(got, f), getattr(ref, f), rtol=2e-5,
            atol=2e-5 * float(np.max(np.abs(getattr(ref, f)))))
    assert got.n_valid == ref.n_valid == 48


@pytest.mark.parametrize("method", ["gj", "pallas"])
def test_singular_lane_is_excluded(method):
    B = 12
    c = np.full(B, 1e-6)
    c[3] = 0.0
    ov = {"c1": c.copy(), "c2": c.copy()}
    got = mc_ac_stats(SINGULAR_NET, ov, node="2", method=method,
                      device="cpu")
    ref = jmc.mc_ac_stats(jparse(SINGULAR_NET), ov, node="2", method="gj")
    assert got.n_valid == ref.n_valid == B - 1
    np.testing.assert_allclose(got.mean, ref.mean, rtol=1e-9)


@pytest.mark.parametrize("q_method", ["exact", "approx"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mask_ndim", [1, 2])
def test_stats_of_matches_jax(q_method, dtype, mask_ndim):
    rng = np.random.default_rng(11)
    B, F = 40, 7
    resp = rng.lognormal(size=(B, F)).astype(dtype)
    valid = rng.random((B, F) if mask_ndim == 2 else (B,)) > 0.2
    qs = (5.0, 50.0, 95.0)
    want = jmc._stats_of(jnp.asarray(resp), jnp.asarray(valid), qs,
                         q_method=q_method)
    got = tmc._stats_of(torch.as_tensor(resp), torch.as_tensor(valid), qs,
                        q_method=q_method)
    rtol = 1e-12 if dtype == np.float64 else 2e-6
    for k in ("mean", "std", "min", "max", "q"):
        assert got[k].dtype == torch.from_numpy(resp).dtype, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=rtol, err_msg=k)


def test_exact_quantile_of_an_empty_column_is_nan():
    resp = torch.ones((4, 2), dtype=torch.float64)
    valid = torch.tensor([[True, False]] * 4)
    q = tmc._stats_of(resp, valid, (50.0,))["q"]
    assert q[0, 0] == 1.0 and torch.isnan(q[0, 1])


@pytest.mark.parametrize("dist", ["lognormal", "normal"])
def test_sampler_transform_matches_jax(dist, monkeypatch):
    net = RC_NET
    spreads = {"r1": 0.05, "C1": 0.1}
    B = 16
    z = np.random.default_rng(9).standard_normal((B, 2))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape: jnp.asarray(z))
    want = jmc._sampled_values(jbuild(jparse(net)), spreads, B, 0, dist)
    t = build_tensors(parse_netlist(net))
    got = tmc._spread_values(t, tmc._sample_targets(t, spreads),
                             torch.as_tensor(z), dist)
    for g in ("r", "c", "l"):
        assert got[g].dtype == torch.float64
        np.testing.assert_allclose(got[g].numpy(), np.asarray(want[g]),
                                   rtol=1e-15)


def test_sampled_is_seeded_and_chunking_is_invisible():
    kw = dict(node="2", method="pallas", precision="f64", device="cpu")
    a = mc_ac_sampled(RC_NET, {"r1": 0.05, "c1": 0.05}, 30, key=1, **kw)
    b = mc_ac_sampled(RC_NET, {"r1": 0.05, "c1": 0.05}, 30, key=1,
                      chunk=7, **kw)
    c = mc_ac_sampled(RC_NET, {"r1": 0.05, "c1": 0.05}, 30, key=2, **kw)
    assert a.n_valid == a.n_total == 30
    # the chunked response is laid out differently, so the f64 sums may
    # round in another order
    _stats_close(b, a, rtol=1e-13)
    assert not np.allclose(a.mean, c.mean, rtol=1e-9)
    with pytest.raises(ValueError, match="unknown sampled element"):
        mc_ac_sampled(RC_NET, {"r9": 0.1}, 4, node="2", device="cpu")


def test_unported_options_raise():
    with pytest.raises(ValueError, match="precision"):
        mc_ac_stats(RC_NET, {"r1": np.ones(2)}, node="2", precision="f16",
                    device="cpu")
    # a K deck, refused before ROADMAP §1 item 2, runs and matches the
    # JAX package
    k_net = ("* k deck\nv1 1 0 ac 1\nl1 1 0 1m\nl2 2 0 1m\nr1 2 0 1k\n"
             "k1 l1 l2 0.5\n.ac dec 2 1 100\n.end\n")
    # l2 moves M = k sqrt(L1 L2) and with it |V(2)| ~ M / L1 (an r1 sweep
    # would leave the two lanes equal to ~1e-12, their std cancellation)
    ov = {"l2": np.array([1e-3, 4e-3])}
    got = mc_ac_stats(k_net, ov, node="2", dialect="extended", device="cpu")
    want = jmc.mc_ac_stats(k_net, ov, node="2", dialect="extended")
    assert got.n_valid == want.n_valid == 2
    _stats_close(got, want, rtol=1e-9)
    # method="schur" on a deck with no subcircuit structure: both packages
    # refuse it with the same ValueError (ROADMAP §1 item 6, ported)
    with pytest.raises(ValueError) as jerr:
        jmc.mc_ac_stats(RC_NET, {"r1": np.ones(2)}, node="2",
                        method="schur")
    with pytest.raises(ValueError) as terr:
        mc_ac_stats(RC_NET, {"r1": np.ones(2)}, node="2", method="schur",
                    device="cpu")
    assert str(terr.value) == str(jerr.value)
