"""The port's Monte-Carlo transient against the JAX package on the CPU.

The fused tier's plain versions (the CPU versions of kernels K8 and K9)
are held to the Pallas kernel ``mc_tran_fused_f32`` in interpret mode,
K8 at rtol 2e-5 and K9 at 2e-4 (``tests/test_pallas_fused.py``'s f32
tolerance; K9 iterates f32 Newton), ``valid`` identical, with few steps
and few variants (interpret mode is slow). The f64 statistics are held
to the JAX package's sequential scan (``time_parallel="never"``) at rtol
1e-9, the repo's cross-tier tolerance, with MOSFET and BJT name
overrides sweeping beta and Is. Inputs are made with numpy from a seed
and handed to both packages; the sampled path is fed the port's own
draws on the JAX side.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spicey_tpu.analysis.mc as jmc
from spicey_tpu import parse_netlist as jparse
from spicey_tpu.ir.circuit import build_tensors as jbuild
from spicey_tpu.ops import pallas_mc_tran as jfused
from spicey_tpu_torch import (decks, mc_tran_sampled, mc_tran_stats,
                              parse_netlist)
from spicey_tpu_torch.analysis import batch as tbatch
from spicey_tpu_torch.analysis import mc as tmc
from spicey_tpu_torch.constants import VT_300K
from spicey_tpu_torch.ir.circuit import (build_tensors, effective_time_step,
                                         sample_source_values)
from spicey_tpu_torch.ops import mc_tran_fused as tfused
from tests.fixtures import netlists
from tests.test_torch_tran import NONLINEAR

# the RC pulse deck of the tran MC bench, cut to 21 steps
RC = ("* tran bench\nV1 1 0 PULSE(0 5 0 1n 1n 5u 10u)\nR1 1 2 1k\n"
      "C1 2 0 1u\n.tran 1u 20u\n.end\n")
EXT = """an extended linear transient
I1 0 a PULSE(0 1m 0 1u 1u 5u 10u)
R1 a 0 1k
G1 0 b a 0 2m
R2 b 0 500
E1 c 0 b 0 3
R3 c d 100
C1 d 0 1u
V1 e 0 PULSE(0 5 0 1n 1n 5u 10u)
R4 e d 200
F1 0 b V1 0.5
H1 f 0 V1 50
R5 f d 300
L1 d 0 10m
.tran 1u 12u
.end
"""
DECKS = {"rc": (RC, "2", ("R1", "C1"), "spicey"),
         "ext": (EXT, "d", ("R1", "C1", "L1", "R4", "G1"), "extended"),
         "boost": (netlists.BOOST_CONVERTER, "N3", ("RR1", "CC1"),
                   "spicey"),
         "ring": (NONLINEAR["ring"], "n1", ("c1", "c2", "mn1", "mp2"),
                  "extended"),
         "bjt": (NONLINEAR["bjt_net"], "c1", ("RC", "Q1"), "extended"),
         "jfet": (NONLINEAR["jfet"], "d1", ("RD", "J1"), "extended")}


def _overrides(key, B, seed):
    """Each name's netlist value x U(1, 1.2); a MOSFET/JFET name sweeps
    its beta (model units), a BJT name its Is."""
    net, _node, names, dialect = DECKS[key]
    rng = np.random.default_rng(seed)
    t = build_tensors(parse_netlist(net, dialect=dialect))
    base = dict(zip([n.lower() for n in t.r_names + t.c_names + t.l_names
                     + t.g_names + t.m_names + t.q_names],
                    np.concatenate([t.r_vals, t.c_vals, t.l_vals, t.g_gm,
                                    t.m_beta / t.m_beta_scale, t.q_is])))
    return {n: base[n.lower()] * (1 + 0.2 * rng.random(B)) for n in names}


def _jax_pattern(jt):
    """The JAX package's full pattern of a deck."""
    return jfused.build_tran_pattern(
        jt.nvar, jt.r_idx, jt.c_idx, jt.l_idx, jt.v_idx, jt.n_i,
        {k: getattr(jt, k) for k in ("i_idx", "g_idx", "e_idx", "f_idx",
                                    "h_idx")},
        s_idx=jt.s_idx, d_idx=jt.d_idx, m_idx=jt.m_idx, m_pol=jt.m_polarity,
        q_idx=jt.q_idx, q_pol=jt.q_polarity, d_chg=bool(jt.has_d_charge),
        q_chg=bool(jt.has_q_charge))


def _stats_close(a, b, rtol, std_rtol=None):
    """Every statistic at ``rtol``; the std at ``std_rtol`` when given (the
    std of near-identical variants is cancellation-limited in f32:
    ``tests/test_pallas_fused.py`` holds it at 2e-2)."""
    np.testing.assert_array_equal(a.grid, b.grid)
    for f in ("mean", "std", "min", "max"):
        x, y = getattr(a, f), getattr(b, f)
        tol = std_rtol if f == "std" and std_rtol is not None else rtol
        np.testing.assert_allclose(x, y, rtol=tol,
                                   atol=tol * float(np.max(np.abs(y))),
                                   err_msg=f)
    for q in b.quantiles:
        y = b.quantiles[q]
        np.testing.assert_allclose(a.quantiles[q], y, rtol=rtol,
                                   atol=rtol * float(np.max(np.abs(y))),
                                   err_msg=f"q{q}")
    assert a.n_valid == b.n_valid and a.n_total == b.n_total


PATTERN_DECKS = {"rc": (RC, "spicey"), "ext": (EXT, "extended"),
                 "boost": (netlists.BOOST_CONVERTER, "spicey"),
                 **{k: (NONLINEAR[k], "extended")
                    for k in ("ring", "bjt charge", "diode charge", "pnp",
                              "jfet")}}


@pytest.mark.parametrize("deck", sorted(PATTERN_DECKS))
def test_tran_pattern_equals_jax(deck):
    net, dialect = PATTERN_DECKS[deck]
    jt = jbuild(jparse(net, dialect=dialect))
    ckt = parse_netlist(net, dialect=dialect)
    t = build_tensors(ckt)
    packed = tmc._fused_tran_pattern(ckt, t, "pallas", "f32", "be", False,
                                     "cpu")
    want = _jax_pattern(jt)
    got = tfused.build_tran_pattern(
        t.nvar, t.r_idx, t.c_idx, t.l_idx, t.v_idx, t.n_i,
        {k: getattr(t, k) for k in ("i_idx", "g_idx", "e_idx", "f_idx",
                                    "h_idx")},
        s_idx=t.s_idx, d_idx=t.d_idx, m_idx=t.m_idx, m_pol=t.m_polarity,
        q_idx=t.q_idx, q_pol=t.q_polarity, d_chg=t.has_d_charge,
        q_chg=t.has_q_charge)
    assert got == want
    nonlinear = any(want[5:9])
    assert packed.nonlinear == nonlinear and packed.n_rows == want[0]
    # every position of K8's [A | I] or K9's (n, n) part is either an
    # entry or zeroed
    width = t.nvar if nonlinear else 2 * t.nvar
    assert packed.ent.shape[0] + packed.zeros.shape[0] == t.nvar * width
    assert packed.slist.shape[0] == len(want[5])
    assert packed.qchg.shape[0] == len(want[10])
    assert packed.pol.tolist() == [m[6] for m in want[7]] + [
        q[6] for q in want[8]]


@pytest.mark.parametrize("deck", ["rc", "ext"])
def test_plain_fused_matches_pallas_kernel(deck):
    net, node, _names, dialect = DECKS[deck]
    B = 48
    ckt = parse_netlist(net, dialect=dialect)
    t = build_tensors(ckt)
    ov = _overrides(deck, B, seed=2)
    dt, steps = effective_time_step(ckt.tran.dt, ckt.tran.tstop)
    vs = sample_source_values(ckt, np.arange(steps + 1) * dt)
    f64 = torch.float64
    ext = tmc._batched_ext(t, ov, B, "cpu", f64)

    def vals(base, names):
        return torch.as_tensor(tmc._batch_values(base, names, ov, B),
                               dtype=f64)

    cols = [vals(t.r_vals, t.r_names), vals(t.c_vals, t.c_names) / dt,
            dt / vals(t.l_vals, t.l_names)]
    cols += [ext[k] for k in ("g_gm", "e_gain", "f_gain", "h_r")]
    values = torch.cat(cols, 1).T.to(torch.float32).contiguous()
    node_idx = [n.upper() for n in t.node_names].index(node.upper())
    pattern = tfused.build_tran_pattern(
        t.nvar, t.r_idx, t.c_idx, t.l_idx, t.v_idx, t.n_i,
        {k: getattr(t, k) for k in ("i_idx", "g_idx", "e_idx", "f_idx",
                                   "h_idx")})
    vs32 = torch.as_tensor(vs, dtype=torch.float32)
    got, valid = tfused.mc_tran_fused(
        vs32, values, tfused.pack_tran_pattern(pattern, t.nvar, "cpu"),
        node_idx)
    jt = jbuild(jparse(net, dialect=dialect))
    jpat = jfused.build_tran_pattern(
        jt.nvar, jt.r_idx, jt.c_idx, jt.l_idx, jt.v_idx, jt.n_i,
        {k: getattr(jt, k) for k in ("i_idx", "g_idx", "e_idx", "f_idx",
                                    "h_idx")},
        s_idx=jt.s_idx, d_idx=jt.d_idx)
    want, jvalid = jfused.mc_tran_fused_f32(
        jnp.asarray(vs32.numpy()), jnp.asarray(values.numpy()), t.nvar,
        node_idx, jpat, interpret=True)
    want = np.asarray(want)
    assert got.shape == (B, steps + 1) and got.dtype == torch.float32
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                               atol=2e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("deck,method,integration", [
    ("rc", "gj", "be"), ("rc", "pallas", "be"), ("rc", "gj", "trap"),
    ("ext", "gj", "be"), ("ext", "pallas", "gear2"),
    ("boost", "gj", "be"), ("boost", "pallas", "be"),
    ("ring", "gj", "be"), ("ring", "pallas", "trap"), ("bjt", "gj", "be"),
    ("bjt", "pallas", "gear2"), ("jfet", "gj", "be")])
def test_f64_stats_match_jax_scan(deck, method, integration):
    net, node, names, dialect = DECKS[deck]
    ov = _overrides(deck, 24, seed=5)
    ref = jmc.mc_tran_stats(jparse(net, dialect=dialect), ov, node=node,
                            method="gj", precision="f64",
                            time_parallel="never", integration=integration)
    got = mc_tran_stats(net, ov, node=node, method=method, precision="f64",
                        dialect=dialect, integration=integration,
                        device="cpu")
    _stats_close(got, ref, rtol=1e-9)


def test_source_overrides_match_jax():
    """Per-variant DC source values ride a (S+1, B, nSrc) grid."""
    net = netlists.SWITCH_VT_VH
    B = 6
    ov = {"Vsimulation_voltage_source_0": np.linspace(4.0, 6.0, B),
          "RR1": np.linspace(900.0, 1100.0, B)}
    ref = jmc.mc_tran_stats(jparse(net), ov, node="N2", method="gj",
                            time_parallel="never")
    got = mc_tran_stats(net, ov, node="N2", device="cpu")
    _stats_close(got, ref, rtol=1e-9)
    with pytest.raises(ValueError, match="waveform-driven"):
        mc_tran_stats(net, {"VCTRL_SW1": np.ones(2)}, node="N2",
                      device="cpu")


def test_f32_fused_route_matches_jax_fused_tier():
    """method="pallas" at f32 takes K8's plain version here and the Pallas
    kernel (interpret mode) in JAX: the same tier, held at 2e-5."""
    net, node, _names, dialect = DECKS["rc"]
    ov = _overrides("rc", 32, seed=7)
    ref = jmc.mc_tran_stats(jparse(net), ov, node=node, method="pallas",
                            precision="f32", interpret=True)
    got = mc_tran_stats(net, ov, node=node, method="pallas",
                        precision="f32", device="cpu")
    _stats_close(got, ref, rtol=2e-5)


def test_sampled_matches_jax_on_the_same_draws():
    net, node = RC, "2"
    B, spreads, key = 20, {"R1": 0.05, "c1": 0.1}, 3
    got = mc_tran_sampled(net, spreads, B, node=node, key=key,
                          device="cpu")
    # the port's draws, regenerated and fed to the JAX scan as overrides
    gen = torch.Generator(device="cpu")
    gen.manual_seed(key)
    z = torch.randn((B, 2), generator=gen, dtype=torch.float64).numpy()
    ov = {"R1": 1e3 * np.exp(0.05 * z[:, 0]),
          "C1": 1e-6 * np.exp(0.1 * z[:, 1])}
    ref = jmc.mc_tran_stats(jparse(net), ov, node=node,
                            time_parallel="never")
    _stats_close(got, ref, rtol=1e-9)
    chunked = mc_tran_sampled(net, spreads, B, node=node, key=key, chunk=7,
                              device="cpu")
    _stats_close(chunked, got, rtol=1e-13)
    other = mc_tran_sampled(net, spreads, B, node=node, key=key + 1,
                            device="cpu")
    assert not np.allclose(other.mean, got.mean, rtol=1e-9)


def test_sampled_f32_fused_is_seeded():
    kw = dict(node="2", method="pallas", precision="f32", device="cpu")
    a = mc_tran_sampled(RC, {"R1": 0.1}, 16, key=1, **kw)
    b = mc_tran_sampled(RC, {"R1": 0.1}, 16, key=1, **kw)
    assert a.n_valid == a.n_total == 16 and a.mean.dtype == np.float32
    np.testing.assert_array_equal(a.mean, b.mean)


def test_unported_routes_and_bad_arguments_raise():
    # a K deck, refused before ROADMAP §1 item 2, runs and matches the
    # JAX package's sequential scan
    k_net = ("* k\nv1 1 0 PULSE(0 1 0 1n 1n 5u 10u)\nl1 1 0 1m\n"
             "l2 2 0 1m\nr1 2 0 1k\nk1 l1 l2 0.5\n.tran 1u 10u\n.end\n")
    ov = {"r1": np.array([1e3, 2e3])}
    got = mc_tran_stats(k_net, ov, node="2", dialect="extended",
                        device="cpu")
    want = jmc.mc_tran_stats(k_net, ov, node="2", dialect="extended",
                             time_parallel="never")
    assert got.n_valid == want.n_valid == 2
    _stats_close(got, want, rtol=1e-9)
    with pytest.raises(ValueError, match="time_parallel"):
        mc_tran_stats(RC, {"R1": np.ones(2)}, node="2", time_parallel="yes",
                      device="cpu")
    with pytest.raises(ValueError, match="integration"):
        mc_tran_stats(RC, {"R1": np.ones(2)}, node="2", integration="rk4",
                      device="cpu")
    with pytest.raises(ValueError, match="no .tran"):
        mc_tran_stats(netlists.BASICS01_AC, {"r1": np.ones(2)}, node="2",
                      device="cpu")


# K9's families, cut to <= 20 steps for interpret mode: (deck, dialect,
# node, the overridden element and its nominal value)
NR_FAMILIES = {
    "switch_diode": (netlists.DIODE_SWITCH.replace(".tran 0.00001 0.01",
                                                   ".tran 0.00001 0.00015"),
                     "spicey", "N3", "RR1", 1e3),
    "boost": (netlists.BOOST_CONVERTER.replace(".tran 0.001 0.1",
                                               ".tran 0.001 0.015"),
              "spicey", "N3", "RR1", 1e3),
    "mosfet": (NONLINEAR["ring"].replace(".tran 0.1u 10u", ".tran 0.1u 1.9u"),
               "extended", "n1", "c1", 1e-9),
    "bjt": (NONLINEAR["bjt_net"].replace(".tran 0.2u 40u", ".tran 0.2u 3u"),
            "extended", "c1", "RC", 1e3),
    "diode_tt": (decks.TT_NET.replace(".tran 4n 400n", ".tran 4n 72n"),
                 "extended", "2", "R1", 100.0),
    "diode_cjo": (NONLINEAR["varactor"].replace(".tran 10n 3u",
                                                ".tran 10n 190n"),
                  "extended", "2", "R1", 1e3),
    "bjt_charge": (NONLINEAR["bjt charge"].replace(".tran 0.2u 20u",
                                                   ".tran 0.2u 3u"),
                   "extended", "c1", "RC", 1e3),
    "jfet": (NONLINEAR["jfet"], "extended", "d1", "RD", 1e4),
    "pnp": (NONLINEAR["pnp"].replace(".tran 0.2u 20u", ".tran 0.2u 3u"),
            "extended", "c1", "RC", 1e3),
}


def _k9_inputs(family, B, seed, dtype=torch.float32):
    net, dialect, node, name, nominal = NR_FAMILIES[family]
    rng = np.random.default_rng(seed)
    ov = {name: nominal * (1 + 0.1 * rng.random(B))}
    ckt = parse_netlist(net, dialect=dialect)
    t = build_tensors(ckt)
    dt, steps = effective_time_step(ckt.tran.dt, ckt.tran.tstop)
    vs = torch.as_tensor(sample_source_values(ckt, np.arange(steps + 1) * dt),
                         dtype=dtype)

    def vals(base, names):
        return torch.as_tensor(tbatch._batch_values(base, names, ov, B),
                               dtype=dtype)

    values = tmc.tran_value_slab(
        t, vals(t.r_vals, t.r_names), vals(t.c_vals, t.c_names),
        vals(t.l_vals, t.l_names), tbatch._batched_ext(t, ov, B, "cpu", dtype),
        tbatch._batched_nl(t, ov, B, "cpu", dtype), dt)
    pattern = tmc._fused_tran_pattern(ckt, t, "pallas", "f32", "be", False,
                                      "cpu")
    nr, max_nr = tmc._nr_mode(t)
    node_idx = [n.upper() for n in t.node_names].index(node.upper())
    kw = dict(vd_scale=float(t.vt) / VT_300K, nr=nr, max_nr=max_nr)
    return ckt, t, vs, values, pattern, node_idx, kw


@pytest.mark.parametrize("family", sorted(NR_FAMILIES))
def test_plain_fused_nr_matches_pallas_kernel(family):
    """K9's plain version against the Pallas kernel in interpret mode on
    the same value slab: S/D with the switch-stability exit, M/Q with
    Newton to convergence, diode and BJT junction charge."""
    B = 24
    ckt, t, vs, values, pattern, node_idx, kw = _k9_inputs(family, B,
                                                           seed=8)
    assert pattern.nonlinear and vs.shape[0] <= 21
    got, valid, passes = tfused.mc_tran_fused_nr_plain(
        vs, values, pattern, node_idx, return_passes=True, **kw)
    jt = jbuild(jparse(NR_FAMILIES[family][0],
                       dialect=NR_FAMILIES[family][1]))
    want, jvalid = jfused.mc_tran_fused_f32(
        jnp.asarray(vs.numpy()), jnp.asarray(values.numpy()), t.nvar,
        node_idx, _jax_pattern(jt), interpret=True, **kw)
    want = np.asarray(want)
    assert got.shape == (B, vs.shape[0]) and got.dtype == torch.float32
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert bool(valid.all())
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-4 * float(np.abs(want).max()))
    # every lane runs at least one pass per step, at most max_nr
    assert bool((passes >= vs.shape[0]).all())
    assert bool((passes <= kw["max_nr"] * vs.shape[0]).all())


@pytest.mark.parametrize("family", ["boost", "mosfet", "bjt_charge"])
def test_f32_fused_nonlinear_route_matches_jax_fused_tier(family,
                                                          monkeypatch):
    """method="pallas" at f32 on a nonlinear deck takes K9's plain version
    here (and nothing else) and the Pallas kernel in interpret mode in
    JAX: the same tier, held at 2e-4."""
    net, dialect, node, name, nominal = NR_FAMILIES[family]
    rng = np.random.default_rng(9)
    ov = {name: nominal * (1 + 0.1 * rng.random(16))}
    calls = []
    real = tfused.mc_tran_fused_nr_plain
    monkeypatch.setattr(tfused, "mc_tran_fused_nr_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(tmc, "_tran_core", None)  # the loop must not run
    got = mc_tran_stats(net, ov, node=node, method="pallas",
                        precision="f32", dialect=dialect, device="cpu")
    assert calls == [1]
    ref = jmc.mc_tran_stats(jparse(net, dialect=dialect), ov, node=node,
                            method="pallas", precision="f32",
                            interpret=True)
    _stats_close(got, ref, rtol=2e-4, std_rtol=2e-2)


def test_sampled_f32_fused_nonlinear_matches_jax_on_the_same_draws():
    """mc_tran_sampled on a switch/diode deck takes K9's route; the JAX
    fused tier fed the port's draws as overrides gives the same stats."""
    net, _dialect, node, name, _nominal = NR_FAMILIES["boost"]
    B, key = 16, 4
    got = mc_tran_sampled(net, {name: 0.05}, B, node=node, key=key,
                          method="pallas", precision="f32", device="cpu")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(key)
    z = torch.randn((B, 1), generator=gen, dtype=torch.float64).numpy()
    ov = {name: 1e3 * np.exp(0.05 * z[:, 0])}
    ref = jmc.mc_tran_stats(jparse(net), ov, node=node, method="pallas",
                            precision="f32", interpret=True)
    _stats_close(got, ref, rtol=2e-4, std_rtol=2e-2)
    assert got.n_valid == B
