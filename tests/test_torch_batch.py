"""The port's batched corner sweeps against the JAX package on the CPU.

Kernel K7's plain version (``mc_ac_fused_x_plain``, the fused
full-solution assemble-and-solve) is held in f32 to the Pallas kernel
``mc_ac_fused_x_f32`` in interpret mode, with and without an external
RHS, at rtol 2e-5 of each system's largest unknown (the tolerance
``tests/test_pallas_fused.py`` sets for the f32 fused tier; the far taps
of a ladder are small beside its input node, so the bound is per system
rather than per unknown), and in f64 to the JAX package's f64 plane GJ
at 1e-12. ``simulate_ac_batch`` (both routes: K7's plain version for
``method="pallas"``, the torch assembly and K1's plain version for
``"gj"``) and ``simulate_tran_batch`` are held to ``spicey_tpu``'s at
rtol 1e-9 / atol 1e-12, the repo's cross-tier tolerance. Under
``time_parallel="auto"`` both packages take their parallel-in-time core
for the RC pulse deck; that core agrees with the sequential scan at 1e-9
/ 1e-12 (``tests/test_batch.py``), so the port's answer is held to both
of the JAX package's at that tolerance. Inputs are made with numpy from a seed and
handed to both packages; B, F and the step counts stay small, since the
JAX engine compiles once per deck.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spicey_tpu
from spicey_tpu.analysis import ac as jac
from spicey_tpu.analysis import batch as jbatch
from spicey_tpu.ir.circuit import build_tensors as jbuild
from spicey_tpu.ops import linsolve as jlin
from spicey_tpu.ops import pallas_mc_ac as jfused
from spicey_tpu_torch import (BatchACResult, BatchTranResult, decks,
                              parse_netlist, simulate_ac_batch,
                              simulate_tran_batch)
from spicey_tpu_torch.analysis import batch as tbatch
from spicey_tpu_torch.ir.circuit import build_tensors
from spicey_tpu_torch.ops import mc_ac_fused as tfused
from tests.fixtures import netlists

RC_NET = ("* fused x rc\nv1 1 0 dc 0 ac 1\nr1 1 2 30\nc1 2 0 100u\n"
          ".ac dec 1 1 1000\n.end\n")


# N = 3 and N = 8, F <= 5
FUSED_DECKS = {"rc": (RC_NET, ("r1", "c1")),
               "ladder": (decks.rc_ladder_netlist(6, 5), ("r1", "c3", "r6"))}

# extended deck: I/G/E/F/H sources, an inductor and a V-kind B source
EXT_AC = """* extended batch ac deck
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
B1 g 0 V=2*tanh(v(d))
R6 g d 1k
.ac dec 3 10 1e5
.end
"""
AC_DECKS = {"basics01": (netlists.BASICS01_AC, "spicey", ("r1", "c1")),
            "extended": (EXT_AC, "extended", ("R1", "C1", "L1", "G1",
                                              "H1"))}


def _overrides(net, names, B, seed, dialect="spicey", spread=0.2):
    """Each named element at its netlist value times U(1, 1 + spread)."""
    rng = np.random.default_rng(seed)
    t = build_tensors(parse_netlist(net, dialect=dialect))
    base = {}
    for names_, vals in ((t.r_names, t.r_vals), (t.c_names, t.c_vals),
                         (t.l_names, t.l_vals), (t.g_names, t.g_gm),
                         (t.h_names, t.h_r), (t.m_names, t.m_beta),
                         (t.q_names, t.q_is)):
        base.update(zip([n.lower() for n in names_], vals))
    return {n: base[n.lower()] * (1 + spread * rng.random(B))
            for n in names}


def _fused_inputs(net, names, B, dtype, seed=3):
    """K7's inputs as ``simulate_ac_batch`` forms them, and the pattern."""
    ckt = parse_netlist(net)
    t = build_tensors(ckt)
    ov = _overrides(net, names, B, seed)
    freqs = tbatch.build_frequency_array(ckt.ac.mode, ckt.ac.N, ckt.ac.f1,
                                         ckt.ac.f2)

    def vals(base, names_):
        return torch.as_tensor(tbatch._batch_values(base, names_, ov, B),
                               dtype=dtype)

    ph = np.deg2rad(t.v_ac_phase_deg)
    iph = np.deg2rad(t.i_ac_phase_deg)
    values = tfused.combine_values(
        vals(t.r_vals, t.r_names), vals(t.c_vals, t.c_names),
        vals(t.l_vals, t.l_names),
        torch.as_tensor(t.v_ac_mag * np.cos(ph), dtype=dtype).expand(B, -1),
        torch.as_tensor(t.v_ac_mag * np.sin(ph), dtype=dtype).expand(B, -1),
        ext=tbatch._batched_ext(t, ov, B, "cpu", dtype),
        i_re=torch.as_tensor(t.i_ac_mag * np.cos(iph), dtype=dtype),
        i_im=torch.as_tensor(t.i_ac_mag * np.sin(iph), dtype=dtype),
        dtype=dtype)
    pattern = tfused.build_stamp_pattern(
        t.nvar, t.r_idx, t.c_idx, t.l_idx, t.v_idx,
        {k: getattr(t, k) for k in ("i_idx", "g_idx", "e_idx", "f_idx",
                                    "h_idx")})
    return torch.as_tensor(freqs, dtype=dtype), values, pattern, t, ov


def _rhs(F, n, B, dtype, seed=8):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal((F, n, B)), dtype=dtype)
                 for _ in range(2))


def _per_system_close(got, want, rtol):
    """|got - want| <= rtol * max|want| over each system's unknowns (axis
    1 of (F, N, B))."""
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= rtol * scale), \
        float(np.max(np.abs(got - want) / scale))


@pytest.mark.parametrize("ext_rhs", [False, True])
@pytest.mark.parametrize("deck", sorted(FUSED_DECKS))
def test_plain_k7_f32_matches_pallas_kernel(deck, ext_rhs):
    net, names = FUSED_DECKS[deck]
    B = 12
    freqs, values, pattern, t, _ov = _fused_inputs(net, names, B,
                                                   torch.float32)
    F, n = freqs.shape[0], t.nvar
    rhs = _rhs(F, n, B, torch.float32) if ext_rhs else None
    packed = tfused.pack_pattern(pattern, n, "cpu", ext_rhs=ext_rhs)
    xr, xi, valid = tfused.mc_ac_fused_x(freqs, values, packed, rhs)
    jxr, jxi, jvalid = jfused.mc_ac_fused_x_f32(
        jnp.asarray(freqs.numpy()), jnp.asarray(values.numpy()), n, pattern,
        rhs=None if rhs is None else tuple(jnp.asarray(r.numpy())
                                           for r in rhs),
        interpret=True)
    assert xr.shape == xi.shape == (F, n, B) and xr.dtype == torch.float32
    assert valid.dtype == torch.bool and valid.shape == (F, B)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid) > 0.5)
    assert bool(valid.all())
    got = xr.numpy() + 1j * xi.numpy()
    want = np.asarray(jxr) + 1j * np.asarray(jxi)
    _per_system_close(got, want, 2e-5)


@pytest.mark.parametrize("ext_rhs", [False, True])
@pytest.mark.parametrize("deck", sorted(FUSED_DECKS))
def test_plain_k7_f64_matches_jax_plane_gj(deck, ext_rhs):
    """The same systems assembled by the JAX package (``_assemble_grid``
    per variant) and solved by its f64 plane GJ."""
    net, names = FUSED_DECKS[deck]
    B = 6
    f64 = torch.float64
    freqs, values, pattern, t, ov = _fused_inputs(net, names, B, f64)
    F, n = freqs.shape[0], t.nvar
    rhs = _rhs(F, n, B, f64) if ext_rhs else None
    packed = tfused.pack_pattern(pattern, n, "cpu", ext_rhs=ext_rhs)
    xr, xi, valid = tfused.mc_ac_fused_x_plain(freqs, values, packed, rhs)

    jt = jbuild(spicey_tpu.parse_netlist(net))

    def jvals(base, names_):
        return jnp.asarray(jbatch._batch_values(base, names_, ov, B))

    ph = np.deg2rad(jt.v_ac_phase_deg)
    A_re, A_im, b_re, b_im = jax.vmap(
        lambda r, c, l: jac._assemble_grid(
            jnp.asarray(freqs.numpy()), jnp.asarray(jt.r_idx), r,
            jnp.asarray(jt.c_idx), c, jnp.asarray(jt.l_idx), l,
            jnp.asarray(jt.v_idx), jnp.asarray(jt.v_ac_mag * np.cos(ph)),
            jnp.asarray(jt.v_ac_mag * np.sin(ph)), jt.nvar))(
        jvals(jt.r_vals, jt.r_names), jvals(jt.c_vals, jt.c_names),
        jvals(jt.l_vals, jt.l_names))                 # (B, F, ...)
    if rhs is not None:
        b_re, b_im = (jnp.asarray(r.numpy().transpose(2, 0, 1)) for r in rhs)
    jx_re, jx_im, jvalid = jlin.solve_planes(A_re, A_im, b_re, b_im,
                                             method="gj")
    np.testing.assert_array_equal(valid.numpy().T, np.asarray(jvalid))
    got = (xr.numpy() + 1j * xi.numpy()).transpose(2, 0, 1)
    want = np.asarray(jx_re) + 1j * np.asarray(jx_im)
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_ext_rhs_tables_leave_the_rhs_column_alone():
    n = 3
    pattern = tfused.build_stamp_pattern(
        n, np.array([[0, 1], [1, 3]]), np.array([[1, 3]]), np.zeros((0, 2)),
        np.array([[0, 3, 2]]))
    full = tfused.pack_pattern(pattern, n, "cpu")
    ext = tfused.pack_pattern(pattern, n, "cpu", ext_rhs=True)
    w = n + 1
    col = lambda pos: (pos.long() % w).tolist()  # noqa: E731
    assert n in col(full.ent[:, 0]) and n in col(full.zeros)
    assert n not in col(ext.ent[:, 0]) and n not in col(ext.zeros)
    # every A position is written or zeroed, in both modes
    assert ext.ent.shape[0] + ext.zeros.shape[0] == 2 * n * n
    with pytest.raises(ValueError, match="ext_rhs=True"):
        tfused.mc_ac_fused_x_plain(torch.ones(1), torch.ones((4, 1)), ext)
    with pytest.raises(ValueError, match="ext_rhs=True"):
        tfused.mc_ac_fused_x_plain(torch.ones(1), torch.ones((4, 1)), full,
                                   _rhs(1, n, 1, torch.float32))


@pytest.mark.parametrize("method", ["gj", "pallas"])
@pytest.mark.parametrize("deck", sorted(AC_DECKS))
def test_ac_batch_matches_jax(deck, method, monkeypatch):
    net, dialect, names = AC_DECKS[deck]
    ov = _overrides(net, names, 7, seed=5, dialect=dialect)
    want = jbatch.simulate_ac_batch(net, ov, dialect=dialect)
    fused = []
    real = tbatch.mc_ac_fused_x
    monkeypatch.setattr(tbatch, "mc_ac_fused_x",
                        lambda *a, **k: fused.append(1) or real(*a, **k))
    got = simulate_ac_batch(net, ov, method=method, dialect=dialect,
                            device="cpu")
    assert fused == ([1] if method == "pallas" else [])
    assert isinstance(got, BatchACResult)
    assert got.x.dtype == np.complex128 and got.x.shape == want.x.shape
    np.testing.assert_array_equal(got.freqs, want.freqs)
    assert got.node_names == tuple(want.node_names)
    np.testing.assert_array_equal(got.valid, want.valid)
    assert got.valid.all()
    np.testing.assert_allclose(got.x, want.x, rtol=1e-9, atol=1e-12)
    node = got.node_names[1]
    np.testing.assert_array_equal(got.node_voltage(node),
                                  got.x[..., 1])


def test_ac_batch_full_width_ladder_takes_k1():
    """N = 18 is past the fused tier's width: ``method="pallas"`` solves
    the assembled planes (K1's plain version), as ``"gj"`` does."""
    net = decks.rc_ladder_netlist(16, 3)
    ov = _overrides(net, ("r1", "c16"), 3, seed=2)
    want = jbatch.simulate_ac_batch(net, ov)
    got = simulate_ac_batch(net, ov, method="pallas", device="cpu")
    assert got.x.shape == (3, 3, 18)
    np.testing.assert_allclose(got.x, want.x, rtol=1e-9, atol=1e-12)


# the RC pulse deck with a record window: integrate from 0, keep t >= 5u
RC_TSTART = netlists.RC_PULSE.replace(".tran 0.1u 20u", ".tran 0.1u 20u 5u")
DC_NET = "The t\nV1 1 0 DC 5\nR1 1 2 1k\nC1 2 0 1u\n.tran 10u 1m\n.end\n"
MOS_NET = decks.RING_NET.replace(".tran 0.1u 10u", ".tran 0.1u 3u")
TRAN_DECKS = {
    "rc_pulse": (netlists.RC_PULSE, "spicey", {"R1": 1e3, "C1": 1e-6}),
    "rc_tstart": (RC_TSTART, "spicey", {"R1": 1e3}),
    "boost": (netlists.BOOST_CONVERTER, "spicey", {"RR1": 1e3}),
    "dc_override": (DC_NET, "spicey", {"V1": 5.0, "R1": 1e3}),
    "mosfet": (MOS_NET, "extended", {"c1": 1e-9, "mn1": 2e-3}),
}


@pytest.mark.parametrize("deck", sorted(TRAN_DECKS))
def test_tran_batch_matches_jax(deck):
    net, dialect, nominal = TRAN_DECKS[deck]
    B = 4
    rng = np.random.default_rng(7)
    ov = {k: v * (1 + 0.3 * rng.random(B)) for k, v in nominal.items()}
    got = simulate_tran_batch(net, ov, dialect=dialect, device="cpu")
    assert isinstance(got, BatchTranResult)
    # the JAX package's time-parallel core takes the linear RC decks under
    # "auto": hold the port to it and to the sequential scan
    modes = ("auto", "never") if deck.startswith("rc") else ("auto",)
    for mode in modes:
        want = jbatch.simulate_tran_batch(net, ov, dialect=dialect,
                                          time_parallel=mode)
        np.testing.assert_array_equal(got.times, want.times)
        assert got.node_names == tuple(want.node_names)
        assert got.xs.shape == want.xs.shape
        assert got.sw_states.shape == want.sw_states.shape
        np.testing.assert_array_equal(got.sw_states, want.sw_states)
        np.testing.assert_array_equal(got.valid, want.valid)
        np.testing.assert_allclose(got.xs, want.xs, rtol=1e-9, atol=1e-12,
                                   err_msg=mode)
    assert got.valid.all()
    assert got.xs.shape[:2] == (B, len(got.times))
    np.testing.assert_array_equal(got.node_voltage(got.node_names[0]),
                                  got.xs[..., 0])


def test_tran_batch_time_parallel_modes_agree():
    ov = {"R1": np.array([1e3, 1.5e3])}
    a = simulate_tran_batch(netlists.RC_PULSE, ov, device="cpu")
    b = simulate_tran_batch(netlists.RC_PULSE, ov, time_parallel="never",
                            device="cpu")
    # "auto" takes the parallel-in-time core on this linear deck: the
    # same recurrence reassociated, held to the loop at the JAX tests'
    # tolerance (tests/test_batch.py)
    np.testing.assert_allclose(a.xs, b.xs, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(a.valid, b.valid)
    with pytest.raises(ValueError, match="time_parallel"):
        simulate_tran_batch(netlists.RC_PULSE, ov, time_parallel="always",
                            device="cpu")


def test_waveform_source_override_rejected():
    with pytest.raises(ValueError, match="waveform-driven"):
        simulate_tran_batch(netlists.RC_PULSE, {"V1": np.ones(2)},
                            device="cpu")


def test_unknown_override_rejected():
    with pytest.raises(ValueError, match="unknown elements"):
        simulate_ac_batch(netlists.BASICS01_AC, {"nope": np.ones(2)},
                          device="cpu")
    with pytest.raises(ValueError, match="unknown elements"):
        simulate_tran_batch(netlists.RC_PULSE, {"nope": np.ones(2)},
                            device="cpu")


def test_inconsistent_batch_rejected():
    with pytest.raises(ValueError, match="inconsistent"):
        simulate_ac_batch(netlists.BASICS01_AC,
                          {"r1": np.ones(2), "c1": np.ones(3)}, device="cpu")


def test_nonpositive_batched_r_rejected():
    with pytest.raises(ValueError, match="R r1 must be > 0"):
        simulate_ac_batch(netlists.BASICS01_AC,
                          {"r1": np.array([30.0, -1.0])}, device="cpu")


def test_missing_analysis_rejected():
    with pytest.raises(ValueError, match="no .ac analysis"):
        simulate_ac_batch(netlists.RC_PULSE, {"R1": np.ones(2)},
                          device="cpu")
    with pytest.raises(ValueError, match="no .tran analysis"):
        simulate_tran_batch(netlists.BASICS01_AC, {"r1": np.ones(2)},
                            device="cpu")


@pytest.mark.parametrize("method", ["gj", "pallas"])
def test_batched_singular_flags_not_raises(method):
    """Batched runs report validity per variant instead of throwing."""
    net = "The t\nv1 1 0 ac 1\nv2 1 0 ac 2\nr1 1 0 1k\n.ac lin 2 1 10\n"
    ov = {"r1": np.array([1e3, 2e3])}
    got = simulate_ac_batch(net, ov, method=method, device="cpu")
    want = jbatch.simulate_ac_batch(net, ov)
    assert not got.valid.any() and not want.valid.any()
    # a floating node in one lane only
    cap = "* cap divider\nv1 1 0 ac 1\nc1 1 2 1u\nc2 2 0 1u\n.ac lin 3 1 100\n"
    c = np.array([1e-6, 0.0, 2e-6])
    got = simulate_ac_batch(cap, {"c1": c, "c2": c}, method=method,
                            device="cpu")
    np.testing.assert_array_equal(got.valid.all(axis=1), [True, False, True])


def test_unported_elements_raise():
    """The K and B decks the batch analyses refused before ROADMAP §1
    item 2 now match the JAX package (its sequential scan), every lane
    valid, at rtol 1e-9 / atol 1e-12 of the largest value."""
    k_net = ("* k deck\nv1 1 0 ac 1\nl1 1 0 1m\nl2 2 0 1m\nr1 2 0 1k\n"
             "k1 l1 l2 0.5\n.ac dec 2 1 100\n.tran 1u 10u\n.end\n")
    b_net = ("* b deck\nv1 in 0 PULSE(0 1 0 1u 1u 5u 10u)\nr1 in 0 1k\n"
             "b1 out 0 V=2*v(in)\nr2 out 0 1k\n.tran 1u 10u\n.end\n")
    ov = {"r1": np.array([1e3, 2e3])}
    for got, want in (
            (simulate_ac_batch(k_net, ov, dialect="extended", device="cpu"),
             jbatch.simulate_ac_batch(k_net, ov, dialect="extended")),
            (simulate_tran_batch(k_net, ov, dialect="extended",
                                 device="cpu"),
             jbatch.simulate_tran_batch(k_net, ov, dialect="extended",
                                        time_parallel="never")),
            (simulate_tran_batch(b_net, ov, dialect="extended",
                                 device="cpu"),
             jbatch.simulate_tran_batch(b_net, ov, dialect="extended"))):
        x = got.x if hasattr(got, "x") else got.xs
        want_x = np.asarray(want.x if hasattr(want, "x") else want.xs)
        assert got.valid.all() and np.asarray(want.valid).all()
        np.testing.assert_allclose(
            x, want_x, rtol=1e-9, atol=1e-12 * float(np.abs(want_x).max()))


def test_entry_points_default_to_the_card(monkeypatch):
    """With no CUDA device the batched entry points called without
    ``device`` raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
            lambda: simulate_ac_batch(netlists.BASICS01_AC,
                                      {"r1": [30.0, 33.0]}),
            lambda: simulate_tran_batch(netlists.RC_PULSE,
                                        {"R1": [1e3, 1.1e3]})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
