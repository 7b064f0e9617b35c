"""The port's parallel-in-time linear transient against the JAX package's.

``spicey_tpu_torch/analysis/timeparallel.py`` and ``mc._tp_solutions``
are held three ways on the CPU: against the port's own sequential loop
(``time_parallel="never"``) at the JAX tests' tolerances (mean and max at
rtol 1e-9 / atol 1e-12, std at rtol 1e-7: the same recurrence,
reassociated), against the JAX package's time-parallel path, and, for the
pieces, unit by unit: ``affine_prefix_states`` (log-depth doubling here,
``lax.associative_scan`` there) on random maps at the edges of the
doubling, the affine maps themselves, and the regime guard, whose routes
must be the JAX package's exactly (``eligible``, ``worthwhile`` on a grid,
the knobs by argument and by environment variable). The decks are
``tests/test_mc.py``'s and ``tests/test_batch.py``'s (RLC, RC with DC
overrides, a K-coupled transformer), BE and trap, the full trajectories
of ``simulate_tran_batch`` included. The JAX package's sharded-mesh case
(``tests/test_mc.py:582``) has its counterpart in
``tests/test_torch_mesh.py``.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spicey_tpu as sj
from spicey_tpu.analysis import batch as jbatch
from spicey_tpu.analysis import timeparallel as jtp
from spicey_tpu.analysis.mc import mc_tran_stats as jax_mc_tran_stats
from spicey_tpu.ir.circuit import build_tensors as jax_build_tensors
import spicey_tpu_torch as st
from spicey_tpu_torch.analysis import mc as tmc
from spicey_tpu_torch.analysis import timeparallel as ttp
from spicey_tpu_torch.analysis.batch import simulate_tran_batch
from spicey_tpu_torch.analysis.mc import mc_tran_sampled, mc_tran_stats
from spicey_tpu_torch.ir.circuit import build_tensors, effective_time_step
from tests.test_mc import _RLC_TP_NET, _XFMR_TP_NET

CPU = "cpu"
RLC_G_NET = ("x rlc mc\n"
             "V1 in 0 PULSE(0 5 0 1n 1n 5u 10u)\n"
             "R1 in a 100\n"
             "L1 a b 1m\n"
             "C1 b 0 1u\n"
             "R2 b 0 2k\n"
             "g1 0 b in 0 0.1m\n"
             ".tran 0.2u 30u\n"
             ".end\n")
RC_DC_NET = ("x rc dc sweep\nV1 in 0 DC 5\nR1 in a 1k\nC1 a 0 1u\n"
             ".tran 0.5u 20u\n.end\n")


@pytest.fixture
def tp_calls(monkeypatch):
    """Count the port's time-parallel runs (``mc._tp_solutions``)."""
    calls = []
    real = tmc._tp_solutions

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(tmc, "_tp_solutions", spy)
    return calls


def _stats_close(got, want, rtol=1e-9, atol=1e-12, std_rtol=1e-7,
                 what: str = "") -> None:
    assert got.n_valid == want.n_valid, what
    np.testing.assert_allclose(got.mean, want.mean, rtol=rtol, atol=atol,
                               err_msg=f"{what} mean")
    np.testing.assert_allclose(got.max, want.max, rtol=rtol, atol=atol,
                               err_msg=f"{what} max")
    np.testing.assert_allclose(got.min, want.min, rtol=rtol, atol=atol,
                               err_msg=f"{what} min")
    np.testing.assert_allclose(got.std, want.std, rtol=std_rtol, atol=atol,
                               err_msg=f"{what} std")


def test_time_parallel_matches_sequential_and_jax(tp_calls):
    B = 48
    rng = np.random.default_rng(9)
    over = {"R1": 100.0 * (1 + 0.2 * rng.random(B)),
            "C1": 1e-6 * (1 + 0.2 * rng.random(B))}
    kw = dict(node="b", dialect="extended")
    tp = mc_tran_stats(RLC_G_NET, over, device=CPU, **kw)
    assert len(tp_calls) == 1
    seq = mc_tran_stats(RLC_G_NET, over, time_parallel="never", device=CPU,
                        **kw)
    assert len(tp_calls) == 1 and tp.n_valid == B
    _stats_close(tp, seq, what="tp vs loop")
    want = jax_mc_tran_stats(RLC_G_NET, over, **kw)
    _stats_close(tp, want, what="tp vs jax tp")
    for q in want.quantiles:
        np.testing.assert_allclose(tp.quantiles[q], want.quantiles[q],
                                   rtol=1e-9, atol=1e-12)
    # f32: within the f32 tier's distance of the f64 loop
    tp32 = mc_tran_stats(RLC_G_NET, over, precision="f32", method="pallas",
                         device=CPU, **kw)
    scale = float(np.max(np.abs(seq.mean)))
    np.testing.assert_allclose(tp32.mean, seq.mean, rtol=2e-3,
                               atol=2e-4 * scale)


def test_time_parallel_dc_source_override(tp_calls):
    vs = np.array([1.0, 2.0, 4.0, 8.0])
    tp = mc_tran_stats(RC_DC_NET, {"V1": vs}, node="a", device=CPU)
    assert tp_calls and len(tp_calls[0]) == 3  # a (S+1, B, m) grid
    seq = mc_tran_stats(RC_DC_NET, {"V1": vs}, node="a",
                        time_parallel="never", device=CPU)
    np.testing.assert_allclose(tp.mean, seq.mean, rtol=1e-9)
    np.testing.assert_allclose(tp.max, seq.max, rtol=1e-9)
    want = jax_mc_tran_stats(RC_DC_NET, {"V1": vs}, node="a")
    _stats_close(tp, want, what="vs jax")
    # the BE discretization with the step-0 bootstrap solve: after S+1 =
    # 41 applications of v' = (v + h V) / (1 + h), h = dt / tau = 5e-4
    expect = 8.0 * (1 - (1 + 0.5e-6 / 1e-3) ** -41)
    assert tp.max[-1] == pytest.approx(expect, rel=1e-9)


def test_time_parallel_regime_guard():
    small = SimpleNamespace(n_c=1, n_l=1)
    many = SimpleNamespace(n_c=4, n_l=1)
    for fn in (ttp.worthwhile, jtp.worthwhile):
        assert fn(small, steps=100_000, B=16, itemsize=8)
        assert not fn(small, steps=200, B=10_000, itemsize=8)
        assert not fn(many, steps=5_000, B=100_000, itemsize=8)


def test_time_parallel_regime_guard_tunable(monkeypatch):
    small = SimpleNamespace(n_c=1, n_l=1)
    many = SimpleNamespace(n_c=4, n_l=1)
    assert not ttp.worthwhile(small, steps=200, B=10_000, itemsize=8)
    assert ttp.worthwhile(small, steps=200, B=10_000, itemsize=8,
                          crossover=2000.0)
    assert not ttp.worthwhile(many, steps=5_000, B=100_000, itemsize=8)
    assert ttp.worthwhile(many, steps=5_000, B=100_000, itemsize=8,
                          mem_budget_bytes=1e15)
    # the CPU budget is the JAX package's fallback, so the routes agree
    assert ttp.default_mem_budget() == ttp.default_mem_budget(CPU) == 2e9
    assert ttp.default_crossover() == 32.0
    monkeypatch.setenv("SPICEY_TPU_TP_CROSSOVER", "2000")
    monkeypatch.setenv("SPICEY_TPU_TP_MEM_BUDGET", "1e15")
    assert ttp.default_crossover() == 2000.0
    assert ttp.default_mem_budget() == ttp.default_mem_budget(CPU) == 1e15
    assert ttp.worthwhile(small, steps=200, B=10_000, itemsize=8)
    assert ttp.worthwhile(many, steps=5_000, B=100_000, itemsize=8)


def test_time_parallel_knobs_route_mc_tran(tp_calls, monkeypatch):
    """``tp_crossover`` / ``tp_mem_budget`` and their environment
    variables move mc_tran_stats' and mc_tran_sampled's route as in the
    JAX package."""
    over = {"R1": np.array([100.0, 120.0])}
    kw = dict(node="b", device=CPU)
    # S + 1 = 151 steps: a crossover of 0.01 puts B = 2 past it
    mc_tran_stats(_RLC_TP_NET, over, tp_crossover=0.01, **kw)
    mc_tran_stats(_RLC_TP_NET, over, tp_mem_budget=1.0, **kw)
    assert not tp_calls
    mc_tran_stats(_RLC_TP_NET, over, tp_crossover=1.0, **kw)
    assert len(tp_calls) == 1
    monkeypatch.setenv("SPICEY_TPU_TP_MEM_BUDGET", "1")
    mc_tran_sampled(_RLC_TP_NET, {"R1": 0.05}, 4, **kw)
    assert len(tp_calls) == 1
    monkeypatch.delenv("SPICEY_TPU_TP_MEM_BUDGET")
    mc_tran_sampled(_RLC_TP_NET, {"R1": 0.05}, 4, **kw)
    assert len(tp_calls) == 2
    # chunked runs keep the sequential loop's bounded buffers
    mc_tran_sampled(_RLC_TP_NET, {"R1": 0.05}, 4, chunk=2, **kw)
    assert len(tp_calls) == 2


def test_time_parallel_sampled_matches_sequential(tp_calls):
    kw = dict(node="b", key=3, device=CPU)
    tp = mc_tran_sampled(_RLC_TP_NET, {"R1": 0.1, "C1": 0.1}, 32, **kw)
    seq = mc_tran_sampled(_RLC_TP_NET, {"R1": 0.1, "C1": 0.1}, 32,
                          time_parallel="never", **kw)
    assert len(tp_calls) == 1
    _stats_close(tp, seq, what="sampled")


def test_time_parallel_trap_matches_sequential(tp_calls):
    B = 24
    rng = np.random.default_rng(11)
    over = {"R1": 100.0 * (1 + 0.2 * rng.random(B)),
            "C1": 1e-6 * (1 + 0.2 * rng.random(B))}
    tp = mc_tran_stats(_RLC_TP_NET, over, node="b", integration="trap",
                       device=CPU)
    seq = mc_tran_stats(_RLC_TP_NET, over, node="b", integration="trap",
                        time_parallel="never", device=CPU)
    assert len(tp_calls) == 1 and tp.n_valid == B
    _stats_close(tp, seq, what="trap")
    want = jax_mc_tran_stats(_RLC_TP_NET, over, node="b",
                             integration="trap")
    _stats_close(tp, want, what="trap vs jax")
    be = mc_tran_stats(_RLC_TP_NET, over, node="b", device=CPU)
    assert np.max(np.abs(np.asarray(tp.mean) - np.asarray(be.mean))) > 1e-4


def test_time_parallel_k_coupling_matches_sequential(tp_calls):
    B = 16
    rng = np.random.default_rng(12)
    over = {"RLOAD": 100.0 * (1 + 0.2 * rng.random(B))}
    for integ in ("be", "trap"):
        kw = dict(node="s", dialect="extended", integration=integ)
        tp = mc_tran_stats(_XFMR_TP_NET, over, device=CPU, **kw)
        seq = mc_tran_stats(_XFMR_TP_NET, over, time_parallel="never",
                            device=CPU, **kw)
        want = jax_mc_tran_stats(_XFMR_TP_NET, over, **kw)
        assert tp.n_valid == B, integ
        scale = float(np.max(np.abs(np.asarray(seq.mean)))) + 1e-30
        for other, what in ((seq, "loop"), (want, "jax")):
            np.testing.assert_allclose(tp.mean, other.mean, rtol=1e-9,
                                       atol=1e-11 * scale,
                                       err_msg=f"{integ} {what}")
            np.testing.assert_allclose(tp.max, other.max, rtol=1e-9,
                                       atol=1e-11 * scale,
                                       err_msg=f"{integ} {what}")
    assert len(tp_calls) == 2


def test_time_parallel_trap_worthwhile_doubles_state():
    t = SimpleNamespace(n_c=2, n_l=2)
    budget = 4.0e8
    assert ttp.worthwhile(t, 5000, 64, 8, mem_budget_bytes=budget)
    assert not ttp.worthwhile(t, 5000, 64, 8, mem_budget_bytes=budget,
                              integration="trap")


def test_time_parallel_large_n_has_no_size_guard(tp_calls):
    """The JAX package keeps N past its TPU inverse kernel's VMEM limit
    off that kernel; the port's A^-1 is K3 at every N, so a 30-node ladder
    takes the time-parallel path like any other and matches the loop."""
    stages = 30
    lines = ["x big ladder", "V1 n0 0 PULSE(0 5 0 1n 1n 5u 10u)"]
    for i in range(stages):
        lines += [f"R{i} n{i} n{i + 1} 100", f"C{i} n{i + 1} 0 1n"]
    net = "\n".join(lines + [".tran 0.5u 5u", ".end"]) + "\n"
    rng = np.random.default_rng(2)
    over = {"R0": 100.0 * (1 + 0.1 * rng.random(4))}
    tp = mc_tran_stats(net, over, node="n1", device=CPU)
    seq = mc_tran_stats(net, over, node="n1", time_parallel="never",
                        device=CPU)
    assert len(tp_calls) == 1 and tp.n_valid == 4
    _stats_close(tp, seq, what="N = 32")


def test_tran_batch_time_parallel_full_trajectories(tp_calls):
    net = ("x rlc batch tp\nV1 in 0 PULSE(0 5 0 1n 1n 5u 10u)\n"
           "R1 in a 100\nL1 a b 1m\nC1 b 0 1u\nR2 b 0 2k\n"
           ".tran 0.2u 30u\n.end\n")
    rng = np.random.default_rng(0)
    over = {"R1": 100.0 * (1 + 0.2 * rng.random(12))}
    tp = simulate_tran_batch(net, over, device=CPU)
    assert len(tp_calls) == 1
    seq = simulate_tran_batch(net, over, time_parallel="never", device=CPU)
    assert tp.valid.all() and seq.valid.all()
    assert tp.sw_states.shape == seq.sw_states.shape
    np.testing.assert_allclose(tp.xs, seq.xs, rtol=1e-9, atol=1e-12)
    want = jbatch.simulate_tran_batch(net, over)
    np.testing.assert_allclose(tp.xs, np.asarray(want.xs), rtol=1e-9,
                               atol=1e-12)
    xnet = ("x xfmr batch\nV1 in 0 PULSE(0 5 0 1n 1n 20u 40u)\n"
            "R1 in p 10\nL1 p 0 1m\nL2 s 0 4m\nK1 L1 L2 0.9\n"
            "RLOAD s 0 100\nC2 s 0 10n\n.tran 0.2u 60u\n.end\n")
    kover = {"K1": np.array([0.5, 0.7, 0.9, 0.95])}
    tpx = simulate_tran_batch(xnet, kover, dialect="extended", device=CPU)
    sqx = simulate_tran_batch(xnet, kover, dialect="extended",
                              time_parallel="never", device=CPU)
    assert len(tp_calls) == 2
    np.testing.assert_allclose(tpx.xs, sqx.xs, rtol=1e-9, atol=1e-12)


# ---- the pieces ------------------------------------------------------------


@pytest.mark.parametrize("s1", [1, 2, 3, 7, 8, 9, 1000])
def test_affine_prefix_states_matches_jax(s1):
    """Random contracting maps at every edge of the doubling (one step, a
    power of two, one past it): the port's doubling against the JAX
    package's associative scan and against the plain recurrence."""
    rng = np.random.default_rng(s1)
    B, k = 3, 4
    T = rng.normal(size=(B, k, k)) * (0.9 / k)
    Ru = rng.normal(size=(B, k, s1))
    got = ttp.affine_prefix_states(torch.as_tensor(T), torch.as_tensor(Ru))
    want = np.asarray(jax.jit(jtp.affine_prefix_states)(jnp.asarray(T),
                                                        jnp.asarray(Ru)))
    assert got.shape == want.shape == (B, k, s1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-13)
    s = np.zeros((B, k))
    for t in range(s1):
        np.testing.assert_allclose(got.numpy()[..., t], s, rtol=1e-12,
                                   atol=1e-13)
        s = np.einsum("bij,bj->bi", T, s) + Ru[..., t]


def test_worthwhile_grid_equals_jax():
    for k in range(0, 7):
        t = SimpleNamespace(n_c=k // 2, n_l=k - k // 2)
        for steps in (0, 200, 10_000, 100_000):
            for B in (1, 16, 1_000, 16_000, 1_000_000):
                for itemsize in (4, 8):
                    for integ in ("be", "trap"):
                        assert ttp.worthwhile(
                            t, steps, B, itemsize, integration=integ) == \
                            jtp.worthwhile(t, steps, B, itemsize,
                                           integration=integ), \
                            (k, steps, B, itemsize, integ)


def test_eligible_equals_jax():
    decks = {
        "rlc": (_RLC_TP_NET, "spicey"),
        "xfmr": (_XFMR_TP_NET, "extended"),
        "diode": ("x\nv1 a 0 PULSE(0 1 0 1n 1n 1u 2u)\nr1 a b 1k\n"
                  "d1 b 0 dd\n.model dd d(is=1e-14)\n.tran 1u 10u\n.end\n",
                  "extended"),
        "bsrc": ("x\nv1 a 0 PULSE(0 1 0 1n 1n 1u 2u)\nr1 a 0 1k\n"
                 "b1 b 0 V=2*v(a)\nr2 b 0 1k\n.tran 1u 10u\n.end\n",
                 "extended"),
        "tline": ("t line\nv1 a 0 PULSE(0 1 0 1n 1n 5n 10n)\nr1 a b 50\n"
                  "t1 b 0 c 0 z0=50 td=1n\nr2 c 0 50\n.tran 0.1n 5n\n.end\n",
                  "extended"),
    }
    for name, (net, dialect) in decks.items():
        ct = st.parse_netlist(net, dialect=dialect)
        cj = sj.parse_netlist(net, dialect=dialect)
        tt, tj = build_tensors(ct), jax_build_tensors(cj)
        for nr in ("spicey", "converged"):
            for integ in ("be", "trap", "gear2"):
                assert ttp.eligible(tt, ct, nr, integ) == \
                    jtp.eligible(tj, cj, nr, integ), (name, nr, integ)
    assert ttp.eligible(build_tensors(st.parse_netlist(_RLC_TP_NET)),
                        st.parse_netlist(_RLC_TP_NET), "spicey", "trap")


@pytest.mark.parametrize("integration", ["be", "trap"])
def test_affine_maps_match_jax(integration):
    """The (T, R, X, Y) maps (and trap's step-0 maps) from the same A^-1
    and values, against the JAX package's."""
    ckt = st.parse_netlist(_XFMR_TP_NET, dialect="extended")
    t = build_tensors(ckt)
    dt, _ = effective_time_step(ckt.tran.dt, ckt.tran.tstop)
    rng = np.random.default_rng(5)
    B, n = 3, t.nvar
    Ainv = rng.normal(size=(B, n, n))
    Ainv2 = rng.normal(size=(B, n, n))
    c = t.c_vals * (1 + 0.1 * rng.random((B, t.n_c)))
    lv = t.l_vals * (1 + 0.1 * rng.random((B, t.n_l)))
    minv = rng.normal(size=(B, t.n_l, t.n_l))
    idx = [np.asarray(a, np.int64) for a in (t.c_idx, t.l_idx, t.v_idx,
                                             t.i_idx)]
    for m in (None, minv):
        args_t = [torch.as_tensor(a) for a in idx]
        args_j = [jnp.asarray(a) for a in idx]
        mt = None if m is None else torch.as_tensor(m)
        mj = None if m is None else jnp.asarray(m)
        if integration == "be":
            got = ttp.linear_tran_maps(
                torch.as_tensor(Ainv), args_t[0], torch.as_tensor(c),
                args_t[1], torch.as_tensor(lv), args_t[2], args_t[3], dt, n,
                minv=mt)
            want = jtp.linear_tran_maps(
                jnp.asarray(Ainv), args_j[0], jnp.asarray(c), args_j[1],
                jnp.asarray(lv), args_j[2], args_j[3], dt, n, minv=mj)
        else:
            got = ttp.linear_tran_maps_trap(
                torch.as_tensor(Ainv2), torch.as_tensor(Ainv), args_t[0],
                torch.as_tensor(c), args_t[1], torch.as_tensor(lv),
                args_t[2], args_t[3], dt, n, minv=mt)
            want = jtp.linear_tran_maps_trap(
                jnp.asarray(Ainv2), jnp.asarray(Ainv), args_j[0],
                jnp.asarray(c), args_j[1], jnp.asarray(lv), args_j[2],
                args_j[3], dt, n, minv=mj)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(
                g.numpy(), np.broadcast_to(w, g.shape), rtol=1e-12,
                atol=1e-12 * float(np.max(np.abs(w)) + 1e-300))
