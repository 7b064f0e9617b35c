"""Kernels K1, K2, K3, K4, K5, K7, K8, K9, K10a and K10b against their
plain versions (K5, K8 and K9 in every form) (K1-K4 also past N = 128), the .noise residual guard's
re-solves, the batched corner sweeps (``simulate_ac_batch``,
``simulate_tran_batch``, ``.step``), a flat N = 129 ladder's .ac and
.op, and the K, T and B workloads of ``chip_smoke.py`` phase 23 at small
size (a transformer, a matched line with its delay swept, the uA741
amplifier, a B-source Monte-Carlo) and phase 24's (a) and (c) (the
uA741's .pz and .sens, STEP_DECK's .step with .meas) against the CPU
path, on the card; and the derivative rules of ops/linsolve.py (each
tangent or adjoint of K1's and K2's solves one more launch, K3's rules
none, the multi entries refusing a dual) with phase 26 at small size
(sensitivities, a fit, an adaptive run) against the CPU path.

Tests marked ``cuda`` need an NVIDIA GPU with the CUDA toolkit and skip
elsewhere; run them on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest`` (the
card's machine has no jax, which ``tests/conftest.py`` imports, so this
file needs no conftest fixture). f64 is held at rtol
1e-12 and f32 at 1e-5 (nvcc contracts multiply-adds into FMAs, so the
last bits differ from the CPU); ``valid`` must agree exactly. The
unmarked tests check, on any host, that a wrapper refuses what its kernel
does not take before it builds anything.
"""

import pathlib

import numpy as np
import pytest
import torch

import spicey_tpu_torch as st
from chip_smoke import pair_nearest
from spicey_tpu_torch import decks
from spicey_tpu_torch.ir.circuit import (effective_time_step,
                                         sample_source_values)
from spicey_tpu_torch.ops import (gj, gj_real, linsolve, mc_ac_fused,
                                  mc_tran_fused)
from tests.fixtures import netlists
from tests.fused_systems import FREQS, dense_pattern, dense_values
from tests.oracle import oracle_tran

RC = ("* rc\nv1 1 0 dc 0 ac 1\nr1 1 2 30\nc1 2 0 100u\n"
      ".ac dec 10 1 100\n.end\n")
BASICS01 = ("Demo of a simple AC circuit\nv1 1 0 dc 0 ac 1\nr1 1 2 30\n"
            "c1 2 0 100u\n.ac dec 100 1 100\n.end\n")
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
GOLDEN = pathlib.Path(__file__).parent / "fixtures" / "basics01_golden.txt"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _systems(n, B, dtype, seed=0):
    rng = np.random.default_rng(seed)
    Ar = rng.standard_normal((B, n, n)) + n * np.eye(n)
    Ai = rng.standard_normal((B, n, n))
    br, bi = rng.standard_normal((2, B, n))
    Ar[0] = Ai[0] = 0.0  # one singular lane
    return [torch.as_tensor(a, dtype=dtype) for a in (Ar, Ai, br, bi)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [3, 16, 17, 32, 33, 64, 128, 256])
def test_k1_matches_plain(cuda, n, dtype):
    cpu = _systems(n, 33, dtype)
    before = gj.K1[dtype].launches
    xr, xi, valid = linsolve.solve_planes(*[t.to(cuda) for t in cpu])
    assert gj.K1[dtype].launches == before + 1
    rr, ri, rv = linsolve.gj_solve_planes(*cpu)
    assert torch.equal(valid.cpu(), rv) and not rv[0]
    for got, want in ((xr, rr), (xi, ri)):
        torch.testing.assert_close(got.cpu()[rv], want[rv],
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("method", ["pallas", "gj"])
def test_mc_routes_match_cpu(cuda, precision, method):
    rng = np.random.default_rng(1)
    ov = {"r1": 30 * (1 + 0.2 * rng.random(500)),
          "c1": 1e-4 * (1 + 0.2 * rng.random(500))}
    dtype = torch.float64 if precision == "f64" else torch.float32
    counter = (mc_ac_fused.K5 if method == "pallas" else gj.K1)[dtype]
    before = counter.launches
    got = st.mc_ac_stats(RC, ov, node="2", method=method,
                         precision=precision, device=cuda)
    assert counter.launches > before
    want = st.mc_ac_stats(RC, ov, node="2", method=method,
                          precision=precision, device="cpu")
    tol = TOL[dtype]
    assert got.n_valid == want.n_valid == 500
    for f in ("mean", "std", "min", "max"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=10 * tol, err_msg=f)


@pytest.mark.cuda
def test_golden_on_cuda(cuda):
    golden = GOLDEN.read_text()
    out = st.format_ac_result(st.simulate(BASICS01, device=cuda).ac)
    assert out == golden


def test_k1_wrapper_refuses_bad_input():
    cpu = _systems(4, 2, torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        gj.gj_solve_planes_cuda(*cpu)
    with pytest.raises(TypeError, match="float32 or float64"):
        gj.gj_solve_planes_cuda(*[t.to(torch.float16) for t in cpu])
    # no upper limit on N (a global workspace past shared memory), but
    # an empty system is refused
    empty = _systems(1, 1, torch.float64)
    with pytest.raises(ValueError, match="N >= 1"):
        gj.gj_solve_planes_cuda(*[t[:, :0, :0] if t.ndim == 3 else t[:, :0]
                                  for t in empty])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", range(1, 17))
def test_k5_every_form_matches_plain(cuda, n, dtype):
    """Every form of K5 that takes N (register up to its last instance,
    group at every N) against the plain version on dense random systems
    with an all-zero, a zero-row and a NaN variant: ``valid`` identical,
    |x[node]| at rtol; each launch counted under its form."""
    vals = dense_values(n, 64, seed=n)
    vals[2 + 2 * (n - 1), 2] = np.nan
    freqs = torch.as_tensor(FREQS, dtype=dtype)
    values = torch.as_tensor(vals, dtype=dtype)
    packed = mc_ac_fused.pack_pattern(dense_pattern(n), n, "cpu")
    node = n // 2
    pmag, pv = mc_ac_fused.mc_ac_fused_plain(freqs, values, packed, node)
    assert int(pv.sum()) == 3 * (64 - 3)
    forms = [f for f in mc_ac_fused.FORMS
             if not (f == "register" and n > mc_ac_fused.REG_MAX_N)]
    for form in forms:
        counts = dict(mc_ac_fused.K5_FORMS[dtype])
        mag, v = mc_ac_fused.mc_ac_fused_cuda(
            freqs.to(cuda), values.to(cuda), packed.to(cuda), node,
            form=form)
        assert mc_ac_fused.K5_FORMS[dtype][form] == counts[form] + 1
        assert torch.equal(v.cpu(), pv)
        torch.testing.assert_close(
            mag.cpu()[pv], pmag[pv], rtol=TOL[dtype],
            atol=TOL[dtype] * float(pmag[pv].abs().max()))
    if n > mc_ac_fused.REG_MAX_N:
        with pytest.raises(ValueError, match="no form 'register'"):
            mc_ac_fused.mc_ac_fused_cuda(freqs.to(cuda), values.to(cuda),
                                         packed.to(cuda), node,
                                         form="register")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k5_yield_runs_the_chosen_form(cuda, dtype):
    """The Monte-Carlo yield's N = 3 deck runs K5 in the form k5_form_for
    chooses."""
    rng = np.random.default_rng(4)
    ov = {"r1": 30 * (1 + 0.2 * rng.random(100)),
          "c1": 1e-4 * (1 + 0.2 * rng.random(100))}
    form = mc_ac_fused.k5_form_for(3, dtype)[0]
    before = mc_ac_fused.K5_FORMS[dtype][form]
    st.mc_ac_stats(RC, ov, node="2", method="pallas",
                   precision="f64" if dtype == torch.float64 else "f32",
                   device=cuda)
    assert mc_ac_fused.K5_FORMS[dtype][form] == before + 1


def test_k5_wrapper_refuses_bad_input():
    ckt = st.parse_netlist(RC)
    t = st.build_tensors(ckt)
    pattern = mc_ac_fused.build_stamp_pattern(t.nvar, t.r_idx, t.c_idx,
                                              t.l_idx, t.v_idx)
    packed = mc_ac_fused.pack_pattern(pattern, t.nvar, "cpu")
    freqs = torch.ones(3, dtype=torch.float32)
    values = torch.ones((packed.n_rows, 5), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        mc_ac_fused.mc_ac_fused_cuda(freqs, values, packed, 1)
    with pytest.raises(TypeError, match="float32 or float64"):
        mc_ac_fused.mc_ac_fused_cuda(freqs.double(), values, packed, 1)
    with pytest.raises(ValueError, match="n_rows"):
        mc_ac_fused.mc_ac_fused_cuda(freqs, values[:1], packed, 1)


def _real_systems(n, B, dtype, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)) + n * np.eye(n)
    b = rng.standard_normal((B, n))
    A[0] = 0.0            # all-zero system
    A[1, n // 2] = 0.0    # one zero row
    return [torch.as_tensor(a, dtype=dtype) for a in (A, b)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [3, 6, 16, 17, 32, 33, 64, 128, 256])
def test_k2_k3_match_plain(cuda, n, dtype):
    A, b = _real_systems(n, 40, dtype)
    k2, k3 = gj_real.K2[dtype].launches, gj_real.K3[dtype].launches
    x, v = linsolve.solve(A.to(cuda), b.to(cuda))
    inv, iv = linsolve.inverse(A.to(cuda))
    assert gj_real.K2[dtype].launches == k2 + 1
    assert gj_real.K3[dtype].launches == k3 + 1
    rx, rv = linsolve.gj_solve(A, b)
    rinv, riv = linsolve.gj_inverse(A)
    assert torch.equal(v.cpu(), rv) and torch.equal(iv.cpu(), riv)
    assert not rv[:2].any() and rv[2:].all()
    for got, want, ok in ((x, rx, rv), (inv, rinv, riv)):
        torch.testing.assert_close(got.cpu()[ok], want[ok], rtol=TOL[dtype],
                                   atol=TOL[dtype] * float(
                                       want[ok].abs().max()))


RC_TRAN = ("* rc\nV1 1 0 PULSE(0 5 0 1n 1n 5u 10u)\nR1 1 2 1k\n"
           "C1 2 0 1u\n.tran 0.1u 20u\n.end\n")


@pytest.mark.cuda
def test_k8_matches_plain(cuda):
    ckt = st.parse_netlist(RC_TRAN)
    t = st.build_tensors(ckt)
    dt, steps = effective_time_step(ckt.tran.dt, ckt.tran.tstop)
    vs = torch.as_tensor(sample_source_values(ckt, np.arange(steps + 1) * dt),
                         dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(3)
    B = 5000
    values = torch.as_tensor(np.stack([
        1e3 * (1 + 0.2 * rng.random(B)),
        1e-6 * (1 + 0.2 * rng.random(B)) / dt]), dtype=torch.float32,
        device=cuda)
    pattern = mc_tran_fused.pack_tran_pattern(
        mc_tran_fused.build_tran_pattern(t.nvar, t.r_idx, t.c_idx, t.l_idx,
                                         t.v_idx, t.n_i), t.nvar, cuda)
    before = mc_tran_fused.K8[torch.float32].launches
    got, valid = mc_tran_fused.mc_tran_fused(vs, values, pattern, 1)
    assert mc_tran_fused.K8[torch.float32].launches == before + 1
    want, pvalid = mc_tran_fused.mc_tran_fused_plain(vs, values, pattern, 1)
    assert torch.equal(valid, pvalid) and bool(valid.all())
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("deck", ["RC_PULSE", "SERIES_RLC", "BOOST_CONVERTER",
                                  "SWITCH_VT_VH"])
def test_tran_golden_on_cuda(cuda, deck):
    net = getattr(netlists, deck)
    ckt = st.parse_netlist(net)
    got = st.simulate_tran(ckt, device=cuda)
    times, nv, ec = oracle_tran(ckt)
    rtol, atol = (1e-7, 1e-9) if deck == "BOOST_CONVERTER" else (1e-9, 1e-12)
    np.testing.assert_array_equal(got.times, times)
    for series, ref in ((got.node_voltages, nv), (got.element_currents, ec)):
        for name, w in ref.items():
            np.testing.assert_allclose(series[name], w, rtol=rtol, atol=atol,
                                       err_msg=name)


def test_k2_k3_wrappers_refuse_bad_input():
    A, b = _real_systems(4, 2, torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        gj_real.gj_solve_cuda(A, b)
    with pytest.raises(ValueError, match="CUDA"):
        gj_real.gj_inverse_cuda(A)
    with pytest.raises(TypeError, match="float32 or float64"):
        gj_real.gj_solve_cuda(A.half(), b.half())
    with pytest.raises(TypeError, match="float32 or float64"):
        gj_real.gj_solve_cuda(A, b.float())
    with pytest.raises(ValueError, match=r"b must be \(B, N\)"):
        gj_real.gj_solve_cuda(A, b[:, :3])
    with pytest.raises(ValueError, match=r"\(B, N, N\)"):
        gj_real.gj_inverse_cuda(A[:, :3])
    # no upper limit on N (a global workspace past shared memory), but
    # an empty system is refused
    with pytest.raises(ValueError, match="N >= 1"):
        gj_real.gj_inverse_cuda(A[:, :0, :0])


def test_k8_wrapper_refuses_bad_input():
    t = st.build_tensors(st.parse_netlist(RC_TRAN))
    pattern = mc_tran_fused.pack_tran_pattern(
        mc_tran_fused.build_tran_pattern(t.nvar, t.r_idx, t.c_idx, t.l_idx,
                                         t.v_idx, t.n_i), t.nvar, "cpu")
    vs = torch.zeros((5, 1), dtype=torch.float32)
    values = torch.ones((pattern.n_rows, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        mc_tran_fused.mc_tran_fused_cuda(vs, values, pattern, 1)
    with pytest.raises(TypeError, match="float32"):
        mc_tran_fused.mc_tran_fused_cuda(vs, values.double(), pattern, 1)
    with pytest.raises(ValueError, match="n_rows"):
        mc_tran_fused.mc_tran_fused_cuda(vs, values[:1], pattern, 1)


# K9: a switch + diode deck (the reference's exit on switch stability) and
# a MOSFET deck (Newton to convergence), both on a few hundred variants
K9_DECKS = {
    "switch_diode": (netlists.DIODE_SWITCH.replace(".tran 0.00001 0.01",
                                                   ".tran 0.00001 0.002"),
                     "spicey", "N3", {"RR1": 1e3}),
    "ring": (decks.RING_NET.replace(".tran 0.1u 10u", ".tran 0.1u 5u"),
             "extended", "n1", {"c1": 1e-9, "mn1": 2e-3}),
}


def _k9_inputs(deck, B, device):
    from spicey_tpu_torch.analysis import batch as tbatch
    from spicey_tpu_torch.analysis import mc as tmc

    net, dialect, node, nominal = K9_DECKS[deck]
    rng = np.random.default_rng(6)
    ov = {k: v * (1 + 0.1 * rng.random(B)) for k, v in nominal.items()}
    ckt = st.parse_netlist(net, dialect=dialect)
    t = st.build_tensors(ckt)
    dt, steps = effective_time_step(ckt.tran.dt, ckt.tran.tstop)
    f32 = torch.float32
    vs = torch.as_tensor(sample_source_values(ckt, np.arange(steps + 1) * dt),
                         dtype=f32, device=device)

    def vals(base, names):
        return torch.as_tensor(tbatch._batch_values(base, names, ov, B),
                               dtype=f32, device=device)

    values = tmc.tran_value_slab(
        t, vals(t.r_vals, t.r_names), vals(t.c_vals, t.c_names),
        vals(t.l_vals, t.l_names),
        tbatch._batched_ext(t, ov, B, device, f32),
        tbatch._batched_nl(t, ov, B, device, f32), dt)
    pattern = tmc._fused_tran_pattern(ckt, t, "pallas", "f32", "be", False,
                                      device)
    nr, max_nr = tmc._nr_mode(t)
    node_idx = [n.upper() for n in t.node_names].index(node.upper())
    return vs, values, pattern, node_idx, dict(
        vd_scale=float(t.vt) / st.VT_300K, nr=nr, max_nr=max_nr)


@pytest.mark.cuda
@pytest.mark.parametrize("deck", sorted(K9_DECKS))
def test_k9_matches_plain(cuda, deck):
    vs, values, pattern, node_idx, kw = _k9_inputs(deck, 300, cuda)
    before = mc_tran_fused.K9[torch.float32].launches
    got, valid = mc_tran_fused.mc_tran_fused(vs, values, pattern, node_idx,
                                             **kw)
    assert mc_tran_fused.K9[torch.float32].launches == before + 1
    want, pvalid = mc_tran_fused.mc_tran_fused_nr_plain(vs, values, pattern,
                                                        node_idx, **kw)
    assert torch.equal(valid, pvalid) and bool(valid.all())
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


def test_k9_wrapper_refuses_bad_input():
    vs, values, pattern, node_idx, kw = _k9_inputs("switch_diode", 3, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        mc_tran_fused.mc_tran_fused_nr_cuda(vs, values, pattern, node_idx,
                                            **kw)
    with pytest.raises(TypeError, match="float32"):
        mc_tran_fused.mc_tran_fused_nr_cuda(vs, values.double(), pattern,
                                            node_idx, **kw)
    with pytest.raises(ValueError, match="n_rows"):
        mc_tran_fused.mc_tran_fused_nr_cuda(vs, values[:1], pattern,
                                            node_idx, **kw)
    with pytest.raises(ValueError, match="nr must be"):
        mc_tran_fused.mc_tran_fused_nr_cuda(vs, values, pattern, node_idx,
                                            nr="newton")
    linear = mc_tran_fused.pack_tran_pattern(
        mc_tran_fused.build_tran_pattern(2, np.array([[0, 1]]),
                                         np.zeros((0, 2)), np.zeros((0, 2)),
                                         np.array([[0, 2, 1]]), 0), 2, "cpu")
    with pytest.raises(ValueError, match="nonlinear"):
        mc_tran_fused.mc_tran_fused_nr_cuda(vs, values, linear, 0, **kw)
    # N = 17: a diode at the end of a 16-section RC ladder
    n = 17
    big = mc_tran_fused.pack_tran_pattern(mc_tran_fused.build_tran_pattern(
        n, np.array([[i, i + 1] for i in range(n - 2)]), np.zeros((0, 2)),
        np.zeros((0, 2)), np.array([[0, n, n - 1]]), 0,
        d_idx=np.array([[n - 2, n]])), n, "cpu")
    with pytest.raises(ValueError, match="N <= 16"):
        mc_tran_fused.mc_tran_fused_nr_cuda(
            vs, torch.ones((big.n_rows, 3), dtype=torch.float32), big, 0,
            **kw)


# K8 and K9 in every form (register, shared) against their plain versions:
# K9 on one deck per family of chip_smoke.py phase 2, K8 on the RC and the
# extended linear decks; 307 variants (no multiple of any block), lane 1
# with its first value row NaN, lane 2 singular (K8: every R infinite and
# every C zero, a floating node; K9: every value infinite, no finite
# pivot). K8 at TOL's f32 1e-5; K9 with ``valid`` identical and each lane
# within 1e-4 x max|V|, otherwise mean/min/max within 2e-4
# (chip_smoke.py's rule: a rounding difference can put a switch or a
# Newton exit on the other side of its threshold)
K9_FORM_DECKS = {
    "boost": (decks.BOOST_NET, "spicey", "N3", {"RR1": 1e3}),
    "boost 10us grid": (decks.BOOST_FINE, "spicey", "N3", {"RR1": 1e3}),
    "ring": (decks.RING_NET, "extended", "n1", {"c1": 1e-9}),
    "BJT_NET": (decks.BJT_NET, "extended", "c1", {"RC": 1e3}),
    "TT diode": (decks.TT_NET, "extended", "2", {"R1": 100.0}),
    "CJO diode": (decks.CJ_NET, "extended", "2", {"R1": 1e3}),
    "BJT charge": (decks.QC_NET, "extended", "c1", {"RC": 1e3}),
    "JFET": (decks.JFET_NET, "extended", "d1", {"RD": 1e4}),
    "PNP": (decks.PNP_NET, "extended", "c1", {"RC": 1e3}),
}
K8_FORM_DECKS = {
    "rc": (RC_TRAN, "spicey", "2", {"R1": 1e3, "C1": 1e-6}),
    "extended": (decks.EXT_TRAN, "extended", "d",
                 {"R1": 1e3, "L1": 1e-2, "C1": 1e-6}),
}
FORM_B = 307


def _form_inputs(net, dialect, node, nominal, B, device):
    """The fused kernels' inputs as analysis/mc.py forms them, with the
    NaN lane 1 and the singular lane 2."""
    from spicey_tpu_torch.analysis import batch as tbatch
    from spicey_tpu_torch.analysis import mc as tmc

    rng = np.random.default_rng(11)
    ov = {k: v * (1 + 0.1 * rng.random(B)) for k, v in nominal.items()}
    ckt = st.parse_netlist(net, dialect=dialect)
    t = st.build_tensors(ckt)
    dt, steps = effective_time_step(ckt.tran.dt, ckt.tran.tstop)
    f32 = torch.float32
    vs = torch.as_tensor(sample_source_values(ckt, np.arange(steps + 1) * dt),
                         dtype=f32, device=device)

    def vals(base, names):
        return torch.as_tensor(tbatch._batch_values(base, names, ov, B),
                               dtype=f32, device=device)

    values = tmc.tran_value_slab(
        t, vals(t.r_vals, t.r_names), vals(t.c_vals, t.c_names),
        vals(t.l_vals, t.l_names), tbatch._batched_ext(t, ov, B, device, f32),
        tbatch._batched_nl(t, ov, B, device, f32), dt)
    pattern = tmc._fused_tran_pattern(ckt, t, "pallas", "f32", "be", False,
                                      device)
    values[0, 1] = float("nan")
    if pattern.nonlinear:
        values[:, 2] = float("inf")
    else:
        n_r, n_c = len(t.r_names), len(t.c_names)
        values[:n_r, 2] = float("inf")
        values[n_r:n_r + n_c, 2] = 0.0
    node_idx = [n.upper() for n in t.node_names].index(node.upper())
    kw = {}
    if pattern.nonlinear:
        nr, max_nr = tmc._nr_mode(t)
        kw = dict(vd_scale=float(t.vt) / st.VT_300K, nr=nr, max_nr=max_nr)
    return vs, values, pattern, node_idx, kw


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["register", "shared"])
@pytest.mark.parametrize("deck", sorted(K9_FORM_DECKS))
def test_k9_every_form_matches_plain(cuda, deck, form):
    vs, values, pattern, node_idx, kw = _form_inputs(
        *K9_FORM_DECKS[deck], FORM_B, cuda)
    before = mc_tran_fused.K9_FORMS[form]
    got, valid = mc_tran_fused.mc_tran_fused_nr_cuda(
        vs, values, pattern, node_idx, form=form, **kw)
    assert mc_tran_fused.K9_FORMS[form] == before + 1
    want, pvalid = mc_tran_fused.mc_tran_fused_nr_plain(vs, values, pattern,
                                                        node_idx, **kw)
    assert torch.equal(valid, pvalid)
    assert not pvalid[1:3].any() and bool(pvalid[3:].all())
    scale = float(want[pvalid].abs().max())
    lane_err = (got[pvalid] - want[pvalid]).abs().amax(dim=1)
    if bool((lane_err > 1e-4 * scale).any()):
        for f in (torch.mean, torch.amin, torch.amax):
            w = f(want[pvalid], dim=0)
            torch.testing.assert_close(f(got[pvalid], dim=0), w, rtol=2e-4,
                                       atol=2e-4 * float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["register", "shared"])
@pytest.mark.parametrize("deck", sorted(K8_FORM_DECKS))
def test_k8_every_form_matches_plain(cuda, deck, form):
    vs, values, pattern, node_idx, _kw = _form_inputs(
        *K8_FORM_DECKS[deck], FORM_B, cuda)
    if form == "register" and pattern.n > mc_tran_fused.REG_MAX_N:
        with pytest.raises(ValueError, match="no form 'register'"):
            mc_tran_fused.mc_tran_fused_cuda(vs, values, pattern, node_idx,
                                             form=form)
        return
    before = mc_tran_fused.K8_FORMS[form]
    got, valid = mc_tran_fused.mc_tran_fused_cuda(vs, values, pattern,
                                                  node_idx, form=form)
    assert mc_tran_fused.K8_FORMS[form] == before + 1
    want, pvalid = mc_tran_fused.mc_tran_fused_plain(vs, values, pattern,
                                                     node_idx)
    assert torch.equal(valid, pvalid)
    assert not pvalid[1:3].any() and bool(pvalid[3:].all())
    w = want[pvalid]
    torch.testing.assert_close(got[pvalid], w, rtol=TOL[torch.float32],
                               atol=TOL[torch.float32] * float(w.abs().max()))


@pytest.mark.cuda
def test_k8_k9_plans_report_the_card(cuda):
    """The launch plans read the card's SM count and the kernels'
    residency: every SM gets a block at 4096 variants."""
    vs, values, pattern, node_idx, kw = _form_inputs(
        *K9_FORM_DECKS["ring"], 4096, cuda)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    for form in ("register", "shared"):
        plan = mc_tran_fused.k9_launch_plan(values, pattern, form)
        assert plan.n_sm == n_sm and plan.blocks >= n_sm
        assert plan.resident >= 1


# K4: the complex inverse, and the operating-point slice on the card

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [3, 11, 64, 85, 128])
def test_k4_matches_plain(cuda, n, dtype):
    Ar, Ai, _br, _bi = _systems(n, 33, dtype)
    Ar[1, n // 2] = Ai[1, n // 2] = 0.0  # one zero row
    before = gj.K4[dtype].launches
    mr, mi, valid = linsolve.inverse_planes(Ar.to(cuda), Ai.to(cuda))
    assert gj.K4[dtype].launches == before + 1
    rr, ri, rv = linsolve.gj_inverse_planes(Ar, Ai)
    assert torch.equal(valid.cpu(), rv) and not rv[:2].any() and rv[2:].all()
    for got, want in ((mr, rr), (mi, ri)):
        torch.testing.assert_close(got.cpu()[rv], want[rv], rtol=TOL[dtype],
                                   atol=TOL[dtype] * float(
                                       want[rv].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("deck", ["OPDCTF_DECK", "AMP_DECK", "MOS_IV"])
def test_op_slice_on_cuda_equals_cpu(cuda, deck):
    net = (decks.MOS_IV_DECK.replace("0.01 vgs 0 5 0.1", "0.5 vgs 0 5 1")
           if deck == "MOS_IV" else getattr(decks, deck))
    k4 = gj.K4[torch.float64].launches
    got = st.simulate(net, dialect="extended", device=cuda)
    want = st.simulate(net, dialect="extended", device="cpu")
    if got.noise is not None:
        assert gj.K4[torch.float64].launches > k4
        for f in ("output_psd", "gain"):
            np.testing.assert_allclose(getattr(got.noise, f),
                                       getattr(want.noise, f), rtol=1e-9,
                                       atol=1e-30)
    if got.op is not None:
        for name, v in want.op.node_voltages.items():
            np.testing.assert_allclose(got.op.node_voltages[name], v,
                                       rtol=1e-9, atol=1e-12)
    if got.dc is not None:
        assert got.dc.valid.all()
        for name, v in want.dc.node_voltages.items():
            np.testing.assert_allclose(got.dc.node_voltages[name], v,
                                       rtol=1e-9, atol=1e-12)


def guard_systems():
    """Six complex 5 x 5 systems as ``analysis/noise._noise_core`` takes
    them, float64 on the CPU: (A_re, A_im, b_re, b_im, e_out (1, 5)).
    Systems 0-2 have cond(A) = 1e10 with b along the largest singular
    direction of A and the real e_out along that of A^T: there x = M b
    and z = M^T e_out are O(1) sums of O(1e10) terms, whose rounding
    leaves a residual ~cond * eps, so the residual guard solves them again,
    forward and adjoint; systems 3-5 are well conditioned."""
    rng = np.random.default_rng(11)
    F, n = 6, 5

    def unitary(first=None):
        a = rng.standard_normal((F, n, n)) + 1j * rng.standard_normal(
            (F, n, n))
        if first is not None:
            a[:, :, 0] = first
        return np.linalg.qr(a)[0]

    w = rng.standard_normal(n)
    w /= np.linalg.norm(w)
    U = unitary()
    V = np.swapaxes(unitary(w), -1, -2)  # row 0 is +-w
    A = (U * np.logspace(0, -10, n)[None, None, :]) @ V
    A[3:] = rng.standard_normal((3, n, n)) + n * np.eye(n)
    b = U[:, :, 0].copy()
    b[3:] = rng.standard_normal((3, n))
    return tuple(torch.as_tensor(a.copy()) for a in (
        A.real, A.imag, b.real, b.imag, w[None]))


@pytest.mark.cuda
def test_noise_guard_resolves_on_cuda(cuda):
    """The residual guard's re-solve branch on the card: after K4, systems
    0-2 of ``guard_systems`` fail the guard forward and adjoint and K1
    solves them again, on A and on A^T. Their answers are K1's direct
    solves, leave a residual within 1e-12 and agree with the CPU path to
    1e-5 of their size (cond(A) * eps ~ 2e-6 is as far as two direct
    solves of them agree); systems 3-5 equal the CPU path at 1e-9."""
    from spicey_tpu_torch.analysis import noise as tnoise

    f64 = torch.float64
    cpu = guard_systems()
    A_re, A_im, b_re, b_im, e = (t.to(cuda) for t in cpu)
    k1, k4 = gj.K1[f64].launches, gj.K4[f64].launches
    got = tnoise._noise_core(A_re, A_im, b_re, b_im, e, "gj")
    assert gj.K4[f64].launches == k4 + 1 and gj.K1[f64].launches == k1 + 2
    want = tnoise._noise_core(*cpu, "gj")
    assert got[-1] == want[-1] == 6
    x_re, x_im, z_re, z_im, ok_f, ok_a, _ = got
    assert bool(ok_f.all()) and bool(ok_a.all())
    et = e.expand(b_re.shape)[:3]
    fr, fi, _ = linsolve.solve_planes(A_re[:3], A_im[:3], b_re[:3], b_im[:3])
    ar, ai, _ = linsolve.solve_planes(A_re[:3].transpose(-1, -2),
                                      A_im[:3].transpose(-1, -2), et,
                                      torch.zeros_like(et))
    for g, w in ((x_re, fr), (x_im, fi), (z_re, ar), (z_im, ai)):
        assert torch.equal(g[:3], w)
    ez = e.expand(b_re.shape)
    assert bool((tnoise._rel_residual(A_re, A_im, x_re, x_im, b_re, b_im,
                                      False) <= 1e-12).all())
    assert bool((tnoise._rel_residual(A_re, A_im, z_re, z_im, ez,
                                      torch.zeros_like(ez), True)
                 <= 1e-12).all())
    for k in (0, 2):  # x, then z, as complex vectors
        g = got[k].cpu().numpy() + 1j * got[k + 1].cpu().numpy()
        w = want[k].numpy() + 1j * want[k + 1].numpy()
        np.testing.assert_allclose(g[3:], w[3:], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(g[:3], w[:3], rtol=0,
                                   atol=1e-5 * np.abs(w[:3]).max())


def test_k4_wrapper_refuses_bad_input():
    Ar, Ai, _br, _bi = _systems(4, 2, torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        gj.gj_inverse_planes_cuda(Ar, Ai)
    with pytest.raises(TypeError, match="float32 or float64"):
        gj.gj_inverse_planes_cuda(Ar.half(), Ai.half())
    with pytest.raises(TypeError, match="float32 or float64"):
        gj.gj_inverse_planes_cuda(Ar, Ai.float())
    with pytest.raises(ValueError, match=r"\(B, N, N\)"):
        gj.gj_inverse_planes_cuda(Ar[:, :3], Ai[:, :3])
    # no upper limit on N (a global workspace past shared memory), but
    # an empty system is refused
    with pytest.raises(ValueError, match="N >= 1"):
        gj.gj_inverse_planes_cuda(Ar[:, :0, :0], Ai[:, :0, :0])


# K7: the fused full-solution AC kernel, and the batched corner sweeps

@pytest.mark.cuda
@pytest.mark.parametrize("ext_rhs", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [3, 8, 16])
def test_k7_matches_plain(cuda, n, dtype, ext_rhs):
    """Dense random systems (tests/fused_systems.py) with an all-zero and
    a zero-row variant, in both modes."""
    B, F = 70, 3
    packed = mc_ac_fused.pack_pattern(dense_pattern(n), n, "cpu",
                                      ext_rhs=ext_rhs)
    values = torch.as_tensor(dense_values(n, B), dtype=dtype)
    freqs = torch.as_tensor(FREQS, dtype=dtype)
    rng = np.random.default_rng(4)
    rhs = (tuple(torch.as_tensor(rng.standard_normal((F, n, B)), dtype=dtype)
                 for _ in range(2)) if ext_rhs else None)
    want = mc_ac_fused.mc_ac_fused_x(freqs, values, packed, rhs)
    on = packed.to(cuda)
    before = mc_ac_fused.K7[dtype].launches
    xr, xi, valid = mc_ac_fused.mc_ac_fused_x(
        freqs.to(cuda), values.to(cuda), on,
        None if rhs is None else tuple(r.to(cuda) for r in rhs))
    assert mc_ac_fused.K7[dtype].launches == before + 1
    assert torch.equal(valid.cpu(), want[2])
    assert not want[2][:, :2].any() and want[2][:, 2:].all()
    ok = want[2]
    for got, w in ((xr, want[0]), (xi, want[1])):
        got, w = got.cpu().permute(0, 2, 1)[ok], w.permute(0, 2, 1)[ok]
        torch.testing.assert_close(got, w, rtol=TOL[dtype],
                                   atol=TOL[dtype] * float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("ext_rhs", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 8, 9, 15, 16])
def test_k7_every_group_width_matches_plain(cuda, n, dtype, ext_rhs):
    """K7 at every group width (N = 1-4 on 4 lanes, 5-8 on 8, 9-16 on 16)
    on dense random systems with an all-zero (0), a zero-row (1) and a
    NaN (2) variant: ``valid``
    identical; f64 within 1e-12 of the largest value; f32 no worse than
    twice the plain f32 version's error against an f64 solve, plus 1e-5
    of the largest value."""
    B, F = 70, 3
    vals = dense_values(n, B, 5)
    vals[2 + 2 * (n - 1), 2] = np.nan  # entry (0, n - 1), variant 2
    packed = mc_ac_fused.pack_pattern(dense_pattern(n), n, "cpu",
                                      ext_rhs=ext_rhs)
    values = torch.as_tensor(vals, dtype=dtype)
    freqs = torch.as_tensor(FREQS, dtype=dtype)
    rng = np.random.default_rng(6)
    rhs = (tuple(torch.as_tensor(rng.standard_normal((F, n, B)), dtype=dtype)
                 for _ in range(2)) if ext_rhs else None)
    pr, pi, pv = mc_ac_fused.mc_ac_fused_x_plain(freqs, values, packed, rhs)
    assert not pv[:, :3].any() and pv[:, 3:].all()
    tr, ti, _ = mc_ac_fused.mc_ac_fused_x_plain(
        freqs.double(), values.double(), packed,
        None if rhs is None else tuple(r.double() for r in rhs))

    def sel(x):  # (F, N, B) -> (valid systems, N)
        return x.permute(0, 2, 1)[pv].double()

    scale = max(float(sel(t).abs().max()) for t in (tr, ti))
    e_plain = max(float((sel(p) - sel(t)).abs().max())
                  for p, t in ((pr, tr), (pi, ti)))
    before = mc_ac_fused.K7[dtype].launches
    xr, xi, valid = mc_ac_fused.mc_ac_fused_x(
        freqs.to(cuda), values.to(cuda), packed.to(cuda),
        None if rhs is None else tuple(r.to(cuda) for r in rhs))
    assert mc_ac_fused.K7[dtype].launches == before + 1
    assert torch.equal(valid.cpu(), pv)
    e = max(float((sel(g.cpu()) - sel(t)).abs().max())
            for g, t in ((xr, tr), (xi, ti)))
    limit = TOL[dtype] * scale
    if dtype == torch.float32:
        limit += 2 * e_plain
    assert e <= limit, f"K7 N={n}: {e:.3e} > {limit:.3e}"


def test_k7_wrapper_refuses_bad_input():
    n = 3
    full = mc_ac_fused.pack_pattern(dense_pattern(n), n, "cpu")
    ext = mc_ac_fused.pack_pattern(dense_pattern(n), n, "cpu", ext_rhs=True)
    freqs = torch.ones(2, dtype=torch.float64)
    values = torch.as_tensor(dense_values(n, 4))
    rhs = (torch.zeros((2, n, 4), dtype=torch.float64),) * 2
    with pytest.raises(ValueError, match="CUDA"):
        mc_ac_fused.mc_ac_fused_x_cuda(freqs, values, full)
    with pytest.raises(ValueError, match="ext_rhs=True"):
        mc_ac_fused.mc_ac_fused_x_cuda(freqs, values, ext)
    with pytest.raises(ValueError, match="ext_rhs=True"):
        mc_ac_fused.mc_ac_fused_x_cuda(freqs, values, full, rhs)
    with pytest.raises(TypeError, match="float32 or float64"):
        mc_ac_fused.mc_ac_fused_x_cuda(freqs.float(), values, full)
    with pytest.raises(ValueError, match="n_rows"):
        mc_ac_fused.mc_ac_fused_x_cuda(freqs, values[:1], full)
    with pytest.raises(ValueError, match="K5 takes tables"):
        mc_ac_fused.mc_ac_fused_cuda(freqs, values, ext, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["pallas", "gj"])
def test_ac_batch_on_cuda_equals_cpu(cuda, method):
    net = decks.rc_ladder_netlist(14, 21)
    rng = np.random.default_rng(2)
    ov = {f"r{i}": (100 + i) * rng.uniform(0.9, 1.1, 300)
          for i in range(1, 15)}
    counter = (mc_ac_fused.K7 if method == "pallas" else gj.K1)[
        torch.float64]
    before = counter.launches
    got = st.simulate_ac_batch(net, ov, method=method, device=cuda)
    assert counter.launches == before + 1
    want = st.simulate_ac_batch(net, ov, method=method, device="cpu")
    assert got.valid.all() and want.valid.all()
    np.testing.assert_allclose(got.x, want.x, rtol=1e-9,
                               atol=1e-12 * np.abs(want.x).max())


@pytest.mark.cuda
@pytest.mark.parametrize("deck", ["rc", "boost", "ring"])
def test_tran_batch_on_cuda_equals_cpu(cuda, deck):
    net, dialect, nominal = {
        "rc": (decks.TRAN_NET, "spicey", {"R1": 1e3, "C1": 1e-6}),
        "boost": (decks.BOOST_NET, "spicey", {"RR1": 1e3}),
        "ring": (decks.RING_NET.replace(".tran 0.1u 10u", ".tran 0.1u 3u"),
                 "extended", {"c1": 1e-9})}[deck]
    rng = np.random.default_rng(5)
    ov = {k: v * (1 + 0.1 * rng.random(40)) for k, v in nominal.items()}
    got = st.simulate_tran_batch(net, ov, dialect=dialect, device=cuda)
    want = st.simulate_tran_batch(net, ov, dialect=dialect, device="cpu")
    assert got.valid.all() and want.valid.all()
    np.testing.assert_array_equal(got.sw_states, want.sw_states)
    np.testing.assert_allclose(got.xs, want.xs, rtol=1e-9,
                               atol=1e-12 * np.abs(want.xs).max())


@pytest.mark.cuda
def test_step_on_cuda_equals_cpu(cuda):
    net = decks.STEP_DECK.replace("100 1100 1", "100 1100 100")
    k7 = mc_ac_fused.K7[torch.float64].launches
    got = st.simulate(net, dialect="extended", method="pallas",
                      device=cuda).step
    assert mc_ac_fused.K7[torch.float64].launches == k7 + 1
    want = st.simulate(net, dialect="extended", method="pallas",
                       device="cpu").step
    for g, w in ((got.ac.x, want.ac.x), (got.tran.xs, want.tran.xs),
                 (got.op.x, want.op.x)):
        np.testing.assert_allclose(g, w, rtol=1e-9,
                                   atol=1e-12 * np.abs(w).max())


# K10a/K10b: the panel-blocked Gauss-Jordan tier, and K1-K4 past N = 128

def _k10_vs_f64(got, plain, truth, valid, dtype):
    """f64: the kernel at rtol 1e-12 of its plain version. f32: the panel
    form's pivot-row step (1/pv - 1) cancels, amplifying rounding by ~|pv|,
    so two f32 runs that sum in another order differ by more than 1e-5;
    the kernel must then be as accurate as the plain version against an
    f64 solve of the same systems."""
    if dtype == torch.float64:
        for g, p in zip(got, plain):
            torch.testing.assert_close(g.cpu()[valid], p[valid], rtol=1e-12,
                                       atol=1e-12 * float(p[valid].abs().max()))
        return
    scale = max(float(t[valid].abs().max()) for t in truth)
    e_k = max(float((g.cpu().double() - t)[valid].abs().max())
              for g, t in zip(got, truth))
    e_p = max(float((p.double() - t)[valid].abs().max())
              for p, t in zip(plain, truth))
    assert e_k <= 2 * e_p + 1e-5 * scale, (e_k, e_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [40, 48, 64, 67, 100, 128])
def test_k10_matches_plain(cuda, n, dtype):
    from spicey_tpu_torch.ops import mxu

    A, b = _real_systems(n, 24, torch.float64)
    k10a = mxu.K10a[dtype].launches
    x, v = mxu.mxu_solve_real(A.to(cuda, dtype), b.to(cuda, dtype))
    assert mxu.K10a[dtype].launches == k10a + 1
    px, pv = mxu.mxu_solve_real_plain(A.to(dtype), b.to(dtype))
    tx, _ = mxu.mxu_solve_real_plain(A, b)
    assert torch.equal(v.cpu(), pv) and not pv[:2].any() and pv[2:].all()
    _k10_vs_f64((x,), (px,), (tx,), pv, dtype)

    planes = _systems(n, 24, torch.float64, seed=1)
    k10b = mxu.K10b[dtype].launches
    got = mxu.mxu_solve_complex(*[t.to(cuda, dtype) for t in planes])
    assert mxu.K10b[dtype].launches == k10b + 1
    plain = mxu.mxu_solve_complex_plain(*[t.to(dtype) for t in planes])
    truth = mxu.mxu_solve_complex_plain(*planes)
    assert torch.equal(got[2].cpu(), plain[2]) and not plain[2][0]
    _k10_vs_f64(got[:2], plain[:2], truth[:2], plain[2], dtype)


@pytest.mark.cuda
def test_k10_plan_on_card(cuda):
    """The kernel's shared-memory bytes equal ops/mxu.py:smem_bytes (the
    copy the CPU tests check) at N = 40-128; its workspace is the resident
    blocks' slots, the same for any batch past them; a complex f64 N = 128
    batch that leaves the persistent blocks' last round partial equals the
    plain version, and the launch is counted."""
    from spicey_tpu_torch.ops import mxu

    lib = mxu.load_library()
    for n in range(mxu.MXU_MIN_N, mxu.MXU_MAX_N + 1):
        for planes in (1, 2):
            for item in (4, 8):
                for place in (mxu.ALL_SMEM, mxu.PLANES_GLOBAL):
                    assert mxu.smem_bytes(n, planes, item, place) == \
                        lib.mxu_gj_smem_bytes(n, mxu.blocked_plan(n)[0],
                                              planes, int(item == 8), place)
    slots = {B: lib.mxu_gj_workspace_systems(128, B, 2, 1, 32)
             for B in (52_224, 10**6)}
    assert len(set(slots.values())) == 1 and 0 < slots[52_224] <= 132 * 8
    B = slots[52_224] + 7
    planes = _systems(128, B, torch.float64, seed=2)
    k10b = mxu.K10b[torch.float64].launches
    got = mxu.mxu_solve_complex(*[p.to(cuda) for p in planes])
    assert mxu.K10b[torch.float64].launches == k10b + 1
    want = mxu.mxu_solve_complex_plain(*planes)
    assert torch.equal(got[2].cpu(), want[2])
    assert not want[2][0] and want[2][1:].all()
    _k10_vs_f64(got[:2], want[:2], want[:2], want[2], torch.float64)


def test_k10_wrappers_refuse_bad_input():
    from spicey_tpu_torch.ops import mxu

    A, b = _real_systems(48, 2, torch.float64)
    planes = _systems(48, 2, torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        mxu.mxu_solve_real_cuda(A, b)
    with pytest.raises(ValueError, match="CUDA"):
        mxu.mxu_solve_complex_cuda(*planes)
    with pytest.raises(TypeError, match="float32 or float64"):
        mxu.mxu_solve_real_cuda(A, b.float())
    with pytest.raises(ValueError, match=r"\(B, N\)"):
        mxu.mxu_solve_complex_cuda(*planes[:3], planes[3][:, :5])
    small, sb = _real_systems(39, 2, torch.float64)
    with pytest.raises(ValueError, match=r"N in \[40, 128\]"):
        mxu.mxu_solve_real_cuda(small, sb)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [129, 256])
def test_k1_to_k4_past_128_match_plain(cuda, n, dtype):
    """Past N = 128 every dense kernel runs (in a global workspace where
    shared memory overflows) and equals its plain version."""
    A, b = _real_systems(n, 6, dtype)
    x, v = linsolve.solve(A.to(cuda), b.to(cuda))
    inv, iv = linsolve.inverse(A.to(cuda))
    rx, rv = linsolve.gj_solve(A, b)
    rinv, riv = linsolve.gj_inverse(A)
    assert torch.equal(v.cpu(), rv) and torch.equal(iv.cpu(), riv)
    assert not rv[:2].any() and rv[2:].all()
    planes = _systems(n, 6, dtype)
    xr, xi, cv = linsolve.solve_planes(*[t.to(cuda) for t in planes])
    mr, mi, mv = linsolve.inverse_planes(planes[0].to(cuda),
                                         planes[1].to(cuda))
    pr, pi, pv = linsolve.gj_solve_planes(*planes)
    qr, qi, qv = linsolve.gj_inverse_planes(*planes[:2])
    assert torch.equal(cv.cpu(), pv) and torch.equal(mv.cpu(), qv)
    for got, want, ok in ((x, rx, rv), (inv, rinv, riv), (xr, pr, pv),
                          (xi, pi, pv), (mr, qr, qv), (mi, qi, qv)):
        torch.testing.assert_close(got.cpu()[ok], want[ok], rtol=TOL[dtype],
                                   atol=TOL[dtype] * float(
                                       want[ok].abs().max()))


@pytest.mark.cuda
def test_flat_ladder_past_128_on_cuda_equals_cpu(cuda):
    net = decks.rc_ladder_netlist(127, 11)
    dc = net.replace("v1 in 0 dc 0 ac 1", "v1 in 0 dc 1")
    got = st.simulate(net, device=cuda).ac
    want = st.simulate(net, device="cpu").ac
    for name, w in want.node_voltages.items():
        np.testing.assert_allclose(got.node_voltages[name], w, rtol=1e-9,
                                   atol=1e-12)
    got = st.simulate_op(st.parse_netlist(dc), device=cuda)
    want = st.simulate_op(st.parse_netlist(dc), device="cpu")
    for name, w in want.node_voltages.items():
        np.testing.assert_allclose(got.node_voltages[name], w, rtol=1e-9,
                                   atol=1e-12)


# The two series of the uA741 amplifier held to their own atol on the card
# (ROADMAP §3, measured by tools/profile_torch_parity.py): the 1 ohm series
# resistances of the clamp diodes dc and dlp carry -1.4e-11 and -3.9e-11 A
# between nodes at ~15 and ~40 V, and the card's and the CPU's values
# differ by up to 2.55e-13 and 2.7e-14 A, their voltages' rounding over
# 1 ohm.
UA741_KNOWN_ATOL = {"dc.xamp#rs": 5e-13, "dlp.xamp#rs": 5e-14}


def _same_series(got: dict, want: dict, what: str,
                 known: dict | None = None) -> None:
    """Every series of ``want`` at rtol 1e-9 with an atol of 1e-12 of the
    field's largest value, or the atol ``known`` names for it."""
    assert list(got) == list(want), what
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    for name, v in want.items():
        atol = (known or {}).get(name, 1e-12 * scale)
        np.testing.assert_allclose(got[name], v, rtol=1e-9, atol=atol,
                                   err_msg=f"{what} {name}")


@pytest.mark.cuda
def test_transformer_on_cuda_equals_cpu(cuda):
    """chip_smoke.py phase 23 (a) at small size: the transformer's .ac
    (its closed form too), .tran, mc_ac_stats and a k1 sweep."""
    ac = st.simulate(decks.TRANSFORMER_AC, dialect="extended",
                     device=cuda).ac
    ref = decks.analytic_transformer(ac.freqs)
    np.testing.assert_allclose(ac.node_voltages["s"], ref[:, 1], rtol=1e-9)
    want = st.simulate(decks.TRANSFORMER_AC, dialect="extended",
                       device="cpu").ac
    _same_series(ac.node_voltages, want.node_voltages, "ac")
    _same_series(ac.element_currents, want.element_currents, "ac")
    net = decks.TRANSFORMER_TRAN.replace(".tran 2u 1m", ".tran 2u 0.2m")
    got = st.simulate(net, dialect="extended", device=cuda).tran
    want = st.simulate(net, dialect="extended", device="cpu").tran
    _same_series(got.element_currents, want.element_currents, "tran")
    over = {"rload": np.linspace(90.0, 110.0, 33),
            "l2": np.linspace(3.6, 4.4, 33)}
    kw = dict(node="s", dialect="extended")
    a = st.mc_ac_stats(decks.TRANSFORMER_AC, over, device=cuda, **kw)
    b = st.mc_ac_stats(decks.TRANSFORMER_AC, over, device="cpu", **kw)
    assert a.n_valid == b.n_valid == 33
    np.testing.assert_allclose(a.mean, b.mean, rtol=1e-9)
    ks = {"k1": np.array([0.3, 0.6, 0.95, 1.0])}
    a = st.simulate_tran_batch(net, ks, dialect="extended", device=cuda)
    b = st.simulate_tran_batch(net, ks, dialect="extended", device="cpu")
    np.testing.assert_array_equal(a.valid, [True, True, True, False])
    np.testing.assert_allclose(a.xs[:3], b.xs[:3], rtol=1e-9,
                               atol=1e-12 * float(np.abs(b.xs[:3]).max()))


@pytest.mark.cuda
def test_tline_on_cuda_equals_cpu(cuda):
    """Phase 23 (b) at small size: a (rl, Z0, Td) sweep of the matched
    line (the swept-delay history) and its .ac."""
    rng = np.random.default_rng(23)
    over = {"rl": rng.uniform(25, 150, 16), "t1.z0": rng.uniform(45, 55, 16),
            "t1.td": rng.uniform(4e-9, 6e-9, 16)}
    a = st.simulate_tran_batch(decks.TLINE_TRAN, over, dialect="extended",
                               device=cuda)
    b = st.simulate_tran_batch(decks.TLINE_TRAN, over, dialect="extended",
                               device="cpu")
    assert a.valid.all()
    np.testing.assert_allclose(a.xs, b.xs, rtol=1e-9,
                               atol=1e-12 * float(np.abs(b.xs).max()))
    np.testing.assert_allclose(a.node_voltage("b")[:, -1],
                               over["rl"] / (50.0 + over["rl"]), rtol=1e-6)
    got = st.simulate(decks.TLINE_AC, dialect="extended", device=cuda).ac
    want = st.simulate(decks.TLINE_AC, dialect="extended", device="cpu").ac
    _same_series(got.node_voltages, want.node_voltages, "tline ac")
    _same_series(got.element_currents, want.element_currents, "tline ac")


@pytest.mark.cuda
def test_ua741_on_cuda_equals_cpu(cuda):
    """Phase 23 (c) at small size: the uA741 amplifier's .step over a few
    feedback resistors, and its .op, acop .ac, .noise and .tran."""
    net = decks.UA741_STEP.replace(".step param rfb 5k 20k 15",
                                   ".step param rfb 5k 20k 3k")
    a = st.simulate(net, dialect="extended", device=cuda).step
    b = st.simulate(net, dialect="extended", device="cpu").step
    assert a.op.valid.all()
    np.testing.assert_allclose(a.op.x, b.op.x, rtol=1e-9,
                               atol=1e-12 * float(np.abs(b.op.x).max()))
    np.testing.assert_allclose(a.op.node_voltage("out"),
                               -a.values / 1e3 * 0.05, rtol=5e-3)
    amp = decks.UA741_AMP.replace(".tran 1u 50u", ".tran 1u 10u")
    got = st.simulate(amp, dialect="extended", device=cuda)
    want = st.simulate(amp, dialect="extended", device="cpu")
    for an in ("op", "ac", "tran"):
        g, w = getattr(got, an), getattr(want, an)
        _same_series(g.node_voltages, w.node_voltages, an)
        _same_series(g.element_currents, w.element_currents, an,
                     known=UA741_KNOWN_ATOL)
    np.testing.assert_allclose(got.noise.output_psd, want.noise.output_psd,
                               rtol=1e-9)


@pytest.mark.cuda
def test_bsource_mc_on_cuda_equals_cpu(cuda):
    """Phase 23 (d) at small size: the tanh amplifier's Monte-Carlo
    transient; ``method="pallas"`` at f32 launches no fused kernel."""
    net = decks.BSRC_TANH.replace(".tran 10u 1m", ".tran 10u 0.2m")
    over = {"rl": np.linspace(900.0, 1100.0, 33)}
    kw = dict(node="out", dialect="extended")
    a = st.mc_tran_stats(net, over, device=cuda, **kw)
    b = st.mc_tran_stats(net, over, device="cpu", **kw)
    assert a.n_valid == b.n_valid == 33
    np.testing.assert_allclose(a.mean, b.mean, rtol=1e-9, atol=1e-12)
    before = (mc_tran_fused.K8[torch.float32].launches,
              mc_tran_fused.K9[torch.float32].launches)
    c = st.mc_tran_stats(net, over, method="pallas", precision="f32",
                         device=cuda, **kw)
    assert (mc_tran_fused.K8[torch.float32].launches,
            mc_tran_fused.K9[torch.float32].launches) == before
    np.testing.assert_allclose(c.mean, b.mean, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_ua741_pz_sens_on_cuda_equals_cpu(cuda):
    """Phase 24 (a) at small size (no .noise, no .tran): the uA741's .pz
    and .sens at the operating point K2's panel tier solves, poles and
    zeros = the CPU path's as sets, every sensitivity at rtol 1e-9 with an
    atol on one scale for every unit (1e-12 of the largest |value * p /
    100|, the volts per 1% change, over the entry's |p| / 100; p = 0 taken
    as 1), d v(out)/d rfb within 2% of -v(in)/rin."""
    net = (decks.UA741_PZ_SENS
           .replace(".noise v(out) vin dec 10 1 10meg\n", "")
           .replace(".tran 1u 50u\n", ""))
    before = gj_real.K2_TIERS[torch.float64]["panel"]
    got = st.simulate(net, dialect="extended", device=cuda)
    assert gj_real.K2_TIERS[torch.float64]["panel"] > before
    want = st.simulate(net, dialect="extended", device="cpu")
    for f in ("poles", "zeros"):
        w = getattr(want.pz, f)
        np.testing.assert_allclose(pair_nearest(getattr(got.pz, f), w), w,
                                   rtol=1e-9,
                                   atol=1e-12 * float(np.abs(w).max()))
    scale = 1e-12 * max(abs(v) for v in want.sens.normalized.values())
    assert list(got.sens.values) == list(want.sens.values)
    for name, v in want.sens.values.items():
        atol = scale * 100.0 / (abs(want.sens.params[name]) or 1.0)
        assert abs(got.sens.values[name] - v) <= 1e-9 * abs(v) + atol, name
    np.testing.assert_allclose(got.sens.values["rfb"], -5e-5, rtol=0.02)


@pytest.mark.cuda
def test_step_meas_on_cuda_equals_cpu(cuda):
    """Phase 24 (c) at small size: STEP_MEAS over 21 lanes, each .meas
    array finite and equal to the CPU path's at rtol 1e-9; the transient
    factors each lane once on K3's register form."""
    net = decks.STEP_MEAS.replace("100 1100 1", "100 1100 50")
    before = gj_real.K3_TIERS[torch.float64]["register"]
    got = st.simulate(net, dialect="extended", device=cuda).step
    assert gj_real.K3_TIERS[torch.float64]["register"] > before
    want = st.simulate(net, dialect="extended", device="cpu").step
    assert list(got.meas) == list(want.meas) == ["vmax", "trise", "vavg"]
    for name, w in want.meas.items():
        assert got.meas[name].shape == (21,)
        assert np.isfinite(got.meas[name]).all()
        np.testing.assert_allclose(got.meas[name], w, rtol=1e-9,
                                   atol=1e-12 * float(np.abs(w).max()))


# ---- K1's and K2's multi entry, the Schur tier, the time-parallel core ----

MULTI_CASES = [(1, 1), (4, 1), (4, 131), (16, 515), (31, 33), (32, 32),
               (33, 7), (64, 131)]


def _multi_systems(n, r, dtype, complex_, seed=0):
    rng = np.random.default_rng(seed + 7 * n + r)
    planes = [rng.standard_normal((37, n, n)) + n * np.eye(n)]
    if complex_:
        planes.append(rng.standard_normal((37, n, n)))
    rhs = [rng.standard_normal((37, n, r)) for _ in planes]
    for A in planes:
        A[0] = 0.0  # a singular lane
    planes[0][1, 0, 0] = np.nan  # a NaN lane
    return [torch.as_tensor(a, dtype=dtype) for a in planes + rhs]


@pytest.mark.cuda
@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,r", MULTI_CASES)
def test_multi_matches_plain(cuda, n, r, dtype, complex_):
    """Every tier of the multi entry (the warp kernel to N = 32, the panel
    tier at R right-hand sides) against the plain multi solve, at the
    edges of N and R: valid identical, the valid lanes at TOL."""
    cpu = _multi_systems(n, r, dtype, complex_)
    plain = (linsolve.gj_solve_planes_multi if complex_
             else linsolve.gj_solve_multi)
    want = plain(*cpu)
    module = gj if complex_ else gj_real
    kernel = (gj.K1 if complex_ else gj_real.K2)[dtype]
    for tier in gj_real.MULTI_TIERS:
        if tier == "multi" and n > gj.WARP_MAX_N:
            continue
        before = (kernel.launches, module_tiers(complex_, dtype)[tier])
        fn = (gj.gj_solve_planes_multi_cuda if complex_
              else gj_real.gj_solve_multi_cuda)
        got = fn(*[t.to(cuda) for t in cpu], tier=tier)
        assert (kernel.launches, module_tiers(complex_, dtype)[tier]) == \
            (before[0] + 1, before[1] + 1)
        rv = want[-1]
        assert torch.equal(got[-1].cpu(), rv) and not rv[0] and not rv[1]
        for g, w in zip(got[:-1], want[:-1]):
            torch.testing.assert_close(g.cpu()[rv], w[rv], rtol=TOL[dtype],
                                       atol=TOL[dtype] * float(w[rv].abs()
                                                               .max()))
    assert module.MULTI_TIERS == ("multi", "panel")


def module_tiers(complex_, dtype):
    return (gj.K1_TIERS if complex_ else gj_real.K2_TIERS)[dtype]


def test_multi_wrappers_refuse_bad_input():
    """The multi wrappers refuse what the kernels do not take, before
    anything is built: CPU tensors, B of the wrong shape, mixed dtypes, a
    warp kernel forced past N = 32."""
    A, Ai, B, Bi = _multi_systems(4, 3, torch.float64, True)
    with pytest.raises(ValueError, match="CUDA"):
        gj_real.gj_solve_multi_cuda(A, B)
    with pytest.raises(ValueError, match="CUDA"):
        gj.gj_solve_planes_multi_cuda(A, Ai, B, Bi)
    with pytest.raises(ValueError, match=r"\(B, N, R\)"):
        gj_real.gj_solve_multi_cuda(A, B[:, :3])
    with pytest.raises(ValueError, match=r"\(B, N, R\)"):
        gj.gj_solve_planes_multi_cuda(A, Ai, B[..., 0], Bi[..., 0])
    with pytest.raises(TypeError, match="one"):
        gj.gj_solve_planes_multi_cuda(A, Ai, B, Bi.float())
    big = _multi_systems(33, 2, torch.float64, False)
    with pytest.raises(ValueError, match="no tier 'multi' at N=33"):
        gj_real.gj_solve_multi_cuda(*big, tier="multi")
    assert gj_real.multi_tier_for(32) == "multi"
    assert gj_real.multi_tier_for(33) == "panel"


@pytest.mark.cuda
def test_schur_ac_on_cuda_equals_cpu(cuda):
    """Phase 25 (a) at small size: the 64-stage ladder's AC through the
    forced Schur tier and the default method's dispatch on the card,
    against the CPU path's Schur solve at rtol 1e-9 / atol 1e-12 of the
    largest value; the block solves run K1's multi entry."""
    net = decks.schur_ladder_netlist(64, analysis=".ac dec 5 1 1e6")
    want = st.simulate_ac(st.parse_netlist(net, dialect="extended"),
                          method="schur", device="cpu")
    scale = max(float(np.abs(v).max()) for v in want.node_voltages.values())
    for method in ("schur", "gj"):
        before = gj.K1_TIERS[torch.float64]["multi"]
        got = st.simulate_ac(st.parse_netlist(net, dialect="extended"),
                             method=method, device=cuda)
        assert gj.K1_TIERS[torch.float64]["multi"] == before + 1
        for name, w in want.node_voltages.items():
            np.testing.assert_allclose(got.node_voltages[name], w,
                                       rtol=1e-9, atol=1e-12 * scale)


@pytest.mark.cuda
def test_time_parallel_on_cuda_equals_cpu(cuda):
    """Phase 25 (d) at small size: the RLC Monte-Carlo through the
    time-parallel core on the card (K3 once) against the same core on the
    CPU and the loop on the card, BE and trap, at the JAX tests'
    tolerances."""
    net = decks.tp_rlc_netlist("400u")  # 2,000 steps
    rng = np.random.default_rng(3)
    over = {"R1": 100.0 * (1 + 0.2 * rng.random(16)),
            "C1": 1e-6 * (1 + 0.2 * rng.random(16))}
    kw = dict(node="b", dialect="extended")
    for integ in ("be", "trap"):
        before = gj_real.K3[torch.float64].launches
        tp = st.mc_tran_stats(net, over, integration=integ, device=cuda,
                              **kw)
        assert gj_real.K3[torch.float64].launches > before
        cpu = st.mc_tran_stats(net, over, integration=integ, device="cpu",
                               **kw)
        seq = st.mc_tran_stats(net, over, integration=integ,
                               time_parallel="never", device=cuda, **kw)
        for other in (cpu, seq):
            assert tp.n_valid == other.n_valid == 16
            for f in ("mean", "max", "min"):
                np.testing.assert_allclose(getattr(tp, f), getattr(other, f),
                                           rtol=1e-9, atol=1e-12, err_msg=f)
            np.testing.assert_allclose(tp.std, other.std, rtol=1e-7,
                                       atol=1e-12)


# ---- the derivative rules (ops/linsolve.py) on the card -----------------

def _rule_systems(n, B, seed=11):
    rng = np.random.default_rng(seed)
    planes = [rng.standard_normal((B, n, n)) + n * np.eye(n),
              rng.standard_normal((B, n, n)), *rng.standard_normal((2, B, n))]
    tangents = [rng.standard_normal((B, n, n)), rng.standard_normal((B, n, n)),
                *rng.standard_normal((2, B, n))]
    cot = rng.standard_normal((2, B, n))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    return ([t(a) for a in planes], [t(a) for a in tangents],
            [t(a) for a in cot])


def _jvp_vjp(fn, primals, tangents, cot, dev):
    """fn's outputs, their tangents (forward mode) and the inputs'
    gradients of sum(out * cot) (reverse mode), all on ``dev``."""
    import torch.autograd.forward_ad as fwAD

    p = [a.to(dev) for a in primals]
    with fwAD.dual_level():
        outs = fn(*[fwAD.make_dual(a, d.to(dev)) for a, d in
                    zip(p, tangents)])
        tan = [fwAD.unpack_dual(o).tangent for o in outs]
    ins = [a.clone().requires_grad_() for a in p]
    outs = fn(*ins)
    loss = sum((o * c.to(dev)).sum() for o, c in zip(outs, cot))
    grads = torch.autograd.grad(loss, ins)
    return ([o.detach().cpu() for o in outs], [t.cpu() for t in tan],
            [g.cpu() for g in grads])


def _same_f64(got, want):
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [6, 40])
def test_solve_rules_launch_k2(cuda, n):
    planes, tangents, cot = _rule_systems(n, 64)
    f64 = torch.float64
    fn = lambda A, b: (linsolve.solve(A, b)[0],)  # noqa: E731
    k2 = gj_real.K2[f64].launches
    rules = dict(linsolve.RULE_CALLS)
    got = _jvp_vjp(fn, (planes[0], planes[2]), (tangents[0], tangents[2]),
                   cot[:1], cuda)
    # forward + tangent, then forward + adjoint: four K2 launches
    assert gj_real.K2[f64].launches == k2 + 4
    for role, n_calls in (("forward", 2), ("tangent", 1), ("adjoint", 1)):
        assert linsolve.RULE_CALLS[("K2", role)] == rules[("K2", role)] + n_calls
    want = _jvp_vjp(fn, (planes[0], planes[2]), (tangents[0], tangents[2]),
                    cot[:1], "cpu")
    for g, w in zip(got, want):
        _same_f64(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [6, 40])
def test_solve_planes_rules_launch_k1(cuda, n):
    planes, tangents, cot = _rule_systems(n, 64)
    f64 = torch.float64
    fn = lambda *a: linsolve.solve_planes(*a)[:2]  # noqa: E731
    k1 = gj.K1[f64].launches
    rules = dict(linsolve.RULE_CALLS)
    got = _jvp_vjp(fn, planes, tangents, cot, cuda)
    assert gj.K1[f64].launches == k1 + 4
    for role, n_calls in (("forward", 2), ("tangent", 1), ("adjoint", 1)):
        assert linsolve.RULE_CALLS[("K1", role)] == rules[("K1", role)] + n_calls
    want = _jvp_vjp(fn, planes, tangents, cot, "cpu")
    for g, w in zip(got, want):
        _same_f64(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 12, 40])
def test_inverse_rules_launch_k3_once(cuda, n):
    """The inverse's tangent and adjoint are products of its own inverse:
    one K3 launch per forward, none for the rules."""
    planes, tangents, _ = _rule_systems(n, 64)
    f64 = torch.float64
    fn = lambda A: (linsolve.inverse(A)[0],)  # noqa: E731
    G = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (64, n, n)))
    k3 = gj_real.K3[f64].launches
    got = _jvp_vjp(fn, planes[:1], tangents[:1], [G], cuda)
    assert gj_real.K3[f64].launches == k3 + 2
    want = _jvp_vjp(fn, planes[:1], tangents[:1], [G], "cpu")
    for g, w in zip(got, want):
        _same_f64(g, w)


@pytest.mark.cuda
def test_multi_entries_refuse_a_dual_on_the_card(cuda):
    import torch.autograd.forward_ad as fwAD

    planes, tangents, _ = _rule_systems(4, 8)
    A, B = planes[0].to(cuda), planes[1].to(cuda)
    with fwAD.dual_level():
        with pytest.raises(NotImplementedError, match="no derivative rule"):
            linsolve.solve_multi(fwAD.make_dual(A, tangents[0].to(cuda)), B)
        with pytest.raises(NotImplementedError, match="no derivative rule"):
            linsolve.inverse_planes(fwAD.make_dual(A, tangents[0].to(cuda)),
                                    B)


@pytest.mark.cuda
def test_sensitivity_fit_adaptive_match_cpu(cuda):
    """phase 26 at small size: sensitivities of the RC low-pass and a
    short boost transient, ten fit_ac steps and an adaptive RC run, each
    equal to the CPU path."""
    ac = ("* rc\nv1 1 0 dc 0 ac 1\nr1 1 2 30\nc1 2 0 100u\n"
          ".ac dec 10 1 100\n.end\n")
    boost = decks.BOOST_NET.replace(".tran 0.001 0.1 uic",
                                    ".tran 0.001 0.01 uic")
    for dev_ckt, cpu_ckt, fn in (
            (st.parse_netlist(ac), st.parse_netlist(ac),
             lambda c, d: st.sensitivity_ac(c, "2", ["r1", "c1"], device=d)),
            (st.parse_netlist(boost), st.parse_netlist(boost),
             lambda c, d: st.sensitivity_tran(c, "N3", ["LL1", "RR1"],
                                              device=d))):
        got, want = fn(dev_ckt, cuda), fn(cpu_ckt, "cpu")
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-9,
                                       atol=1e-12 * np.abs(w).max())
    target = np.abs(st.simulate_ac(st.parse_netlist(ac.replace(
        "r1 1 2 30", "r1 1 2 47")), device="cpu").node_voltages["2"])
    fits = [st.fit_ac(st.parse_netlist(ac), "2", target, ["r1"], steps=10,
                      device=d) for d in (cuda, "cpu")]
    np.testing.assert_allclose(fits[0].loss_history, fits[1].loss_history,
                               rtol=1e-9)
    rc = "t\nV1 1 0 dc 5\nR1 1 2 1k\nC1 2 0 1u\n.tran 10u 10m\n"
    runs = [st.simulate_tran_adaptive(st.parse_netlist(rc), rtol=1e-3,
                                      device=d) for d in (cuda, "cpu")]
    assert runs[0].n_accepted == runs[1].n_accepted
    np.testing.assert_allclose(runs[0].times, runs[1].times, rtol=1e-9)
