"""The structured (Schur) tier of the port against the JAX package's.

Every test of ``tests/test_schur.py`` has a counterpart here, run through
both packages on the CPU (the JAX package's compiled engine, the port's
plain versions with ``device="cpu"``) and held at rtol 1e-9 with an atol
of 1e-12 of the field's largest value (the repo's cross-tier rule): the
synthetic bordered-block-diagonal solves, the planner (plans equal array
for array), AC and Monte-Carlo AC, the linear and diode-clamp transients,
the default method's dispatch past N = 128, the Monte-Carlo transient, the
operating point with L-short branches, the ``.dc`` sweep, ``.tf`` and
``.noise``, and the ``ValueError`` of a forced Schur solve on a flat
deck. Besides: the plain multi-right-hand-side solves (the plain versions
of K1's and K2's multi entry) against the JAX package's
``gj_solve_multi`` / ``gj_solve_planes_multi``, and a board whose block
pivots fail, so that both packages' answers come from the dense retry.
The AC boards run a few frequencies, not the card's 241.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spicey_tpu as sj
from spicey_tpu.analysis.mc import mc_ac_stats as jax_mc_ac_stats
from spicey_tpu.analysis.mc import mc_tran_stats as jax_mc_tran_stats
from spicey_tpu.analysis.noise import simulate_noise as jax_noise
from spicey_tpu.analysis.op import simulate_dc as jax_dc
from spicey_tpu.analysis.op import simulate_op as jax_op
from spicey_tpu.analysis.tf import simulate_tf as jax_tf
from spicey_tpu.ir.circuit import build_tensors as jax_build_tensors
from spicey_tpu.ops import linsolve as jls
from spicey_tpu.ops import schur as js
import spicey_tpu_torch as st
from spicey_tpu_torch.analysis.mc import mc_ac_stats, mc_tran_stats
from spicey_tpu_torch.analysis.noise import simulate_noise
from spicey_tpu_torch.analysis.op import simulate_dc, simulate_op
from spicey_tpu_torch.analysis.tf import simulate_tf
from spicey_tpu_torch.ir.circuit import build_tensors
from spicey_tpu_torch.ops import linsolve as tls
from spicey_tpu_torch.ops import schur as ts
from tests.test_schur import _TRAN_KW, _ladder_netlist, _op_board, \
    _synthetic_bbd

RTOL, REL_ATOL = 1e-9, 1e-12
CPU = "cpu"
AC_FEW = ".ac dec 1 1 1e6"  # 7 frequencies
# the JAX package's device solves, compiled once per shape (eager, each
# runs its fori_loops op by op)
jax_schur_solve = jax.jit(js.schur_solve)
jax_schur_solve_planes = jax.jit(js.schur_solve_planes)
jax_gj_solve_multi = jax.jit(jax.vmap(jls.gj_solve_multi))
jax_gj_solve_planes_multi = jax.jit(jax.vmap(jls.gj_solve_planes_multi))


def _close(got, want, what: str, scale=None) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if scale is None:
        scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=REL_ATOL * scale + 1e-300,
                               err_msg=what)


def _fields_close(got: dict, want: dict, what: str) -> None:
    """Every series of a result dict at the rule, atol 1e-12 of the
    field's largest value."""
    assert list(got) == list(want), what
    scale = max(float(np.max(np.abs(np.asarray(v)))) for v in want.values())
    for name, w in want.items():
        _close(got[name], w, f"{what} {name}", scale)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a))


def _plan_arrays(blk_ix, blk_mask, if_ix) -> tuple:
    return (_t(blk_ix.astype(np.int64)), _t(blk_mask),
            _t(if_ix.astype(np.int64)))


def _parse(net: str, pkg=st):
    return pkg.parse_netlist(net, dialect="extended")


# ---------------------------------------------------------------------------
# The synthetic BBD solves
# ---------------------------------------------------------------------------


def test_schur_solve_real_matches_dense():
    rng = np.random.default_rng(7)
    A, _, b, _, blk_ix, blk_mask, if_ix = _synthetic_bbd(
        rng, [9, 7, 5, 9, 3, 8], 13)
    x, valid = ts.schur_solve(_t(A), _t(b), *_plan_arrays(blk_ix, blk_mask,
                                                          if_ix))
    xj, vj = jax_schur_solve(jnp.asarray(A), jnp.asarray(b),
                            jnp.asarray(blk_ix), jnp.asarray(blk_mask),
                            jnp.asarray(if_ix))
    assert bool(valid) and bool(vj)
    _close(x.numpy(), np.asarray(xj), "schur_solve")
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b), rtol=0,
                               atol=1e-10)


def test_schur_solve_planes_matches_dense():
    rng = np.random.default_rng(8)
    A, Ai, b, bi, blk_ix, blk_mask, if_ix = _synthetic_bbd(
        rng, [6, 6, 6, 6], 9, complex_=True)
    xr, xi, valid = ts.schur_solve_planes(
        _t(A), _t(Ai), _t(b), _t(bi), *_plan_arrays(blk_ix, blk_mask, if_ix))
    jr, ji, vj = jax_schur_solve_planes(
        jnp.asarray(A), jnp.asarray(Ai), jnp.asarray(b), jnp.asarray(bi),
        jnp.asarray(blk_ix), jnp.asarray(blk_mask), jnp.asarray(if_ix))
    assert bool(valid) and bool(vj)
    got = xr.numpy() + 1j * xi.numpy()
    _close(got, np.asarray(jr) + 1j * np.asarray(ji), "schur_solve_planes")
    np.testing.assert_allclose(got, np.linalg.solve(A + 1j * Ai, b + 1j * bi),
                               rtol=0, atol=1e-10)


def test_schur_solve_flags_singular_block():
    """A structurally zero block row flags the system invalid in both."""
    rng = np.random.default_rng(9)
    A, _, b, _, blk_ix, blk_mask, if_ix = _synthetic_bbd(rng, [5, 5], 4)
    u = int(blk_ix[0, 2])
    A[u, :] = 0.0
    A[:, u] = 0.0
    _x, valid = ts.schur_solve(_t(A), _t(b), *_plan_arrays(blk_ix, blk_mask,
                                                           if_ix))
    _xj, vj = jax_schur_solve(jnp.asarray(A), jnp.asarray(b),
                             jnp.asarray(blk_ix), jnp.asarray(blk_mask),
                             jnp.asarray(if_ix))
    assert not bool(valid) and not bool(vj)


def test_schur_solve_batched_and_multi_column():
    """Batch-first: a leading batch of systems equals the systems one by
    one, and R right-hand sides equal R single solves."""
    rng = np.random.default_rng(10)
    sets = [_synthetic_bbd(np.random.default_rng(s), [4, 4, 4], 5)
            for s in (1, 1, 1)]
    plan = _plan_arrays(*sets[0][4:])
    A = np.stack([s[0] + 0.1 * k * np.eye(s[0].shape[0])
                  for k, s in enumerate(sets)])
    Bm = rng.normal(size=A.shape[:2] + (3,))
    X, valid = ts.schur_solve_multi(_t(A), _t(Bm), *plan)
    assert bool(valid.all())
    for k in range(A.shape[0]):
        for j in range(3):
            xj, vj = jax_schur_solve(jnp.asarray(A[k]), jnp.asarray(Bm[k, :, j]),
                                    *(jnp.asarray(a) for a in sets[0][4:]))
            assert bool(vj)
            _close(X[k, :, j].numpy(), np.asarray(xj), f"system {k} col {j}")


# ---------------------------------------------------------------------------
# The planner, array for array
# ---------------------------------------------------------------------------


def _plans(net: str, op: bool = False, **kw):
    cj, ct = _parse(net, sj), _parse(net)
    tj, tt = jax_build_tensors(cj), build_tensors(ct)
    if op:
        return (js.plan_partition_op(cj, tj, **kw),
                ts.plan_partition_op(ct, tt, **kw), tt)
    return js.plan_partition(cj, tj, **kw), ts.plan_partition(ct, tt, **kw), tt


def _same_plan(pj, pt) -> None:
    assert (pj is None) == (pt is None)
    if pj is None:
        return
    for f in ("blk_ix", "blk_mask", "if_ix"):
        a, b = getattr(pj, f), getattr(pt, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert pj.nvar == pt.nvar and pj.group_names == pt.group_names


def test_plan_partition_ladder_structure():
    pj, pt, tensors = _plans(_ladder_netlist(16))
    _same_plan(pj, pt)
    assert pt.n_blocks == 16 and pt.n_interface >= 18
    seen = set(pt.if_ix.tolist())
    for k in range(pt.n_blocks):
        for u in pt.blk_ix[k, pt.blk_mask[k]].tolist():
            assert u not in seen
            seen.add(u)
    assert seen == set(range(tensors.nvar))


def test_plan_promotes_port_to_port_branch():
    lines = ["* promo fixture", ".subckt lift p q", "v1 p q dc 0",
             "r1 p m 1k", "r2 m q 2k", "rg m 0 10k", ".ends",
             "vin in 0 dc 1 ac 1"]
    prev = "in"
    for i in range(1, 13):
        lines.append(f"x{i} {prev} o{i} lift")
        prev = f"o{i}"
    lines += [f"rload {prev} 0 1k", ".ac dec 2 1 1e3", ".end"]
    pj, pt, tensors = _plans("\n".join(lines), min_speedup=0.0)
    _same_plan(pj, pt)
    for nm, (_i1, _i2, br) in zip(tensors.v_names, tensors.v_idx):
        if nm.startswith("v1."):
            assert int(br) in set(pt.if_ix.tolist())


def test_plan_interface_cap_scales_with_nvar():
    net = _ladder_netlist(128, inner=6)
    pj, pt, tensors = _plans(net)
    _same_plan(pj, pt)
    assert tensors.nvar > 1000
    assert pt.n_blocks == 128 and pt.n_interface > 256
    pj, pt, _ = _plans(net, max_interface=100)
    assert pj is None and pt is None


def test_plan_rejects_flat_circuit():
    net = ["* flat", "vin in 0 ac 1", ".ac dec 2 1 1e3"]
    prev = "in"
    for i in range(40):
        net.append(f"r{i} {prev} n{i} 1k")
        net.append(f"c{i} n{i} 0 1n")
        prev = f"n{i}"
    net.append(".end")
    pj, pt, _ = _plans("\n".join(net))
    assert pj is None and pt is None


# ---------------------------------------------------------------------------
# AC
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ladder64_ac():
    net = _ladder_netlist(64, inner=3, analysis=AC_FEW)
    return net, sj.simulate_ac(_parse(net, sj), method="schur")


def test_ac_schur_matches_dense_64_stage_ladder(ladder64_ac):
    net, want = ladder64_ac
    assert build_tensors(_parse(net)).nvar > 256
    got = st.simulate_ac(_parse(net), method="schur", device=CPU)
    dense = st.simulate_ac(_parse(net), method="pallas", device=CPU)
    np.testing.assert_array_equal(got.freqs, want.freqs)
    _fields_close(got.node_voltages, want.node_voltages, "schur v")
    _fields_close(got.element_currents, want.element_currents, "schur i")
    _fields_close(got.node_voltages, dense.node_voltages, "schur vs dense")


def test_ac_gj_auto_takes_the_plan(ladder64_ac, monkeypatch):
    """method="gj" past N = 128 routes a subcircuit board through the
    plan, as the JAX package's default does."""
    net, want = ladder64_ac
    calls = []
    real = ts.schur_solve_planes

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(ts, "schur_solve_planes", spy)
    got = st.simulate_ac(_parse(net), device=CPU)
    assert calls
    _fields_close(got.node_voltages, want.node_voltages, "auto")


def test_mc_ac_schur_matches_dense():
    net = _ladder_netlist(16, inner=3, analysis=AC_FEW)
    rng = np.random.default_rng(3)
    B = 8
    over = {"r1.x1": 1e3 * (1 + 0.2 * rng.standard_normal(B)),
            "c1.x5": 1e-9 * (1 + 0.2 * rng.standard_normal(B))}
    kw = dict(node="o16", quantiles=(50.0,), dialect="extended")
    got = mc_ac_stats(net, over, method="schur", device=CPU, **kw)
    want = jax_mc_ac_stats(net, over, method="schur", **kw)
    dense = mc_ac_stats(net, over, method="pallas", device=CPU, **kw)
    assert got.n_valid == want.n_valid == dense.n_valid == B
    for f in ("mean", "std", "min", "max"):
        _close(getattr(got, f), getattr(want, f), f,
               float(np.max(want.max)))
    _close(got.quantiles[50.0], want.quantiles[50.0], "q50")
    _close(got.quantiles[50.0], dense.quantiles[50.0], "q50 dense")


def test_ac_schur_forced_on_flat_circuit_raises():
    net = ("* flat\nvin in 0 ac 1\nr1 in out 1k\nc1 out 0 1n\n"
           ".ac dec 2 1 1e3\n.end")
    with pytest.raises(ValueError) as jerr:
        sj.simulate_ac(sj.parse_netlist(net), method="schur")
    with pytest.raises(ValueError) as terr:
        st.simulate_ac(st.parse_netlist(net), method="schur", device=CPU)
    assert str(terr.value) == str(jerr.value) == ts.NO_PLAN
    with pytest.raises(ValueError, match="schur"):
        mc_ac_stats(net, {"r1": np.ones(2) * 1e3}, node="out",
                    method="schur", device=CPU)


def _sign_board(stages: int) -> str:
    """A subcircuit board whose every block is singular: the two interior
    nodes of a stage are joined by one resistor and reach the ports only
    through VCCS, so the 2 x 2 block [[g, -g], [-g, g]] fails its second
    pivot at every frequency while the whole system is regular (each
    stage inverts its input: v(o_k) = (-1)^k)."""
    lines = ["* block-singular board", ".subckt inv a y",
             "r12 m1 m2 1k", "g1 m1 0 a 0 1m", "g2 m2 0 y 0 1m",
             "ebuf y 0 m1 0 1", ".ends", "vin in 0 dc 1 ac 1"]
    prev = "in"
    for s in range(1, stages + 1):
        lines.append(f"x{s} {prev} o{s} inv")
        prev = f"o{s}"
    lines += [f"rload {prev} 0 10k", ".ac dec 1 1 100", ".end"]
    return "\n".join(lines) + "\n"


def test_ac_schur_invalid_block_retries_dense():
    """Block pivots fail, the global pivots do not: in both packages the
    Schur solve flags every frequency invalid and the sweep's values and
    flags come from the dense retry, forced and by the default method."""
    net = _sign_board(33)
    ckt = _parse(net)
    tensors = build_tensors(ckt)
    assert tensors.nvar > 128
    plan = ts.plan_partition(ckt, tensors)
    _same_plan(js.plan_partition(_parse(net, sj),
                                 jax_build_tensors(_parse(net, sj))), plan)
    assert plan.n_max == 2
    # the Schur solve alone: every system invalid
    A = np.zeros((tensors.nvar, tensors.nvar))
    for (i1, i2), r in zip(tensors.r_idx, tensors.r_vals):
        for p, q, v in ((i1, i1, 1), (i2, i2, 1), (i1, i2, -1), (i2, i1, -1)):
            if p < tensors.nvar and q < tensors.nvar:
                A[p, q] += v / r
    pa = plan.arrays()
    _x, ok = ts.schur_solve(_t(A), _t(np.ones(tensors.nvar)), pa["blk_ix"],
                            pa["blk_mask"], pa["if_ix"])
    assert not bool(ok)
    for method in ("schur", "gj"):
        want = sj.simulate_ac(_parse(net, sj), method=method)
        got = st.simulate_ac(_parse(net), method=method, device=CPU)
        _fields_close(got.node_voltages, want.node_voltages, method)
        for s in (1, 2, 33):
            np.testing.assert_allclose(got.node_voltages[f"o{s}"],
                                       (-1.0) ** s, rtol=1e-12)


# ---------------------------------------------------------------------------
# Transient
# ---------------------------------------------------------------------------


def _tran_close(got, want, what: str) -> None:
    np.testing.assert_array_equal(got.times, want.times)
    _fields_close(got.node_voltages, want.node_voltages, what)


def test_tran_schur_matches_dense_linear():
    net = _ladder_netlist(24, inner=5, **_TRAN_KW)
    tensors = build_tensors(_parse(net))
    assert tensors.nvar > 128
    assert ts.plan_partition(_parse(net), tensors) is not None
    got = st.simulate_tran(_parse(net), method="schur", device=CPU)
    want = sj.simulate_tran(_parse(net, sj), method="schur")
    dense = st.simulate_tran(_parse(net), method="pallas", device=CPU)
    _tran_close(got, want, "schur")
    _tran_close(got, dense, "schur vs dense")


def test_tran_schur_nonlinear_diode_clamps():
    net = _ladder_netlist(
        24, inner=4, stage_extra=(".model dd d(is=1e-14)", "dcl m2 0 dd"),
        **_TRAN_KW)
    tensors = build_tensors(_parse(net))
    assert tensors.nvar > 128 and tensors.n_d == 24
    got = st.simulate_tran(_parse(net), method="schur", device=CPU)
    want = sj.simulate_tran(_parse(net, sj), method="schur")
    _tran_close(got, want, "clamp")


def test_tran_schur_auto_dispatch_default_method(monkeypatch):
    net = _ladder_netlist(24, inner=5, **_TRAN_KW)
    calls = []
    real = ts.schur_solve_multi

    def spy(*a, **k):
        calls.append(a[1].shape)
        return real(*a, **k)

    monkeypatch.setattr(ts, "schur_solve_multi", spy)
    monkeypatch.setattr("spicey_tpu_torch.analysis.tran.schur_solve_multi",
                        spy)
    got = st.simulate_tran(_parse(net), device=CPU)
    want = sj.simulate_tran(_parse(net, sj))
    # the factor-once A^-1 is one Schur solve of the identity's columns
    nvar = build_tensors(_parse(net)).nvar
    assert calls and calls[0][-1] == nvar
    _tran_close(got, want, "auto")


def test_mc_tran_schur_matches_dense():
    net = _ladder_netlist(
        24, inner=4, stage_extra=(".model dd d(is=1e-14)", "dcl m2 0 dd"),
        **_TRAN_KW)
    rng = np.random.default_rng(5)
    B = 8
    over = {"r1.x1": 1e3 * (1 + 0.2 * rng.random(B))}
    kw = dict(node="o24", quantiles=(50.0,), dialect="extended")
    got = mc_tran_stats(net, over, method="schur", device=CPU, **kw)
    want = jax_mc_tran_stats(net, over, method="schur", **kw)
    assert got.n_valid == want.n_valid == B
    scale = float(np.max(np.abs(want.max)))
    for f in ("mean", "min", "max"):
        _close(getattr(got, f), getattr(want, f), f, scale)
    _close(got.quantiles[50.0], want.quantiles[50.0], "q50", scale)


def test_tran_schur_forced_on_flat_circuit_raises():
    net = ("* flat\nvin in 0 PULSE(0 1 0 1n 1n 5u 10u)\nr1 in out 1k\n"
           "c1 out 0 1n\n.tran 1u 10u\n.end")
    with pytest.raises(ValueError) as jerr:
        sj.simulate_tran(sj.parse_netlist(net), method="schur")
    with pytest.raises(ValueError) as terr:
        st.simulate_tran(st.parse_netlist(net), method="schur", device=CPU)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="schur"):
        mc_tran_stats(net, {"r1": np.ones(2) * 1e3}, node="out",
                      method="schur", device=CPU)


# ---------------------------------------------------------------------------
# .op / .dc / .tf / .noise
# ---------------------------------------------------------------------------


def test_op_schur_matches_dense_with_l_short_branches():
    net = _op_board(28)
    pj, pt, tensors = _plans(net, op=True)
    _same_plan(pj, pt)
    assert pt.nvar == tensors.nvar + tensors.n_l
    covered = set(pt.if_ix.tolist())
    for k in range(pt.n_blocks):
        covered.update(pt.blk_ix[k, pt.blk_mask[k]].tolist())
    assert covered == set(range(pt.nvar))
    got = simulate_op(_parse(net), method="schur", device=CPU)
    want = jax_op(_parse(net, sj), method="schur")
    _fields_close(got.node_voltages, want.node_voltages, ".op v")
    _fields_close(got.element_currents, want.element_currents, ".op i")
    assert [n for n in got.element_currents if n.startswith("l1.")]


def test_dc_sweep_schur_matches_dense():
    net = _op_board(28, tail=".dc vsrc 0 3 0.5")
    got = simulate_dc(_parse(net), method="schur", device=CPU)
    want = jax_dc(_parse(net, sj), method="schur")
    assert got.valid.all() and want.valid.all()
    _fields_close(got.node_voltages, want.node_voltages, ".dc")


def test_tf_schur_matches_dense():
    net = _op_board(28, tail=".tf v(o28) vsrc")
    got = simulate_tf(_parse(net), method="schur", device=CPU)
    want = jax_tf(_parse(net, sj), method="schur")
    for f in ("transfer_function", "input_impedance", "output_impedance"):
        _close(getattr(got, f), getattr(want, f), f)


def test_noise_schur_matches_dense():
    net = _op_board(28, tail=".noise v(o28) vsrc dec 5 1k 1meg")
    got = simulate_noise(_parse(net), method="schur", device=CPU)
    want = jax_noise(_parse(net, sj), method="schur")
    assert got.guard_resolves == 0  # two Schur solves, no inverse route
    _close(got.output_psd, want.output_psd, "output_psd")
    _close(got.gain, want.gain, "gain")


# ---------------------------------------------------------------------------
# The plain multi-RHS solves (K1's and K2's multi entry on the CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r", [1, 7, 131])
def test_gj_solve_multi_matches_jax(r):
    rng = np.random.default_rng(r)
    n = 5
    A = rng.normal(size=(6, n, n)) + 2 * np.eye(n)
    A[3, 1] = A[3, 0]  # a singular system among them
    B = rng.normal(size=(6, n, r))
    X, valid = tls.gj_solve_multi(_t(A), _t(B))
    XJ, VJ = jax_gj_solve_multi(jnp.asarray(A), jnp.asarray(B))
    for k in range(A.shape[0]):
        assert bool(valid[k]) == bool(VJ[k])
        if bool(VJ[k]):
            _close(X[k].numpy(), np.asarray(XJ[k]), f"system {k}")
    assert not bool(valid[3]) and bool(valid[0])


@pytest.mark.parametrize("r", [1, 7, 131])
def test_gj_solve_planes_multi_matches_jax(r):
    rng = np.random.default_rng(100 + r)
    n = 4
    Ar = rng.normal(size=(5, n, n)) + 2 * np.eye(n)
    Ai = rng.normal(size=(5, n, n))
    Ar[2], Ai[2] = 0.0, 0.0  # a singular system among them
    Br = rng.normal(size=(5, n, r))
    Bi = rng.normal(size=(5, n, r))
    Xr, Xi, valid = tls.gj_solve_planes_multi(_t(Ar), _t(Ai), _t(Br), _t(Bi))
    JR, JI, VJ = jax_gj_solve_planes_multi(
        jnp.asarray(Ar), jnp.asarray(Ai), jnp.asarray(Br), jnp.asarray(Bi))
    for k in range(Ar.shape[0]):
        assert bool(valid[k]) == bool(VJ[k])
        if bool(VJ[k]):
            _close(Xr[k].numpy() + 1j * Xi[k].numpy(),
                   np.asarray(JR[k]) + 1j * np.asarray(JI[k]), f"system {k}")
    assert not bool(valid[2])


def test_multi_dispatch_is_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(4)
    A = _t(rng.normal(size=(3, 4, 4)) + 2 * np.eye(4))
    B = _t(rng.normal(size=(3, 4, 9)))
    X, v = tls.solve_multi(A, B)
    Xp, vp = tls.gj_solve_multi(A, B)
    assert torch.equal(X, Xp) and torch.equal(v, vp)
    # the inverse is the multi solve of the identity
    inv, ok = tls.gj_inverse(A)
    Xi, oki = tls.gj_solve_multi(A, torch.eye(4, dtype=A.dtype).expand(3, 4, 4))
    assert torch.equal(inv, Xi) and torch.equal(ok, oki)
