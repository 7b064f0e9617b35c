"""The port's panel-blocked Gauss-Jordan tier (K10a/K10b, ops/mxu.py) on the CPU.

The plain versions, which the CPU runs and the card's kernel repeats, are
held against the JAX package's Pallas kernels in interpret mode
(``spicey_tpu/ops/pallas_mxu.py``) on the same seeded inputs in f32,
within 5e-5 of each system's largest unknown (the tolerance of
tests/test_pallas_mxu.py), and against the port's one-step Gauss-Jordan
(``ops/linsolve``, the plain K1/K2) at 1e-12 in f64; ``valid`` agrees
exactly, a zero system included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spicey_tpu.ops import pallas_mxu as jmxu
from spicey_tpu_torch.ops import linsolve, mxu

F32_TOL = 5e-5


def _real(B, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)) + 8.0 * np.eye(n)
    b = rng.standard_normal((B, n))
    A[1] = 0.0  # a zero system
    return A.astype(dtype), b.astype(dtype)


def _complex(B, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    Ar = rng.standard_normal((B, n, n)) + 8.0 * np.eye(n)
    Ai = rng.standard_normal((B, n, n))
    br, bi = rng.standard_normal((2, B, n))
    Ar[2] = Ai[2] = 0.0  # a zero system
    return [a.astype(dtype) for a in (Ar, Ai, br, bi)]


def _rel(got, want, valid):
    """Largest |got - want| over each valid system's largest |want|."""
    got, want = got[valid], want[valid]
    return float((np.abs(got - want)
                  / np.abs(want).max(axis=-1, keepdims=True)).max())


@pytest.mark.parametrize("n", [40, 67, 128])
def test_plain_real_matches_pallas_interpret(n):
    A, b = _real(4, n, seed=n)
    xj, vj = jmxu.mxu_solve_real(jnp.asarray(A), jnp.asarray(b),
                                 interpret=True)
    x, v = mxu.mxu_solve_real_plain(torch.as_tensor(A), torch.as_tensor(b))
    vj = np.asarray(vj)
    np.testing.assert_array_equal(v.numpy(), vj)
    assert not vj[1] and vj[[0, 2, 3]].all()
    assert _rel(x.numpy(), np.asarray(xj), vj) < F32_TOL


@pytest.mark.parametrize("n", [40, 67, 128])
def test_plain_complex_matches_pallas_interpret(n):
    planes = _complex(4, n, seed=n + 1)
    xr, xi, vj = jmxu.mxu_solve_complex(*map(jnp.asarray, planes),
                                        interpret=True)
    gr, gi, v = mxu.mxu_solve_complex_plain(*map(torch.as_tensor, planes))
    vj = np.asarray(vj)
    np.testing.assert_array_equal(v.numpy(), vj)
    assert not vj[2] and vj[[0, 1, 3]].all()
    want = np.asarray(xr) + 1j * np.asarray(xi)
    assert _rel(gr.numpy() + 1j * gi.numpy(), want, vj) < F32_TOL


@pytest.mark.parametrize("n", [40, 48, 67, 100, 128])
def test_plain_f64_matches_port_gj_and_numpy(n):
    A, b = _real(6, n, seed=2 * n, dtype=np.float64)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    x, v = mxu.mxu_solve_real_plain(At, bt)
    gx, gv = linsolve.gj_solve(At, bt)
    assert torch.equal(v, gv) and not v[1] and v.sum() == 5
    torch.testing.assert_close(x[v], gx[v], rtol=1e-12, atol=1e-12)
    ref = np.linalg.solve(A[v.numpy()], b[v.numpy()][..., None])[..., 0]
    np.testing.assert_allclose(x[v].numpy(), ref, rtol=1e-12, atol=1e-12)

    planes = _complex(6, n, seed=2 * n + 1, dtype=np.float64)
    pt = [torch.as_tensor(a) for a in planes]
    xr, xi, v = mxu.mxu_solve_complex_plain(*pt)
    gr, gi, gv = linsolve.gj_solve_planes(*pt)
    assert torch.equal(v, gv) and not v[2] and v.sum() == 5
    torch.testing.assert_close(xr[v], gr[v], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(xi[v], gi[v], rtol=1e-12, atol=1e-12)
    Ac = planes[0] + 1j * planes[1]
    bc = planes[2] + 1j * planes[3]
    vn = v.numpy()
    ref = np.linalg.solve(Ac[vn], bc[vn][..., None])[..., 0]
    np.testing.assert_allclose((xr + 1j * xi)[v].numpy(), ref, rtol=1e-12,
                               atol=1e-12)


def test_zero_diagonal_mna_structure():
    """Voltage-source branch rows have zero diagonals: the pivot search
    must reorder (tests/test_pallas_mxu.py's MNA case), in both packages
    and in f64 as the port's GJ does."""
    n = 64
    rng = np.random.default_rng(5)
    A = np.zeros((1, n, n))
    A[0, :n - 2, :n - 2] = (rng.standard_normal((n - 2, n - 2))
                            + 8 * np.eye(n - 2))
    A[0, n - 2, 0] = A[0, 0, n - 2] = 1.0
    A[0, n - 1, 1] = A[0, 1, n - 1] = 1.0
    b = rng.standard_normal((1, n))
    xj, vj = jmxu.mxu_solve_real(jnp.asarray(A, jnp.float32),
                                 jnp.asarray(b, jnp.float32), interpret=True)
    x32, v32 = mxu.mxu_solve_real(torch.as_tensor(A, dtype=torch.float32),
                                  torch.as_tensor(b, dtype=torch.float32))
    assert bool(np.asarray(vj)[0]) and bool(v32[0])
    assert _rel(x32.numpy(), np.asarray(xj), np.ones(1, bool)) < F32_TOL
    x, v = mxu.mxu_solve_real(torch.as_tensor(A), torch.as_tensor(b))
    gx, _ = linsolve.gj_solve(torch.as_tensor(A), torch.as_tensor(b))
    assert bool(v[0])
    torch.testing.assert_close(x, gx, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(x[0].numpy(), np.linalg.solve(A[0], b[0]),
                               rtol=1e-12, atol=1e-12)


def test_blocked_plan_equals_jax():
    for n in range(mxu.MXU_MIN_N, mxu.MXU_MAX_N + 1):
        assert mxu.blocked_plan(n) == jmxu.blocked_plan(n)
    assert (mxu.MXU_MIN_N, mxu.MXU_MAX_N) == (jmxu.MXU_MIN_N, jmxu.MXU_MAX_N)
    for n in (mxu.MXU_MIN_N - 1, mxu.MXU_MAX_N + 1):
        with pytest.raises(ValueError, match="MXU tier supports"):
            mxu.blocked_plan(n)
        A = torch.zeros((1, n, n))
        with pytest.raises(ValueError, match=r"N in \[40, 128\]"):
            mxu.mxu_solve_real(A, torch.zeros((1, n)))


def test_cpu_tensors_run_the_plain_versions():
    A, b = (torch.as_tensor(a) for a in _real(3, 48, seed=7,
                                              dtype=np.float64))
    before = {k.name: k.launches for k in
              list(mxu.K10a.values()) + list(mxu.K10b.values())}
    x, v = mxu.mxu_solve_real(A, b)
    px, pv = mxu.mxu_solve_real_plain(A, b)
    assert torch.equal(x, px) and torch.equal(v, pv)
    planes = [torch.as_tensor(a) for a in _complex(3, 48, seed=8)]
    got = mxu.mxu_solve_complex(*planes)
    want = mxu.mxu_solve_complex_plain(*planes)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert before == {k.name: k.launches for k in
                      list(mxu.K10a.values()) + list(mxu.K10b.values())}
