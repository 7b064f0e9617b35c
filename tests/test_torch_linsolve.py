"""The port's plain complex Gauss-Jordan (the CPU version of kernel K1)
against the JAX package's solvers on identical numpy inputs.

f64 is held to the JAX plane GJ at rtol 1e-12 (same algorithm, same pivot
order; the last bits differ only where XLA fuses differently). f32 is held
to the Pallas kernel in interpret mode at rtol 1e-5 (f32 elimination
carries ~N * 6e-8 relative rounding). ``valid`` must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spicey_tpu.ops import linsolve as jlin
from spicey_tpu.ops.pallas_gj import pallas_gj_solve_complex
from spicey_tpu_torch.ops import linsolve as tlin


def _random(rng, B, N):
    Ar = rng.standard_normal((B, N, N)) + N * np.eye(N)
    Ai = rng.standard_normal((B, N, N))
    br = rng.standard_normal((B, N))
    bi = rng.standard_normal((B, N))
    return Ar, Ai, br, bi


def _mna_like(rng, B, N):
    """Zero-diagonal rows in the voltage-source pattern: the branch row
    and column of each source carry +-1 couplings and a zero diagonal, so
    the first pivot of that column must come from another row."""
    Ar, Ai, br, bi = _random(rng, B, N)
    for j in range(N - 2, N):
        Ar[:, j, :] = 0.0
        Ar[:, :, j] = 0.0
        Ai[:, j, :] = 0.0
        Ai[:, :, j] = 0.0
        k = j - (N - 2)
        Ar[:, k, j] = Ar[:, j, k] = 1.0
    return Ar, Ai, br, bi


def _singular(rng, B, N):
    """Lane 0: a zero row; lane 1: two equal rows; lane 2: all zero; the
    rest regular."""
    Ar, Ai, br, bi = _random(rng, B, N)
    Ar[0, 1, :] = Ai[0, 1, :] = 0.0
    Ar[1, 2, :] = Ar[1, 0, :]
    Ai[1, 2, :] = Ai[1, 0, :]
    Ar[2] = Ai[2] = 0.0
    return Ar, Ai, br, bi


def _jax_gj(Ar, Ai, br, bi):
    f = jax.vmap(jlin.gj_solve_planes)
    return [np.asarray(a) for a in f(*map(jnp.asarray, (Ar, Ai, br, bi)))]


def _port(arrays, dtype):
    xr, xi, valid = tlin.gj_solve_planes(
        *[torch.as_tensor(a, dtype=dtype) for a in arrays])
    return xr.numpy(), xi.numpy(), valid.numpy()


@pytest.mark.parametrize("kind,N", [("random", 3), ("random", 8),
                                    ("random", 24), ("mna", 6),
                                    ("singular", 5)])
def test_f64_plane_gj_matches_jax(kind, N):
    rng = np.random.default_rng(N)
    make = {"random": _random, "mna": _mna_like, "singular": _singular}[kind]
    arrays = make(rng, 16, N)
    jr, ji, jv = _jax_gj(*arrays)
    tr, ti, tv = _port(arrays, torch.float64)
    np.testing.assert_array_equal(tv, jv)
    if kind == "singular":
        assert not tv[:3].any() and tv[3:].all()
    ok = jv
    np.testing.assert_allclose(tr[ok], jr[ok], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ti[ok], ji[ok], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind,N", [("random", 4), ("mna", 8),
                                    ("singular", 6)])
def test_f32_matches_pallas_kernel_interpret(kind, N):
    rng = np.random.default_rng(100 + N)
    make = {"random": _random, "mna": _mna_like, "singular": _singular}[kind]
    arrays = [a.astype(np.float32) for a in make(rng, 24, N)]
    jr, ji, jv = [np.asarray(a) for a in pallas_gj_solve_complex(
        *map(jnp.asarray, arrays), refine=0, interpret=True)]
    tr, ti, tv = _port(arrays, torch.float32)
    assert tr.dtype == np.float32
    np.testing.assert_array_equal(tv, jv)
    # the duplicated-row lane of the singular set keeps an f32 rounding
    # residue as its last pivot: both flag it valid with garbage x, so
    # values are compared on the regular lanes only
    ok = jv.copy()
    if kind == "singular":
        ok[:3] = False
    scale = np.max(np.abs(jr[ok]))
    np.testing.assert_allclose(tr[ok], jr[ok], rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(ti[ok], ji[ok], rtol=1e-5, atol=1e-5 * scale)


def test_batch_dims_and_ties_to_lowest_row():
    """Leading batch dims survive, and equal |pivot| candidates pick the
    lowest row: with A = [[1, 1], [1, -1]] (equal magnitudes in column 0)
    the first pivot is row 0, as jnp.argmax picks it."""
    A = torch.tensor([[1.0, 1.0], [1.0, -1.0]], dtype=torch.float64)
    Ar = A.expand(2, 3, 2, 2)
    Ai = torch.zeros_like(Ar)
    br = torch.tensor([3.0, 1.0], dtype=torch.float64).expand(2, 3, 2)
    xr, xi, valid = tlin.gj_solve_planes(Ar, Ai, br, torch.zeros_like(br))
    assert xr.shape == (2, 3, 2) and valid.shape == (2, 3)
    torch.testing.assert_close(xr[1, 2], torch.tensor(
        [2.0, 1.0], dtype=torch.float64), rtol=0, atol=1e-15)
    jr, _, _ = jlin.gj_solve_planes(jnp.asarray(A.numpy()),
                                    jnp.zeros((2, 2)),
                                    jnp.asarray([3.0, 1.0]), jnp.zeros(2))
    np.testing.assert_array_equal(xr[0, 0].numpy(), np.asarray(jr))


def test_solve_planes_cpu_runs_plain_and_checks_method():
    rng = np.random.default_rng(7)
    arrays = [torch.as_tensor(a) for a in _random(rng, 4, 5)]
    for method in ("gj", "pallas"):
        got = tlin.solve_planes(*arrays, method=method)
        ref = tlin.gj_solve_planes(*arrays)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    with pytest.raises(ValueError, match="unknown solve method"):
        tlin.solve_planes(*arrays, method="lax")


# ---- the real solve and inverse: plain K2 and K3 -------------------------

def _real(kind, rng, B, N):
    """Random diagonally dominant systems; "singular": lane 0 a zero row,
    lane 1 two equal rows, lane 2 all zero, lane 3 a NaN entry."""
    A = rng.standard_normal((B, N, N)) + N * np.eye(N)
    b = rng.standard_normal((B, N))
    if kind == "mna":
        A = _mna_like(rng, B, N)[0]
    elif kind == "singular":
        A[0, 1, :] = 0.0
        A[1, 2, :] = A[1, 0, :]
        A[2] = 0.0
        A[3, 0, 0] = np.nan
    return A, b


def _jax_inv_of(A):
    """The JAX transient's factor-once inverse (analysis/tran.py inv_of):
    one gj_solve per unit vector, column j of the inverse."""
    def col(a, e):
        return jlin.gj_solve(a, e, 1e-15)

    f = jax.jit(jax.vmap(jax.vmap(col, in_axes=(None, 0)), in_axes=(0, None)))
    X, oks = f(jnp.asarray(A), jnp.eye(A.shape[-1]))  # (B, col, row)
    return np.swapaxes(np.asarray(X), -1, -2), np.asarray(oks).all(axis=1)


@pytest.mark.parametrize("kind", ["random", "mna", "singular"])
@pytest.mark.parametrize("N", [3, 8, 32])
def test_real_gj_solve_matches_jax(kind, N):
    rng = np.random.default_rng(200 + N)
    A, b = _real(kind, rng, 16, N)
    jx, jv = [np.asarray(a) for a in jax.vmap(
        jlin.gj_solve, in_axes=(0, 0, None))(jnp.asarray(A), jnp.asarray(b),
                                             1e-15)]
    tx, tv = tlin.gj_solve(torch.as_tensor(A), torch.as_tensor(b))
    np.testing.assert_array_equal(tv.numpy(), jv)
    if kind == "singular":
        assert not tv[:4].any() and tv[4:].all()
    np.testing.assert_allclose(tx.numpy()[jv], jx[jv], rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("kind", ["random", "mna", "singular"])
@pytest.mark.parametrize("N", [3, 8, 32])
def test_real_gj_inverse_matches_jax_inv_of(kind, N):
    rng = np.random.default_rng(300 + N)
    A, _b = _real(kind, rng, 12, N)
    jinv, jv = _jax_inv_of(A)
    tinv, tv = tlin.gj_inverse(torch.as_tensor(A))
    tv = tv.numpy()
    if kind == "singular":
        # the duplicated-row lane's last pivot is a rounding residue near
        # EPS; whether it clears EPS depends on the order XLA sums in, so
        # that lane is held to nothing but being the only one in doubt
        assert not tv[[0, 2, 3]].any() and not jv[[0, 2, 3]].any()
        tv[1] = jv[1] = False
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tinv.numpy()[jv], jinv[jv], rtol=1e-12,
                               atol=1e-12)
    if kind == "random":  # the true inverse, not a row-permuted one
        np.testing.assert_allclose(tinv.numpy(), np.linalg.inv(A),
                                   rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("N", [4, 8])
def test_real_f32_matches_pallas_kernels_interpret(N):
    """The f32 plain versions against the TPU kernels K2 and K3 run in
    interpret mode; K3's row-permuted output is un-permuted by its pivot
    map (colidx) first."""
    from spicey_tpu.ops import pallas_gj

    rng = np.random.default_rng(400 + N)
    A, b = [a.astype(np.float32) for a in _real("mna", rng, 20, N)]
    jx, jv = pallas_gj.pallas_gj_solve_real(jnp.asarray(A), jnp.asarray(b),
                                            refine=0, interpret=True)
    tx, tv = tlin.gj_solve(torch.as_tensor(A), torch.as_tensor(b))
    assert tx.dtype == torch.float32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    scale = float(np.abs(np.asarray(jx)).max())
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-5 * scale)
    M, colidx, mv = pallas_gj._inverse_real_f32(jnp.asarray(A), 1e-15, True)
    M, colidx = np.asarray(M), np.asarray(colidx).astype(int)
    jinv = np.zeros_like(M)
    for s in range(A.shape[0]):
        jinv[s, colidx[s]] = M[s]
    tinv, iv = tlin.gj_inverse(torch.as_tensor(A))
    np.testing.assert_array_equal(iv.numpy(), np.asarray(mv))
    scale = float(np.abs(jinv).max())
    np.testing.assert_allclose(tinv.numpy(), jinv, rtol=1e-5,
                               atol=1e-5 * scale)


def test_real_solve_and_inverse_dispatch_on_the_cpu():
    rng = np.random.default_rng(9)
    A, b = [torch.as_tensor(a) for a in _real("random", rng, 6, 5)]
    A4, b3 = A.reshape(2, 3, 5, 5), b.reshape(2, 3, 5)
    for method in ("gj", "pallas"):
        x, v = tlin.solve(A4, b3, method=method)
        rx, rv = tlin.gj_solve(A, b)
        assert x.shape == (2, 3, 5) and v.shape == (2, 3)
        assert torch.equal(x.reshape(6, 5), rx) and torch.equal(
            v.reshape(6), rv)
    inv, v = tlin.inverse(A4)
    rinv, rv = tlin.gj_inverse(A)
    assert inv.shape == (2, 3, 5, 5)
    assert torch.equal(inv.reshape(6, 5, 5), rinv)
    with pytest.raises(ValueError, match="unknown solve method"):
        tlin.solve(A, b, method="lax")


# ---- the complex inverse: plain K4 ---------------------------------------

def _unpermuted(M, colidx):
    """The TPU kernel's row-permuted inverse un-permuted by its pivot map
    (``pallas_gj._unperm_onehot``): row r of M is row colidx[r] of the
    true inverse."""
    out = np.zeros_like(M)
    for s in range(M.shape[0]):
        out[s, colidx[s]] = M[s]
    return out


@pytest.mark.parametrize("kind,N", [("random", 3), ("mna", 6),
                                    ("singular", 5), ("random", 8)])
def test_f32_inverse_matches_pallas_kernel_interpret(kind, N):
    from spicey_tpu.ops import pallas_gj

    rng = np.random.default_rng(500 + N)
    make = {"random": _random, "mna": _mna_like, "singular": _singular}[kind]
    Ar, Ai = [a.astype(np.float32) for a in make(rng, 16, N)[:2]]
    Mr, Mi, colidx, jv = [np.asarray(a) for a in
                          pallas_gj._inverse_complex_f32(
                              jnp.asarray(Ar), jnp.asarray(Ai), 1e-15, True)]
    colidx = colidx.astype(int)
    jr, ji = _unpermuted(Mr, colidx), _unpermuted(Mi, colidx)
    tr, ti, tv = tlin.gj_inverse_planes(torch.as_tensor(Ar),
                                        torch.as_tensor(Ai))
    assert tr.dtype == torch.float32
    np.testing.assert_array_equal(tv.numpy(), jv)
    ok = jv.copy()
    if kind == "singular":
        # as in the solve: the duplicated-row lane keeps a rounding
        # residue as its last pivot, valid in both with garbage values
        assert not ok[[0, 2]].any()
        ok[:3] = False
    scale = np.max(np.abs(jr[ok]))
    np.testing.assert_allclose(tr.numpy()[ok], jr[ok], rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(ti.numpy()[ok], ji[ok], rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("kind,N", [("random", 4), ("mna", 8),
                                    ("singular", 6)])
def test_f64_inverse_matches_jax_plane_gj_columns(kind, N):
    """Column j of the plain K4 inverse is JAX's f64 plane GJ solve of
    A x = e_j, at 1e-12, with the same ``valid``."""
    rng = np.random.default_rng(600 + N)
    make = {"random": _random, "mna": _mna_like, "singular": _singular}[kind]
    Ar, Ai = make(rng, 10, N)[:2]
    eye = np.eye(N)
    f = jax.jit(jax.vmap(jax.vmap(jlin.gj_solve_planes,
                                  in_axes=(None, None, 0, 0)),
                         in_axes=(0, 0, None, None)))
    xr, xi, oks = [np.asarray(a) for a in f(jnp.asarray(Ar), jnp.asarray(Ai),
                                            jnp.asarray(eye),
                                            jnp.zeros((N, N)))]
    jv = oks.all(axis=1)
    tr, ti, tv = tlin.gj_inverse_planes(torch.as_tensor(Ar),
                                        torch.as_tensor(Ai))
    np.testing.assert_array_equal(tv.numpy(), jv)
    if kind == "singular":
        assert not jv[:3].any() and jv[3:].all()
    # (B, col, row) -> (B, row, col)
    jr, ji = np.swapaxes(xr, -1, -2), np.swapaxes(xi, -1, -2)
    np.testing.assert_allclose(tr.numpy()[jv], jr[jv], rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(ti.numpy()[jv], ji[jv], rtol=1e-12,
                               atol=1e-12)
    if kind == "random":  # the true inverse
        np.testing.assert_allclose((tr + 1j * ti).numpy(),
                                   np.linalg.inv(Ar + 1j * Ai), rtol=1e-10,
                                   atol=1e-12)


def test_inverse_planes_dispatch_on_the_cpu():
    rng = np.random.default_rng(12)
    Ar, Ai = [torch.as_tensor(a) for a in _random(rng, 6, 4)[:2]]
    got = tlin.inverse_planes(Ar.reshape(2, 3, 4, 4), Ai.reshape(2, 3, 4, 4))
    ref = tlin.gj_inverse_planes(Ar, Ai)
    assert got[0].shape == (2, 3, 4, 4) and got[2].shape == (2, 3)
    for g, r in zip(got, ref):
        assert torch.equal(g.reshape(r.shape), r)
