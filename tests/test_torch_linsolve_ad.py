"""The derivative rules of the port's solves against the JAX package.

``ops/linsolve.py`` routes a differentiated input of ``solve`` (K2),
``solve_planes`` (K1) and ``inverse`` (K3) through autograd Functions
whose JVP and VJP are one more dispatch with the same matrix. On random
well-conditioned f64 batches (one MNA-like system with zero-diagonal
branch rows among them) each rule is held:
  - to ``jax.jvp`` / ``jax.vjp`` through ``spicey_tpu.ops.linsolve``'s
    ``gj_solve`` / ``gj_solve_planes`` (vmapped), and for the inverse
    through ``gj_solve`` over the identity's columns (``inv_of`` of
    spicey_tpu/analysis/tran.py), at rtol 1e-12 with an atol of 1e-12 of
    the largest |value|;
  - to torch's own forward- and reverse-mode AD through the plain
    Gauss-Jordan (the same elimination differentiated op by op);
  - by ``torch.autograd.gradcheck(..., check_forward_ad=True)``.
And the rule, not native AD, carries every tangent: the plain versions
never see a dual or gradient-recording input, and the rules' counters
move.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from spicey_tpu.ops import linsolve as jlin
from spicey_tpu_torch.ops import linsolve as tlin

RTOL = 1e-12


def _systems(seed, B=6, N=7, mna=True):
    rng = np.random.default_rng(seed)
    Ar = rng.standard_normal((B, N, N)) + N * np.eye(N)
    Ai = rng.standard_normal((B, N, N))
    br, bi = rng.standard_normal((2, B, N))
    if mna:  # lane 0: a voltage-source pattern (zero diagonal, +-1 rows)
        for A in (Ar, Ai):
            A[0, -1, :] = A[0, :, -1] = 0.0
        Ar[0, 0, -1] = Ar[0, -1, 0] = 1.0
    dAr, dAi = rng.standard_normal((2, B, N, N))
    dbr, dbi = rng.standard_normal((2, B, N))
    g = rng.standard_normal((4, B, N))
    G = rng.standard_normal((B, N, N))
    return dict(Ar=Ar, Ai=Ai, br=br, bi=bi, dAr=dAr, dAi=dAi, dbr=dbr,
                dbi=dbi, gr=g[0], gi=g[1], G=G)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    atol = RTOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                               err_msg=what)


def _jax_solve(A, b):
    return jax.vmap(jlin.gj_solve)(A, b)[0]


def _jax_planes(Ar, Ai, br, bi):
    xr, xi, _ = jax.vmap(jlin.gj_solve_planes)(Ar, Ai, br, bi)
    return xr, xi


def _jax_inverse(A):
    """``inv_of``: column j of A^-1 is ``gj_solve(A, e_j)``."""
    eye = jnp.eye(A.shape[-1], dtype=A.dtype)
    cols = jax.vmap(lambda e: _jax_solve(A, jnp.broadcast_to(
        e, A.shape[:-1])), out_axes=-1)(eye)
    return cols


def _fwd(fn, primals, tangents):
    """torch forward-mode: fn's outputs' tangents."""
    with fwAD.dual_level():
        outs = fn(*[fwAD.make_dual(p, t) for p, t in zip(primals, tangents)])
        return [fwAD.unpack_dual(o).tangent for o in outs]


def _rev(fn, primals, cotangents):
    """torch reverse-mode: the inputs' gradients of sum(out * cot)."""
    ins = [p.clone().requires_grad_() for p in primals]
    outs = fn(*ins)
    loss = sum((o * c).sum() for o, c in zip(outs, cotangents))
    return torch.autograd.grad(loss, ins)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_jvp_vjp_match_jax(seed):
    s = _systems(seed)
    A, b = s["Ar"], s["br"]
    _, jt = jax.jvp(_jax_solve, (A, b), (s["dAr"], s["dbr"]))
    _, pull = jax.vjp(_jax_solve, A, b)
    jgA, jgb = pull(jnp.asarray(s["gr"]))

    def port(A, b):
        return (tlin.solve(A, b)[0],)

    (tt,) = _fwd(port, (_t(A), _t(b)), (_t(s["dAr"]), _t(s["dbr"])))
    _close(tt, jt, "solve jvp")
    tgA, tgb = _rev(port, (_t(A), _t(b)), (_t(s["gr"]),))
    _close(tgA, jgA, "solve vjp A")
    _close(tgb, jgb, "solve vjp b")

    def plain(A, b):
        return (tlin.gj_solve(A, b)[0],)

    (nt,) = _fwd(plain, (_t(A), _t(b)), (_t(s["dAr"]), _t(s["dbr"])))
    _close(tt, nt, "solve jvp vs torch AD of the plain GJ")
    ngA, ngb = _rev(plain, (_t(A), _t(b)), (_t(s["gr"]),))
    _close(tgA, ngA, "solve vjp A vs plain")
    _close(tgb, ngb, "solve vjp b vs plain")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_planes_jvp_vjp_match_jax(seed):
    s = _systems(seed)
    prim = tuple(s[k] for k in ("Ar", "Ai", "br", "bi"))
    tang = tuple(s[k] for k in ("dAr", "dAi", "dbr", "dbi"))
    _, (jr, ji) = jax.jvp(_jax_planes, prim, tang)
    _, pull = jax.vjp(_jax_planes, *prim)
    jg = pull((jnp.asarray(s["gr"]), jnp.asarray(s["gi"])))

    def port(*a):
        return tlin.solve_planes(*a)[:2]

    tr, ti = _fwd(port, [_t(a) for a in prim], [_t(a) for a in tang])
    _close(tr, jr, "planes jvp re")
    _close(ti, ji, "planes jvp im")
    tg = _rev(port, [_t(a) for a in prim], (_t(s["gr"]), _t(s["gi"])))
    for name, got, want in zip(("A_re", "A_im", "b_re", "b_im"), tg, jg):
        _close(got, want, f"planes vjp {name}")

    def plain(*a):
        return tlin.gj_solve_planes(*a)[:2]

    nr, ni = _fwd(plain, [_t(a) for a in prim], [_t(a) for a in tang])
    _close(tr, nr, "planes jvp vs plain re")
    _close(ti, ni, "planes jvp vs plain im")
    ng = _rev(plain, [_t(a) for a in prim], (_t(s["gr"]), _t(s["gi"])))
    for got, want in zip(tg, ng):
        _close(got, want, "planes vjp vs plain")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inverse_jvp_vjp_match_jax(seed):
    s = _systems(seed)
    A = s["Ar"]
    _, jt = jax.jvp(_jax_inverse, (A,), (s["dAr"],))
    _, pull = jax.vjp(_jax_inverse, A)
    (jg,) = pull(jnp.asarray(s["G"]))

    def port(A):
        return (tlin.inverse(A)[0],)

    (tt,) = _fwd(port, (_t(A),), (_t(s["dAr"]),))
    _close(tt, jt, "inverse jvp")
    (tg,) = _rev(port, (_t(A),), (_t(s["G"]),))
    _close(tg, jg, "inverse vjp")

    def plain(A):
        return (tlin.gj_inverse(A)[0],)

    (nt,) = _fwd(plain, (_t(A),), (_t(s["dAr"]),))
    _close(tt, nt, "inverse jvp vs plain")
    (ng,) = _rev(plain, (_t(A),), (_t(s["G"]),))
    _close(tg, ng, "inverse vjp vs plain")


@pytest.mark.parametrize("which", ["solve", "solve_planes", "inverse"])
def test_rules_pass_gradcheck(which):
    s = _systems(3, B=3, N=5)
    if which == "solve":
        fn = lambda A, b: tlin.solve(A, b)[0]  # noqa: E731
        ins = (s["Ar"], s["br"])
    elif which == "solve_planes":
        fn = lambda *a: tlin.solve_planes(*a)[:2]  # noqa: E731
        ins = tuple(s[k] for k in ("Ar", "Ai", "br", "bi"))
    else:
        fn = lambda A: tlin.inverse(A)[0]  # noqa: E731
        ins = (s["Ar"],)
    assert torch.autograd.gradcheck(
        fn, tuple(_t(a).requires_grad_() for a in ins),
        check_forward_ad=True)


def test_rule_not_native_ad_carries_every_tangent(monkeypatch):
    """The plain versions never see a dual or a gradient-recording input:
    the Function hands them primals, so what runs on the CPU is what runs
    on the card (where a dual passed to a kernel would lose its
    tangent). Inputs without a tangent skip the Function."""
    seen = []

    def guard(fn):
        def run(*args, **kw):
            for a in args:
                if isinstance(a, torch.Tensor):
                    assert fwAD.unpack_dual(a).tangent is None
                    assert not (torch.is_grad_enabled() and a.requires_grad)
            seen.append(fn.__name__)
            return fn(*args, **kw)
        return run

    for name in ("gj_solve", "gj_solve_planes", "gj_inverse"):
        monkeypatch.setattr(tlin, name, guard(getattr(tlin, name)))
    s = _systems(4)
    before = dict(tlin.RULE_CALLS)
    planes = [_t(s[k]) for k in ("Ar", "Ai", "br", "bi")]
    tangents = [_t(s[k]) for k in ("dAr", "dAi", "dbr", "dbi")]
    with fwAD.dual_level():
        x = tlin.solve(fwAD.make_dual(planes[0], tangents[0]), planes[2])[0]
        assert fwAD.unpack_dual(x).tangent is not None
        xr = tlin.solve_planes(*[fwAD.make_dual(p, t) for p, t in
                                 zip(planes, tangents)])[0]
        assert fwAD.unpack_dual(xr).tangent is not None
        inv = tlin.inverse(fwAD.make_dual(planes[0], tangents[0]))[0]
        assert fwAD.unpack_dual(inv).tangent is not None
    A = planes[0].clone().requires_grad_()
    (tlin.solve(A, planes[2])[0].sum() + tlin.inverse(A)[0].sum()).backward()
    assert A.grad is not None
    # the CPU counters stay put (they count the card's dispatches) ...
    assert tlin.RULE_CALLS == before
    # ... and every plain call came from a rule: forward, tangent and
    # adjoint solves, the inverse once per Function forward
    assert seen.count("gj_solve") == 2 + 2 and seen.count("gj_inverse") == 2
    assert seen.count("gj_solve_planes") == 2
    seen.clear()
    tlin.solve(planes[0], planes[2])   # no tangent: the dispatch directly
    assert seen == ["gj_solve"]


def test_no_rule_entries_refuse_a_dual_on_the_card_only():
    """The multi entries and K4 have no rule: on the CPU their plain
    versions differentiate natively (nothing is dropped), and the card
    refuses a differentiated input (covered by the CUDA tests)."""
    s = _systems(5)
    A, B = _t(s["Ar"]), _t(s["G"])
    with fwAD.dual_level():
        X = tlin.solve_multi(fwAD.make_dual(A, _t(s["dAr"])), B)[0]
        assert fwAD.unpack_dual(X).tangent is not None
    with pytest.raises(NotImplementedError, match="no derivative rule"):
        tlin._no_rule(A.clone().requires_grad_())
