"""Batched Gauss-Jordan solves: complex on (re, im) planes, and real.

The reference solves each system with scalar Gaussian elimination + partial
pivoting (spicey/lib/math/solveComplex.ts:4-74), throwing on |pivot| < EPS.
Batched code cannot throw, so singularity is a per-system ``valid`` flag
that callers surface at the host boundary.

``gj_solve_planes`` is the plain PyTorch version of kernel K1
(ops/gj.py, csrc/gj_complex.cu) and ``gj_inverse_planes``, the same
elimination of [A | I], that of kernel K4 (the complex inverse, same
files), both written batch-first: a leading batch dimension instead of
``vmap``. They keep the JAX package's semantics
exactly: the pivot of column k is the unused row with the largest |a|²,
ties to the lowest row (``torch.argmax`` returns the first maximum, as
``jnp.argmax`` does); a system is invalid when |pivot|² < EPS²; elimination
continues through an invalid pivot with a unit divisor so shapes and
control flow never depend on the data.

``gj_solve`` and ``gj_inverse`` are the real counterparts (the plain
versions of kernels K2 and K3, ops/gj_real.py, csrc/gj_real.cu), ports
of ``spicey_tpu/ops/linsolve.py:gj_solve`` batch-first: pivot = the
unused row with the largest |a|, ties to the lowest row, invalid when
|pivot| < EPS, a unit divisor on an invalid pivot. ``gj_inverse`` reduces
[A | I] with the same pivot order, so column j of its inverse is
``gj_solve(A, e_j)``, the JAX package's ``inv_of`` (analysis/tran.py).

``gj_solve_multi`` and ``gj_solve_planes_multi`` reduce [A | B] for a
right block B of R columns with the same pivots (the plain versions of
K2's and K1's "multi" entry: the Schur tier's block solves, ops/schur.py);
the inverses are these with B = I.

``solve_planes``, ``inverse_planes``, ``solve``, ``inverse`` and the
multi forms dispatch by the tensor's device: a CUDA tensor always launches the kernel (the
instantiation follows the dtype), a CPU tensor runs the plain version.
The one other branch is a system with no unknowns (N = 0: a deck whose
only node is ground), which every analysis of such a deck reaches: there
is nothing to eliminate, so each system is valid and its answer empty, as
in the JAX package, whose solves take empty arrays; the kernels, which
refuse N = 0, are not called. The JAX package's
f32-kernel-plus-f64-refinement wrapper (``pallas_gj.py:562-640``) has no
counterpart: the card solves f64 natively.

Derivatives. The JAX package differentiates its plain Gauss-Jordan
natively; a kernel launch is opaque to torch's AD (a dual tensor handed to
a ctypes wrapper gives the primal answer and drops the tangent). So
``solve``, ``solve_planes`` and ``inverse`` route an input that carries a
forward-mode tangent or ``requires_grad`` through a
``torch.autograd.Function`` (``_Solve``, ``_SolvePlanes``, ``_Inverse``)
whose forward is the same dispatch and whose JVP and VJP are one more
dispatch with the same matrix (its transpose, or A^H on the planes), so
the card differentiates with the kernel it solves with, and the CPU with
the plain version, never natively through it. The inverse's rules are
products of the inverse itself. Inputs without a tangent take the
dispatch directly. The multi entries, K4 and the Schur tier have no rule
(no analysis differentiates through them) and refuse a differentiated
input on the card.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from ..constants import EPS


def _gj_complex(Ar: torch.Tensor, Ai: torch.Tensor, n: int, eps: float
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Reduce the batch of complex augmented systems (Ar, Ai) (nb, n, w)
    on copies. Returns (reduced Ar, reduced Ai, perm (nb, n), valid (nb,));
    pivot row perm[k] carries row k of the answer in its right block."""
    nb, _, w = Ar.shape
    dtype = Ar.dtype
    dev = Ar.device
    used = torch.zeros((nb, n), dtype=torch.bool, device=dev)
    perm = torch.zeros((nb, n), dtype=torch.int64, device=dev)
    valid = torch.ones((nb,), dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)
    neg_one = torch.tensor(-1.0, dtype=dtype, device=dev)
    zero = torch.tensor(0.0, dtype=dtype, device=dev)
    one = torch.tensor(1.0, dtype=dtype, device=dev)
    eps2 = eps * eps
    for k in range(n):
        cr = Ar[:, :, k]
        ci = Ai[:, :, k]
        mag2 = cr * cr + ci * ci
        score = torch.where(used, neg_one, mag2)
        p = torch.argmax(score, dim=1)                       # (nb,)
        onehot = rows[None, :] == p[:, None]                 # (nb, n)
        pvr = cr.gather(1, p[:, None])[:, 0]
        pvi = ci.gather(1, p[:, None])[:, 0]
        d = pvr * pvr + pvi * pvi
        ok = d >= eps2  # |pivot| >= eps, the reference threshold
        valid = valid & ok
        inv_d = (1.0 / torch.where(ok, d, one))[:, None]
        pidx = p[:, None, None].expand(nb, 1, w)
        prr = Ar.gather(1, pidx)[:, 0, :]                    # (nb, w)
        pri = Ai.gather(1, pidx)[:, 0, :]
        # pivot_row / pivot (complex divide)
        prow_r = (prr * pvr[:, None] + pri * pvi[:, None]) * inv_d
        prow_i = (pri * pvr[:, None] - prr * pvi[:, None]) * inv_d
        fr = torch.where(onehot, zero, cr)[:, :, None]
        fi = torch.where(onehot, zero, ci)[:, :, None]
        Ar = Ar - (fr * prow_r[:, None, :] - fi * prow_i[:, None, :])
        Ai = Ai - (fr * prow_i[:, None, :] + fi * prow_r[:, None, :])
        Ar = torch.where(onehot[:, :, None], prow_r[:, None, :], Ar)
        Ai = torch.where(onehot[:, :, None], prow_i[:, None, :], Ai)
        used = used | onehot
        perm[:, k] = p
    return Ar, Ai, perm, valid


def gj_solve_planes(A_re: torch.Tensor, A_im: torch.Tensor,
                    b_re: torch.Tensor, b_im: torch.Tensor,
                    eps: float = EPS
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Complex Gauss-Jordan with |pivot|² pivoting, batched (plain K1).

    A_*: (..., N, N); b_*: (..., N). Returns (x_re, x_im, valid) shaped
    (..., N), (..., N) and (...). Works on copies; the inputs are unchanged.
    """
    lead = A_re.shape[:-2]
    N = A_re.shape[-1]
    Ar = torch.cat([A_re, b_re[..., None]], dim=-1).reshape(-1, N, N + 1)
    Ai = torch.cat([A_im, b_im[..., None]], dim=-1).reshape(-1, N, N + 1)
    Ar, Ai, perm, valid = _gj_complex(Ar, Ai, N, eps)
    # pivot row perm[k] carries x[k] in its RHS entry
    x_re = Ar[:, :, N].gather(1, perm)
    x_im = Ai[:, :, N].gather(1, perm)
    return (x_re.reshape(lead + (N,)), x_im.reshape(lead + (N,)),
            valid.reshape(lead))


def gj_solve_planes_multi(A_re: torch.Tensor, A_im: torch.Tensor,
                          B_re: torch.Tensor, B_im: torch.Tensor,
                          eps: float = EPS
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-RHS complex Gauss-Jordan on (re, im) planes, A X = B, batched
    (plain K1 multi): the pivots of ``gj_solve_planes`` with an R-column
    right block, so each column is that solve's arithmetic.

    A_*: (..., N, N); B_*: (..., N, R). Returns (X_re, X_im (..., N, R),
    valid (...))."""
    lead = A_re.shape[:-2]
    n, r = A_re.shape[-1], B_re.shape[-1]
    Ar = torch.cat([A_re, B_re], dim=-1).reshape(-1, n, n + r)
    Ai = torch.cat([A_im, B_im], dim=-1).reshape(-1, n, n + r)
    Ar, Ai, perm, valid = _gj_complex(Ar, Ai, n, eps)
    # pivot row perm[k] carries row k of X in its right block
    rows = perm[:, :, None].expand(-1, -1, r)
    return (Ar[:, :, n:].gather(1, rows).reshape(lead + (n, r)),
            Ai[:, :, n:].gather(1, rows).reshape(lead + (n, r)),
            valid.reshape(lead))


def gj_inverse_planes(A_re: torch.Tensor, A_im: torch.Tensor,
                      eps: float = EPS
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The true complex inverse by reducing [A | I] on (re, im) planes,
    batched (plain K4), with the pivot order of ``gj_solve_planes``: column
    j of the inverse is ``gj_solve_planes(A, e_j)``'s elimination.

    A_*: (..., N, N). Returns (M_re, M_im (..., N, N), valid (...))."""
    n = A_re.shape[-1]
    eye = torch.eye(n, dtype=A_re.dtype, device=A_re.device).expand(
        A_re.shape)
    return gj_solve_planes_multi(A_re, A_im, eye, torch.zeros_like(eye),
                                 eps=eps)


def _no_unknowns(A: torch.Tensor) -> torch.Tensor:
    """The ``valid`` flags of a batch of (N = 0) systems: all true."""
    return torch.ones(A.shape[:-2], dtype=torch.bool, device=A.device)


def solve_planes(A_re: torch.Tensor, A_im: torch.Tensor,
                 b_re: torch.Tensor, b_im: torch.Tensor,
                 method: str = "gj", eps: float = EPS,
                 plan: dict | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Complex solve on (re, im) planes. A_*: (..., N, N); b_*: (..., N).

    ``method`` keeps the JAX package's names so calls compare like with
    like: "gj" (its f64 plane GJ) and "pallas" (its kernel tier). Both name
    the same elimination here, and the device picks the implementation:
    K1 on a CUDA tensor, in the tensor's precision; the plain version on
    the CPU. ``plan``: a ``SchurPlan.arrays()``, which routes the solve
    through the structured tier (ops/schur.py) whatever the method, as in
    the JAX package; without one "schur" names the dense elimination. An
    input with a forward-mode tangent or ``requires_grad`` goes through
    the derivative rules (``_SolvePlanes``) on the same dispatch."""
    _check_method(method)
    if A_re.shape[-1] == 0:
        return b_re.clone(), b_im.clone(), _no_unknowns(A_re)
    if plan is not None:
        from .schur import schur_solve_planes

        return schur_solve_planes(A_re, A_im, b_re, b_im, plan["blk_ix"],
                                  plan["blk_mask"], plan["if_ix"], eps)
    if _differentiated(A_re, A_im, b_re, b_im):
        return _SolvePlanes.apply(A_re, A_im, b_re, b_im, eps)
    return _solve_planes_dense(A_re, A_im, b_re, b_im, eps)


def _solve_planes_dense(A_re: torch.Tensor, A_im: torch.Tensor,
                        b_re: torch.Tensor, b_im: torch.Tensor, eps: float
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 on a CUDA tensor, the plain ``gj_solve_planes`` on the CPU."""
    if A_re.is_cuda:
        from .gj import gj_solve_planes_cuda

        lead = A_re.shape[:-2]
        n = A_re.shape[-1]
        xr, xi, valid = gj_solve_planes_cuda(
            A_re.reshape(-1, n, n).contiguous(),
            A_im.reshape(-1, n, n).contiguous(),
            b_re.reshape(-1, n).contiguous(),
            b_im.reshape(-1, n).contiguous(), eps=eps)
        return (xr.reshape(lead + (n,)), xi.reshape(lead + (n,)),
                valid.reshape(lead))
    return gj_solve_planes(A_re, A_im, b_re, b_im, eps=eps)


def solve_planes_multi(A_re: torch.Tensor, A_im: torch.Tensor,
                       B_re: torch.Tensor, B_im: torch.Tensor,
                       eps: float = EPS
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Complex A X = B on (re, im) planes for R right-hand sides: K1's
    multi entry on a CUDA tensor, the plain ``gj_solve_planes_multi`` on
    the CPU. A_*: (..., N, N); B_*: (..., N, R)."""
    if A_re.shape[-1] == 0:
        return B_re.clone(), B_im.clone(), _no_unknowns(A_re)
    if A_re.is_cuda:
        _no_rule(A_re, A_im, B_re, B_im)
        from .gj import gj_solve_planes_multi_cuda

        lead = A_re.shape[:-2]
        n, r = A_re.shape[-1], B_re.shape[-1]
        xr, xi, valid = gj_solve_planes_multi_cuda(
            A_re.reshape(-1, n, n).contiguous(),
            A_im.reshape(-1, n, n).contiguous(),
            B_re.reshape(-1, n, r).contiguous(),
            B_im.reshape(-1, n, r).contiguous(), eps=eps)
        return (xr.reshape(lead + (n, r)), xi.reshape(lead + (n, r)),
                valid.reshape(lead))
    return gj_solve_planes_multi(A_re, A_im, B_re, B_im, eps=eps)


def inverse_planes(A_re: torch.Tensor, A_im: torch.Tensor,
                   eps: float = EPS
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The true complex inverse of a batch on (re, im) planes: K4 on a
    CUDA tensor, in the tensor's precision; the plain
    ``gj_inverse_planes`` on the CPU. A_*: (..., N, N)."""
    if A_re.shape[-1] == 0:
        return A_re.clone(), A_im.clone(), _no_unknowns(A_re)
    if A_re.is_cuda:
        _no_rule(A_re, A_im)
        from .gj import gj_inverse_planes_cuda

        lead = A_re.shape[:-2]
        n = A_re.shape[-1]
        mr, mi, valid = gj_inverse_planes_cuda(
            A_re.reshape(-1, n, n).contiguous(),
            A_im.reshape(-1, n, n).contiguous(), eps=eps)
        return (mr.reshape(lead + (n, n)), mi.reshape(lead + (n, n)),
                valid.reshape(lead))
    return gj_inverse_planes(A_re, A_im, eps=eps)


def _gj_real(Ab: torch.Tensor, n: int, eps: float
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reduce the batch of real augmented systems Ab (nb, n, w) in place of
    a copy. Returns (reduced Ab, perm (nb, n), valid (nb,)); pivot row
    perm[k] carries row k of the answer in its right block."""
    nb, _, w = Ab.shape
    dev, dtype = Ab.device, Ab.dtype
    used = torch.zeros((nb, n), dtype=torch.bool, device=dev)
    perm = torch.zeros((nb, n), dtype=torch.int64, device=dev)
    valid = torch.ones((nb,), dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)
    neg_one = torch.tensor(-1.0, dtype=dtype, device=dev)
    zero = torch.tensor(0.0, dtype=dtype, device=dev)
    one = torch.tensor(1.0, dtype=dtype, device=dev)
    for k in range(n):
        col = Ab[:, :, k]
        score = torch.where(used, neg_one, col.abs())
        p = torch.argmax(score, dim=1)                       # (nb,)
        onehot = rows[None, :] == p[:, None]                 # (nb, n)
        pv = col.gather(1, p[:, None])[:, 0]
        ok = pv.abs() >= eps  # the reference threshold
        valid = valid & ok
        safe = torch.where(ok, pv, one)[:, None]
        prow = Ab.gather(1, p[:, None, None].expand(nb, 1, w))[:, 0, :]
        prow = prow / safe                                    # (nb, w)
        factor = torch.where(onehot, zero, col)[:, :, None]
        Ab = Ab - factor * prow[:, None, :]
        Ab = torch.where(onehot[:, :, None], prow[:, None, :], Ab)
        used = used | onehot
        perm[:, k] = p
    return Ab, perm, valid


def gj_solve(A: torch.Tensor, b: torch.Tensor, eps: float = EPS
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Real Gauss-Jordan with |pivot| pivoting, batched (plain K2).

    A: (..., N, N); b: (..., N). Returns (x, valid) shaped (..., N) and
    (...). Works on copies; the inputs are unchanged."""
    lead = A.shape[:-2]
    n = A.shape[-1]
    Ab = torch.cat([A, b[..., None]], dim=-1).reshape(-1, n, n + 1)
    Ab, perm, valid = _gj_real(Ab, n, eps)
    x = Ab[:, :, n].gather(1, perm)
    return x.reshape(lead + (n,)), valid.reshape(lead)


def gj_solve_multi(A: torch.Tensor, B: torch.Tensor, eps: float = EPS
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-RHS real Gauss-Jordan, A X = B, batched (plain K2 multi): the
    pivots of ``gj_solve`` with an R-column right block.

    A: (..., N, N); B: (..., N, R). Returns (X (..., N, R), valid (...))."""
    lead = A.shape[:-2]
    n, r = A.shape[-1], B.shape[-1]
    Ab = torch.cat([A, B], dim=-1).reshape(-1, n, n + r)
    Ab, perm, valid = _gj_real(Ab, n, eps)
    X = Ab[:, :, n:].gather(1, perm[:, :, None].expand(-1, -1, r))
    return X.reshape(lead + (n, r)), valid.reshape(lead)


def gj_inverse(A: torch.Tensor, eps: float = EPS
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The true inverse by reducing [A | I], batched (plain K3).

    A: (..., N, N). Returns (Ainv (..., N, N), valid (...))."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    return gj_solve_multi(A, eye, eps=eps)


def _check_method(method: str) -> None:
    if method not in ("gj", "pallas", "schur"):
        raise ValueError(f"unknown solve method {method!r} "
                         "(this package has 'gj', 'pallas' and 'schur')")


def solve(A: torch.Tensor, b: torch.Tensor, method: str = "gj",
          eps: float = EPS, plan: dict | None = None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Real solve with method dispatch. A: (..., N, N); b: (..., N).

    "gj" and "pallas" keep the JAX package's names and name the same
    elimination here: K2 on a CUDA tensor, in the tensor's precision; the
    plain ``gj_solve`` on the CPU. ``plan``: a ``SchurPlan.arrays()``, the
    structured tier (ops/schur.py), as in ``solve_planes``. An input with a
    forward-mode tangent or ``requires_grad`` goes through the derivative
    rules (``_Solve``) on the same dispatch."""
    _check_method(method)
    if A.shape[-1] == 0:
        return b.clone(), _no_unknowns(A)
    if plan is not None:
        from .schur import schur_solve

        return schur_solve(A, b, plan["blk_ix"], plan["blk_mask"],
                           plan["if_ix"], eps)
    if _differentiated(A, b):
        return _Solve.apply(A, b, eps)
    return _solve_dense(A, b, eps)


def _solve_dense(A: torch.Tensor, b: torch.Tensor, eps: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 on a CUDA tensor, the plain ``gj_solve`` on the CPU."""
    if A.is_cuda:
        from .gj_real import gj_solve_cuda

        lead = A.shape[:-2]
        n = A.shape[-1]
        x, valid = gj_solve_cuda(A.reshape(-1, n, n).contiguous(),
                                 b.reshape(-1, n).contiguous(), eps=eps)
        return x.reshape(lead + (n,)), valid.reshape(lead)
    return gj_solve(A, b, eps=eps)


def solve_multi(A: torch.Tensor, B: torch.Tensor, eps: float = EPS
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Real A X = B for R right-hand sides: K2's multi entry on a CUDA
    tensor, the plain ``gj_solve_multi`` on the CPU. A: (..., N, N);
    B: (..., N, R)."""
    if A.shape[-1] == 0:
        return B.clone(), _no_unknowns(A)
    if A.is_cuda:
        _no_rule(A, B)
        from .gj_real import gj_solve_multi_cuda

        lead = A.shape[:-2]
        n, r = A.shape[-1], B.shape[-1]
        x, valid = gj_solve_multi_cuda(A.reshape(-1, n, n).contiguous(),
                                       B.reshape(-1, n, r).contiguous(),
                                       eps=eps)
        return x.reshape(lead + (n, r)), valid.reshape(lead)
    return gj_solve_multi(A, B, eps=eps)


def inverse(A: torch.Tensor, eps: float = EPS
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The true inverse of a batch: K3 on a CUDA tensor, the plain
    ``gj_inverse`` on the CPU. A: (..., N, N). An input with a
    forward-mode tangent or ``requires_grad`` goes through the derivative
    rules (``_Inverse``) on the same dispatch."""
    if A.shape[-1] == 0:
        return A.clone(), _no_unknowns(A)
    if _differentiated(A):
        return _Inverse.apply(A, eps)
    return _inverse_dense(A, eps)


def _inverse_dense(A: torch.Tensor, eps: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 on a CUDA tensor, the plain ``gj_inverse`` on the CPU."""
    if A.is_cuda:
        from .gj_real import gj_inverse_cuda

        lead = A.shape[:-2]
        n = A.shape[-1]
        inv, valid = gj_inverse_cuda(A.reshape(-1, n, n).contiguous(),
                                     eps=eps)
        return inv.reshape(lead + (n, n)), valid.reshape(lead)
    return gj_inverse(A, eps=eps)


# ---- derivative rules --------------------------------------------------
# Rule dispatches that reached a CUDA tensor, by kernel and role: each
# "tangent" or "adjoint" solve of K1 / K2 is one more launch of that kernel
# (its wrapper counts the launch); K3's rules are products of the
# kernel's own inverse and launch nothing. "forward" counts the primal
# dispatches made through the rules.
RULE_CALLS = {(k, role): 0 for k in ("K1", "K2", "K3")
              for role in ("forward", "tangent", "adjoint")}


def _tangent(t: torch.Tensor) -> torch.Tensor | None:
    return fwAD.unpack_dual(t).tangent


def _differentiated(*ts: torch.Tensor) -> bool:
    """Whether any input carries a forward-mode tangent, or takes part in
    a recorded reverse-mode graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return True
    return any(_tangent(t) is not None for t in ts)


def _no_rule(*ts: torch.Tensor) -> None:
    """The multi entries and K4 have no derivative rule: refuse a
    differentiated input on the card rather than drop its tangent in the
    launch (the plain versions on the CPU differentiate natively)."""
    if _differentiated(*ts):
        raise NotImplementedError(
            "no derivative rule for this solve on a CUDA tensor (the "
            "rules cover solve, solve_planes and inverse)")


def _count(kernel: str, role: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        RULE_CALLS[(kernel, role)] += 1


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.matmul(M, v[..., None])[..., 0]


def _outer(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return u[..., :, None] * v[..., None, :]


def _or_zeros(t: torch.Tensor | None, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(like) if t is None else t


class _Solve(torch.autograd.Function):
    """x = A^-1 b through ``_solve_dense`` (K2 on the card), with
    JVP dx = A^-1 (db - dA x) and VJP g_b = A^-T g, g_A = -g_b x^T: each
    rule one more dispatch on the same A (or its transpose)."""

    @staticmethod
    def forward(A, b, eps):
        _count("K2", "forward", A)
        return _solve_dense(A, b, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, _b, eps = inputs
        x, valid = output
        ctx.mark_non_differentiable(valid)
        ctx.save_for_backward(A, x)
        ctx.save_for_forward(A, x)
        ctx.eps = eps

    @staticmethod
    def jvp(ctx, dA, db, _deps):
        A, x = ctx.saved_tensors
        rhs = _or_zeros(db, x)
        if dA is not None:
            rhs = rhs - _mv(dA, x)
        _count("K2", "tangent", A)
        return _solve_dense(A, rhs, ctx.eps)[0], None

    @staticmethod
    def backward(ctx, gx, _gvalid):
        A, x = ctx.saved_tensors
        _count("K2", "adjoint", A)
        gb = _solve_dense(A.transpose(-1, -2), gx, ctx.eps)[0]
        return -_outer(gb, x), gb, None


class _SolvePlanes(torch.autograd.Function):
    """The complex solve on (re, im) planes through ``_solve_planes_dense``
    (K1 on the card). JVP: dx = A^-1 (db - dA x) in complex arithmetic on
    the planes, one more solve with A. VJP: one solve with A^H (planes
    A_re^T, -A_im^T), (g_r, g_i) its answer: g_b = (g_r, g_i), g_Are =
    -(g_r x_r^T + g_i x_i^T), g_Aim = g_r x_i^T - g_i x_r^T."""

    @staticmethod
    def forward(A_re, A_im, b_re, b_im, eps):
        _count("K1", "forward", A_re)
        return _solve_planes_dense(A_re, A_im, b_re, b_im, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        A_re, A_im, _br, _bi, eps = inputs
        x_re, x_im, valid = output
        ctx.mark_non_differentiable(valid)
        ctx.save_for_backward(A_re, A_im, x_re, x_im)
        ctx.save_for_forward(A_re, A_im, x_re, x_im)
        ctx.eps = eps

    @staticmethod
    def jvp(ctx, dAr, dAi, dbr, dbi, _deps):
        A_re, A_im, x_re, x_im = ctx.saved_tensors
        rr, ri = _or_zeros(dbr, x_re), _or_zeros(dbi, x_im)
        if dAr is not None:
            rr = rr - _mv(dAr, x_re)
            ri = ri - _mv(dAr, x_im)
        if dAi is not None:
            rr = rr + _mv(dAi, x_im)
            ri = ri - _mv(dAi, x_re)
        _count("K1", "tangent", A_re)
        dxr, dxi, _ = _solve_planes_dense(A_re, A_im, rr, ri, ctx.eps)
        return dxr, dxi, None

    @staticmethod
    def backward(ctx, g_re, g_im, _gvalid):
        A_re, A_im, x_re, x_im = ctx.saved_tensors
        _count("K1", "adjoint", A_re)
        gr, gi, _ = _solve_planes_dense(
            A_re.transpose(-1, -2).contiguous(),
            (-A_im.transpose(-1, -2)).contiguous(), g_re, g_im, ctx.eps)
        g_Are = -(_outer(gr, x_re) + _outer(gi, x_im))
        g_Aim = _outer(gr, x_im) - _outer(gi, x_re)
        return g_Are, g_Aim, gr, gi, None


class _Inverse(torch.autograd.Function):
    """A^-1 through ``_inverse_dense`` (K3 on the card); JVP -A^-1 dA A^-1
    and VJP -A^-T G A^-T, products of the kernel's own inverse."""

    @staticmethod
    def forward(A, eps):
        _count("K3", "forward", A)
        return _inverse_dense(A, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        inv, valid = output
        ctx.mark_non_differentiable(valid)
        ctx.save_for_backward(inv)
        ctx.save_for_forward(inv)

    @staticmethod
    def jvp(ctx, dA, _deps):
        (inv,) = ctx.saved_tensors
        _count("K3", "tangent", inv)
        return -torch.matmul(inv, torch.matmul(dA, inv)), None

    @staticmethod
    def backward(ctx, g, _gvalid):
        (inv,) = ctx.saved_tensors
        _count("K3", "adjoint", inv)
        inv_t = inv.transpose(-1, -2)
        return -torch.matmul(inv_t, torch.matmul(g, inv_t)), None
