"""K10a and K10b: the panel-blocked Gauss-Jordan solve for mid-size systems.

K10a replaces ``spicey_tpu/ops/pallas_mxu.py:_mxu_gj_real_kernel``
(pallas_call in ``mxu_solve_real``) and K10b ``_mxu_gj_complex_kernel``
(pallas_call in ``mxu_solve_complex``), the JAX package's batch-major
"MXU" tier for N in [40, 128]. The same one-hot-pivot Jordan elimination
as K1/K2 runs in panel form: for each panel of P columns, P pivot steps
update only the panel's columns while they accumulate the composite
transform I + C S (C: N x P, S: the P pivot-row selectors); then one
matrix product updates every column right of the panel,

    M[:, trailing] += C @ M[pivot rows of the panel, trailing],

which is where ~(1 - P/N) of the elimination's operations run. The
kernel is ``csrc/mxu_gj.cu`` (f32 and f64): the panel tier's kernel of
K1/K2 (``csrc/gj_panel.cuh``: persistent blocks, the planes where the
most blocks are resident and a workspace of one slot per resident block,
one barrier per pivot step, the product on the tensor cores in f64) run
with K10's own step. The plain versions here, ``mxu_solve_real_plain``
and ``mxu_solve_complex_plain``, repeat its arithmetic in torch.

The contract is the Pallas kernels' (``pallas_mxu.py:134-212``): the
pivot of column k is the unused row with the largest |a| (complex: |a|^2),
ties to the lowest row; it is accepted when |a| >= eps (|a|^2 >= eps^2);
a rejected pivot continues with a unit divisor and flags the system; x[k]
is the final right-hand side of the row that pivoted column k. One step
is the elementary matrix E = I + u e_p^T with u_i = -a_ik / pv off the
pivot and u_p = 1/pv - 1, as on the TPU. The TPU kernel pads N to a
multiple of P with identity columns; those pad steps are exact no-ops
(no real row has a nonzero entry there, and pad rows never win a real
column's pivot), so here the last panel is ragged instead. A NaN column
differs: the TPU kernel picks no row there (pv = 0) while this port ranks
NaN highest (``gj_common.cuh:better``, ``torch.argmax``); both flag the
system invalid, so compare x on valid systems only.

Nothing in ``analysis/`` routes here, as nothing in the JAX package
routes to its tier (``pallas_mxu.py:49-69`` measured it slower than the
batch-last kernel on the TPU). ``tools/profile_torch_solver.py`` times it
against K1/K2 and ``torch.linalg.solve``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..constants import EPS
from ._build import Kernel, check, load, ptr, stream_ptr, workspace

# below 40 the one-system-per-block elimination (K1/K2) has no trailing
# work worth a product; the TPU tier's rows filled its 128 lanes
MXU_MIN_N = 40
MXU_MAX_N = 128

_SRC = "spicey_tpu_torch/csrc/mxu_gj.cu"
# one launch counter per instantiation
K10a = {dt: Kernel(name=f"mxu_gj_real_{tag}", source=_SRC,
                   replaces="spicey_tpu/ops/pallas_mxu.py:416")
        for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64"))}
K10b = {dt: Kernel(name=f"mxu_gj_complex_{tag}", source=_SRC,
                   replaces="spicey_tpu/ops/pallas_mxu.py:387")
        for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64"))}

_LANE = 128

# gj_panel.cuh's places of the planes: all in shared memory, or the planes
# in the block's workspace slot ([panel | C] and G stay on chip)
ALL_SMEM, PLANES_GLOBAL = 0, 1
# gj_panel.cuh:G_LD, the row stride of the staged pivot rows G
_G_LD = 68


def _roundup(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=None)
def blocked_plan(n: int) -> tuple[int, int, int, tuple[int, ...]]:
    """(P, Np, S, widths): panel width, padded N, sublane extent, and the
    per-panel trailing-window widths (cols (k+1)P .. Np inclusive of the
    RHS column at sublane Np, rounded up to the 8-sublane granule).

    A copy of ``spicey_tpu/ops/pallas_mxu.py:blocked_plan``, so both tiers
    cut the same panels; its cost model is the TPU's. The kernel here uses
    P only: Np, S and the 8-sublane rounding of ``widths`` are TPU layout."""
    if not MXU_MIN_N <= n <= MXU_MAX_N:
        raise ValueError(f"MXU tier supports N in [{MXU_MIN_N}, {MXU_MAX_N}], got {n}")
    # P=32 balances the VPU panel cost (linear in P) against the MXU K=P
    # rate; for small/awkward N a 16-panel wastes fewer identity-pad steps
    best = None
    for p in (32, 16):
        np_ = _roundup(n, p)
        widths = tuple(
            _roundup(np_ - (k + 1) * p + 1, 8) for k in range(np_ // p)
        )
        s = max(np_ + 1, max((k + 1) * p + w for k, w in enumerate(widths)))
        s = _roundup(s, 8)
        # cost model: VPU panel slots ~ 4*P*128*Np; MXU padded flops at
        # the measured K-rate (4.1 TF @K=32, 2.2 TF @K=16, VPU 1.17 TF)
        mxu_rate = 4.1e3 if p == 32 else 2.2e3  # GFLOP/s
        vpu = 4.0 * p * _LANE * np_ / 1.17e3
        mxu = sum(4.0 * w * _LANE * p for w in widths) / mxu_rate
        cost = vpu + mxu
        if best is None or cost < best[0]:
            best = (cost, p, np_, s, widths)
    _, p, np_, s, widths = best
    return p, np_, s, widths


def smem_bytes(n: int, planes: int, itemsize: int, place: int) -> int:
    """Shared-memory bytes of one K10 block for (n, n) systems at ``place``
    (``ALL_SMEM`` or ``PLANES_GLOBAL``), a copy of
    ``gj_panel.cuh:smem_bytes`` for K10's step (``mxu_gj.cu:
    ElementaryStep``): per plane the planes (``ALL_SMEM``), [panel | C]
    (n x (P + 1) with an odd row stride) and G (P x 68), each rounded to 4
    elements; then the ints. ``mxu_gj_smem_bytes`` is the kernel's own."""
    p_ = blocked_plan(n)[0]

    def al4(x: int) -> int:
        return -(-x // 4) * 4

    ld = (p_ + 1) | 1
    elems = al4(n * ld) + al4(p_ * _G_LD)
    if place == ALL_SMEM:
        elems += al4(n * (n + 1))
    return planes * elems * itemsize + (4 + 2 * n + 1) * 4


def workspace_systems(place: int, grid: int) -> int:
    """Systems of (planes, n, n + 1) in K10's workspace for a grid of
    ``grid`` persistent blocks (at most the resident slots, whatever the
    batch): one slot per block where the planes live in global memory
    (``gj_panel.cuh:workspace_units``)."""
    return 0 if place == ALL_SMEM else grid


# ---- plain versions --------------------------------------------------------

def _mxu_eliminate(planes: list[torch.Tensor], n: int, eps: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reduce the augmented planes (nb, n, n + 1) in place, one (real) or
    two (re, im) of them, in panels of blocked_plan(n)'s P. Returns (perm
    (nb, n), valid (nb,)): pivot row perm[k] carries x[k] in column n."""
    cplx = len(planes) == 2
    T0 = planes[0]
    nb, _, w = T0.shape
    dev, dtype = T0.device, T0.dtype
    p_ = blocked_plan(n)[0]
    used = torch.zeros((nb, n), dtype=torch.bool, device=dev)
    perm = torch.zeros((nb, n), dtype=torch.int64, device=dev)
    valid = torch.ones((nb,), dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)
    neg_one = torch.tensor(-1.0, dtype=dtype, device=dev)
    one = torch.tensor(1.0, dtype=dtype, device=dev)
    thr = eps * eps if cplx else eps
    for k0 in range(0, n, p_):
        pw = min(p_, n - k0)
        panel = [T[:, :, k0:k0 + pw] for T in planes]     # views
        C = [torch.zeros((nb, n, pw), dtype=dtype, device=dev)
             for _ in planes]
        for j in range(pw):
            cols = [t[:, :, j].clone() for t in panel]      # (nb, n)
            if cplx:
                cr, ci = cols
                score = torch.where(used, neg_one, cr * cr + ci * ci)
            else:
                score = torch.where(used, neg_one, cols[0].abs())
            p = torch.argmax(score, dim=1)
            onehot = rows[None, :] == p[:, None]
            pv = [c.gather(1, p[:, None]) for c in cols]    # (nb, 1)
            if cplx:
                pvr, pvi = pv
                d = pvr * pvr + pvi * pvi
                ok = d >= thr
                ipd = 1.0 / torch.where(ok, d, one)
                # u = -col/pv off the pivot, 1/pv - 1 at it (complex)
                u = [torch.where(onehot, pvr * ipd - 1.0,
                                 -(cr * pvr + ci * pvi) * ipd),
                     torch.where(onehot, -pvi * ipd,
                                 -(ci * pvr - cr * pvi) * ipd)]
            else:
                ok = pv[0].abs() >= thr
                ipv = 1.0 / torch.where(ok, pv[0], one)
                u = [torch.where(onehot, ipv - 1.0, -cols[0] * ipv)]
            valid = valid & ok[:, 0]
            pidx = p[:, None, None].expand(nb, 1, pw)
            # the panel and C take the outer product u (x) (pivot row)
            for blocks in (panel, C):
                prow = [t.gather(1, pidx) for t in blocks]  # (nb, 1, pw)
                if cplx:
                    ur, ui = (x[:, :, None] for x in u)
                    pr, pi = prow
                    new_r = blocks[0] + pr * ur - pi * ui
                    new_i = blocks[1] + pr * ui + pi * ur
                    blocks[0].copy_(new_r)
                    blocks[1].copy_(new_i)
                else:
                    blocks[0].copy_(blocks[0] + prow[0] * u[0][:, :, None])
            for c, uc in zip(C, u):
                c[:, :, j] += uc
            used = used | onehot
            perm[:, k0 + j] = p
        c0 = k0 + pw  # < w: the right-hand side is always trailing
        # trailing update: M[:, c0:] += C @ (the panel's pivot rows)
        sel = perm[:, k0:c0, None].expand(nb, pw, w - c0)
        G = [T[:, :, c0:].gather(1, sel) for T in planes]   # (nb, pw, wt)
        # (in place: G holds copies of the pivot rows, and the
        # (nb, n, n + 1 - c0) products never exist beside the planes)
        if cplx:
            tr, ti = (T[:, :, c0:] for T in planes)
            tr.baddbmm_(C[0], G[0]).baddbmm_(C[1], G[1], alpha=-1.0)
            ti.baddbmm_(C[0], G[1]).baddbmm_(C[1], G[0])
        else:
            planes[0][:, :, c0:].baddbmm_(C[0], G[0])
    return perm, valid


def mxu_solve_real_plain(A: torch.Tensor, b: torch.Tensor, eps: float = EPS
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain K10a: A (B, N, N), b (B, N), N in [40, 128]. Returns (x (B, N),
    valid (B,)). Works on a copy; the inputs are unchanged."""
    n = A.shape[-1]
    T = torch.cat([A, b[..., None]], dim=-1)
    perm, valid = _mxu_eliminate([T], n, eps)
    return T[:, :, n].gather(1, perm), valid


def mxu_solve_complex_plain(Ar: torch.Tensor, Ai: torch.Tensor,
                            br: torch.Tensor, bi: torch.Tensor,
                            eps: float = EPS
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain K10b: (Ar + j Ai) x = (br + j bi) on (B, N, N) and (B, N)
    planes, N in [40, 128]. Returns (xr, xi (B, N), valid (B,))."""
    n = Ar.shape[-1]
    planes = [torch.cat([Ar, br[..., None]], dim=-1),
              torch.cat([Ai, bi[..., None]], dim=-1)]
    perm, valid = _mxu_eliminate(planes, n, eps)
    return (planes[0][:, :, n].gather(1, perm),
            planes[1][:, :, n].gather(1, perm), valid)


# ---- the kernel ------------------------------------------------------------

_REAL_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
    ctypes.c_double, ctypes.c_void_p]
_CPLX_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
    ctypes.c_double, ctypes.c_void_p]
_SIGNATURES = {
    "mxu_gj_smem_bytes": ([ctypes.c_int] * 5, ctypes.c_longlong),
    "mxu_gj_workspace_systems": ([ctypes.c_int] * 5, ctypes.c_int),
    "mxu_gj_real_f32": (_REAL_ARGS, ctypes.c_int),
    "mxu_gj_real_f64": (_REAL_ARGS, ctypes.c_int),
    "mxu_gj_complex_f32": (_CPLX_ARGS, ctypes.c_int),
    "mxu_gj_complex_f64": (_CPLX_ARGS, ctypes.c_int),
}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load this kernel's library."""
    return load("mxu_gj", _SIGNATURES)


def _check(ts: tuple, what: str) -> tuple[int, int]:
    A = ts[0]
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"{what}: A must be (B, N, N), got {tuple(A.shape)}")
    nb, n = A.shape[0], A.shape[1]
    blocked_plan(n)  # raises outside [MXU_MIN_N, MXU_MAX_N]
    if nb >= 2**31:
        raise ValueError(f"{what} takes fewer than 2^31 systems, got {nb}")
    planes = len(ts) // 2
    if any(t.shape != A.shape for t in ts[:planes]) \
            or any(t.shape != (nb, n) for t in ts[planes:]):
        raise ValueError(f"{what}: A planes must be (B, N, N) and b planes "
                         f"(B, N), got {[tuple(t.shape) for t in ts]}")
    if A.dtype not in (torch.float32, torch.float64) \
            or any(t.dtype != A.dtype for t in ts):
        raise TypeError(f"{what} takes float32 or float64 tensors of one "
                        "dtype")
    if any(not t.is_cuda or t.device != A.device for t in ts):
        raise ValueError(f"{what} takes CUDA tensors on one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError(f"{what} takes contiguous tensors")
    return nb, n


def _launch(ts: tuple, eps: float, what: str) -> tuple[torch.Tensor, ...]:
    """Launch K10a (one A plane) or K10b (two) on checked CUDA tensors."""
    nb, n = _check(ts, what)
    planes = len(ts) // 2
    A = ts[0]
    dbl = A.dtype == torch.float64
    lib = load_library()
    p_ = blocked_plan(n)[0]
    xs = [torch.empty((nb, n), dtype=A.dtype, device=A.device)
          for _ in range(planes)]
    valid = torch.empty((nb,), dtype=torch.bool, device=A.device)
    with torch.cuda.device(A.device):
        ws = None
        n_ws = lib.mxu_gj_workspace_systems(n, nb, planes, int(dbl), p_)
        if n_ws:
            # the plan keeps the planes in global memory: one slot per
            # resident block, whatever the batch
            ws = workspace((n_ws, planes, n, n + 1), A, what)
        kind = "real" if planes == 1 else "complex"
        fn = getattr(lib, f"mxu_gj_{kind}_{'f64' if dbl else 'f32'}")
        code = fn(*[ptr(t) for t in ts], *[ptr(x) for x in xs], ptr(valid),
                  ctypes.c_void_p(0 if ws is None else ws.data_ptr()), nb, n,
                  p_, float(eps), stream_ptr(A.device))
        check(code, f"{what} launch")
    (K10a if planes == 1 else K10b)[A.dtype].launches += 1
    return (*xs, valid)


def mxu_solve_real_cuda(A: torch.Tensor, b: torch.Tensor, eps: float = EPS
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K10a: A (B, N, N), b (B, N), CUDA, contiguous, one float
    dtype, N in [40, 128]. Returns (x (B, N), valid (B,))."""
    return _launch((A, b), eps, "K10a")


def mxu_solve_complex_cuda(Ar: torch.Tensor, Ai: torch.Tensor,
                           br: torch.Tensor, bi: torch.Tensor,
                           eps: float = EPS
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Launch K10b on (re, im) planes: A_* (B, N, N), b_* (B, N), CUDA,
    contiguous, one float dtype. Returns (xr, xi (B, N), valid (B,))."""
    return _launch((Ar, Ai, br, bi), eps, "K10b")


def mxu_solve_real(A: torch.Tensor, b: torch.Tensor, eps: float = EPS
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve A[i] x = b[i] for N in [40, 128], batch-major panel tier.
    A: (B, N, N), b: (B, N), float32 or float64. K10a on a CUDA tensor,
    the plain version on the CPU. Returns (x (B, N), valid (B,) bool)."""
    if A.is_cuda:
        return mxu_solve_real_cuda(A, b, eps)
    return mxu_solve_real_plain(A, b, eps)


def mxu_solve_complex(Ar: torch.Tensor, Ai: torch.Tensor, br: torch.Tensor,
                      bi: torch.Tensor, eps: float = EPS
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve (Ar + j Ai) x = (br + j bi) for N in [40, 128], batch-major
    panel tier. Ar/Ai: (B, N, N), br/bi: (B, N). K10b on a CUDA tensor, the
    plain version on the CPU. Returns (xr, xi (B, N), valid (B,) bool)."""
    if Ar.is_cuda:
        return mxu_solve_complex_cuda(Ar, Ai, br, bi, eps)
    return mxu_solve_complex_plain(Ar, Ai, br, bi, eps)
