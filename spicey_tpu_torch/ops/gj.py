"""K1 and K4: the batched complex Gauss-Jordan kernels (csrc/gj_complex.cu).

K1 replaces ``spicey_tpu/ops/pallas_gj.py:_gj_complex_kernel`` (the
solve) and K4 ``_gj_inv_complex_kernel`` (the inverse of [A | I], which
``.noise`` applies to its forward and adjoint right-hand sides). The TPU
kernels run in f32 only (their f64 tier is f32 eliminations plus
refinement outside the kernel); Hopper has native f64, so both are
instantiated in float and double and the f64 instance is the fidelity
tier itself. K4 writes the true inverse, not the TPU kernel's
row-permuted one. Their plain PyTorch versions are
``ops/linsolve.gj_solve_planes`` and ``ops/linsolve.gj_inverse_planes``.

K1 and K4 run in three tiers, chosen by ``tier_for`` from N and the dtype
(``csrc/gj_complex.cu`` says what bounds each): "warp" (N <= 32, one warp
per system, ``gj_common.cuh:warp_gj``, on [A | b] or [A | I]), "block"
(one block per system, ``block_gj``, chosen at no N: only forced, for
the comparisons) and "panel" (N >= 33, ``csrc/gj_panel.cuh``: pivot steps
on a panel of PW = 16 columns, then one product per panel over the
trailing columns, the right-hand side or the identity block included, on
the tensor cores in f64). ``K1_TIERS`` and ``K4_TIERS`` count each tier's
launches beside ``K1``'s and ``K4``'s totals.

K1's multi entry (``gj_solve_planes_multi_cuda``) solves [A | B] for a
right block B of R columns, the Schur tier's block solves (ops/schur.py):
``gj_common.cuh:multi_solve_kernel`` up to N = 32 (one warp per system,
A factored once by ``warp_gj``, each lane streaming its columns of B
through the recorded steps), the panel tier at R columns from 33
(``MULTI_TIERS``, chosen by ``gj_real.multi_tier_for``). Its launches
count in ``K1``, in ``K1_TIERS`` ("multi" or "panel") and in its own
``K1_MULTI``; its plain version is ``linsolve.gj_solve_planes_multi``.

N has no upper limit: where a system's planes overflow the 227 KB of
shared memory a block may hold, the kernel eliminates in a global
workspace. The block tier's solve does so from N = 119 in f64 and 169 in
f32 (B N (N + 1) elements per plane), its inverse above N = 84 in f64 and
119 in f32 (2 B N^2). The panel tier keeps one slot per resident block,
holding the planes where its plan says and, past N = 401 in f64 and 822
in f32 (the solve), its n x 33 [panel | C] as well. So a flat deck past
N = 128 solves dense, as the JAX package solves a deck that has no
subcircuit structure there.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import EPS
from ._build import Kernel, check, load, ptr, stream_ptr, workspace

# one launch counter per instantiation
K1 = {dt: Kernel(name=f"gj_complex_{tag}",
                 source="spicey_tpu_torch/csrc/gj_complex.cu",
                 replaces="spicey_tpu/ops/pallas_gj.py:651")
      for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64"))}
K4 = {dt: Kernel(name=f"gj_inv_complex_{tag}",
                 source="spicey_tpu_torch/csrc/gj_complex.cu",
                 replaces="spicey_tpu/ops/pallas_gj.py:514")
      for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64"))}


TIERS = ("warp", "block", "panel")  # the C side's tier codes, in order
WARP_MAX_N = 32                     # gj_common.cuh:WARP_MAX_N
# The crossovers: the warp tier up to K1_WARP_MAX, the panel tier from
# K1_PANEL_MIN, the block tier between (empty where the two meet); the
# same in f32 and f64. Measured by ``tools/profile_torch_solver.py
# --tiers`` (every tier forced on the sweep's ladder planes, N = 8-32 and
# 33-128) on an NVIDIA H100 80GB HBM3 at 700.00 W: the warp tier beat the block tier at every
# N <= 32 (N = 32: 1.86 / 3.55 ms against 14.5 / 16.5 ms, f32 / f64); the
# panel tier beat it at every N >= 33 (N = 33: 13.6 / 14.5 ms against
# 16.0 / 17.9 ms; N = 128: 63.6 / 102.9 ms against 538 / 1462 ms). Past
# N = 401 (f64) / 822 (f32), where the panel tier keeps its [panel | C]
# in the workspace, it beat the block tier too (``chip_smoke.py`` phase 9,
# random systems, same card: complex f64 N = 512, 64 systems, 18.1
# against 488.9 ms; N = 1024, 16 systems, 95.0 against 3621 ms). So the
# block tier keeps no N of the solve.
K1_WARP_MAX = 32
K1_PANEL_MIN = 33
# K4 (the inverse, [A | I]) takes the same crossovers: the warp tier up to
# N = 32, the panel tier from N = 33 (``chip_smoke.py`` phase 9 times every
# tier at the .noise shapes, PERF.md)
K4_WARP_MAX = 32
K4_PANEL_MIN = 33
# the multi entry's own launch counter (each of its launches is one of K1's
# too, under K1_TIERS' "multi" or "panel"), so a run can list it apart
K1_MULTI = {dt: Kernel(name=f"gj_complex_multi_{tag}",
                       source="spicey_tpu_torch/csrc/gj_complex.cu",
                       replaces="spicey_tpu/ops/pallas_gj.py:651")
            for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64"))}
# K1's multi entry ([A | B], r right-hand sides, the C side's code 3): the
# warp kernel gj_common.cuh:multi_solve_kernel up to N = 32, the panel
# tier from 33 (ops/gj_real.py:multi_tier_for)
MULTI_TIERS = ("multi", "panel")
MULTI_CODE = 3
# launches of each tier, per instantiation (K1, K4 count their sums;
# "multi" counts the multi entry's warp kernel, its panel launches count
# as "panel")
K1_TIERS = {dt: dict.fromkeys(TIERS + ("multi",), 0)
            for dt in (torch.float32, torch.float64)}
K4_TIERS = {dt: dict.fromkeys(TIERS, 0)
            for dt in (torch.float32, torch.float64)}


def tier_for(n: int, dtype: torch.dtype, inverse: bool = False) -> str:
    """The tier K1 (or, ``inverse``, K4) runs an (n, n) system of ``dtype``
    planes in (the same for both dtypes on the card measured)."""
    wmax, pmin = (K4_WARP_MAX, K4_PANEL_MIN) if inverse \
        else (K1_WARP_MAX, K1_PANEL_MIN)
    if n <= wmax:
        return "warp"
    return "panel" if n >= pmin else "block"


_LAUNCH_ARGS = [ctypes.c_void_p] * 8 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
    ctypes.c_void_p]
_INV_ARGS = [ctypes.c_void_p] * 6 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
    ctypes.c_void_p]
_MULTI_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
    ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
_SIGNATURES = {
    "gj_complex_workspace_systems": ([ctypes.c_int] * 4, ctypes.c_int),
    "gj_complex_multi_workspace_systems": ([ctypes.c_int] * 5,
                                           ctypes.c_int),
    "gj_complex_multi_f32": (_MULTI_ARGS, ctypes.c_int),
    "gj_complex_multi_f64": (_MULTI_ARGS, ctypes.c_int),
    "gj_complex_f32": (_LAUNCH_ARGS, ctypes.c_int),
    "gj_complex_f64": (_LAUNCH_ARGS, ctypes.c_int),
    "gj_complex_inv_workspace_systems": ([ctypes.c_int] * 4, ctypes.c_int),
    "gj_complex_inverse_f32": (_INV_ARGS, ctypes.c_int),
    "gj_complex_inverse_f64": (_INV_ARGS, ctypes.c_int),
}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load this kernel's library."""
    return load("gj_complex", _SIGNATURES)


def gj_solve_planes_cuda(A_re: torch.Tensor, A_im: torch.Tensor,
                         b_re: torch.Tensor, b_im: torch.Tensor,
                         eps: float = EPS, tier: str | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K1 on batch-first planes: A_* (B, N, N), b_* (B, N), all CUDA,
    contiguous, one float dtype (float32 or float64). Returns (x_re, x_im,
    valid) shaped (B, N), (B, N), (B,). ``tier`` forces one of ``TIERS``
    (for the comparisons and the sweep); None takes ``tier_for``'s."""
    ts = (A_re, A_im, b_re, b_im)
    if A_re.ndim != 3 or A_re.shape[1] != A_re.shape[2]:
        raise ValueError(f"A_re must be (B, N, N), got {tuple(A_re.shape)}")
    nb, n = A_re.shape[0], A_re.shape[1]
    if n < 1:
        raise ValueError(f"K1 solves N >= 1, got N={n}")
    if nb >= 2**31:
        raise ValueError(f"K1 takes fewer than 2^31 systems, got {nb}")
    if A_im.shape != A_re.shape or b_re.shape != (nb, n) \
            or b_im.shape != (nb, n):
        raise ValueError("plane shapes disagree")
    if A_re.dtype not in (torch.float32, torch.float64) \
            or any(t.dtype != A_re.dtype for t in ts):
        raise TypeError("K1 takes float32 or float64 planes of one dtype")
    tier = tier_for(n, A_re.dtype) if tier is None else tier
    if tier not in TIERS or (tier == "warp" and n > WARP_MAX_N):
        raise ValueError(f"K1 has no tier {tier!r} at N={n}")
    if any(not t.is_cuda or t.device != A_re.device for t in ts):
        raise ValueError("K1 takes CUDA tensors on one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("K1 takes contiguous tensors")
    code_tier = TIERS.index(tier)
    lib = load_library()
    dbl = A_re.dtype == torch.float64
    x_re = torch.empty((nb, n), dtype=A_re.dtype, device=A_re.device)
    x_im = torch.empty_like(x_re)
    valid = torch.empty((nb,), dtype=torch.bool, device=A_re.device)
    with torch.cuda.device(A_re.device):
        ws = None
        n_ws = lib.gj_complex_workspace_systems(n, nb, int(dbl), code_tier)
        if n_ws:
            # the planes live in global memory: the block tier's where they
            # overflow shared memory (f64 from N = 119, f32 past ~168), one
            # system each; the panel tier's where its plan keeps them there,
            # one slot per resident block
            ws = workspace((n_ws, 2, n, n + 1), A_re, "K1")
        fn = lib.gj_complex_f64 if dbl else lib.gj_complex_f32
        code = fn(ptr(A_re), ptr(A_im), ptr(b_re), ptr(b_im), ptr(x_re),
                  ptr(x_im), ptr(valid),
                  ctypes.c_void_p(0 if ws is None else ws.data_ptr()),
                  nb, n, float(eps), code_tier, stream_ptr(A_re.device))
        check(code, f"gj_complex {tier} launch")
    K1[A_re.dtype].launches += 1
    K1_TIERS[A_re.dtype][tier] += 1
    return x_re, x_im, valid


def gj_inverse_planes_cuda(A_re: torch.Tensor, A_im: torch.Tensor,
                           eps: float = EPS, tier: str | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Launch K4 on batch-first planes A_* (B, N, N), CUDA, contiguous, one
    float dtype (float32 or float64). Returns (M_re, M_im, valid) shaped
    (B, N, N), (B, N, N), (B,): the true inverse of every valid system.
    ``tier`` forces one of ``TIERS`` (for the comparisons); None takes
    ``tier_for(n, dtype, inverse=True)``'s."""
    if A_re.ndim != 3 or A_re.shape[1] != A_re.shape[2]:
        raise ValueError(f"A_re must be (B, N, N), got {tuple(A_re.shape)}")
    nb, n = A_re.shape[0], A_re.shape[1]
    if n < 1:
        raise ValueError(f"K4 inverts N >= 1, got N={n}")
    if nb >= 2**31:
        raise ValueError(f"K4 takes fewer than 2^31 systems, got {nb}")
    if A_im.shape != A_re.shape:
        raise ValueError("plane shapes disagree")
    if A_re.dtype not in (torch.float32, torch.float64) \
            or A_im.dtype != A_re.dtype:
        raise TypeError("K4 takes float32 or float64 planes of one dtype")
    tier = tier_for(n, A_re.dtype, inverse=True) if tier is None else tier
    if tier not in TIERS or (tier == "warp" and n > WARP_MAX_N):
        raise ValueError(f"K4 has no tier {tier!r} at N={n}")
    if not (A_re.is_cuda and A_im.is_cuda) or A_im.device != A_re.device:
        raise ValueError("K4 takes CUDA tensors on one device")
    if not (A_re.is_contiguous() and A_im.is_contiguous()):
        raise ValueError("K4 takes contiguous tensors")
    code_tier = TIERS.index(tier)
    lib = load_library()
    dbl = A_re.dtype == torch.float64
    m_re = torch.empty_like(A_re)
    m_im = torch.empty_like(A_re)
    valid = torch.empty((nb,), dtype=torch.bool, device=A_re.device)
    with torch.cuda.device(A_re.device):
        ws = None
        n_ws = lib.gj_complex_inv_workspace_systems(n, nb, int(dbl), code_tier)
        if n_ws:
            # [A | I] in global memory: the block tier's where it overflows
            # shared memory (f64 above N = 84, f32 above ~119), one system
            # each; the panel tier's where its plan keeps the planes there,
            # one slot per resident block
            ws = workspace((n_ws, 2, n, 2 * n), A_re, "K4")
        fn = lib.gj_complex_inverse_f64 if dbl else lib.gj_complex_inverse_f32
        code = fn(ptr(A_re), ptr(A_im), ptr(m_re), ptr(m_im), ptr(valid),
                  ctypes.c_void_p(0 if ws is None else ws.data_ptr()), nb, n,
                  float(eps), code_tier, stream_ptr(A_re.device))
        check(code, f"gj_complex inverse {tier} launch")
    K4[A_re.dtype].launches += 1
    K4_TIERS[A_re.dtype][tier] += 1
    return m_re, m_im, valid


def gj_solve_planes_multi_cuda(A_re: torch.Tensor, A_im: torch.Tensor,
                               B_re: torch.Tensor, B_im: torch.Tensor,
                               eps: float = EPS, tier: str | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Launch K1's multi entry on batch-first planes: A_* (nb, N, N), B_*
    (nb, N, R), all CUDA, contiguous, one float dtype. Returns (X_re,
    X_im (nb, N, R), valid (nb,)), the plain
    ``linsolve.gj_solve_planes_multi``'s function. ``tier`` forces one of
    ``MULTI_TIERS`` (the comparisons); None takes the multi chooser's."""
    from .gj_real import multi_tier_for

    ts = (A_re, A_im, B_re, B_im)
    if A_re.ndim != 3 or A_re.shape[1] != A_re.shape[2]:
        raise ValueError(f"A_re must be (B, N, N), got {tuple(A_re.shape)}")
    nb, n = A_re.shape[0], A_re.shape[1]
    if n < 1:
        raise ValueError(f"K1 multi solves N >= 1, got N={n}")
    if B_re.ndim != 3 or B_re.shape[:2] != (nb, n) or B_re.shape[2] < 1:
        raise ValueError(f"K1 multi: B must be (B, N, R) with B, N = "
                         f"{(nb, n)}, got {tuple(B_re.shape)}")
    r = B_re.shape[2]
    if A_im.shape != A_re.shape or B_im.shape != B_re.shape:
        raise ValueError("plane shapes disagree")
    if nb * n * r >= 2**31:
        raise ValueError("K1 multi takes fewer than 2^31 elements of B")
    if A_re.dtype not in (torch.float32, torch.float64) \
            or any(t.dtype != A_re.dtype for t in ts):
        raise TypeError("K1 multi takes float32 or float64 planes of one "
                        "dtype")
    tier = multi_tier_for(n) if tier is None else tier
    if tier not in MULTI_TIERS or (tier == "multi" and n > WARP_MAX_N):
        raise ValueError(f"K1 multi has no tier {tier!r} at N={n}")
    if any(not t.is_cuda or t.device != A_re.device for t in ts):
        raise ValueError("K1 multi takes CUDA tensors on one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("K1 multi takes contiguous tensors")
    code_tier = MULTI_CODE if tier == "multi" else TIERS.index(tier)
    lib = load_library()
    dbl = A_re.dtype == torch.float64
    X_re = torch.empty((nb, n, r), dtype=A_re.dtype, device=A_re.device)
    X_im = torch.empty_like(X_re)
    valid = torch.empty((nb,), dtype=torch.bool, device=A_re.device)
    with torch.cuda.device(A_re.device):
        n_ws = lib.gj_complex_multi_workspace_systems(n, r, nb, int(dbl),
                                                      code_tier)
        ws = workspace((n_ws, 2, n, n + r), A_re, "K1 multi") if n_ws else None
        fn = lib.gj_complex_multi_f64 if dbl else lib.gj_complex_multi_f32
        code = fn(ptr(A_re), ptr(A_im), ptr(B_re), ptr(B_im), ptr(X_re),
                  ptr(X_im), ptr(valid),
                  ctypes.c_void_p(0 if ws is None else ws.data_ptr()), nb, n,
                  r, float(eps), code_tier, stream_ptr(A_re.device))
        check(code, f"gj_complex multi {tier} launch")
    K1[A_re.dtype].launches += 1
    K1_TIERS[A_re.dtype][tier] += 1
    K1_MULTI[A_re.dtype].launches += 1
    return X_re, X_im, valid
