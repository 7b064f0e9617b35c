"""K2 and K3: the batched real Gauss-Jordan kernels (csrc/gj_real.cu).

K2 replaces ``spicey_tpu/ops/pallas_gj.py:_gj_real_kernel`` (the solve
of every Newton pass of the transient) and K3 replaces
``_gj_inv_real_kernel`` (the factor-once inverse of linear transients).
The TPU kernels run in f32 only, with f64 as f32 solves plus refinement
outside the kernel; Hopper has native f64, so both are instantiated in
float and double and the f64 instance is the fidelity tier itself. K3
writes the true inverse, not the TPU kernel's row-permuted one. Their
plain PyTorch versions are ``ops/linsolve.gj_solve`` and
``ops/linsolve.gj_inverse``; both kernels share the elimination of K1
(csrc/gj_common.cuh). N has no upper limit: where a system overflows
shared memory (f64 [A | I] past N = 119, f64 [A | b] past N = 168 in the
block tier; in the panel tier the planes where its plan says, and its
n x 33 [panel | C] past N = 822 in f64 and 1629 in f32), the kernel
eliminates in a global workspace, so a flat deck past N = 128 solves
dense, as in the JAX package.

The solve runs in four tiers, chosen by ``tier_for`` from N and the dtype
(``csrc/gj_real.cu`` says what bounds each): "thread" (N <= 16, one
thread per system, ``gj_common.cuh:thread_gj``), "warp" (N <= 32, one warp
per system, ``warp_gj``), "block" (one block per system, ``block_gj``) and
"panel" (``csrc/gj_panel.cuh``: a panel of PW = 16 columns, then one
product per panel, on the tensor cores in f64). The inverse runs in four,
chosen by ``tier_for(n, dtype, inverse=True)``: "register" (N <= 8: one
thread per system, [A | I] reduced in place in its registers,
``gj_common.cuh:reg_gj_inv_real``), warp (``warp_inverse_kernel``, K4's
on one plane) and panel (R = N right-hand sides, the identity); block
only when forced. ``K2_TIERS`` and ``K3_TIERS`` count each tier's
launches beside ``K2``'s and ``K3``'s totals.

K2's multi entry (``gj_solve_multi_cuda``) solves [A | B] for a right
block B of R columns, the Schur tier's real block solves (ops/schur.py):
``gj_common.cuh:multi_solve_kernel`` up to N = 32, the panel tier at R
columns from 33 (``MULTI_TIERS``, ``multi_tier_for``); its launches count
in ``K2``, ``K2_TIERS`` and ``K2_MULTI``; its plain version is
``linsolve.gj_solve_multi``.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import EPS
from ._build import Kernel, check, load, ptr, stream_ptr, workspace
from .gj import WARP_MAX_N

# one launch counter per instantiation
K2 = {dt: Kernel(name=f"gj_real_{tag}",
                 source="spicey_tpu_torch/csrc/gj_real.cu",
                 replaces="spicey_tpu/ops/pallas_gj.py:430")
      for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64"))}
K3 = {dt: Kernel(name=f"gj_inv_real_{tag}",
                 source="spicey_tpu_torch/csrc/gj_real.cu",
                 replaces="spicey_tpu/ops/pallas_gj.py:468")
      for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64"))}

# the multi entry's own launch counter (each of its launches is one of K2's
# too, under K2_TIERS' "multi" or "panel"), so a run can list it apart
K2_MULTI = {dt: Kernel(name=f"gj_real_multi_{tag}",
                       source="spicey_tpu_torch/csrc/gj_real.cu",
                       replaces="spicey_tpu/ops/pallas_gj.py:430")
            for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64"))}

# the C side's tier codes (csrc/gj_real.cu:Tier)
CODES = {"warp": 0, "block": 1, "panel": 2, "thread": 3, "register": 4,
         "multi": 5}
TIERS = ("warp", "block", "panel", "thread")   # K2's
INV_TIERS = ("register", "warp", "block", "panel")  # K3's
# K2's multi entry ([A | B], r right-hand sides): the warp kernel
# gj_common.cuh:multi_solve_kernel up to N = 32, the panel tier from 33
MULTI_TIERS = ("multi", "panel")
THREAD_MAX_N = 16                              # gj_common.cuh:THREAD_MAX_N
K3_REG_INSTANCES = 8                           # gj_real.cu:REG_MAX_N
# The crossovers: the thread tier up to K2_THREAD_MAX (per dtype), the
# warp tier from there up to K2_WARP_MAX, the panel tier from
# K2_PANEL_MIN, the block tier between (empty where they meet). Measured by
# ``tools/profile_torch_solver.py --tiers`` (every tier forced on the real
# part of the sweep's ladder planes) on an NVIDIA H100 80GB HBM3 at
# 700.00 W. Thread against warp, ``--ns 8 9 10 11 12 13 14 15 16 --reps
# 5``: the thread tier won up to N = 11 in f32 (0.283 against 0.304 ms)
# and N = 9 in f64 (0.276 against 0.287 ms); the warp tier won every N
# from 12 (f32) and 11 (f64) to 16, by 1.3-2.2x (f32) and 1.3-3.7x
# (f64). At N = 10 in f64 the two swapped places across three runs
# (thread / warp 0.353 / 0.351, 0.354 / 0.356, 0.340 / 0.333 ms), so it
# keeps the thread tier. Warp against block and panel against block,
# ``--ns 8 ... 128``: the warp tier beat the block tier at every N <= 32
# (N = 32: 1.06 / 1.72 ms against 11.9 / 13.0 ms, f32 / f64); the panel
# tier beat it at every N >= 33 (N = 33: 10.3 / 12.2 ms against 13.1 /
# 14.4 ms; N = 128: 30.8 / 39.7 ms against 161 / 345 ms). Past N = 822
# (f64) / 1629 (f32), where the panel tier keeps its [panel | C] in the
# workspace, it beat the block tier too (``chip_smoke.py`` phase 9,
# random systems, same card: f64 N = 1024, 16 systems, 56.2 against 1754
# ms; N = 512, 64 systems, 5.77 against 236.2 ms). So the block tier
# keeps no N of the solve.
K2_THREAD_MAX = {torch.float32: 11, torch.float64: 10}
K2_WARP_MAX = 32
K2_PANEL_MIN = 33
# launches of each tier, per instantiation (K2 counts their sum; "multi"
# counts the multi entry's warp kernel, its panel launches count as "panel")
K2_TIERS = {dt: dict.fromkeys(TIERS + ("multi",), 0)
            for dt in (torch.float32, torch.float64)}
# K3's crossovers: the register form up to its last instance,
# K3_REG_INSTANCES, in both dtypes, the warp tier from there up to
# K3_WARP_MAX, the panel tier from K3_PANEL_MIN; the block tier at no N.
# Measured by ``tools/profile_torch_k3.py --sweep`` (every tier forced on
# random systems) on an NVIDIA H100 80GB HBM3 at 700.00 W, against the
# thread tier (thread_gj on [A | I]) that K3 then still had. Register
# against thread, N = 2-8, at the tran-1M loop's batch (``--batch
# 1000000``): the register form won at every N in both dtypes (N = 2
# 0.047 / 0.047 ms against 0.049 / 0.062 ms, f32 / f64; N = 8 0.306 /
# 0.567 against 1.904 / 3.043 ms; at 65,536 systems N = 2-4 tie within
# 0.005 ms, launch-bound), and no instance spills (f64 N = 8: 255
# registers, no local memory). Thread against warp, N = 9-16: the warp
# tier won at every N (1M systems: N = 9 2.73 / 3.51 ms against 3.05 /
# 5.63 ms; N = 16 6.08 / 7.57 against 23.1 / 80.5 ms). So the thread
# tier won at no N and K3 no longer has it. Warp against panel (16,384
# systems): the warp tier won at N = 32 (0.43 / 0.79 ms against 1.09 /
# 1.23 ms); from N = 33 only the panel tier takes the system (1.55 / 1.82
# ms, block 2.78 / 3.47 ms).
K3_WARP_MAX = 32
K3_PANEL_MIN = 33
K3_TIERS = {dt: dict.fromkeys(INV_TIERS, 0)
            for dt in (torch.float32, torch.float64)}


def tier_for(n: int, dtype: torch.dtype, inverse: bool = False) -> str:
    """The tier K2 (or, ``inverse``, K3) runs an (n, n) system of
    ``dtype`` in."""
    if inverse:
        if n <= K3_REG_INSTANCES:
            return "register"
        return "warp" if n <= K3_WARP_MAX else "panel"
    if n <= K2_THREAD_MAX[dtype]:
        return "thread"
    if n <= K2_WARP_MAX:
        return "warp"
    return "panel" if n >= K2_PANEL_MIN else "block"


def multi_tier_for(n: int) -> str:
    """The tier K1's and K2's multi entry runs an (n, n) system in."""
    return "multi" if n <= WARP_MAX_N else "panel"


def _takes(tier: str, n: int) -> bool:
    """Whether ``tier`` can take an (n, n) system at all (register: N with
    an instance; thread: 4-bit pivot rows; warp: a row per lane)."""
    return not ((tier == "register" and n > K3_REG_INSTANCES)
                or (tier == "thread" and n > THREAD_MAX_N)
                or (tier == "warp" and n > WARP_MAX_N))


def inverse_tiers(n: int) -> list[str]:
    """The tiers of K3 that can take an (n, n) system."""
    return [t for t in INV_TIERS if _takes(t, n)]


_SOLVE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_double, ctypes.c_int,
                                       ctypes.c_void_p]
_INV_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_double, ctypes.c_int,
                                     ctypes.c_void_p]
_MULTI_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
    ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
_SIGNATURES = {
    "gj_real_workspace_systems": ([ctypes.c_int] * 5, ctypes.c_int),
    "gj_real_multi_workspace_systems": ([ctypes.c_int] * 5, ctypes.c_int),
    "gj_real_solve_multi_f32": (_MULTI_ARGS, ctypes.c_int),
    "gj_real_solve_multi_f64": (_MULTI_ARGS, ctypes.c_int),
    "gj_real_solve_f32": (_SOLVE_ARGS, ctypes.c_int),
    "gj_real_solve_f64": (_SOLVE_ARGS, ctypes.c_int),
    "gj_real_inverse_f32": (_INV_ARGS, ctypes.c_int),
    "gj_real_inverse_f64": (_INV_ARGS, ctypes.c_int),
}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load this kernel's library."""
    return load("gj_real", _SIGNATURES)


def _check_systems(A: torch.Tensor, what: str) -> tuple[int, int]:
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"{what}: A must be (B, N, N), got "
                         f"{tuple(A.shape)}")
    nb, n = A.shape[0], A.shape[1]
    if n < 1:
        raise ValueError(f"{what} solves N >= 1, got N={n}")
    if nb >= 2**31:
        raise ValueError(f"{what} takes fewer than 2^31 systems, got {nb}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} takes float32 or float64 systems")
    return nb, n


def _check_tensors(ts: tuple, what: str) -> None:
    if any(t.dtype != ts[0].dtype for t in ts):
        raise TypeError(f"{what} takes float32 or float64 tensors of one "
                        "dtype")
    if any(not t.is_cuda or t.device != ts[0].device for t in ts):
        raise ValueError(f"{what} takes CUDA tensors on one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError(f"{what} takes contiguous tensors")


def _workspace(lib: ctypes.CDLL, A: torch.Tensor, n: int,
               inv: bool, tier: str = "block") -> torch.Tensor | None:
    """The global workspace of a tier whose planes live in global memory
    (the block tier past shared memory, f64 [A | I] past N = 119, one
    system each; the panel tier where its plan says so, one slot per
    resident block), else None."""
    dbl = A.dtype == torch.float64
    n_ws = lib.gj_real_workspace_systems(n, A.shape[0], int(inv), int(dbl),
                                         CODES[tier])
    if not n_ws:
        return None
    w = 2 * n if inv else n + 1
    return workspace((n_ws, n, w), A, "K3" if inv else "K2")


def gj_solve_cuda(A: torch.Tensor, b: torch.Tensor, eps: float = EPS,
                  tier: str | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2: A (B, N, N), b (B, N), CUDA, contiguous, one float dtype.
    Returns (x (B, N), valid (B,)). ``tier`` forces one of ``TIERS`` (for
    the comparisons and the sweep); None takes ``tier_for``'s."""
    nb, n = _check_systems(A, "K2")
    if b.shape != (nb, n):
        raise ValueError(f"K2: b must be (B, N) = {(nb, n)}, got "
                         f"{tuple(b.shape)}")
    tier = tier_for(n, A.dtype) if tier is None else tier
    if tier not in TIERS or not _takes(tier, n):
        raise ValueError(f"K2 has no tier {tier!r} at N={n}")
    _check_tensors((A, b), "K2")
    lib = load_library()
    x = torch.empty((nb, n), dtype=A.dtype, device=A.device)
    valid = torch.empty((nb,), dtype=torch.bool, device=A.device)
    with torch.cuda.device(A.device):
        ws = _workspace(lib, A, n, inv=False, tier=tier)
        fn = lib.gj_real_solve_f64 if A.dtype == torch.float64 \
            else lib.gj_real_solve_f32
        code = fn(ptr(A), ptr(b), ptr(x), ptr(valid),
                  ctypes.c_void_p(0 if ws is None else ws.data_ptr()), nb, n,
                  float(eps), CODES[tier], stream_ptr(A.device))
        check(code, f"gj_real {tier} solve launch")
    K2[A.dtype].launches += 1
    K2_TIERS[A.dtype][tier] += 1
    return x, valid


def gj_inverse_cuda(A: torch.Tensor, eps: float = EPS,
                    tier: str | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K3: A (B, N, N), CUDA, contiguous, float32 or float64.
    Returns (the true inverse (B, N, N), valid (B,)). ``tier`` forces one
    of ``INV_TIERS`` (for the comparisons and the sweep); None takes
    ``tier_for(n, dtype, inverse=True)``'s."""
    nb, n = _check_systems(A, "K3")
    tier = tier_for(n, A.dtype, inverse=True) if tier is None else tier
    if tier not in INV_TIERS or not _takes(tier, n):
        raise ValueError(f"K3 has no tier {tier!r} at N={n}")
    _check_tensors((A,), "K3")
    lib = load_library()
    inv = torch.empty((nb, n, n), dtype=A.dtype, device=A.device)
    valid = torch.empty((nb,), dtype=torch.bool, device=A.device)
    with torch.cuda.device(A.device):
        ws = _workspace(lib, A, n, inv=True, tier=tier)
        fn = lib.gj_real_inverse_f64 if A.dtype == torch.float64 \
            else lib.gj_real_inverse_f32
        code = fn(ptr(A), ptr(inv), ptr(valid),
                  ctypes.c_void_p(0 if ws is None else ws.data_ptr()), nb, n,
                  float(eps), CODES[tier], stream_ptr(A.device))
        check(code, f"gj_real {tier} inverse launch")
    K3[A.dtype].launches += 1
    K3_TIERS[A.dtype][tier] += 1
    return inv, valid


def gj_solve_multi_cuda(A: torch.Tensor, B: torch.Tensor, eps: float = EPS,
                        tier: str | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2's multi entry: A (nb, N, N), B (nb, N, R), CUDA,
    contiguous, one float dtype. Returns (X (nb, N, R), valid (nb,)), the
    plain ``linsolve.gj_solve_multi``'s function. ``tier`` forces one of
    ``MULTI_TIERS`` (the comparisons); None takes ``multi_tier_for``'s."""
    nb, n = _check_systems(A, "K2 multi")
    if B.ndim != 3 or B.shape[:2] != (nb, n) or B.shape[2] < 1:
        raise ValueError(f"K2 multi: B must be (B, N, R) with B, N = "
                         f"{(nb, n)}, got {tuple(B.shape)}")
    r = B.shape[2]
    if nb * n * r >= 2**31:
        raise ValueError("K2 multi takes fewer than 2^31 elements of B")
    tier = multi_tier_for(n) if tier is None else tier
    if tier not in MULTI_TIERS or (tier == "multi" and n > WARP_MAX_N):
        raise ValueError(f"K2 multi has no tier {tier!r} at N={n}")
    _check_tensors((A, B), "K2 multi")
    lib = load_library()
    X = torch.empty((nb, n, r), dtype=A.dtype, device=A.device)
    valid = torch.empty((nb,), dtype=torch.bool, device=A.device)
    dbl = A.dtype == torch.float64
    with torch.cuda.device(A.device):
        n_ws = lib.gj_real_multi_workspace_systems(n, r, nb, int(dbl),
                                                   CODES[tier])
        ws = workspace((n_ws, n, n + r), A, "K2 multi") if n_ws else None
        fn = lib.gj_real_solve_multi_f64 if dbl \
            else lib.gj_real_solve_multi_f32
        code = fn(ptr(A), ptr(B), ptr(X), ptr(valid),
                  ctypes.c_void_p(0 if ws is None else ws.data_ptr()), nb, n,
                  r, float(eps), CODES[tier], stream_ptr(A.device))
        check(code, f"gj_real multi {tier} launch")
    K2[A.dtype].launches += 1
    K2_TIERS[A.dtype][tier] += 1
    K2_MULTI[A.dtype].launches += 1
    return X, valid
