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
shared memory (f64 [A | I] past N = 119, f64 [A | b] past N = 168), the
block route eliminates in a global workspace, so a flat deck past
N = 128 solves dense, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import EPS
from ._build import Kernel, check, load, ptr, stream_ptr, workspace

# one launch counter per instantiation
K2 = {dt: Kernel(name=f"gj_real_{tag}",
                 source="spicey_tpu_torch/csrc/gj_real.cu",
                 replaces="spicey_tpu/ops/pallas_gj.py:430")
      for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64"))}
K3 = {dt: Kernel(name=f"gj_inv_real_{tag}",
                 source="spicey_tpu_torch/csrc/gj_real.cu",
                 replaces="spicey_tpu/ops/pallas_gj.py:468")
      for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64"))}

_SOLVE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_double, ctypes.c_void_p]
_INV_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_double, ctypes.c_void_p]
_SIGNATURES = {
    "gj_real_needs_workspace": ([ctypes.c_int] * 3, ctypes.c_int),
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
               inv: bool) -> torch.Tensor | None:
    """The global workspace of the block route where its planes overflow
    shared memory (f64 [A | I] past N = 119), else None."""
    dbl = A.dtype == torch.float64
    if not lib.gj_real_needs_workspace(n, int(inv), int(dbl)):
        return None
    w = 2 * n if inv else n + 1
    return workspace((A.shape[0], n, w), A, "K3" if inv else "K2")


def gj_solve_cuda(A: torch.Tensor, b: torch.Tensor, eps: float = EPS
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2: A (B, N, N), b (B, N), CUDA, contiguous, one float dtype.
    Returns (x (B, N), valid (B,))."""
    nb, n = _check_systems(A, "K2")
    if b.shape != (nb, n):
        raise ValueError(f"K2: b must be (B, N) = {(nb, n)}, got "
                         f"{tuple(b.shape)}")
    _check_tensors((A, b), "K2")
    lib = load_library()
    x = torch.empty((nb, n), dtype=A.dtype, device=A.device)
    valid = torch.empty((nb,), dtype=torch.bool, device=A.device)
    ws = _workspace(lib, A, n, inv=False)
    fn = lib.gj_real_solve_f64 if A.dtype == torch.float64 \
        else lib.gj_real_solve_f32
    code = fn(ptr(A), ptr(b), ptr(x), ptr(valid),
              ctypes.c_void_p(0 if ws is None else ws.data_ptr()), nb, n,
              float(eps), stream_ptr(A.device))
    check(code, "gj_real solve launch")
    K2[A.dtype].launches += 1
    return x, valid


def gj_inverse_cuda(A: torch.Tensor, eps: float = EPS
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K3: A (B, N, N), CUDA, contiguous, float32 or float64.
    Returns (the true inverse (B, N, N), valid (B,))."""
    nb, n = _check_systems(A, "K3")
    _check_tensors((A,), "K3")
    lib = load_library()
    inv = torch.empty((nb, n, n), dtype=A.dtype, device=A.device)
    valid = torch.empty((nb,), dtype=torch.bool, device=A.device)
    ws = _workspace(lib, A, n, inv=True)
    fn = lib.gj_real_inverse_f64 if A.dtype == torch.float64 \
        else lib.gj_real_inverse_f32
    code = fn(ptr(A), ptr(inv), ptr(valid),
              ctypes.c_void_p(0 if ws is None else ws.data_ptr()), nb, n,
              float(eps), stream_ptr(A.device))
    check(code, "gj_real inverse launch")
    K3[A.dtype].launches += 1
    return inv, valid
