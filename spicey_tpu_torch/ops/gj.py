"""K1: the batched complex Gauss-Jordan kernel (csrc/gj_complex.cu).

Replaces ``spicey_tpu/ops/pallas_gj.py:_gj_complex_kernel``. The TPU
kernel runs in f32 only (its f64 tier is f32 solves plus refinement
outside the kernel); Hopper has native f64, so this kernel is
instantiated in float and double and the f64 instance is the fidelity
tier itself. Its plain PyTorch version is ``ops/linsolve.gj_solve_planes``.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import EPS
from ._build import SMEM_MAX, Kernel, check, load, ptr, stream_ptr

MAX_N = 128  # the JAX dense tiers stop here; larger systems go to Schur

# one launch counter per instantiation
K1 = {dt: Kernel(name=f"gj_complex_{tag}",
                 source="spicey_tpu_torch/csrc/gj_complex.cu",
                 replaces="spicey_tpu/ops/pallas_gj.py:651")
      for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64"))}


_LAUNCH_ARGS = [ctypes.c_void_p] * 8 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_void_p]
_SIGNATURES = {
    "gj_complex_smem_bytes": ([ctypes.c_int, ctypes.c_int], ctypes.c_size_t),
    "gj_complex_f32": (_LAUNCH_ARGS, ctypes.c_int),
    "gj_complex_f64": (_LAUNCH_ARGS, ctypes.c_int),
}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load this kernel's library."""
    return load("gj_complex", _SIGNATURES)


def gj_solve_planes_cuda(A_re: torch.Tensor, A_im: torch.Tensor,
                         b_re: torch.Tensor, b_im: torch.Tensor,
                         eps: float = EPS
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K1 on batch-first planes: A_* (B, N, N), b_* (B, N), all CUDA,
    contiguous, one float dtype (float32 or float64). Returns (x_re, x_im,
    valid) shaped (B, N), (B, N), (B,)."""
    ts = (A_re, A_im, b_re, b_im)
    if A_re.ndim != 3 or A_re.shape[1] != A_re.shape[2]:
        raise ValueError(f"A_re must be (B, N, N), got {tuple(A_re.shape)}")
    nb, n = A_re.shape[0], A_re.shape[1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"K1 solves 1 <= N <= {MAX_N}, got N={n}")
    if nb >= 2**31:
        raise ValueError(f"K1 takes fewer than 2^31 systems, got {nb}")
    if A_im.shape != A_re.shape or b_re.shape != (nb, n) \
            or b_im.shape != (nb, n):
        raise ValueError("plane shapes disagree")
    if A_re.dtype not in (torch.float32, torch.float64) \
            or any(t.dtype != A_re.dtype for t in ts):
        raise TypeError("K1 takes float32 or float64 planes of one dtype")
    if any(not t.is_cuda or t.device != A_re.device for t in ts):
        raise ValueError("K1 takes CUDA tensors on one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("K1 takes contiguous tensors")
    lib = load_library()
    dbl = A_re.dtype == torch.float64
    x_re = torch.empty((nb, n), dtype=A_re.dtype, device=A_re.device)
    x_im = torch.empty_like(x_re)
    valid = torch.empty((nb,), dtype=torch.bool, device=A_re.device)
    ws = None
    if lib.gj_complex_smem_bytes(n, int(dbl)) > SMEM_MAX:
        # the f64 planes near N=128 overflow shared memory: eliminate in
        # place in a global workspace instead
        ws = torch.empty((nb, 2, n, n + 1), dtype=A_re.dtype,
                         device=A_re.device)
    fn = lib.gj_complex_f64 if dbl else lib.gj_complex_f32
    code = fn(ptr(A_re), ptr(A_im), ptr(b_re), ptr(b_im), ptr(x_re),
              ptr(x_im), ptr(valid),
              ctypes.c_void_p(0 if ws is None else ws.data_ptr()),
              nb, n, float(eps), stream_ptr(A_re.device))
    check(code, "gj_complex launch")
    K1[A_re.dtype].launches += 1
    return x_re, x_im, valid
