"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` file exposes a plain C interface and is compiled by
``nvcc`` into ``build/spicey_tpu_torch/lib<name>-<hash>.so`` at the repo
root, then loaded with ``ctypes``. The hash covers the source text and the
flags, so an edited kernel is rebuilt and a stale library is never loaded.
Nothing here runs at import time: the CPU-only test hosts import every
module and have no ``nvcc``.

Every C entry point takes raw device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch; ``check``
turns a nonzero code into an exception (a refused launch never runs, and a
later synchronize would not report it). The C side plans, sets function
attributes and queries occupancy on the runtime's current device, so each
launcher makes the tensors' device current around its C calls
(``torch.cuda.device``): a launch on ``cuda:1`` gets ``cuda:1``'s plan as
well as its stream. No plan or attribute is cached on the host across
calls, and the Python-side caches are keyed by device
(``mc_tran_fused._plan``).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "spicey_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# opt-in shared memory of one H100 block (227 KB), gj_common.cuh:SMEM_MAX
SMEM_MAX = 232_448

# every library of csrc/ (warmup and chip_smoke.py build them all)
LIBRARIES = ("gj_complex", "gj_real", "mc_ac_fused", "mc_tran_fused",
             "mc_tran_nr", "mxu_gj", "stamp_real")

_LIBS: dict[str, ctypes.CDLL] = {}
_BUILD_S: dict[str, float] = {}


@dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    often its wrapper launched it (the wrapper adds one per launch and
    nowhere else, so a run can prove it went through the kernel)."""

    name: str
    source: str      # path in the repo
    replaces: str    # the TPU kernel's pallas_call site, file:line
    launches: int = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build_seconds() -> dict[str, float]:
    """Seconds each library took to build and load in this process (near
    0 when it was already built on disk)."""
    return dict(_BUILD_S)


def _target(name: str) -> tuple[Path, Path]:
    """The source of ``name`` and the library it builds into; the hash
    covers the source, the shared headers and the flags."""
    src = _CSRC / f"{name}.cu"
    text = src.read_bytes()
    for dep in sorted(_CSRC.glob("*.cuh")):
        text += dep.read_bytes()
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: list[str]) -> None:
    """Compile every library of ``names`` not built yet, one nvcc process
    per source, all started together; raise if any fails. Each compiles
    to a private name and is renamed when done, so a concurrent process
    never loads a half-written library."""
    jobs = []
    for name in names:
        src, out = _target(name)
        if out.is_file():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        jobs.append((name, src, out, tmp, time.perf_counter(),
                     subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)))
    errors = []
    for name, src, out, tmp, t0, proc in jobs:
        _out, err = proc.communicate()
        _BUILD_S[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {src.name}:\n{err}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str, signatures: dict[str, tuple[list, object]]
         ) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library,
    with ``argtypes``/``restype`` set from ``signatures`` (function name ->
    (argtypes, restype)) so no pointer is ever passed as a 32-bit int."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    t0 = time.perf_counter()
    build([name])
    lib = ctypes.CDLL(str(_target(name)[1]))
    for fn_name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    _BUILD_S.setdefault(name, time.perf_counter() - t0)
    _LIBS[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def workspace(shape: tuple, like: torch.Tensor, what: str) -> torch.Tensor:
    """A global workspace of ``shape`` in ``like``'s dtype and device, for
    a kernel whose systems overflow shared memory. Its size grows as
    B N (N + 1); when the card cannot hold it, say how many bytes it asked
    for, so the caller can pass a smaller ``chunk``."""
    try:
        return torch.empty(shape, dtype=like.dtype, device=like.device)
    except torch.cuda.OutOfMemoryError as exc:
        nbytes = math.prod(shape) * like.element_size()
        raise RuntimeError(
            f"{what}: the global workspace {tuple(shape)} takes {nbytes} "
            "bytes, more than the card has free; solve fewer systems per "
            "call (a smaller chunk)") from exc


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
