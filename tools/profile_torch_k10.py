"""K10a/K10b, the panel-blocked Gauss-Jordan, phase by phase, in one tree.

Run on a CUDA card from the repo root: ``python3 tools/profile_torch_k10.py
[--root DIR] [--reps 3] [--out build/profile_torch_k10.json]``. Imports
nothing of JAX.

``--root`` names the checkout whose ``spicey_tpu_torch`` is imported and
whose ``csrc/mxu_gj.cu`` is profiled (default: this one), so that the
kernel of two trees can be compared on one card in one call, alternating
(parent, change, change, parent). For each of the solver sweep's shapes,
N = 64 (104,448 systems) and N = 128 (52,224), real (K10a) and complex
(K10b), f64 and f32, on random well-conditioned systems made from
``--seed`` (the time does not depend on the values of such systems), it
prints:

  ms          the kernel through the tree's wrapper (``ops/mxu.py``), CUDA
              events, mean of ``--reps`` after a warm launch;
  workspace   the elements of the wrapper's global workspace;
  cycles      from a copy of the kernel in which thread 0 of every block
              reads ``clock64()`` at each phase boundary and adds the
              cycles since its last reading to a device counter for that
              phase (built into ``build/profile_torch_k10/``): the cycles
              per system summed over a block's phases, each phase's share,
              and the kernel's ms with the stamps on.

The phases of a kernel built on ``gj_panel.cuh`` (this tree's K10): load
(A and b into the planes), stage ([panel | C]), search (the first pivot
search of a panel), steps (the pivot steps), product (G's staging and the
trailing update). Of the one-block-per-system kernel before it (a tree
whose ``mxu_gj.cu`` has ``mxu_gj_kernel``): load, steps (the panel's
pivot steps, C's zeroing included), product. Then the card's nvidia-smi
name and power limit. Every line also goes to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
BUILD = HERE.parent / "build" / "profile_torch_k10"
# the sweep's shapes: (N, systems)
SHAPES = ((64, 104_448), (128, 52_224))
PHASES = ("load", "stage", "search", "steps", "product")
# the one-block-per-system kernel's anchors (phase index as in PHASES)
OLD_START = "  const T* A[2] = {A0 + sys * n * n, P == 2 ? A1 + sys * n * n : nullptr};"
OLD_MARKS = [("  for (int k0 = 0; k0 < n; k0 += pmax) {", 0),
             ("    const int pw = min(pmax, n - k0);", 4),
             ("    // ---- the trailing update: M[:, c0:] += C @ G", 3),
             ("  // pivot row perm[k] carries x[k] in its right-hand side", 4)]
CYCLES_FN = """
extern "C" int k10_cycles(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_cycles,
                                   8 * sizeof(unsigned long long));
}
extern "C" int k10_zero_cycles() {
  unsigned long long zero[8] = {0};
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
"""


def build_stamped(csrc: Path, nvcc: str, flags: tuple) -> ctypes.CDLL:
    """A stamped copy of ``csrc/mxu_gj.cu`` (and, for the kernel built on
    it, of ``gj_panel.cuh``) with the counters' accessors; built with the
    wrapper's flags and loaded."""
    sys.path.insert(0, str(HERE))
    from profile_torch_panel import MARKS, PANEL_START, stamped
    BUILD.mkdir(parents=True, exist_ok=True)
    src = (csrc / "mxu_gj.cu").read_text()
    if "mxu_gj_kernel" in src:
        src = stamped(src, OLD_START, OLD_MARKS, "mxu_gj.cu")
    else:
        panel = stamped((csrc / "gj_panel.cuh").read_text(), PANEL_START,
                        MARKS, "gj_panel.cuh")
        (BUILD / "gj_panel_profiled.cuh").write_text(panel)
        src = src.replace('#include "gj_panel.cuh"',
                          '#include "gj_panel_profiled.cuh"', 1)
    cu = BUILD / "mxu_gj_profiled.cu"
    cu.write_text(src + CYCLES_FN)
    lib = BUILD / f"libmxu_gj_profiled_{abs(hash(src)) % 10**8}.so"
    subprocess.run([nvcc, *flags, "-I", str(BUILD), "-I", str(csrc), "-o",
                    str(lib), str(cu)], check=True)
    cdll = ctypes.CDLL(str(lib))
    cdll.k10_cycles.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    return cdll


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE.parent))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/profile_torch_k10.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_k10: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import spicey_tpu_torch as st
    from spicey_tpu_torch.ops import _build, mxu
    if not Path(st.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {st.__file__}, not from {root}")
    csrc = root / "spicey_tpu_torch" / "csrc"
    t0 = time.perf_counter()
    mxu.load_library()
    prof = build_stamped(csrc, _build._nvcc(), _build.NVCC_FLAGS)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    old = "mxu_gj_kernel" in (csrc / "mxu_gj.cu").read_text()
    rows = [{"root": str(root), "kernel": "one block per system" if old
             else "gj_panel.cuh, ElementaryStep",
             "built_s": round(time.perf_counter() - t0, 1)}]
    print(json.dumps(rows[0]), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    for n, batch in SHAPES:
        base = rng.standard_normal((2048, n, n)) + n * np.eye(n)
        reps = -(-batch // 2048)
        for dtype in (torch.float64, torch.float32):
            A = torch.as_tensor(base, dtype=dtype, device=dev).repeat(
                reps, 1, 1)[:batch].contiguous()
            Ai = (0.1 * A).contiguous()
            b = torch.ones((batch, n), dtype=dtype, device=dev)
            bi = (0.5 * b).contiguous()
            for planes in (1, 2):
                ts = (A, b) if planes == 1 else (A, Ai, b, bi)
                solve = (mxu.mxu_solve_real if planes == 1
                         else mxu.mxu_solve_complex)
                ms = cuda_ms(lambda: solve(*ts), args.reps)
                # the stamped copy, through the tree's own argument layout
                p_ = mxu.blocked_plan(n)[0]
                dbl = int(dtype == torch.float64)
                xs = [torch.empty((batch, n), dtype=dtype, device=dev)
                      for _ in range(planes)]
                valid = torch.empty((batch,), dtype=torch.bool, device=dev)
                ws = None
                if old:
                    if mxu.load_library().mxu_gj_smem_bytes(
                            n, p_, planes, dbl) > _build.SMEM_MAX:
                        ws = torch.empty((batch, planes, n, n + 1),
                                         dtype=dtype, device=dev)
                else:
                    n_ws = mxu.load_library().mxu_gj_workspace_systems(
                        n, batch, planes, dbl, p_)
                    if n_ws:
                        ws = torch.empty((n_ws, planes, n, n + 1),
                                         dtype=dtype, device=dev)
                kind = "real" if planes == 1 else "complex"
                fn = getattr(prof, f"mxu_gj_{kind}_{'f64' if dbl else 'f32'}")
                fn.argtypes = (mxu._REAL_ARGS if planes == 1
                               else mxu._CPLX_ARGS)
                fn.restype = ctypes.c_int

                def stamped_launch():
                    code = fn(*[ctypes.c_void_p(t.data_ptr()) for t in ts],
                              *[ctypes.c_void_p(x.data_ptr()) for x in xs],
                              ctypes.c_void_p(valid.data_ptr()),
                              ctypes.c_void_p(0 if ws is None
                                              else ws.data_ptr()),
                              batch, n, p_, 1e-12,
                              ctypes.c_void_p(torch.cuda.current_stream(
                                  dev).cuda_stream))
                    if code != 0:
                        raise RuntimeError(f"stamped K10 N={n}: {code}")

                stamped_launch()
                torch.cuda.synchronize()
                prof.k10_zero_cycles()
                stamped_launch()
                torch.cuda.synchronize()
                counts = (ctypes.c_ulonglong * 8)()
                prof.k10_cycles(counts)
                total = sum(counts[i] for i in range(len(PHASES)))
                ms_st = cuda_ms(stamped_launch, args.reps)
                row = {"kernel": ("K10a" if planes == 1 else "K10b"),
                       "dtype": str(dtype).split(".")[1], "n": n,
                       "systems": batch, "panel": p_, "ms": ms,
                       "workspace_elems": 0 if ws is None else ws.numel(),
                       "ms_stamped": ms_st,
                       "cycles_per_system": total / batch,
                       "share": {p: counts[i] / total
                                 for i, p in enumerate(PHASES)
                                 if counts[i]}}
                rows.append(row)
                print(json.dumps(row), flush=True)
                del xs, valid, ws
            del A, Ai, b, bi
            torch.cuda.empty_cache()
    print(smi, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": smi, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
