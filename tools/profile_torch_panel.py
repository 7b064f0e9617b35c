"""Where the panel tier of K1/K2 spends its cycles, phase by phase.

Run on a CUDA card from the repo root: ``python3 tools/profile_torch_panel.py
[--out build/profile_torch_panel.json]``. Imports nothing of JAX.

It writes a copy of ``spicey_tpu_torch/csrc/gj_panel.cuh`` into
``build/profile_torch_panel/`` in which thread 0 of every block reads
``clock64()`` at each phase boundary and adds the cycles since its last
reading to a device counter for that phase, builds it with nvcc, and runs
the panel kernel with the plan the wrapper uses (``gj_panel.cuh:plan``: the
place of the planes and of [panel | C], the resident blocks per SM) on
random well-conditioned systems at the panel tier's main-path shapes: the
solver sweep's N = 64 (104,448 systems) and N = 128 (52,224), complex and
real, f32 and f64, and flat-256's 816 complex f64 systems; and 264 complex
f64 systems at N = 512, past the N where [panel | C] fits on chip. The
phases:

  load     A and b into the planes (and the previous system's x out);
  stage    the panel's columns and a zero C into [panel | C];
  search   the first pivot search of each panel;
  steps    the panel's pivot steps;
  product  G's staging and the trailing update (the DMMA / register-tiled
           product), each panel.

One line per shape: the plan, the kernel's milliseconds with the stamps on
(CUDA events; the stamps add one atomic per phase per block), the cycles
per system summed over a block's phases, and each phase's share; then the
card's nvidia-smi name and power limit. Every line also goes to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "spicey_tpu_torch" / "csrc"
BUILD = ROOT / "build" / "profile_torch_panel"
PHASES = ("load", "stage", "search", "steps", "product")
PLACES = ("all in shared memory", "planes in the workspace",
          "planes and [panel | C] in the workspace")  # gj_panel.cuh:Place
# (N, planes, dtype, systems): the sweep's N = 64 and 128, flat-256, and
# complex f64 at N = 512, where [panel | C] lives in the workspace
SHAPES = [(64, 2, torch.float64, 104448), (64, 1, torch.float64, 104448),
          (64, 2, torch.float32, 104448), (64, 1, torch.float32, 104448),
          (128, 2, torch.float64, 52224), (128, 1, torch.float64, 52224),
          (128, 2, torch.float32, 52224), (128, 1, torch.float32, 52224),
          (256, 2, torch.float64, 816), (512, 2, torch.float64, 264)]

# (anchor in gj_panel.cuh, phase index charged with the cycles up to it)
MARKS = [("    for (int k0 = 0; k0 < n; k0 += S::W) {", 0),
         ("      // ---- 1. stage [panel | C = 0]", 4),
         ("      if (warp == 0) search<T, P>(pc, used, n, L, S::panel_col(0), "
          "next_p);", 1),
         ("      for (int l = 0; l < pw; ++l) {", 2),
         ("      // ---- 3. the trailing update", 3),
         ("    // pivot row perm[k] carries x[k]", 4)]

LAUNCHER = r"""
#include "gj_panel_profiled.cuh"
template <typename T, int P>
int run_t(const void* const* ptrs, int batch, int n, double thr,
          int* plan_out) {
  const gj::panel::Plan pl = gj::panel::plan<T, P>(n, 1);
  plan_out[0] = pl.blocks_per_sm;
  plan_out[1] = pl.place;
  plan_out[2] = gj::panel::workspace_units(n, 1, pl.place, pl.grid(batch));
  if (pl.blocks_per_sm == 0) return -1;
  if (ptrs[7] == nullptr) return 0;  // the plan only
  unsigned long long zero[8] = {0};
  cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  auto* kernel = pl.place == gj::panel::PANEL_GLOBAL
                     ? gj::panel::solve_kernel<T, P, true>
                     : gj::panel::solve_kernel<T, P, false>;
  kernel<<<pl.grid(batch), gj::panel::THREADS,
           gj::panel::smem_bytes<T, P>(n, 1, pl.place)>>>(
      (const T*)ptrs[0], (const T*)ptrs[1], (const T*)ptrs[2],
      (const T*)ptrs[3], (T*)ptrs[4], (T*)ptrs[5], (uint8_t*)ptrs[6],
      pl.place == gj::panel::ALL_SMEM ? nullptr : (T*)ptrs[7], batch, n, 1,
      (T)thr);
  return (int)cudaGetLastError();
}
extern "C" int run(int dbl, int planes, const void* const* ptrs, int batch,
                   int n, double thr, int* plan_out) {
  if (dbl && planes == 2)
    return run_t<double, 2>(ptrs, batch, n, thr, plan_out);
  if (dbl) return run_t<double, 1>(ptrs, batch, n, thr, plan_out);
  if (planes == 2) return run_t<float, 2>(ptrs, batch, n, thr, plan_out);
  return run_t<float, 1>(ptrs, batch, n, thr, plan_out);
}
extern "C" int cycles(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_cycles,
                                   8 * sizeof(unsigned long long));
}
"""


def stamped(src: str, start: str, marks: list, what: str) -> str:
    """``src`` with a per-phase cycle counter: ``g_phase_cycles`` declared
    before its first ``namespace``, thread 0's clock read before the line
    ``start``, and before each anchor of ``marks`` the cycles since the
    last reading added to that anchor's phase."""
    src = src.replace("namespace ",
                      "__device__ unsigned long long g_phase_cycles[8];\n"
                      "namespace ", 1)
    for anchor in [start] + [a for a, _ in marks]:
        if src.count(anchor) != 1:
            raise RuntimeError(f"{what} has no single line {anchor!r}")
    src = src.replace(start, "  unsigned long long t_last = clock64();\n"
                      + start, 1)
    for anchor, phase in marks:
        stamp = ("if (threadIdx.x == 0) { const unsigned long long t = "
                 f"clock64(); atomicAdd(&g_phase_cycles[{phase}], "
                 "t - t_last); t_last = t; }\n")
        src = src.replace(anchor, stamp + anchor, 1)
    return src


# the persistent loop of gj_panel.cuh:solve_kernel, where the clock starts
PANEL_START = ("  for (long long sys = blockIdx.x; sys < batch; "
               "sys += gridDim.x) {")


def build() -> ctypes.CDLL:
    """Write the stamped copy of gj_panel.cuh and its launcher; build them."""
    src = stamped((CSRC / "gj_panel.cuh").read_text(), PANEL_START, MARKS,
                  "gj_panel.cuh")
    BUILD.mkdir(parents=True, exist_ok=True)
    (BUILD / "gj_panel_profiled.cuh").write_text(src)
    (BUILD / "launcher.cu").write_text(LAUNCHER)
    lib = BUILD / "libprofile_panel.so"
    nvcc = os.environ.get("CUDA_HOME", "/usr/local/cuda") + "/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", str(CSRC), "-o", str(lib),
                    str(BUILD / "launcher.cu")], check=True)
    cdll = ctypes.CDLL(str(lib))
    cdll.run.argtypes = [ctypes.c_int, ctypes.c_int,
                         ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                         ctypes.c_int, ctypes.c_double,
                         ctypes.POINTER(ctypes.c_int)]
    cdll.cycles.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    return cdll


def profile(lib: ctypes.CDLL, n: int, planes: int, dtype: torch.dtype,
            batch: int, seed: int) -> dict:
    """One shape: the plan, ms with the stamps on, each phase's share."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    # 2048 distinct systems, tiled to the batch (the kernel's time does not
    # depend on the values of well-conditioned systems)
    base = rng.standard_normal((min(batch, 2048), n, n)) + n * np.eye(n)
    reps = -(-batch // base.shape[0])
    A = torch.as_tensor(base, dtype=dtype, device=dev).repeat(reps, 1, 1)
    A = A[:batch].contiguous()
    Ai = (0.1 * A).contiguous()
    b = torch.ones((batch, n), dtype=dtype, device=dev)
    x0, x1 = torch.empty_like(b), torch.empty_like(b)
    valid = torch.empty((batch,), dtype=torch.bool, device=dev)
    dbl = int(dtype == torch.float64)
    thr = 1e-12 if planes == 1 else 1e-24
    plan = (ctypes.c_int * 3)()
    ptrs = (ctypes.c_void_p * 8)(A.data_ptr(), Ai.data_ptr(), b.data_ptr(),
                                 b.data_ptr(), x0.data_ptr(), x1.data_ptr(),
                                 valid.data_ptr(), None)
    if lib.run(dbl, planes, ptrs, batch, n, thr, plan) != 0:
        raise RuntimeError(f"N={n}: no panel plan fits")
    ws = None
    if plan[1]:
        ws = torch.empty((plan[2], planes, n, n + 1), dtype=dtype, device=dev)
    ptrs[7] = ws.data_ptr() if ws is not None else A.data_ptr()

    def launch():
        code = lib.run(dbl, planes, ptrs, batch, n, thr, plan)
        if code != 0:
            raise RuntimeError(f"N={n}: launch failed ({code})")

    launch()  # warm, and the counters of one run
    torch.cuda.synchronize()
    counts = (ctypes.c_ulonglong * 8)()
    lib.cycles(counts)
    total = sum(counts[i] for i in range(len(PHASES)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        launch()
    end.record()
    torch.cuda.synchronize()
    return {"n": n, "planes": planes, "dtype": str(dtype).split(".")[1],
            "systems": batch, "blocks_per_sm": plan[0],
            "place": PLACES[plan[1]],
            "ms_stamped": start.elapsed_time(end) / 3,
            "cycles_per_system": total / batch,
            "share": {p: counts[i] / total for i, p in enumerate(PHASES)}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/profile_torch_panel.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_panel: no CUDA device", file=sys.stderr)
        return 1
    lib = build()
    rows = []
    for n, planes, dtype, batch in SHAPES:
        row = profile(lib, n, planes, dtype, batch, args.seed)
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": smi, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
