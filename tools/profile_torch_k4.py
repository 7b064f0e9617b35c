"""K4, the complex inverse of ``.noise``, at the amplifier's noise shape.

Run on a CUDA card from the repo root: ``python3 tools/profile_torch_k4.py
[--root DIR] [--reps 200] [--rounds 5]``. Imports nothing of JAX.

``--root`` names the checkout whose ``spicey_tpu_torch`` is imported and
built (default: this one), so two trees can be timed in one process on
one card: run it once per tree, alternating, e.g. parent, change, change,
parent. The systems are the amplifier's (``decks.AMP_DECK``) 901 noise
planes at N = 11 at its operating point, in f64 as ``.noise`` runs them.

Per round it prints three times, each the mean over ``--reps`` calls:

  wrapper  CUDA events around back-to-back ``gj_inverse_planes_cuda``
           calls, what ``chip_smoke.py`` phase 9 reports: the kernel or
           the wrapper's host work (checks, allocations, the ctypes call),
           whichever is longer;
  launch   CUDA events around back-to-back calls of the C entry point
           with the outputs allocated once: the kernel, unless the ctypes
           call outlasts it;
  kernel   the device time of the kernel by ``torch.profiler`` (null when
           the profiler records none).

Then the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch


def _events_ms(fn, reps: int) -> float:
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


def _profiler_ms(fn, reps: int) -> float | None:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [getattr(e, "device_time_total", None)
             or getattr(e, "cuda_time_total", 0)
             for e in prof.key_averages() if "gj_complex_inv" in e.key]
    times = [x for x in times if x > 0]
    return sum(times) / reps / 1e3 if times else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_k4: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import spicey_tpu_torch as st
    from spicey_tpu_torch.analysis import noise as tnoise
    from spicey_tpu_torch.constants import EPS
    from spicey_tpu_torch.decks import AMP_DECK
    from spicey_tpu_torch.ops import gj
    from spicey_tpu_torch.ops._build import ptr, stream_ptr
    if not os.path.abspath(st.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {st.__file__}, not from {root}")

    dev = torch.device("cuda")
    ckt = st.parse_netlist(AMP_DECK, dialect="extended")
    t = st.build_tensors(ckt)
    op = st.simulate_op(ckt, tensors=t, device=dev)
    _f, planes, _e, _p, _n = tnoise.noise_system(ckt, t, op, dev)
    Ar, Ai = (p.contiguous() for p in planes[:2])
    nb, n = Ar.shape[0], Ar.shape[1]
    lib = gj.load_library()
    m_re, m_im = torch.empty_like(Ar), torch.empty_like(Ar)
    valid = torch.empty((nb,), dtype=torch.bool, device=dev)
    args_c = (ptr(Ar), ptr(Ai), ptr(m_re), ptr(m_im), ptr(valid),
              ctypes.c_void_p(0), nb, n, float(EPS), stream_ptr(dev))
    if hasattr(gj, "K4_TIERS"):  # K4 in tiers: name the one it chooses
        tier = gj.tier_for(n, Ar.dtype, inverse=True)
        args_c = args_c[:-1] + (gj.TIERS.index(tier), args_c[-1])

    def launch():
        code = lib.gj_complex_inverse_f64(*args_c)
        if code != 0:
            raise RuntimeError(f"K4 launch failed ({code})")

    def wrapper():
        gj.gj_inverse_planes_cuda(Ar, Ai)

    rounds = []
    for _ in range(args.rounds):
        rounds.append({"wrapper_ms": _events_ms(wrapper, args.reps),
                       "launch_ms": _events_ms(launch, args.reps),
                       "kernel_ms": _profiler_ms(launch, args.reps)})
        print(json.dumps({"root": root, "shape": [nb, n], **rounds[-1]}),
              flush=True)
    med = {k: statistics.median(r[k] for r in rounds)
           if all(r[k] is not None for r in rounds) else None
           for k in rounds[0]}
    print(json.dumps({"root": root, "shape": [nb, n], "median": med}),
          flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
