"""Where the time goes in the PyTorch/CUDA port's AC workloads.

Run on a CUDA card from the repo root: ``python3 tools/profile_torch_ac.py
[--seed 0] [--reps 5]``. For each workload it prints the warm wall time
(host clock around a call that ends in ``torch.cuda.synchronize()``;
median, min and max of ``--reps`` calls), then one call under
``torch.profiler``: the device time by kernel name (top entries), the
device busy time (the union of the kernels' and copies' intervals), the
idle share of that call's wall time, and the kernel launches and host
synchronizations of the call. The JSON record goes to ``--out``
(default ``build/profile_torch_ac.json``). Imports nothing of JAX.

Workloads: yield-1M (the RC deck, 1M variants x 201 frequencies, N = 3,
f32 and f64, plus the on-device-sampled f32 run), ladder-64 (N = 64,
2048 x 51, f32 and f64), basics01 (one circuit, f64), and the batched
AC with full solutions of ``chip_smoke.py`` phase 18: batch-ac-16k (the
N = 16 ladder, every R and C at U(0.9, 1.1) x nominal, 16,384 variants x
201 frequencies through K7) and batch-ladder-64 (ladder-64's systems
through K1, every unknown returned).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import spicey_tpu_torch as st  # noqa: E402
from spicey_tpu_torch.decks import rc_ladder_netlist  # noqa: E402

RC_NET = ("AC bench\nv1 1 0 dc 0 ac 1\nr1 1 2 30\nc1 2 0 100u\n"
          ".ac dec 100 1 100\n.end\n")
BASICS01 = ("Demo of a simple AC circuit\nv1 1 0 dc 0 ac 1\nr1 1 2 30\n"
            "c1 2 0 100u\n.ac dec 100 1 100\n.end\n")


def workloads(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    B = 1_000_000
    big = {"r1": 30.0 * (1 + 0.2 * rng.random(B)),
           "c1": 100e-6 * (1 + 0.2 * rng.random(B))}
    lad = {"r1": 101.0 * (1 + 0.2 * rng.random(2048))}
    ladder = rc_ladder_netlist(62)
    lad16 = rc_ladder_netlist(14, 201)
    t16 = st.build_tensors(st.parse_netlist(lad16))
    ac16 = {n: v * rng.uniform(0.9, 1.1, 16_384) for n, v in
            zip(t16.r_names + t16.c_names,
                np.concatenate([t16.r_vals, t16.c_vals]))}
    dev = "cuda"
    return {
        "yield-1M f32": lambda: st.mc_ac_stats(
            RC_NET, big, node="2", method="pallas", precision="f32",
            device=dev),
        "yield-1M f64": lambda: st.mc_ac_stats(
            RC_NET, big, node="2", method="pallas", precision="f64",
            device=dev),
        "yield-1M sampled f32": lambda: st.mc_ac_sampled(
            RC_NET, {"r1": 0.2, "c1": 0.2}, B, node="2", key=seed,
            method="pallas", precision="f32", device=dev),
        "ladder-64 f32": lambda: st.mc_ac_stats(
            ladder, lad, node="n62", method="pallas", precision="f32",
            device=dev),
        "ladder-64 f64": lambda: st.mc_ac_stats(
            ladder, lad, node="n62", method="pallas", precision="f64",
            device=dev),
        "basics01 f64": lambda: st.simulate(BASICS01, device=dev),
        "batch-ac-16k f64 K7": lambda: st.simulate_ac_batch(
            lad16, ac16, method="pallas", device=dev),
        "batch-ladder-64 f64 K1": lambda: st.simulate_ac_batch(
            ladder, lad, method="pallas", device=dev),
    }


def wall(fn, reps: int) -> list[float]:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def device_breakdown(fn, top: int) -> dict:
    """One call under the profiler: device time by kernel name, and the
    device busy time as the union of the kernels' and copies' intervals
    (a sum of per-op times would count a kernel once for itself and once
    for the aten op that launched it)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    on_device = [e for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
    by_name: dict[str, list[float]] = {}
    for e in on_device:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us() / 1e3
        acc[1] += 1
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in on_device)
    busy_us, cur_s, cur_e = 0.0, None, None
    for s_, e_ in spans:
        if cur_e is None or s_ > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    busy_ms = busy_us / 1e3
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / (wall_s * 1e3)),
            "top": [{"name": n[:90], "ms": v[0], "count": v[1]}
                    for n, v in rows[:top]]}


def host_counts(fn) -> dict:
    """Kernel launches and host synchronizations of one call, from the
    profiler's CPU-side events."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CPU]
    return {
        "launches": sum(n in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                              "cuLaunchKernel", "cuLaunchKernelEx")
                        for n in names),
        "syncs": sum(n in ("cudaStreamSynchronize",
                           "cudaDeviceSynchronize") for n in names),
        "d2h_copies": sum(n == "aten::_local_scalar_dense" for n in names),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="build/profile_torch_ac.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_ac: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    record = {"card": smi, "seed": args.seed, "reps": args.reps,
              "workloads": {}}
    for name, fn in workloads(args.seed).items():
        fn()  # warm: kernel builds, allocator, first launches
        times = wall(fn, args.reps)
        brk = device_breakdown(fn, top=8)
        counts = host_counts(fn)
        record["workloads"][name] = {
            "wall_s": {"median": statistics.median(times),
                       "min": min(times), "max": max(times),
                       "n": len(times)},
            "profiled": brk, "host": counts}
        print(f"{name}: wall median {statistics.median(times):.4f} s "
              f"(min {min(times):.4f}, max {max(times):.4f}, n "
              f"{len(times)}); profiled call {brk['wall_ms']:.1f} ms, "
              f"device busy {brk['device_busy_ms']:.1f} ms, idle "
              f"{brk['idle_share']:.1%}; {counts['launches']} launches, "
              f"{counts['syncs']} stream syncs, {counts['d2h_copies']} "
              "scalar reads", flush=True)
        for row in brk["top"]:
            print(f"    {row['ms']:9.3f} ms  x{row['count']:<4d} "
                  f"{row['name']}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
