"""Where the time goes in the PyTorch/CUDA port's transient workloads.

Run on a CUDA card from the repo root: ``python3 tools/profile_torch_tran.py
[--seed 0] [--reps 5]``. For each workload it prints the warm wall time
(host clock around a call that ends in ``torch.cuda.synchronize()``;
median, min and max of ``--reps`` calls), then one call under
``torch.profiler``: the device time by kernel name (top entries), the
device busy time (the union of the kernels' and copies' intervals), the
idle share of that call's wall time, and the number of kernel launches
and of host synchronizations (``cudaStreamSynchronize`` and
device-to-host copies) in the call. The JSON record goes to ``--out``
(default ``build/profile_torch_tran.json``). Imports nothing of JAX.

Workloads: tran-1M (the RC-pulse deck of bench.py's transient MC, 1M
variants x 201 steps, R1 and C1 at U(1, 1.2) x nominal) at f32 through the
fused kernel K8, at f32 and f64 through the batched loop with the
factor-once inverse K3, and the on-device-sampled f32 run; boost-100k
(bench.py's boost converter, 100k variants x 101 steps, RR1 at U(1, 1.1)
x 1k) at f64 and f32, K2 on every Newton pass; two single decks on the
card, RC_PULSE (linear, K3) and DIODE_SWITCH (switch + diode, K2); and
the nonlinear Monte-Carlo of K9: the bench's MOSFET ring (bench.py:
646-661, c1 and c2 at U(1, 1.1) x 1 nF) at 4096 variants through K9 and
through the f64 loop, and at 100k through K9; the bench's switch_diode
boost (100k, RR1 at U(1, 1.1) x 1k) through K9 on its 1 ms grid and on
DIODE_SWITCH's 10 us grid; BJT_NET with Q1's Is at U(1, 1.2) x 1e-15,
100k through K9; the bench's ring latency deck through simulate(); and
batch-tran-boost-100k, the boost-100k variants' full trajectories
through ``simulate_tran_batch`` (``chip_smoke.py`` phase 19, K2 every
Newton pass).
The decks are ``spicey_tpu_torch/decks.py``'s, as in ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import spicey_tpu_torch as st  # noqa: E402
from spicey_tpu_torch.decks import (BJT_NET, BOOST_FINE,  # noqa: E402
                                    BOOST_NET, RING_DECK, RING_NET,
                                    TRAN_NET)
from profile_torch_ac import device_breakdown, host_counts, wall  # noqa: E402
from tests.fixtures import netlists  # noqa: E402


def workloads(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    B = 1_000_000
    tran = {"R1": 1e3 * (1 + 0.2 * rng.random(B)),
            "C1": 1e-6 * (1 + 0.2 * rng.random(B))}
    boost = {"RR1": 1e3 * (1 + 0.1 * rng.random(100_000))}
    ring = {"c1": 1e-9 * (1 + 0.1 * rng.random(100_000)),
            "c2": 1e-9 * (1 + 0.1 * rng.random(100_000))}
    ring4k = {k: v[:4096] for k, v in ring.items()}
    bjt = {"Q1": 1e-15 * (1 + 0.2 * rng.random(100_000))}
    k9 = dict(method="pallas", precision="f32", device="cuda")
    dev = "cuda"
    return {
        "tran-1M f32 K8": lambda: st.mc_tran_stats(
            TRAN_NET, tran, node="2", method="pallas", precision="f32",
            device=dev),
        "tran-1M f32 loop": lambda: st.mc_tran_stats(
            TRAN_NET, tran, node="2", method="gj", precision="f32",
            device=dev),
        "tran-1M f64 loop": lambda: st.mc_tran_stats(
            TRAN_NET, tran, node="2", method="pallas", precision="f64",
            device=dev),
        "tran-1M sampled f32 K8": lambda: st.mc_tran_sampled(
            TRAN_NET, {"R1": 0.2, "C1": 0.2}, B, node="2", key=seed,
            method="pallas", precision="f32", device=dev),
        "boost-100k f64": lambda: st.mc_tran_stats(
            BOOST_NET, boost, node="N3", precision="f64", device=dev),
        "boost-100k f32": lambda: st.mc_tran_stats(
            BOOST_NET, boost, node="N3", precision="f32", device=dev),
        "RC_PULSE f64 (simulate)": lambda: st.simulate(
            netlists.RC_PULSE, device=dev),
        "DIODE_SWITCH f64 (simulate)": lambda: st.simulate(
            netlists.DIODE_SWITCH, device=dev),
        "ring-4096 f32 K9": lambda: st.mc_tran_stats(
            RING_NET, ring4k, node="n1", dialect="extended", **k9),
        "ring-4096 f64 loop": lambda: st.mc_tran_stats(
            RING_NET, ring4k, node="n1", dialect="extended", device=dev),
        "ring-100k f32 K9": lambda: st.mc_tran_stats(
            RING_NET, ring, node="n1", dialect="extended", **k9),
        "switch-diode-100k f32 K9": lambda: st.mc_tran_stats(
            BOOST_NET, boost, node="N3", **k9),
        "switch-diode-100k 10us grid f32 K9": lambda: st.mc_tran_stats(
            BOOST_FINE, boost, node="N3", **k9),
        "bjt-100k f32 K9": lambda: st.mc_tran_stats(
            BJT_NET, bjt, node="c1", dialect="extended", **k9),
        "ring_deck f64 (simulate)": lambda: st.simulate(
            RING_DECK, dialect="extended", device=dev),
        "batch-tran-boost-100k f64": lambda: st.simulate_tran_batch(
            BOOST_NET, boost, device=dev),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="build/profile_torch_tran.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_tran: no CUDA device", file=sys.stderr)
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
            print(f"    {row['ms']:9.3f} ms  x{row['count']:<5d} "
                  f"{row['name']}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
