"""Where the time goes in the PyTorch/CUDA port's operating-point workloads.

Run on a CUDA card from the repo root: ``python3 tools/profile_torch_op.py
[--seed 0] [--reps 5]``. For each workload it prints the warm wall time
(host clock around a call that ends in ``torch.cuda.synchronize()``;
median, min and max of ``--reps`` calls), then one call under
``torch.profiler``: the device time by kernel name (top entries), the
device busy time, the idle share of that call's wall time, and the kernel
launches and host synchronizations of the call (as in
``tools/profile_torch_tran.py``). The JSON record goes to ``--out``
(default ``build/profile_torch_op.json``). Imports nothing of JAX.

Workloads (the decks are ``spicey_tpu_torch/decks.py``'s, as in
``chip_smoke.py`` phases 14-17): the bench's op/dc/tf deck through
simulate() (K2 every Newton pass); dc-2d-25k, the MOSFET output
characteristics as one 2D .dc of 25,551 points (K2); op-batch-100k,
BJT_NET's bias at VIN = 0.65 V with Q1's Is at U(1, 1.2) x 1e-15 over
100k variants (K2); the two-stage amplifier through simulate() (.op, .tf
with K2, .options acop .ac with K1, .noise with K4, 901 frequencies); and
ladder-64 noise (N = 64, 901 frequencies, K4).
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import spicey_tpu_torch as st  # noqa: E402
from spicey_tpu_torch.decks import (AMP_DECK, BJT_NET,  # noqa: E402
                                    LADDER_NOISE, MOS_IV_DECK, OPDCTF_DECK)
from profile_torch_ac import device_breakdown, host_counts, wall  # noqa: E402


def workloads(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    B = 100_000
    ob = {"Q1": 1e-15 * (1 + 0.2 * rng.random(B)), "VIN": np.full(B, 0.65)}
    dev = "cuda"
    ext = dict(dialect="extended", device=dev)
    return {
        "opdctf simulate": lambda: st.simulate(OPDCTF_DECK, **ext),
        "dc-2d-25k": lambda: st.simulate(MOS_IV_DECK, **ext),
        "op-batch-100k": lambda: st.op_batch(BJT_NET, ob, **ext),
        "amp simulate (op/tf/acop ac/noise)": lambda: st.simulate(AMP_DECK,
                                                                  **ext),
        "ladder-64 noise": lambda: st.simulate(LADDER_NOISE, **ext),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="build/profile_torch_op.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_op: no CUDA device", file=sys.stderr)
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
