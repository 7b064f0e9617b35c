"""K3, the factor-once real inverse: its tiers at the main path's shapes, and its crossovers.

Run on a CUDA card from the repo root: ``python3 tools/profile_torch_k3.py
[--root DIR] [--shapes] [--sweep] [--ns 2 3 ... 33] [--reps 5] [--seed 0]
[--out FILE]``. Imports nothing of JAX.

``--root`` names the checkout whose ``spicey_tpu_torch`` is imported and
built (default: this one), so two trees can be timed on one card in one
call: run it once per tree, alternating (parent, change, change, parent).
A tree whose ``gj_inverse_cuda`` takes no ``tier`` is timed on its one
route (the row's tier is "route").

``--shapes`` (the default when neither mode is named) times K3 at the
four shapes where the main path inverts a transient's matrix once
(``analysis/tran.py``, through ``ops/linsolve.py:inverse``), each matrix
built as that path builds it (``chip_smoke.py:k3_shapes``,
``linear_system_matrix`` with backward Euler's companions):

  a. ``decks.TRAN_NET``, the tran-1M loop's RC deck: 1M variants, R1 and
     C1 at U(1, 1.2) x nominal, N = 3, f32 and f64;
  b. ``chip_smoke.py:tran_ladder(62)`` (``rc_ladder_netlist(62)`` under a
     pulse), the interconnect Monte-Carlo transient of
     ``mc_tran_stats(method="gj")``: 2048 variants, r1 at 101 x U(1,
     1.2), N = 64, f64;
  c. ``tran_ladder(127)``, one deck through ``simulate()``
     (``chip_smoke.py`` phase 21): B = 1, N = 129, f64;
  d. ``tran_ladder(254)``, flat-256's deck as a transient: 16 variants,
     r1 as in (b), N = 256, f64.

For each it prints one JSON line: the CUDA-event milliseconds of every
tier that can take N (the chosen one named), of the plain version
(``linsolve.gj_inverse``) and of ``torch.linalg.inv`` on the same tensor,
and the bound (``chip_smoke.py:bound``: the larger of the bytes, the
matrices read once and the inverses and flags written once, over the
card's memory rate, and ``inverse_flops`` over its peak for the type).

``--sweep`` times every tier that can take N on random systems (A =
randn + N I, ``--batch`` of them, by default ``sweep_batch``'s) at each N
of ``--ns``: the measurement behind the crossovers in ``ops/gj_real.py``.

``--walls`` times the entry points that reach K3 at those shapes, the
host clock around a call that ends in ``torch.cuda.synchronize()``
(median, min and max of ``--reps`` warm calls): ``mc_tran_stats`` of the
tran-1M loop (a, f32 and f64), of the ladder-64 Monte-Carlo transient (b)
and of flat-256 as a transient (d), ``simulate()`` of the N = 129
transient (c) and of the RC_PULSE fixture, and ``simulate_tran_batch`` of
(a)'s first 100k variants (``chip_smoke.py`` phase 19's RC 100k).

Then the card's nvidia-smi name and power limit. Every line also goes to
``--out`` (default ``build/profile_torch_k3.json``).
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import torch

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = (2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 24, 32, 33)


def walls(seed: int, reps: int, dev) -> list[dict]:
    """The wall times of the entry points that reach K3 (``--walls``)."""
    import statistics
    import time

    import spicey_tpu_torch as st
    from chip_smoke import tran_ladder
    from spicey_tpu_torch.decks import TRAN_NET
    from tests.fixtures.netlists import RC_PULSE
    rng = np.random.default_rng(seed)
    big = 1_000_000
    rc_over = {"R1": 1e3 * (1 + 0.2 * rng.random(big)),
               "C1": 1e-6 * (1 + 0.2 * rng.random(big))}
    r64 = {"r1": 101.0 * (1 + 0.2 * rng.random(2048))}
    r256 = {"r1": 101.0 * (1 + 0.2 * rng.random(16))}
    lad64, lad129, lad256 = (tran_ladder(s) for s in (62, 127, 254))
    cases = {
        "(a) tran-1M loop f32": lambda: st.mc_tran_stats(
            TRAN_NET, rc_over, node="2", method="gj", precision="f32",
            device=dev),
        "(a) tran-1M loop f64": lambda: st.mc_tran_stats(
            TRAN_NET, rc_over, node="2", method="gj", precision="f64",
            device=dev),
        "(a) batch-tran RC 100k": lambda: st.simulate_tran_batch(
            TRAN_NET, {k: v[:100_000] for k, v in rc_over.items()},
            device=dev),
        "(b) ladder-64 MC tran f64": lambda: st.mc_tran_stats(
            lad64, r64, node="n62", device=dev),
        "(c) N=129 simulate()": lambda: st.simulate(lad129, device=dev),
        "(d) flat-256 MC tran f64": lambda: st.mc_tran_stats(
            lad256, r256, node="n254", device=dev),
        "RC_PULSE simulate()": lambda: st.simulate(RC_PULSE, device=dev),
    }
    rows = []
    for label, fn in cases.items():
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        rows.append({"wall": label, "median_ms": statistics.median(times),
                     "min_ms": min(times), "max_ms": max(times)})
    return rows


def sweep_batch(n: int) -> int:
    """Systems per N in the sweep: the batch of the transient MC at small
    N, fewer where one system is large."""
    return 65536 if n <= 16 else (16384 if n <= 33 else 2048)


def tiers_of(gj_real, n: int) -> list[str]:
    """The tiers that can take N, or ["route"] for a tree without tiers."""
    if "tier" not in inspect.signature(gj_real.gj_inverse_cuda).parameters:
        return ["route"]
    return gj_real.inverse_tiers(n)


def time_k3(gj_real, A: torch.Tensor, reps: int) -> dict[str, float]:
    """CUDA-event ms of K3 on A in every tier that can take N."""
    from chip_smoke import cuda_ms
    out = {}
    for tier in tiers_of(gj_real, A.shape[1]):
        kw = {} if tier == "route" else {"tier": tier}
        first = cuda_ms(lambda: gj_real.gj_inverse_cuda(A, **kw), 1)
        n_reps = max(2, min(reps * 10, int(reps * 20 / max(first, 1e-3))))
        out[tier] = cuda_ms(lambda: gj_real.gj_inverse_cuda(A, **kw),
                            min(n_reps, 200))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=_HERE)
    ap.add_argument("--shapes", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--walls", action="store_true")
    ap.add_argument("--ns", type=int, nargs="+", default=list(NS))
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(_HERE, "build",
                                                  "profile_torch_k3.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_k3: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, _HERE)
    from chip_smoke import TAG, bound, cuda_ms, inverse_flops, k3_shapes
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import spicey_tpu_torch as st
    from spicey_tpu_torch.ops import gj_real, linsolve
    if not os.path.abspath(st.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {st.__file__}, not from {root}")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lines = []

    def emit(row: dict) -> None:
        line = json.dumps({"root": root, **row})
        lines.append(line)
        print(line, flush=True)

    def row_of(label, A, with_plain):
        nb, n, el = A.shape[0], A.shape[1], A.element_size()
        b_ms, b_by = bound(nb * inverse_flops(n), el * nb * 2 * n * n + nb,
                           A.dtype)
        row = {"shape": label, "dtype": TAG[A.dtype], "B": nb, "N": n,
               "tiers_ms": time_k3(gj_real, A, args.reps),
               "bound_ms": b_ms, "bound_by": b_by}
        if hasattr(gj_real, "inverse_tiers"):
            row["chosen"] = gj_real.tier_for(n, A.dtype, inverse=True)
        if with_plain:
            row["plain_ms"] = cuda_ms(lambda: linsolve.gj_inverse(A), 2)
            row["library_ms"] = cuda_ms(lambda: torch.linalg.inv(A), 5)
        return row

    if args.shapes or not (args.sweep or args.walls):
        for label, _dt, A in k3_shapes(args.seed, dev):
            emit(row_of(label, A, True))
            del A
            torch.cuda.empty_cache()
    if args.sweep:
        rng = np.random.default_rng(args.seed)
        for n in args.ns:
            nb = args.batch or sweep_batch(n)
            A64 = rng.standard_normal((nb, n, n)) + n * np.eye(n)
            for dtype in (torch.float32, torch.float64):
                A = torch.as_tensor(A64, dtype=dtype, device=dev)
                emit(row_of(f"sweep ({nb}, {n})", A, False))
                del A
            torch.cuda.empty_cache()
    if args.walls:
        for row in walls(args.seed, args.reps, dev):
            emit(row)
    print(smi, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as fh:
        fh.write("\n".join(lines + [json.dumps({"smi": smi})]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
