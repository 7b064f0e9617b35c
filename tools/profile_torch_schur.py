"""The Schur tier's kernels and walls, and the time-parallel crossover, on the card.

Run on a CUDA card from the repo root: ``python3 tools/profile_torch_schur.py
[--check] [--times] [--crossover] [--reps 3] [--seed 0] [--out FILE]``.
Imports nothing of JAX.

``--check`` holds K1's and K2's multi-right-hand-side entry
(``ops/gj.py:gj_solve_planes_multi_cuda``, ``ops/gj_real.py:
gj_solve_multi_cuda``: the warp kernel ``gj_common.cuh:multi_solve_kernel``
up to N = 32, the panel tier at R right-hand sides from 33) to its plain
version (``ops/linsolve.py:gj_solve_planes_multi`` / ``gj_solve_multi``) in
every tier that takes N, f64 and f32, at every edge of N (1, 2, 3, 4, 16,
31, 32, 33, 64) and R (1, 7, 31, 32, 33, 131, 515) on 37 random systems
(A = randn + N I, B = randn) of which one is all zero, one has a NaN and
one a zero row: ``valid`` identical on every system, the values of the
valid ones within 1e-12 (f64) / 1e-5 (f32) of the plain version's largest
(``chip_smoke.py:check_close``). It exits nonzero on the first mismatch.

``--times`` times the multi entry at the Schur tier's block shapes
(``multi_shapes``: the ladder-64 and ladder-256 boards' AC block solves,
K x F systems of n = 4 with R = 1 + N_I columns, complex f64; the clamp
board's real Newton pass, and the real block solves of the factor-once
A^-1 with R = 1 + N + N_I), beside the plain version, ``torch.linalg.solve``
on the same batch and the bound (bytes: A and B read once, X and the flags
written once; operations: 2n^3/3 + 2n^2 R real, x4 complex), one JSON line
each.

``--crossover`` times ``mc_tran_stats`` of ``decks.tp_rlc_netlist`` (the
linear RLC of tests/test_mc.py:343, backward Euler) through the
time-parallel core and through the sequential loop at every S of
``--steps`` x B of ``--batches`` (default S in {201, 10k, 100k}, B in
{16, 1k, 16k}): host-clock walls of one warm call each, ending in
``torch.cuda.synchronize()`` (each route warmed once first), the loop /
tp ratio, and what the JAX package's guard (``timeparallel.worthwhile``,
crossover 32) picks there; a route whose peak memory would take more than
half the card (``route_bytes``) is not run in that cell.
``chip_smoke.py`` phase 25 (f) runs it (``crossover_sweep``).

Then the card's nvidia-smi name and power limit. Every line also goes to
``--out`` (default ``build/profile_torch_schur.json``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import bound, check_close, cuda_ms  # noqa: E402

CHECK_NS = (1, 2, 3, 4, 16, 31, 32, 33, 64)
CHECK_RS = (1, 7, 31, 32, 33, 131, 515)
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def multi_bound(nb: int, n: int, r: int, complex_: bool,
                dtype: torch.dtype) -> tuple[float, str]:
    """The least time for ``nb`` multi solves (``chip_smoke.py:bound``): A
    and B read once, X and the flags written once, against 2n^3/3 +
    2n^2 r real operations (x4 complex)."""
    el = torch.finfo(dtype).bits // 8
    planes = 2 if complex_ else 1
    return bound((4.0 if complex_ else 1.0) * nb * (2.0 * n ** 3 / 3.0
                                                    + 2.0 * n * n * r),
                 el * planes * nb * (n * n + 2 * n * r) + nb, dtype)


def random_systems(rng: np.random.Generator, nb: int, n: int, r: int,
                   complex_: bool, dtype: torch.dtype, dev) -> list:
    """A (nb, n, n) = randn + n I and B (nb, n, r) = randn per plane;
    system 0 all zero, system 1 a NaN, system 2 (n > 1) a zero row."""
    planes = [rng.standard_normal((nb, n, n)) + n * np.eye(n)]
    if complex_:
        planes.append(rng.standard_normal((nb, n, n)))
    rhs = [rng.standard_normal((nb, n, r)) for _ in planes]
    for A in planes:
        A[0] = 0.0
        if n > 1:
            A[2, n // 2] = 0.0
    planes[0][1, n - 1, 0] = np.nan
    return [torch.as_tensor(a, dtype=dtype, device=dev)
            for a in planes + rhs]


def check_multi(dev, seed: int = 0, emit=print) -> int:
    """Every tier of the multi entry against its plain version at every
    (N, R) edge; returns the number of cases, raising on a mismatch."""
    from spicey_tpu_torch.ops import gj, gj_real, linsolve

    rng = np.random.default_rng(seed)
    cases = 0
    for complex_ in (False, True):
        for dtype in (torch.float64, torch.float32):
            for n in CHECK_NS:
                for r in CHECK_RS:
                    ts = random_systems(rng, 37, n, r, complex_, dtype, dev)
                    if complex_:
                        want = linsolve.gj_solve_planes_multi(*ts)
                    else:
                        want = linsolve.gj_solve_multi(*ts)
                    pv = want[-1]
                    for tier in gj_real.MULTI_TIERS:
                        if tier == "multi" and n > gj.WARP_MAX_N:
                            continue
                        got = (gj.gj_solve_planes_multi_cuda(*ts, tier=tier)
                               if complex_ else
                               gj_real.gj_solve_multi_cuda(*ts, tier=tier))
                        what = (f"{'K1' if complex_ else 'K2'} multi {tier} "
                                f"n={n} r={r} {dtype}")
                        if not torch.equal(got[-1], pv):
                            raise AssertionError(f"{what}: valid differs")
                        for g, w in zip(got[:-1], want[:-1]):
                            check_close(g[pv], w[pv], TOL[dtype], what)
                        cases += 1
    emit(json.dumps({"check": "multi vs plain", "cases": cases,
                     "ns": CHECK_NS, "rs": CHECK_RS, "ok": True}))
    return cases


def multi_shapes() -> list[tuple[str, int, int, int, bool]]:
    """(label, systems, n, R, complex) of the multi entry on the Schur
    tier's main path: the plans of ``decks.schur_ladder_netlist(64)`` and
    ``(256)`` (N = 386 / 1538, blocks of 4, N_I = 130 / 514) at 241
    frequencies, one Newton pass of the clamp board (the 64-stage ladder
    with ``decks.SCHUR_CLAMP``), and the factor-once A^-1 of the 64-stage
    ladder as a linear transient (R = N + N_I)."""
    return [("ladder-64 ac (64 x 241, n=4, R=1+130)", 64 * 241, 4, 131,
             True),
            ("ladder-256 ac (256 x 241, n=4, R=1+514)", 256 * 241, 4, 515,
             True),
            ("clamp-64 newton (64, n=4, R=1+130)", 64, 4, 131, False),
            ("ladder-64 A^-1 (64, n=4, R=386+130)", 64, 4, 516, False)]


def time_multi(dev, reps: int, seed: int = 0, emit=print) -> dict:
    """The multi entry at ``multi_shapes``, beside the plain version,
    torch.linalg.solve and the bound; returns label -> times."""
    from spicey_tpu_torch.ops import gj, gj_real, linsolve

    rng = np.random.default_rng(seed)
    out = {}
    for label, nb, n, r, complex_ in multi_shapes():
        ts = random_systems(rng, nb, n, r, complex_, torch.float64, dev)
        ts[0][:3] = torch.eye(n, dtype=ts[0].dtype, device=dev) * n
        if complex_:
            kern = lambda: gj.gj_solve_planes_multi_cuda(*ts)  # noqa: E731
            plain = lambda: linsolve.gj_solve_planes_multi(*ts)  # noqa: E731
            Ac, Bc = torch.complex(ts[0], ts[1]), torch.complex(ts[2], ts[3])
            lib = lambda: torch.linalg.solve(Ac, Bc)  # noqa: E731
        else:
            kern = lambda: gj_real.gj_solve_multi_cuda(*ts)  # noqa: E731
            plain = lambda: linsolve.gj_solve_multi(*ts)  # noqa: E731
            lib = lambda: torch.linalg.solve(ts[0], ts[1])  # noqa: E731
        b_ms, b_by = multi_bound(nb, n, r, complex_, torch.float64)
        row = {"shape": label, "kernel_ms": cuda_ms(kern, reps),
               "plain_ms": cuda_ms(plain, max(1, reps // 3)),
               "library_ms": cuda_ms(lib, reps), "bound_ms": b_ms,
               "bound_by": b_by, "tier": gj_real.multi_tier_for(n),
               "device": smi()}
        emit(json.dumps(row))
        out[label] = row
        del ts
        torch.cuda.empty_cache()
    return out


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def route_bytes(route: str, nb: int, steps: int, k: int, m: int) -> float:
    """Device bytes a route of ``mc_tran_stats`` holds at its peak for the
    probed node: both hold the (B, S+1) response, a copy of it and the
    exact quantiles' sort (values and int64 indices), 5 x 8 (S+1) B; the
    time-parallel core besides the offsets R u and their doubling copy, a
    product and a sum ((B, k, S+1) each) and the (S+1, B, m) grid."""
    stats = 5.0 * 8.0 * (steps + 1) * nb
    if route == "loop":
        return stats
    return stats + 8.0 * (steps + 1) * nb * (4 * k + m)


def crossover_sweep(dev, steps=(201, 10_000, 100_000),
                    batches=(16, 1_000, 16_000), seed: int = 0,
                    emit=print, known: dict | None = None,
                    loop_max_steps: int | None = None) -> list[dict]:
    """tp against the sequential loop at every (S, B) of the grid, one
    call each (one warm call of each route first, at the smallest cell),
    with the JAX package's guard's pick. ``known`` maps (S, B) to walls
    already measured in this process ({"tp_s", "loop_s"}), not run again.
    A route whose peak (``route_bytes``) would take more than half the
    card is not run in that cell, nor the loop past ``loop_max_steps``
    steps (its wall then None)."""
    import spicey_tpu_torch as st
    from spicey_tpu_torch.analysis import timeparallel as tp
    from spicey_tpu_torch.decks import tp_rlc_netlist

    rng = np.random.default_rng(seed)
    half = torch.cuda.get_device_properties(dev).total_memory / 2.0
    known = known or {}
    rows = []

    def run(net, over, mode):
        return st.mc_tran_stats(net, over, node="b", dialect="extended",
                                time_parallel=mode, tp_crossover=1e12,
                                tp_mem_budget=1e15, device=dev)

    warm = {"R1": np.full(2, 100.0)}
    for mode in ("auto", "never"):
        run(tp_rlc_netlist("20u"), warm, mode)
    for s in steps:
        # a stop time just short of S steps of 0.2 us: S steps of ~0.2 us
        net = tp_rlc_netlist(f"{0.2 * s - 0.1:g}u")
        ckt = st.parse_netlist(net, dialect="extended")
        tensors = st.build_tensors(ckt)
        k, m = tensors.n_c + tensors.n_l, tensors.n_v + tensors.n_i
        for nb in batches:
            over = {"R1": 100.0 * (1 + 0.2 * rng.random(nb)),
                    "C1": 1e-6 * (1 + 0.2 * rng.random(nb))}
            walls = dict(known.get((s, nb), {}))
            for mode, key, route in (("auto", "tp_s", "tp"),
                                     ("never", "loop_s", "loop")):
                if key in walls:
                    continue
                if route_bytes(route, nb, s, k, m) > half or (
                        route == "loop" and loop_max_steps is not None
                        and s > loop_max_steps):
                    walls[key] = None
                    continue
                res, walls[key] = timed(lambda: run(net, over, mode))
                if res.n_valid != nb or len(res.grid) != s + 1:
                    raise AssertionError(f"crossover S={s} B={nb} {mode}: "
                                         f"{res.n_valid} valid, "
                                         f"{len(res.grid)} points")
                del res
                torch.cuda.empty_cache()
            row = {"steps": s, "batch": nb, **walls,
                   "loop_over_tp": (None if None in (walls["tp_s"],
                                                     walls["loop_s"])
                                    else walls["loop_s"] / walls["tp_s"]),
                   "tp_bytes": route_bytes("tp", nb, s, k, m),
                   "guard_picks_tp": tp.worthwhile(tensors, s, nb, 8,
                                                   device=dev),
                   "device": smi()}
            emit(json.dumps(row))
            rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--steps", type=int, nargs="*",
                    default=[201, 10_000, 100_000])
    ap.add_argument("--batches", type=int, nargs="*",
                    default=[16, 1_000, 16_000])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "profile_torch_schur.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_schur: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    lines = []

    def emit(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    if not (args.check or args.times or args.crossover):
        args.check = args.times = True
    if args.check:
        check_multi(dev, args.seed, emit)
    if args.times:
        time_multi(dev, args.reps, args.seed, emit)
    if args.crossover:
        crossover_sweep(dev, tuple(args.steps), tuple(args.batches),
                        args.seed, emit)
    emit(smi())
    Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
