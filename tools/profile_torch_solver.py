"""The port's solver-throughput sweep: K1/K2 against K10a/K10b and torch.linalg.solve.

Run on a CUDA card from the repo root: ``python3 tools/profile_torch_solver.py
[--seed 0] [--reps 3] [--ns 8 16 32 64 128] [--tiers]``. Imports nothing of
JAX.
The port's copy of ``bench.py:804-847`` at the bench's shapes: for each N
the RC ladder ``rc_ladder_netlist(N - 2)`` (N unknowns, 51 frequencies)
with SB = 2048 variants (1024 at N = 128) and r1 at 101 x U(1, 1.2). It
prints one JSON line per N, then the card's ``nvidia-smi`` name and power
limit, and writes every line to ``--out`` (default
``build/profile_torch_solver.json``):

  - ``mc_ac_stats``: the wall time (host clock around a call ending in a
    synchronize, median of ``--reps``) and complex systems per second of
    ``mc_ac_stats(method="gj")`` through K1, in f32 and f64 (the bench's
    ``pallas_f32`` and ``gj_f64`` columns; the bench's chunks);
  - ``solvers``: on the planes that route assembles (SB x 51 systems,
    ``analysis/ac.py:_assemble_grid``), the CUDA-event milliseconds and
    systems per second of K1 (``linsolve.solve_planes``, in the tier
    ``ops/gj.py:tier_for`` chooses, named in the row; with ``--tiers``
    also each tier of K1 and K2 forced, rows "K1 warp", "K2 thread", ...),
    K10b
    (``mxu.mxu_solve_complex``, N >= 40) and ``torch.linalg.solve`` on the
    complex planes; and of K2 (``linsolve.solve``), K10a
    (``mxu.mxu_solve_real``) and ``torch.linalg.solve`` on their real part
    (the ladder's conductances with the source's branch rows,
    nonsingular); each beside its bound (``chip_smoke.py``'s
    ``solve_flops`` and ``bound``: the cheapest direct method's operations
    at the card's peak for the type, or the bytes read once and written
    once at its memory rate, whichever is longer), and the largest
    difference of K10's answer from K1's (K2's) over the largest |x|.

It routes nothing: ``ops/mxu.py`` stays on no analysis path.
``chip_smoke.py`` phase 22 runs ``sweep`` at N = 64 and 128.
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import spicey_tpu_torch as st  # noqa: E402
from chip_smoke import bound, cuda_ms, solve_flops  # noqa: E402
from spicey_tpu_torch.analysis import ac as tac  # noqa: E402
from spicey_tpu_torch.analysis import batch as tbatch  # noqa: E402
from spicey_tpu_torch.decks import rc_ladder_netlist  # noqa: E402
from spicey_tpu_torch.ops import gj, gj_real, linsolve, mxu  # noqa: E402

NS = (8, 16, 32, 64, 128)
F32, F64 = torch.float32, torch.float64


def assemble_planes(net: str, overrides: dict, B: int, dtype: torch.dtype,
                    dev: torch.device | str, dialect: str = "spicey"
                    ) -> list[torch.Tensor]:
    """The planes the K1 route assembles for ``net`` under ``overrides``
    (B variants), flattened to (B*F, N, N) and (B*F, N) as K1 takes them:
    [A_re, A_im, b_re, b_im]."""
    ckt = st.parse_netlist(net, dialect=dialect)
    t = st.build_tensors(ckt)
    freqs = tac.build_frequency_array(ckt.ac.mode, ckt.ac.N, ckt.ac.f1,
                                      ckt.ac.f2)
    v_idx, v_re, v_im = tac.ac_vsource_arrays(ckt, t)

    def vals(base, names):
        return torch.as_tensor(tbatch._batch_values(base, names, overrides,
                                                    B), dtype=dtype,
                               device=dev)

    iph = np.deg2rad(t.i_ac_phase_deg)
    planes = tac._assemble_grid(
        torch.as_tensor(freqs, dtype=dtype, device=dev),
        tac.index_tensor(t.r_idx, dev), vals(t.r_vals, t.r_names),
        tac.index_tensor(t.c_idx, dev), vals(t.c_vals, t.c_names),
        tac.index_tensor(t.l_idx, dev), vals(t.l_vals, t.l_names),
        tac.index_tensor(v_idx, dev),
        torch.as_tensor(v_re, dtype=dtype, device=dev).expand(B, -1),
        torch.as_tensor(v_im, dtype=dtype, device=dev).expand(B, -1),
        t.nvar, ext=tbatch._batched_ext(t, overrides, B, dev, dtype),
        i_re=torch.as_tensor(t.i_ac_mag * np.cos(iph), dtype=dtype,
                             device=dev),
        i_im=torch.as_tensor(t.i_ac_mag * np.sin(iph), dtype=dtype,
                             device=dev))
    return [p.reshape((-1,) + p.shape[2:]).contiguous() for p in planes]


def _wall_s(fn, reps: int) -> float:
    """Median host seconds of ``reps`` warm calls ending in a synchronize."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def _rel_diff(got: tuple, ref: tuple) -> float:
    """max |got - ref| over max |ref|, across the planes of x."""
    scale = max(float(r.abs().max()) for r in ref)
    return max(float((g - r).abs().max()) for g, r in zip(got, ref)) / scale


def _solver_row(name, fn, reps, nb, n, cplx, nbytes, dtype) -> dict:
    ms = cuda_ms(fn, reps)
    b_ms, b_by = bound(nb * solve_flops(n, cplx), nbytes, dtype)
    return {"name": name, "ms": ms, "systems_per_s": nb / (ms / 1e3),
            "bound_ms": b_ms, "bound_by": b_by}


def _tier_rows(module, label: str, fn, reps, nb, n, cplx, nbytes, dtype
               ) -> list[dict]:
    """One row per tier of ``module`` (gj: K1, gj_real: K2) that can take
    N, forced through the wrapper: "K1 warp", "K1 block", ..."""
    rows = []
    for tier in module.TIERS:
        if (tier == "warp" and n > module.WARP_MAX_N) or (
                tier == "thread" and n > gj_real.THREAD_MAX_N):
            continue
        rows.append(_solver_row(f"{label} {tier}",
                                lambda t=tier: fn(t), reps, nb, n, cplx,
                                nbytes, dtype))
        torch.cuda.empty_cache()
    return rows


def sweep(ns=NS, reps: int = 3, seed: int = 0, dev="cuda", emit=print,
          tiers: bool = False) -> list[dict]:
    """Run the sweep at each N of ``ns``; ``emit`` each row's JSON line.
    ``tiers``: also time every tier of K1 and K2 forced, one row each."""
    rng = np.random.default_rng(seed)
    rows = []
    for n in ns:
        # the bench's sizes and chunks (bench.py:809-829): at N = 128 the
        # full-batch f64 planes and K1's workspace take ~28 GB
        SB = 1024 if n == 128 else 2048
        f32_chunk = 512 if n == 128 else None
        f64_chunk = 256 if n == 128 else 1024
        net = rc_ladder_netlist(n - 2)
        over = {"r1": 101.0 * (1 + 0.2 * rng.random(SB))}
        node = f"n{n - 2}"
        row = {"n": n, "variants": SB, "mc_ac_stats": {}, "solvers": {}}
        for label, prec, chunk in (("pallas_f32", "f32", f32_chunk),
                                   ("gj_f64", "f64", f64_chunk)):
            s = st.mc_ac_stats(net, over, node=node, method="gj",
                               precision=prec, chunk=chunk, device=dev)
            if s.n_valid != SB:
                raise AssertionError(f"N={n} {label}: n_valid {s.n_valid}")
            wall = _wall_s(lambda: st.mc_ac_stats(
                net, over, node=node, method="gj", precision=prec,
                chunk=chunk, device=dev), reps)
            F = len(s.grid)
            row["mc_ac_stats"][label] = {
                "wall_s": wall, "systems_per_s": SB * F / wall}
        for dtype in (F32, F64):
            tag = "f32" if dtype == F32 else "f64"
            planes = assemble_planes(net, over, SB, dtype, dev)
            Ar, Ai, br, bi = planes
            nb, el = Ar.shape[0], Ar.element_size()
            cbytes = el * nb * (2 * n * n + 4 * n) + nb
            rbytes = el * nb * (n * n + 2 * n) + nb
            out = []
            k1 = linsolve.solve_planes(*planes)
            if not k1[2].all():
                raise AssertionError(f"N={n} {tag}: K1 flags a system")
            out.append(_solver_row("K1", lambda: linsolve.solve_planes(
                *planes), reps, nb, n, True, cbytes, dtype))
            out[-1]["tier"] = gj.tier_for(n, dtype)
            if tiers:
                out += _tier_rows(
                    gj, "K1", lambda t: gj.gj_solve_planes_cuda(*planes,
                                                                tier=t),
                    reps, nb, n, True, cbytes, dtype)
            k10 = {}
            if n >= mxu.MXU_MIN_N:
                got = mxu.mxu_solve_complex(*planes)
                if not torch.equal(got[2], k1[2]):
                    raise AssertionError(f"N={n} {tag}: K10b valid differs")
                k10["K10b_vs_K1"] = _rel_diff(got[:2], k1[:2])
                del got
                out.append(_solver_row(
                    "K10b", lambda: mxu.mxu_solve_complex(*planes), reps, nb,
                    n, True, cbytes, dtype))
            torch.cuda.empty_cache()
            Ac, bc = torch.complex(Ar, Ai), torch.complex(br, bi)
            out.append(_solver_row(
                f"linalg.solve {Ac.dtype}".replace("torch.", ""),
                lambda: torch.linalg.solve(Ac, bc), reps, nb, n, True,
                cbytes, dtype))
            del Ac, bc, k1
            torch.cuda.empty_cache()
            k2 = linsolve.solve(Ar, br)
            if not k2[1].all():
                raise AssertionError(f"N={n} {tag}: K2 flags a system")
            out.append(_solver_row("K2", lambda: linsolve.solve(Ar, br),
                                   reps, nb, n, False, rbytes, dtype))
            out[-1]["tier"] = gj_real.tier_for(n, dtype)
            if tiers:
                out += _tier_rows(
                    gj_real, "K2", lambda t: gj_real.gj_solve_cuda(
                        Ar, br, tier=t), reps, nb, n, False, rbytes, dtype)
            if n >= mxu.MXU_MIN_N:
                got = mxu.mxu_solve_real(Ar, br)
                if not torch.equal(got[1], k2[1]):
                    raise AssertionError(f"N={n} {tag}: K10a valid differs")
                k10["K10a_vs_K2"] = _rel_diff(got[:1], k2[:1])
                out.append(_solver_row(
                    "K10a", lambda: mxu.mxu_solve_real(Ar, br), reps, nb, n,
                    False, rbytes, dtype))
            out.append(_solver_row(
                f"linalg.solve {Ar.dtype}".replace("torch.", ""),
                lambda: torch.linalg.solve(Ar, br), reps, nb, n, False,
                rbytes, dtype))
            row["solvers"][tag] = {"systems": nb, "rows": out, **k10}
            del planes, Ar, Ai, br, bi, k2
            torch.cuda.empty_cache()
        emit(json.dumps(row))
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ns", type=int, nargs="+", default=list(NS))
    ap.add_argument("--out", default="build/profile_torch_solver.json")
    ap.add_argument("--tiers", action="store_true",
                    help="also time every tier of K1 and K2 at each N (the "
                    "run that sets ops/gj.py's and ops/gj_real.py's "
                    "crossovers)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_solver: no CUDA device", file=sys.stderr)
        return 1
    rows = sweep(args.ns, args.reps, args.seed, "cuda",
                 emit=lambda line: print(line, flush=True), tiers=args.tiers)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": smi, "seed": args.seed, "reps": args.reps,
                   "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
