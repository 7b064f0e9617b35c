#!/usr/bin/env python3
"""The lanes that ``op_batch``'s batched Newton leaves invalid, job by job,
on the benchmark's own draws, and why each failed.

    python3 tools/op_lanes.py --workload ua741-step-f64 --seed <n> \
        [--jobs 60] [--variants N] [--max-iters 100] [--reference] \
        [--device cuda] [--out FILE]

For each job ``j`` of the seed (the inputs that ``portbench/run.py``
draws for its ``j``-th timed job), the batched Newton of ``op_batch``
alone, without its convergence aids, on the same inputs, with every pass
recorded: each lane's solve flag and iterate; then the cell's own
``op_batch`` call. A lane the batched Newton leaves invalid is put down
to its first failed solve (the pass, and the same lane's system solved
again by plain partial-pivoting Gauss-Jordan on the host, by K2's block
and panel tiers on the card, with the smallest pivot the host's
elimination met) or to the pass limit (the last steps' largest |dx|
over its tolerance). Then what the convergence ladder made of it, and
with ``--reference`` whether the plain reference solves every variant
of the job (and how far the program's answers lie from it). One JSON
line a job, and a summary; ``--out`` writes them too. Runs on the card
by default, ``--device cpu`` on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def host_pivots(A: np.ndarray) -> tuple[float, list[int]]:
    """Gauss-Jordan with column partial pivoting on the host: the smallest
    |pivot| met, and the pivot rows in order."""
    A = np.array(A, dtype=np.float64)
    n = A.shape[0]
    used = np.zeros(n, dtype=bool)
    smallest, rows = np.inf, []
    for k in range(n):
        cand = np.where(used, -1.0, np.abs(A[:, k]))
        p = int(np.argmax(cand))
        piv = A[p, k]
        smallest = min(smallest, abs(piv))
        rows.append(p)
        used[p] = True
        if piv == 0.0:
            continue
        f = A[:, k] / piv
        f[p] = 0.0
        A -= np.outer(f, A[p])
    return float(smallest), rows


class Recorder:
    """Wraps ``op.solve`` while the batched Newton runs alone: every
    pass's systems, flags and answers."""

    def __init__(self, op):
        self.op, self.solve = op, op.solve
        self.passes: list = []      # (A, b, x_new, ok) of each pass
        self.plain = None           # (x, valid, passes) on the host

    def __enter__(self):
        rec = self

        def solve(A, b, **kw):
            x, ok = rec.solve(A, b, **kw)
            rec.passes.append((A, b, x, ok))
            return x, ok

        self.op.solve = solve
        return self

    def __exit__(self, *exc):
        self.op.solve = self.solve
        return False


def newton_alone(op, ckt, tensors, overrides: dict, max_iters: int, device
                 ) -> tuple:
    """The batched Newton of ``op_batch`` without its convergence aids, on
    the same inputs: host (x, valid, passes)."""
    import torch

    from spicey_tpu_torch.analysis import batch

    B, dump = len(next(iter(overrides.values()))), tensors.nvar + tensors.n_l
    f64 = torch.float64

    def remapped(arrays):
        return {k: (torch.where(v == tensors.nvar, dump, v)
                    if k.endswith("idx") else v) for k, v in arrays.items()}

    return op._batched_op(
        ckt, tensors,
        batch._batch_values(tensors.v_dc, tensors.v_names, overrides, B),
        batch._batch_values(tensors.i_dc, tensors.i_names, overrides, B),
        batch._batch_values(tensors.r_vals, tensors.r_names, overrides, B),
        B, max_iters, op._tol_floor(1e-12), "gj", device,
        ext=remapped(batch._batched_ext(tensors, overrides, B, device, f64)),
        nl=remapped(batch._batched_nl(tensors, overrides, B, device, f64)))


def diagnose(rec: Recorder, lanes: np.ndarray, tol: float) -> list[dict]:
    """Why each of ``lanes`` failed in the recorded batched Newton."""
    import torch

    from spicey_tpu_torch.ops import gj_real, linsolve

    ok = torch.stack([p[3] for p in rec.passes]).cpu().numpy()   # (P, B)
    out = []
    for lane in lanes:
        row = {"lane": int(lane), "passes": int(rec.plain[2][lane])}
        bad = np.flatnonzero(~ok[:, lane])
        if len(bad):
            k = int(bad[0])
            A, b = rec.passes[k][0][lane], rec.passes[k][1][lane]
            smallest, _rows = host_pivots(A.cpu().numpy())
            _x, host_ok = linsolve.gj_solve(A.cpu()[None], b.cpu()[None])
            row.update(failed="pivot", at_pass=k + 1,
                       host_gj_valid=bool(host_ok[0]),
                       smallest_host_pivot=smallest,
                       cond=float(np.linalg.cond(A.cpu().numpy())))
            if A.is_cuda:
                for tier in ("block", "panel"):
                    _x, t_ok = gj_real.gj_solve_cuda(
                        A[None].contiguous(), b[None].contiguous(), tier=tier)
                    row[f"k2_{tier}_valid"] = bool(t_ok[0])
        else:
            xs = [p[2][lane] for p in rec.passes[-4:]]
            steps = [float(((xs[i + 1] - xs[i]).abs().max()
                            / (tol * (1 + xs[i + 1].abs().max()))).cpu())
                     for i in range(len(xs) - 1)]
            row.update(failed="pass limit", dx_over_tol_last=steps)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="ua741-step-f64")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--jobs", type=int, default=60)
    ap.add_argument("--variants", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-iters", type=int, default=100,
                    help="the batched Newton's pass limit (op_batch's)")
    ap.add_argument("--reference", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    import spicey_tpu_torch as program
    from portbench.core import manifest, traffic
    from spicey_tpu_torch.analysis import op

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    cell = manifest.Cell(args.workload)
    spec, ref = cell.spec, cell.reference
    B = int(args.variants or spec["variants_per_job"])
    stream = traffic.Stream(cell.config, args.seed, B, device)
    (name,) = cell.config["sweep"]["elements"]
    lines, totals = [], {"jobs": 0, "plain_invalid": 0, "rescued": 0,
                         "invalid": 0, "reference_unsolved": 0}
    for j in range(args.jobs):
        ov = stream.job(j)
        ckt = program.parse_netlist(cell.deck_text, **cell.parse_kw)
        tensors = program.build_tensors(ckt)
        with Recorder(op) as rec:
            rec.plain = newton_alone(op, ckt, tensors, ov, args.max_iters,
                                     device)
        res = program.op_batch(ckt, ov, tensors=tensors, device=device,
                               max_iters=args.max_iters, **spec["args"])
        x_p, valid_p, passes_p = rec.plain
        lanes = np.flatnonzero(~valid_p)
        line = {"job": j, "plain_invalid": len(lanes),
                "invalid": int((~np.asarray(res.valid)).sum()),
                "max_passes": int(passes_p.max()),
                "mean_passes": float(passes_p.mean()),
                "lanes": diagnose(rec, lanes, op._tol_floor(1e-12))}
        for row in line["lanes"]:
            row[name] = float(ov[name][row["lane"]])
            row["rescued"] = bool(res.valid[row["lane"]])
            row["passes_after_ladder"] = int(res.passes[row["lane"]])
        if args.reference:
            v, names, ok, info = ref.operating_points(
                cell.deck_text, ov, torch.float64, device)
            cols = [n.upper() for n in res.node_names]
            got = np.asarray(res.x)[:, [cols.index(n.upper())
                                        for n in names]]
            want = v.double().cpu().numpy()
            good = np.asarray(res.valid) & ok.cpu().numpy()
            line.update(reference_unsolved=int((~ok).sum()),
                        reference_info=info,
                        gap=float(np.abs(got[good] - want[good]).max()
                                  / np.abs(want).max()))
            totals["reference_unsolved"] += line["reference_unsolved"]
        totals["jobs"] += 1
        totals["plain_invalid"] += len(lanes)
        totals["rescued"] += sum(r["rescued"] for r in line["lanes"])
        totals["invalid"] += line["invalid"]
        lines.append(line)
        print(json.dumps(line), flush=True)
    print(json.dumps({"summary": totals}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines)
                                  + "\n" + json.dumps({"summary": totals})
                                  + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
