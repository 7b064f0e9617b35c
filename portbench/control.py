#!/usr/bin/env python3
"""The readings that a cell's limits are set from, at the cell's own size.

    python3 portbench/control.py --workload <cell> \
        --program-seeds 1 2 ... 12 --control-seeds 21 22 23 \
        [--faults [NAME ...] --fault-seeds 31 32 33] [--out FILE]

For each program seed: one job of the cell (the first job that seed's
run would time), judged against the plain reference as a run judges it:
the lower readings. For each control seed: the plain reference computed
in the precision below the one the cell states (``control_dtype`` in
``workloads/<cell>.json``), put in the program's place and judged the
same way: the upper readings. For each fault and fault seed: one job
with the fault planted in the program, judged the same way: the faults
that the cell's entry declares (``entries/<entry>.py:FAULTS``,
``faults.py``), all of them where ``--faults`` names none. Prints one
JSON line per reading and a summary (the largest program reading, the
smallest control reading, the smallest reading of each fault, and the
cell's limits); ``--out`` writes them too. Runs on the card; the
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(workload: str, program_seeds: list[int],
             control_seeds: list[int], device=None,
             variants: int | None = None, faults: tuple[str, ...] = (),
             fault_seeds: tuple[int, ...] = (), home=None) -> dict:
    """``home``: the folder holding the cell's pieces
    (``core/manifest.py``), ``portbench/`` by default."""
    import torch

    import spicey_tpu_torch as program
    from portbench import faults as planted_faults
    from portbench.core import manifest, traffic

    cell = manifest.Cell(workload, home=home or manifest.HERE)
    spec, ref, caller = cell.spec, cell.reference, cell.caller.ENTRY
    device = torch.device(device or "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B = int(variants or spec["variants_per_job"])
    out = {"workload": workload, "variants": B, "program": [],
           "control": [], "faults": [], "limits": spec["limits"]}

    def draw(seed: int) -> dict:
        return traffic.Stream(cell.config, seed, B, device).job(0)

    def program_row(seed: int) -> dict:
        ov = draw(seed)
        ckt = program.parse_netlist(cell.deck_text, **cell.parse_kw)
        tensors = program.build_tensors(ckt)
        t0 = time.perf_counter()
        res = caller.call(program, ckt, tensors, ov, spec, device)
        numbers, info = caller.judge(res, tensors, ref, cell.deck_text, ov,
                                     spec, device)
        return {"seed": seed, **numbers, "info": info,
                "seconds": time.perf_counter() - t0}

    for seed in program_seeds:
        row = program_row(seed)
        out["program"].append(row)
        print(json.dumps({"program": row}), flush=True)
    for fault in faults:
        for seed in fault_seeds:
            with planted_faults.planted(spec, fault):
                row = {"fault": fault, **program_row(seed)}
            out["faults"].append(row)
            print(json.dumps({"fault": row}), flush=True)
    for seed in control_seeds:
        t0 = time.perf_counter()
        numbers = caller.control(ref, cell.deck_text, draw(seed), spec,
                                 device)
        row = {"seed": seed, **numbers, "seconds": time.perf_counter() - t0}
        out["control"].append(row)
        print(json.dumps({"control": row}), flush=True)
    for name in spec["limits"]:
        lower = max((r[name] for r in out["program"]), default=None)
        upper = min((r[name] for r in out["control"]), default=None)
        out[f"{name}_lower"], out[f"{name}_upper"] = lower, upper
        for fault in faults:
            out[f"{name}_{fault}"] = min(
                (r[name] for r in out["faults"] if r["fault"] == fault),
                default=None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=None,
                    help="faults of the cell's entry; none named: all")
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    faults = args.faults
    if faults == []:
        from portbench import faults as planted_faults
        from portbench.core import manifest
        faults = planted_faults.names(manifest.Cell(args.workload).spec)
    out = readings(args.workload, args.program_seeds, args.control_seeds,
                   faults=tuple(faults or ()),
                   fault_seeds=tuple(args.fault_seeds))
    summary = {k: v for k, v in out.items()
               if k not in ("program", "control", "faults")}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
