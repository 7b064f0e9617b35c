#!/usr/bin/env python3
"""A cell's traced run with the program's spans and counters on, joined
to the trace.

    python3 portbench/trace_spans.py --workload <cell> --seed <n> \
        [--spans 0|1]

runs ``run.py --trace 1`` of the cell unchanged (its set-up, its traced
jobs, its result line), which keeps the program's ``profiled()`` on for
exactly the profiler's window (``--spans 1``, the default; ``--spans 0``
leaves it off, to read what the spans cost), and takes the run's
readers' ``Context``: the trace's raw records, the program's spans and
counters, and their join (``core/spans.py``). On a machine without a
card (the CPU tests) the profiler records the host's operators instead
of CUDA activity.

After the run it prints on standard error, from that join, the table by
span:
host ms, device ms, launches, syncs and device idle ms per traced job;
how the largest idle gaps of the trace split by span; and what each
sync followed. The last line of standard output is JSON: ``workload``,
``seed``, ``spans``, the run's own result line under ``result``, the
readings of ``core/spans.py``'s ``READERS`` under ``readings``, and
under ``join`` the window, the busy and idle seconds, the idle put to
each span, the syncs per job the trace shows
(``cudaStreamSynchronize``), and the largest gaps split by span.

Exit codes as ``run.py``'s. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TOP_GAPS = 8


def one(workload: str, seed: int, spans_on: bool, **run_kw) -> dict:
    """One traced run of ``workload``; ``run_kw`` are ``run.main``'s
    ``device`` and ``variants`` (for the CPU tests)."""
    from portbench import run
    from portbench.core import spans

    seen = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", "1", "--trace", "1"], spans=spans_on,
                      inspect=lambda ctx, _edges: seen.update(ctx=ctx),
                      **run_kw)
    lines = buf.getvalue().strip().splitlines()
    if rc != 0 or not lines or "ctx" not in seen:
        raise SystemExit(rc or 5)
    result = json.loads(lines[-1])
    jobs = int(result["attempted"])
    ctx = seen["ctx"]
    recs, j, counters = ctx.records, ctx.join, ctx.program_counters
    readings = {name: reader(ctx.span_context)
                for name, (_src, _unit, reader) in spans.READERS.items()}
    rows = spans.table(j, jobs)
    syncs_trace = sum(1 for r in recs.runtime
                      if r[2] == "cudaStreamSynchronize")
    gaps = sorted(j.gap_split.items(), key=lambda kv: -sum(kv[1].values()))
    print(f"trace_spans: {workload} seed {seed} spans "
          f"{'on' if spans_on else 'off'}: {jobs} jobs, window "
          f"{j.window_s:.6f} s, busy {j.busy_s:.6f} s, idle "
          f"{j.idle_total_s:.6f} s\n{spans.format_table(rows)}",
          file=sys.stderr)
    for key, split in gaps[:TOP_GAPS]:
        parts = ", ".join(f"{q} {1e3 * s:.3f}" for q, s in
                          sorted(split.items(), key=lambda kv: -kv[1]))
        print(f"  gap {key}: {1e3 * sum(split.values()):.3f} ms = {parts}",
              file=sys.stderr)
    for label, kinds in sorted(j.sync_after.items()):
        print(f"  syncs in {label}, per job: " + ", ".join(
            f"after {k} {n / max(jobs, 1):g}" for k, n in sorted(
                kinds.items())), file=sys.stderr)
    print(f"  counters {counters}", file=sys.stderr)
    sys.stderr.flush()
    return {"workload": workload, "seed": seed, "spans": int(spans_on),
            "result": result, "readings": readings,
            "join": {"window_s": j.window_s, "busy_s": j.busy_s,
                     "idle_s": j.idle_total_s, "idle_by_span": j.idle_s,
                     "device_s_by_span": j.device_s,
                     "syncs_by_span": j.syncs,
                     "syncs_after": j.sync_after,
                     "launches_by_span": j.launches,
                     "stream_syncs_per_job": syncs_trace / max(jobs, 1),
                     "counters": counters,
                     "gaps": [[k, v] for k, v in gaps[:TOP_GAPS]],
                     "table": rows}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    print(json.dumps(one(args.workload, args.seed, bool(args.spans))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
