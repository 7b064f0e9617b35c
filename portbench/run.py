#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout holding ``BENCHMARK.json``, this folder and
``spicey_tpu_torch``, on a machine with the CUDA cards the cell asks for.

A cell is a configuration (``configs/<config>.json``: a deck and the
elements it sweeps) and a traffic mix (``workloads/<cell>.json``: the
entry point of the program, its arguments, how many variants a job
holds). A job is one user call of that entry on
a fresh draw of variants; jobs run one at a time (a closed loop with one
client), each timed from the call to its results on the host, including
the program's front end (``parse_netlist`` and ``build_tensors``).

Set-up (``setup_s``, from the process's start to the first timed job):
import, the CUDA context, one warm job of the cell's own shapes on a
draw of its own.

``--trace 0``: jobs run for ``--seconds`` (whole jobs only), each on
inputs drawn from the seed just before it (``core/traffic.py``); the
end-to-end metrics are the rate of solutions over the window (first
job's start to last job's end, less the draws between jobs) and the
tail of the job times. ``--trace 1``: a few whole jobs, drawn in
set-up, run under ``torch.profiler`` with the program's spans and
counters on (``profiling.profiled()``) for exactly the profiler's
window, and the per-layer metrics (``metrics/<name>.py``) are read from
that trace, those spans and those counters (``Context``).

After the window a sample of the jobs, drawn from the seed, is judged
against the plain reference (``reference/<config>.py``); each number
compared is printed beside its limit, last on standard error and last
in the result line. The last line of standard output is the result:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, (traced)
``breakdown``, and ``checks``.

Exit codes: 0 with a result; 2 bad arguments; 3 no card (or too few);
4 JAX or the JAX package found loaded; 5 the program or a piece of the
cell missing. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "spicey_tpu")
# every kernel and build cache of the program and of PyTorch, inside the
# checkout at fixed paths (the program's own nvcc builds are
# build/spicey_tpu_torch/, fixed in its code)
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "cuda"}
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def process_start() -> float:
    """The epoch time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            boot = next(int(line.split()[1]) for line in fh
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


T_START = process_start()


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


@dataclass
class Job:
    index: int
    t0: float
    t_end: float = 0.0
    front_s: float = 0.0
    solutions: int = 0
    failed: bool = False
    error: str = ""


@dataclass
class Context:
    """What a per-layer metric's reader gets (``metrics/<name>.py``): the
    traced jobs and window, the trace's reduction (``core/trace.py``),
    the harness's front-end times, the program's launch counters
    (``core/counters.py``), the shapes (``_shape``) and what the
    reference counted (``info``); and the program's spans over the
    window (``spans``: qualified name, start_ns, end_ns), the program's
    counters over it (``program_counters``), the trace's raw records
    (``records``) and their join to the spans (``join``;
    ``core/spans.py``)."""
    jobs: int
    window_s: float
    trace: object
    front_end_s: list[float]
    counters: dict[str, int]
    shape: dict
    info: dict = field(default_factory=dict)
    spans: list = field(default_factory=list)
    program_counters: dict = field(default_factory=dict)
    records: object = None
    join: object = None

    def work(self, kernel: str):
        from portbench.core import manifest
        return manifest.module("work", kernel)

    @property
    def span_context(self):
        """The spans' and counters' readers' view (``core/spans.py``)."""
        if self.join is None:
            return None
        from portbench.core.spans import SpanContext
        return SpanContext(jobs=self.jobs, join=self.join,
                           counters=self.program_counters)


class Reservoir:
    """A uniform sample of ``k`` jobs of the stream, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device=None, variants: int | None = None,
         home: Path | None = None, spans: bool = True,
         inspect=None) -> int:
    """Run the cell. ``device`` and ``variants`` are for the CPU tests: a
    device other than the card skips the look for one, and ``variants``
    cuts a job's size. ``home``: the folder holding the cell's pieces
    (``core/manifest.py``; ``portbench/``, the default, for the cells of
    BENCHMARK.json). With ``--trace 1``: ``spans`` False leaves the
    program's spans off (to read what they cost), and ``inspect`` is
    called with the readers' ``Context`` and the window's edges on
    ``time.time_ns()``'s clock (``trace_spans.py``)."""
    args = parse(argv)
    from portbench.core import manifest
    try:
        cell = manifest.Cell(args.workload, home=home or manifest.HERE)
    except (KeyError, FileNotFoundError) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 5
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    # one host thread: a pool of OpenMP threads on a host shared with
    # other machines made the host-bound jobs' times swing by 1.5x
    # between runs and double the tail within one
    for var in THREAD_VARS:
        os.environ[var] = "1"
    import torch
    torch.set_num_threads(1)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"portbench: {args.workload} needs {cell.chips} CUDA "
                  f"card(s), this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(0)
        print(f"portbench: {kind} x {torch.cuda.device_count()}, "
              f"nvidia-smi: {card_line()}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}", file=sys.stderr, flush=True)
    else:
        device = torch.device(device)
        kind = str(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        import spicey_tpu_torch as program
        from portbench.core import counters, traffic, trace
        from portbench.core import spans as span_join
        ref = cell.reference
        caller = cell.caller.ENTRY
    except (ImportError, FileNotFoundError) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 5

    spec = cell.spec
    B = int(variants or spec["variants_per_job"])
    # the card's context first, so that it is not counted in any job
    if device.type == "cuda":
        program.warmup(device=device)
    stream = traffic.Stream(cell.config, args.seed, B, device)
    warm = stream.job(traffic.WARM)
    # the traced run's few jobs are drawn here, so that no draw is traced
    pool = ([stream.job(j) for j in range(int(spec["trace_jobs_max"]))]
            if args.trace else None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def run_job(j: int, overrides: dict) -> tuple[Job, object, object]:
        job = Job(j, time.perf_counter())
        res = tensors = None
        try:
            ckt = program.parse_netlist(cell.deck_text, **cell.parse_kw)
            tensors = program.build_tensors(ckt)
            job.front_s = time.perf_counter() - job.t0
            res = caller.call(program, ckt, tensors, overrides, spec, device)
            job.t_end = time.perf_counter()
            job.failed = caller.invalid(res, B) > 0
            job.solutions = 0 if job.failed else B * caller.points(res)
        except Exception as exc:  # a job that raised is a failed job
            job.t_end = time.perf_counter()
            job.failed, job.error = True, f"{type(exc).__name__}: {exc}"
        return job, res, tensors

    warm_job, _r, _t = run_job(-1, warm)
    del warm, _r, _t
    if warm_job.error:
        print(f"portbench: the warm job raised {warm_job.error}",
              file=sys.stderr)
    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        from spicey_tpu_torch.utils import profiling
        # the card's activity; on a machine without one (the CPU tests)
        # the host's operators instead
        activities = [ProfilerActivity.CUDA if device.type == "cuda"
                      else ProfilerActivity.CPU]
        # CUPTI's first start costs seconds: pay it here, not in a job
        with profile(activities=activities):
            torch.zeros(1, device=device).add_(1)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - T_START

    jobs: list[Job] = []
    sample = Reservoir(int(spec["sample_jobs"]), args.seed)
    before = counters.snapshot()
    if args.trace:
        prof = profile(activities=activities)
        prof.__enter__()
        program_spans = (profiling.profiled() if spans
                         else contextlib.nullcontext())
        program_spans.__enter__()
        t_ns0 = time.time_ns()
    # the window: whole jobs until ``limit_s`` of it have passed. Untraced,
    # each job's inputs are drawn just before it; the draws are the
    # harness's time, not the program's, and are left out of the window.
    limit_s = float(spec["trace_seconds"]) if args.trace else args.seconds
    drawing_s = 0.0
    t_w0 = time.perf_counter()
    j = 0
    while not jobs or time.perf_counter() - t_w0 - drawing_s < limit_s:
        if pool is not None:
            if j == len(pool):
                break
            overrides = pool[j]
        else:
            t_d = time.perf_counter()
            overrides = stream.job(j)
            if jobs:
                drawing_s += time.perf_counter() - t_d
            else:
                t_w0 = time.perf_counter()
        job, res, tensors = run_job(j, overrides)
        jobs.append(job)
        sample.offer((job, res, tensors, overrides))
        del res, tensors, overrides
        j += 1
    if prof is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        edges = (t_ns0, time.time_ns())
        program_spans.__exit__(None, None, None)
        intervals, program_counters = (
            span_join.program_readings(profiling) if spans else ([], {}))
        prof.__exit__(None, None, None)
    used = counters.delta(before, counters.snapshot())
    window_s = jobs[-1].t_end - jobs[0].t0 - drawing_s
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del pool, stream
    failed = sum(j.failed for j in jobs)
    for j in jobs:
        if j.error:
            print(f"portbench: job {j.index} raised {j.error}",
                  file=sys.stderr)
            break

    # the comparison, once the window has closed and its state is freed
    if device.type == "cuda":
        torch.cuda.empty_cache()
    limits = spec["limits"]
    worst = {name: 0 for name in limits}
    info: dict = {}
    judged_ok = True
    for job, res, tensors, overrides in sample.items:
        if res is None:
            judged_ok = False
            continue
        try:
            numbers, info_j = caller.judge(res, tensors, ref, cell.deck_text,
                                           overrides, spec, device)
        except Exception as exc:
            print(f"portbench: judging job {job.index} raised "
                  f"{type(exc).__name__}: {exc}", file=sys.stderr)
            judged_ok = False
            continue
        info = info_j or info
        for name, value in numbers.items():
            worst[name] = max(worst[name], value)
    checks = {name: {"value": worst[name], "limit": limits[name]}
              for name in limits}
    correct = (judged_ok and failed == 0 and bool(sample.items)
               and all(worst[n] <= limits[n] for n in limits))

    metrics: dict = {}
    breakdown = None
    done = [j for j in jobs if not j.failed]
    if not args.trace:
        for m in cell.end_to_end:
            name = m["name"]
            if name == "setup_s":
                value = setup_s
            elif name == "solutions_per_s":
                value = sum(j.solutions for j in done) / window_s
            elif name == "job_p95_ms":
                times = sorted(j.t_end - j.t0 for j in jobs)
                value = 1e3 * _percentile(times, 95.0)
            else:
                continue
            metrics[name] = {"value": value, "unit": m["unit"]}
    else:
        trace_red = trace.reduce(prof)
        recs = span_join.records(prof)
        ctx = Context(jobs=len(jobs), window_s=window_s, trace=trace_red,
                      front_end_s=[j.front_s for j in jobs],
                      counters=used, shape=_shape(cell, B, caller),
                      info=info, spans=intervals,
                      program_counters=program_counters, records=recs,
                      join=span_join.join(recs, intervals, edges))
        if inspect is not None:
            inspect(ctx, edges)
        for m in cell.per_layer:
            reader = manifest.module("metrics", m["name"])
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": trace_red.top(10),
                     "idle_gaps": trace_red.top_gaps(10)}

    found = forbidden_loaded()
    if found:
        print(f"portbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 4
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": cell.chips, "memory_peak_bytes": peak}
    if args.trace:
        dev["busy_s"] = trace_red.busy_s
        dev["window_s"] = window_s
    result = {"correct": correct, "attempted": len(jobs), "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    times = sorted(j.t_end - j.t0 for j in jobs)
    print(f"portbench: {len(jobs)} jobs of {B} variants in {window_s:.3f} s"
          f", set-up {setup_s:.3f} s; job s min {times[0]:.4f} p50 "
          f"{_percentile(times, 50.0):.4f} p95 {_percentile(times, 95.0):.4f}"
          f" max {times[-1]:.4f}; {len(sample.items)} judged, reference "
          f"info {info}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _percentile(sorted_values: list[float], q: float) -> float:
    """Linear interpolation between order statistics (NumPy's default)."""
    pos = q / 100.0 * (len(sorted_values) - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    w = pos - lo
    return sorted_values[lo] * (1 - w) + sorted_values[hi] * w


def _shape(cell, B: int, caller) -> dict:
    """The shapes the work formulas read (``work/<kernel>.py``): the
    configuration's ``shape`` as it states it, with ``n`` (its
    unknowns), the variants a job, the swept elements, and the dtype the
    entry computes in with its item size."""
    dtype = caller.dtype(cell.spec)
    shape = cell.config["shape"]
    return {**shape, "n": shape["unknowns"], "variants": B,
            "swept": len(cell.config["sweep"]["elements"]),
            "dtype": dtype, "itemsize": {"float64": 8, "float32": 4}[dtype]}


if __name__ == "__main__":
    sys.exit(main())
