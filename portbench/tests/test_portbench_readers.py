"""The per-layer readers of the program's spans and counters, and K11's
roofline, on hand-made contexts; and a traced run's wiring of the spans
(CPU).

- Each span or counter metric (``metrics/<name>.py``, bound to
  ``core/spans.py:READERS``) reads run.py's ``Context`` as the reader
  reads the join: whatever the job's top-level span is named, and None
  where the program has no such span or counter.
- ``k11_roofline`` reads the trace's two K11 forms against
  ``work/k11.py`` and gives None where the trace lacks K11 or the
  reference counted no passes; ``work/k11.py`` counts A and b and the
  values each lane reads on the boost deck, from the reference's facts.
- ``run.main --trace 1`` keeps the program's spans on for the profiler's
  window only, and its result line carries the span metrics.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402
from portbench.core import manifest, spans, trace  # noqa: E402

SPAN_METRICS = ("prepare_ms", "solve_idle_pct", "reduce_span_ms",
                "syncs_per_job", "newton_passes_per_step")

# a job's phases in ns, its launches (corr 1 in prepare, 2 in solve, 5
# in reduce) and a sync at the end
PHASES = [("prepare", 5, 40), ("solve", 40, 90), ("reduce", 90, 93)]


def _records() -> spans.Records:
    runtime = [(8, 9, "cudaLaunchKernel", 1), (45, 47, "cudaLaunchKernel", 2),
               (91, 92, "cudaLaunchKernel", 5),
               (94, 95, "cudaStreamSynchronize", 4)]
    device = [(10, 20, "k_a", 1), (60, 92, "k_b", 2), (93, 97, "sort", 5)]
    return spans.Records(device=device, runtime=runtime)


def _context(entry: str | None, counters: dict | None = None,
             jobs: int = 2, records=None) -> run.Context:
    intervals = ([] if entry is None else
                 [(f"{entry}/{p}", s, e) for p, s, e in PHASES]
                 + [(entry, 5, 95)])
    recs = _records() if records is None else records
    return run.Context(jobs=jobs, window_s=100e-9, trace=trace.Trace(),
                       front_end_s=[], counters={}, shape={}, spans=intervals,
                       program_counters=counters or {}, records=recs,
                       join=spans.join(recs, intervals, (0, 100)))


COUNTERS = {"sync.fetch": 2.0, "sync.newton_done": 202.0,
            "tran.steps": 202.0, "tran.newton_passes": 303.0}
WANT = {"prepare_ms": 35e-6, "solve_idle_pct": 20.0,
        "reduce_span_ms": 4e-9 / 2 * 1e3, "syncs_per_job": 102.0,
        "newton_passes_per_step": 1.5}


@pytest.mark.parametrize("entry", ["mc_tran_stats", "op_batch"])
@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metrics_read_any_entrys_phases(name, entry):
    reader = manifest.module("metrics", name)
    assert (reader.SOURCE, reader.UNIT) == spans.READERS[name][:2]
    assert reader.read(_context(entry, COUNTERS)) == pytest.approx(
        WANT[name])


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metrics_read_nothing_without_the_program(name):
    reader = manifest.module("metrics", name)
    assert reader.read(_context(None)) is None
    no_join = _context(None)
    no_join.join = None
    assert reader.read(no_join) is None


def _k11_context(by_name: dict, info: dict) -> run.Context:
    tr = trace.Trace(by_name={k: [1, v] for k, v in by_name.items()})
    shape = {"n": 6, "variants": 1000, "lane_values": 8, "stamp_adds": 22,
             "itemsize": 8, "dtype": "float64"}
    return run.Context(jobs=2, window_s=1.0, trace=tr, front_end_s=[],
                       counters={}, shape=shape, info=info)


def test_k11_roofline_reads_both_forms_against_its_work():
    # 2 jobs x 1,000 variants x 101 passes, 50 items a lane-pass at 8 B
    lane_passes = 2 * 1000 * 101
    least = lane_passes * (36 + 6 + 8) * 8 / 3.35e12
    ctx = _k11_context({"void stamp_real_tile_kernel<double>(...)": least,
                        "void stamp_real_entry_kernel<double>(...)": least,
                        "gj_real_thread_kernel": 1.0},
                       {"passes_per_lane": 101.0})
    reader = manifest.module("metrics", "k11_roofline")
    assert (reader.SOURCE, reader.UNIT) == ("device_trace", "%")
    assert reader.read(ctx) == pytest.approx(50.0)


def test_k11_roofline_reads_nothing_without_k11_or_passes():
    reader = manifest.module("metrics", "k11_roofline")
    assert reader.read(_k11_context({"gj_real_thread_kernel": 1.0},
                                    {"passes_per_lane": 101.0})) is None
    assert reader.read(_k11_context(
        {"stamp_real_tile_kernel": 1.0}, {})) is None


def test_k11_work_counts_a_and_b_and_the_values_each_lane_reads():
    """On the boost deck, one pass of 16 lanes in float64: A and b written
    once (6^2 + 6 items) and the 8 values the reference's stamper holds
    per lane read once each (1/R; C/dt and C's history current; dt/L and
    L's history current; the diode's g and companion current; the
    switch's conductance, per lane since its state is), 8 B an item. The
    two V sources' values are the same in every lane and are not counted
    per lane."""
    text = (ROOT / "portbench/configs/boost-converter-probe.cir").read_text()
    mna = manifest.module("reference", "mna")
    deck = mna.read_deck(text)
    shape = manifest.module("reference", "boost-converter-probe").facts(
        text)["shape"]
    per_kind = {"R": 1, "C": 2, "L": 2, "D": 2, "S": 1}
    assert shape["lane_values"] == sum(
        per_kind[el.kind] for el in deck.elements if el.kind != "V") == 8
    assert sorted(el.name for el in deck.of("V")) == [
        "Vsimulation_voltage_source_0", "Vsimulation_voltage_source_1"]
    assert shape["sources"] == 2
    flops, nbytes = manifest.module("work", "k11").work(
        shape["unknowns"], 16, shape["lane_values"], shape["stamp_adds"], 8)
    assert (flops, nbytes) == (16 * 22, 16 * (36 + 6 + 8) * 8)


def _spans_on() -> bool:
    """Whether the program's spans record, read through its public
    ``span`` and ``intervals``."""
    from spicey_tpu_torch.utils import profiling

    before = len(profiling.intervals())
    with profiling.span("portbench_probe"):
        pass
    return len(profiling.intervals()) > before


def test_a_traced_run_turns_the_programs_spans_on_for_its_window(capsys):
    seen = {}
    rc = run.main(["--workload", "boost-yield-f64-loop", "--seed",
                   "4000000511", "--seconds", "1", "--trace", "1"],
                  device="cpu", variants=16,
                  inspect=lambda ctx, edges: seen.update(ctx=ctx,
                                                         edges=edges))
    assert rc == 0
    assert not _spans_on()
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["syncs_per_job"] == 102.0          # 101 passes and one fetch
    assert m["newton_passes_per_step"] == 1.0
    assert m["prepare_ms"] > 0 and m["solve_idle_pct"] > 0
    ctx = seen["ctx"]
    w0, w1 = seen["edges"]
    assert ctx.spans and all(w0 <= s <= e <= w1 for _q, s, e in ctx.spans)
    assert {q for q, _s, _e in ctx.spans if "/" not in q} == \
        {"mc_tran_stats"}
    assert ctx.program_counters["tran.steps"] == 101 * res["attempted"]


def test_an_untraced_run_leaves_the_programs_spans_off(capsys):
    rc = run.main(["--workload", "boost-yield-f64-loop", "--seed",
                   "4000000512", "--seconds", "0.01", "--trace", "0"],
                  device="cpu", variants=16)
    assert rc == 0 and not _spans_on()
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not set(res["metrics"]) & set(SPAN_METRICS)
