"""The port's spans and counters (utils/profiling.py) and their join to a
profiler trace (portbench/core/spans.py).

- The clock: a span's interval, on ``time.time_ns()``, encloses a
  ``torch.profiler`` record made inside it.
- The spans of the four Monte-Carlo entries: the entry's span holds
  ``prepare``, ``solve``, ``reduce`` and ``fetch``, in that order and
  not overlapping, on the fused and the loop routes and in AC.
- The counters: ``tran.newton_passes`` is the loop's count of solves,
  ``sync.newton_done`` its host syncs; outside ``profiled()`` nothing is
  recorded.
- The join on hand-made records, and the readers of the span and
  counter metrics.

Tests marked ``cuda`` need an NVIDIA GPU and skip elsewhere; run them on
the card with ``python -m pytest tests/test_torch_profiling.py -m cuda
--noconftest`` (no jax there; this file imports none).
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import spicey_tpu_torch as st
from portbench.core import spans as jn
from portbench.core import trace as tr
from spicey_tpu_torch.analysis import tran as tran_mod
from spicey_tpu_torch.utils import profiling
from tests.fixtures import netlists

B = 24
RC_TRAN = ("x rc tran\nV1 1 0 PULSE(0 5 0 1n 1n 5u 10u)\nR1 1 2 1k\n"
           "C1 2 0 1u\n.tran 0.5u 20u\n.end\n")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _boost_overrides(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {name: nominal * rng.uniform(0.9, 1.1, B)
            for name, nominal in (("RR1", 1e3), ("CC1", 10e-6),
                                  ("LL1", 1.0))}


def _children(entry: str) -> tuple[tuple, list]:
    ivs = profiling.intervals()
    top = [iv for iv in ivs if iv[0] == entry]
    kids = sorted((iv for iv in ivs if iv[0].startswith(entry + "/")),
                  key=lambda iv: iv[1])
    assert len(top) == 1, ivs
    return top[0], kids


def _assert_phases(entry: str) -> None:
    (_q, s0, e0), kids = _children(entry)
    assert [q.split("/", 1)[1] for q, _s, _e in kids] == \
        ["prepare", "solve", "reduce", "fetch"]
    assert s0 <= kids[0][1]
    for (_a, _sa, ea), (_b, sb, _eb) in zip(kids, kids[1:]):
        assert ea <= sb
    assert kids[-1][2] <= e0
    assert all(s <= e for _q, s, e in kids)


# --- the clock ---------------------------------------------------------

@pytest.mark.parametrize("rep", range(3))
def test_span_encloses_a_record_function_range(rep):
    """Inside profiled() and a CPU-activity profiler, a span around a
    record_function range encloses that record's interval."""
    name = f"inner_{rep}"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.profiled():
            with profiling.span("outer"):
                with record_function(name):
                    torch.zeros(64).add_(1.0)
    (_q, s, e), = profiling.intervals()
    recs = [ev for ev in prof.profiler.kineto_results.events()
            if ev.name() == name]
    assert len(recs) == 1
    r = recs[0]
    assert s <= r.start_ns() and r.start_ns() + r.duration_ns() <= e
    # the clock is time.time_ns(): the interval sits within a second of now
    assert abs(time.time_ns() - e) < 10**9


def test_report_totals_are_the_intervals():
    with profiling.profiled():
        with profiling.span("a"):
            with profiling.span("b"):
                time.sleep(0.002)
    ivs = {q: (e - s) for q, s, e in profiling.intervals()}
    rows = {line.split(", ")[0]: line.split(", ")[1:]
            for line in profiling.report().splitlines()[1:]}
    assert float(rows["a"][1]) == pytest.approx(ivs["a"] * 1e-6, abs=1e-3)
    assert float(rows["a/b"][1]) == pytest.approx(ivs["a/b"] * 1e-6,
                                                  abs=1e-3)
    assert float(rows["a"][2]) == pytest.approx(
        (ivs["a"] - ivs["a/b"]) * 1e-6, abs=1e-3)


# --- the spans of the Monte-Carlo entries -------------------------------

@pytest.mark.parametrize("method,precision", [("gj", "f64"),
                                              ("pallas", "f32")])
def test_mc_tran_stats_spans_nest_in_order(method, precision):
    with profiling.profiled():
        r = st.mc_tran_stats(netlists.BOOST_CONVERTER, _boost_overrides(),
                             "N3", method=method, precision=precision,
                             device="cpu")
    assert r.n_valid == B
    _assert_phases("mc_tran_stats")
    assert profiling.counters()["sync.fetch"] == 1


def test_mc_tran_stats_spans_on_the_time_parallel_route(monkeypatch):
    from spicey_tpu_torch.analysis import mc
    calls = []
    inner = mc._mc_tran_tp_responses

    def counted(*a, **k):
        calls.append(1)
        return inner(*a, **k)

    monkeypatch.setattr(mc, "_mc_tran_tp_responses", counted)
    rng = np.random.default_rng(1)
    ov = {"R1": 1e3 * rng.uniform(0.9, 1.1, B)}
    with profiling.profiled():
        st.mc_tran_stats(RC_TRAN, ov, "2", time_parallel="auto",
                         tp_crossover=1e6, device="cpu")
    assert calls == [1]
    _assert_phases("mc_tran_stats")


def test_mc_tran_sampled_spans_nest_in_order():
    with profiling.profiled():
        st.mc_tran_sampled(RC_TRAN, {"R1": 0.1, "C1": 0.1}, B, "2", key=3,
                           device="cpu")
    _assert_phases("mc_tran_sampled")


@pytest.mark.parametrize("method", ["gj", "pallas"])
def test_mc_ac_stats_spans_nest_in_order(method):
    rng = np.random.default_rng(2)
    ov = {"r1": 30.0 * rng.uniform(0.9, 1.1, B),
          "c1": 100e-6 * rng.uniform(0.9, 1.1, B)}
    with profiling.profiled():
        r = st.mc_ac_stats(netlists.BASICS01_AC, ov, "2", method=method,
                           device="cpu")
    assert r.n_valid == B
    _assert_phases("mc_ac_stats")


def test_mc_ac_sampled_spans_nest_in_order():
    with profiling.profiled():
        st.mc_ac_sampled(netlists.BASICS01_AC, {"r1": 0.1, "c1": 0.1}, B,
                         "2", device="cpu")
    _assert_phases("mc_ac_sampled")


def test_an_entry_that_raises_closes_its_spans():
    with profiling.profiled():
        with pytest.raises(ValueError):
            st.mc_tran_stats(netlists.BOOST_CONVERTER, {"nope": np.ones(2)},
                             "N3", device="cpu")
        with profiling.span("after"):
            pass
    names = [q for q, _s, _e in profiling.intervals()]
    assert names == ["mc_tran_stats/prepare", "mc_tran_stats", "after"]


# --- the counters -------------------------------------------------------

def test_newton_passes_count_the_loops_solves(monkeypatch):
    calls = []
    inner = tran_mod.solve

    def counted(*a, **k):
        calls.append(1)
        return inner(*a, **k)

    monkeypatch.setattr(tran_mod, "solve", counted)
    with profiling.profiled():
        st.mc_tran_stats(netlists.BOOST_CONVERTER, _boost_overrides(3),
                         "N3", method="gj", precision="f64", device="cpu")
    c = profiling.counters()
    assert c["tran.newton_passes"] == len(calls) > 0
    assert c["sync.newton_done"] == len(calls)
    assert c["tran.steps"] == 101
    # the boost deck converges in one pass a step (its switch stays open)
    assert c["tran.newton_passes"] / c["tran.steps"] == 1.0
    assert c["sync.fetch"] == 1


def test_a_linear_loop_counts_steps_and_no_passes():
    with profiling.profiled():
        st.mc_tran_stats(RC_TRAN, {"R1": np.full(4, 1e3)}, "2",
                         time_parallel="never", device="cpu")
    c = profiling.counters()
    assert c["tran.steps"] == 41
    assert "tran.newton_passes" not in c and "sync.newton_done" not in c


def test_off_records_no_interval_and_no_counter():
    with profiling.profiled():
        pass
    assert profiling.span("a") is profiling.span("b")   # the shared no-op
    with profiling.span("ignored"):
        profiling.count("ignored")
    st.mc_tran_stats(netlists.BOOST_CONVERTER, _boost_overrides(4), "N3",
                     method="gj", precision="f64", device="cpu")
    assert profiling.intervals() == []
    assert profiling.counters() == {}
    assert profiling.report() == "span, calls, total_ms, own_ms"


# --- the join, on hand-made records ------------------------------------

SPANS = [("e/prepare", 5, 40), ("e/solve", 40, 90), ("e/reduce", 90, 93),
         ("e", 5, 95)]


def _recs():
    # a launch in prepare (corr 1) and one in solve (corr 2), a sync in
    # fetch's place (the entry's own time), a copy from outside (corr 3)
    runtime = [(8, 9, "cudaLaunchKernel", 1), (45, 47, "cudaLaunchKernel", 2),
               (94, 95, "cudaStreamSynchronize", 4),
               (1, 2, "cudaMemcpyAsync", 3)]
    device = [(2, 4, "copy", 3), (10, 20, "k_a", 1), (60, 92, "k_b", 2)]
    return jn.Records(device=device, runtime=runtime)


def test_join_splits_a_gap_across_nested_spans():
    j = jn.join(_recs(), SPANS, (0, 100))
    # idle: [0, 2) outside, [4, 5) outside, [5, 10) prepare,
    # [20, 40) prepare, [40, 60) solve, [92, 93) reduce, [93, 95) e,
    # [95, 100) outside
    assert j.idle_s == pytest.approx({
        jn.OUTSIDE: 8e-9, "e/prepare": 25e-9, "e/solve": 20e-9,
        "e/reduce": 1e-9, "e": 2e-9})
    assert j.gap_split["before k_b"] == pytest.approx(
        {"e/prepare": 20e-9, "e/solve": 20e-9})
    assert j.idle_total_s + j.busy_s == pytest.approx(j.window_s)


def test_join_puts_time_outside_every_span():
    j = jn.join(_recs(), [], (0, 100))
    assert set(j.idle_s) == {jn.OUTSIDE}
    assert j.idle_s[jn.OUTSIDE] == pytest.approx(56e-9)
    assert jn.join(jn.Records(), SPANS, (0, 100)).gap_split == {
        "no device record": pytest.approx({jn.OUTSIDE: 10e-9,
                                           "e/prepare": 35e-9,
                                           "e/solve": 50e-9,
                                           "e/reduce": 3e-9, "e": 2e-9})}


def test_join_links_a_launch_to_its_span_by_correlation_id():
    recs = _recs()
    recs.device.append((96, 99, "k_orphan", 99))
    j = jn.join(recs, SPANS, (0, 100))
    assert j.device_s == pytest.approx({"e/prepare": 10e-9,
                                        "e/solve": 32e-9,
                                        jn.OUTSIDE: 2e-9,
                                        jn.UNLINKED: 3e-9})
    assert j.launches == {"e/prepare": 1, "e/solve": 1}
    assert j.syncs == {"e": 1}
    # the sync at 94 follows the launch of k_b (corr 2) at 45
    assert j.sync_after == {"e": {"k_b": 1}}


class _Event:
    def __init__(self, rec, on_device, corr=True):
        self.rec, self.on_device, self.corr = rec, on_device, corr

    def name(self):
        return self.rec[2]

    def start_ns(self):
        return self.rec[0]

    def duration_ns(self):
        return self.rec[1] - self.rec[0]

    def correlation_id(self):
        return self.rec[3] if self.corr else 0

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self.on_device else DeviceType.CPU


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda _s: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


@pytest.mark.parametrize("with_corr", [True, False])
def test_the_join_agrees_with_core_trace(with_corr):
    """core/trace.py's numbers are the same whether the records carry
    correlation ids or not, and the join reads the same busy time,
    launches and gaps from the same records."""
    recs = _recs()
    events = ([_Event(r, True, with_corr) for r in recs.device]
              + [_Event(r, False, with_corr) for r in recs.runtime])
    t = tr.reduce(_Prof(events))
    ref = tr.reduce(_Prof([_Event(r, True) for r in recs.device]
                          + [_Event(r, False) for r in recs.runtime]))
    assert (t.busy_s, t.launches, t.gaps, t.by_name, t.runtime) == \
        (ref.busy_s, ref.launches, ref.gaps, ref.by_name, ref.runtime)
    got = jn.records(_Prof(events))
    assert sorted(got.device) == sorted(
        (s, e, n, c if with_corr else 0) for s, e, n, c in recs.device)
    j = jn.join(got, SPANS, (2, 92))     # the window from first to last
    assert j.busy_s == pytest.approx(t.busy_s)
    assert sum(j.launches.values()) == t.launches
    for key, seconds in t.gaps.items():
        assert sum(j.gap_split[key].values()) == pytest.approx(seconds)


# --- the readers --------------------------------------------------------

def _ctx(intervals=SPANS, counters=None, jobs=1):
    return jn.SpanContext(jobs=jobs, join=jn.join(_recs(), intervals,
                                                  (0, 100)),
                          counters=counters or {})


ENTRY_SPANS = [(q.replace("e", "mc_tran_stats", 1), s, e)
               for q, s, e in SPANS]
COUNTERS = {"sync.fetch": 2.0, "sync.newton_done": 202.0,
            "tran.steps": 202.0, "tran.newton_passes": 303.0}


@pytest.mark.parametrize("name,want", [
    ("prepare_ms", 35e-6),
    ("solve_idle_pct", 20.0),
    ("reduce_span_ms", 0.0),
    ("syncs_per_job", 102.0),
    ("newton_passes_per_step", 1.5),
])
def test_readers_read_spans_and_counters(name, want):
    _src, _unit, reader = jn.READERS[name]
    assert reader(_ctx(ENTRY_SPANS, COUNTERS, jobs=2)) == \
        pytest.approx(want)


@pytest.mark.parametrize("name", sorted(jn.READERS))
def test_readers_give_none_without_the_program(name):
    _src, _unit, reader = jn.READERS[name]
    assert reader(_ctx([], {})) is None


def test_reduce_span_ms_reads_the_records_launched_in_reduce():
    recs = _recs()
    recs.runtime.append((91, 92, "cudaLaunchKernel", 5))
    recs.device.append((93, 97, "sort", 5))
    ctx = jn.SpanContext(jobs=2, join=jn.join(recs, ENTRY_SPANS, (0, 100)),
                         counters={})
    assert jn.reduce_span_ms(ctx) == pytest.approx(4e-9 / 2 * 1e3)


def _span_tool(older: bool) -> dict:
    """portbench/trace_spans.py on the loop cell at 16 variants, in a
    process of its own (the harness refuses to report with jax loaded);
    ``older``: the program without the accessors, as before them."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    code = ("import json, sys; sys.path.insert(0, %r)\n"
            "from spicey_tpu_torch.utils import profiling\n"
            "if %r:\n"
            "    del profiling.intervals, profiling.counters\n"
            "from portbench import trace_spans\n"
            "out = trace_spans.one('boost-yield-f64-loop', 4000000003, True,"
            " device='cpu', variants=16)\n"
            "print(json.dumps(out))\n" % (str(root), older))
    done = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def test_the_span_tool_on_a_program_without_the_accessors():
    out = _span_tool(older=True)
    assert out["result"]["correct"]
    assert set(out["readings"].values()) == {None}


def test_the_span_tool_on_the_cpu():
    """The idle time put to spans adds up to the window's, and the
    readings are those of the program's spans and counters."""
    out = _span_tool(older=False)
    jobs = out["result"]["attempted"]
    r = out["readings"]
    assert r["prepare_ms"] > 0 and r["solve_idle_pct"] > 0
    assert r["syncs_per_job"] == 102.0      # 101 passes and one fetch
    assert r["newton_passes_per_step"] == 1.0
    assert out["join"]["counters"]["tran.steps"] == 101 * jobs
    assert sum(out["join"]["idle_by_span"].values()) == pytest.approx(
        out["join"]["window_s"] - out["join"]["busy_s"])


# --- on the card ----------------------------------------------------------

@pytest.mark.cuda
def test_span_encloses_a_cuda_launch(cuda):
    """A span around one launch encloses the runtime's launch record, and
    the kernel's device record (linked by correlation id) starts after
    the span's start."""
    x = torch.zeros(1 << 20, device=cuda)
    x.add_(1.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.profiled():
            with profiling.span("launch"):
                x.mul_(2.0)
        torch.cuda.synchronize()
    (_q, s, e), = profiling.intervals()
    recs = jn.records(prof)
    launches = [r for r in recs.runtime if r[2] in tr.LAUNCH_CALLS]
    assert len(launches) == 1
    ls, le, _n, corr = launches[0]
    assert s <= ls and le <= e
    kernels = [r for r in recs.device if r[3] == corr]
    assert len(kernels) == 1 and kernels[0][0] >= s


@pytest.mark.cuda
def test_mc_tran_stats_records_link_to_their_spans_on_the_card(cuda):
    """The fused route on the card: K9 is launched in ``solve``, the
    sort in ``reduce``, and the copy to the host in ``fetch``."""
    ov = _boost_overrides(5)
    kw = dict(method="pallas", precision="f32", device=cuda)
    st.mc_tran_stats(netlists.BOOST_CONVERTER, ov, "N3", **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.profiled():
            st.mc_tran_stats(netlists.BOOST_CONVERTER, ov, "N3", **kw)
        w1 = time.time_ns()
    _assert_phases("mc_tran_stats")
    ivs = profiling.intervals()
    recs = jn.records(prof)
    w0 = min(s for _q, s, _e in ivs)
    j = jn.join(recs, ivs, (w0, w1))
    by_corr = {r[3]: r[2] for r in recs.device}
    solve = [by_corr[c] for _s, _e, n, c in recs.runtime
             if c in by_corr and "mc_tran_nr" in by_corr[c]]
    assert solve and j.device_s.get("mc_tran_stats/solve", 0) > 0
    assert j.device_s.get("mc_tran_stats/reduce", 0) > 0
    assert jn.UNLINKED not in j.device_s
    assert j.idle_total_s + j.busy_s == pytest.approx(j.window_s)
