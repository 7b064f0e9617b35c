"""The ``ua741-step-f64`` cell's own pieces on the CPU: its reference
(``reference/ua741-step.py``) read against the deck and the program, its
convergence aids, and the four readers of the op path's spans and
counters on hand-made contexts.

The cell itself runs through ``run.main`` with every fault of its entry
and the control in ``test_portbench_faults.py`` (every cell of
BENCHMARK.json at 24 variants); its configuration's facts are held to
the reference in ``test_portbench_manifest.py``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402
from portbench.core import manifest, spans, trace  # noqa: E402

CELL = "ua741-step-f64"
CPU = torch.device("cpu")


def _ref():
    return manifest.module("reference", "ua741-step")


def _deck() -> str:
    return manifest.Cell(CELL).deck_text


def test_the_reader_flattens_the_macromodel():
    """25 nodes (20 of the deck, 5 inside the diodes' Rs), 9 V sources,
    the H limiter and the POLY(2) E: 36 unknowns; the POLY(5) F reads its
    five controlling sources inside the instance."""
    ref = _ref()
    deck = ref.read_deck(_deck())
    assert len(deck.nodes) == 20 and "11.xamp" in deck.nodes
    assert [e.name for e in deck.of("D")] == [
        "dc.xamp", "de.xamp", "dlp.xamp", "dln.xamp", "dp.xamp"]
    assert all(d.model["rs"] == 1.0 for d in deck.of("D"))
    (fb,) = deck.of("F")
    assert fb.controls == ("vb.xamp", "vc.xamp", "ve.xamp", "vlp.xamp",
                           "vln.xamp")
    assert fb.coeffs == (0.0, 10.61e6, -10e6, 10e6, 10e6, -10e6)
    (egnd,) = deck.of("E")
    assert egnd.controls == (("vcc", "0"), ("vee", "0"))
    assert ref.facts(_deck())["shape"] == {"unknowns": 36}


def test_the_reader_refuses_what_it_does_not_read():
    ref = _ref()
    with pytest.raises(ValueError, match="first-order POLY"):
        ref.read_deck("t\ne1 1 0 poly(1) 2 0 0 1 0.5\nr1 2 0 1k\n.op\n")
    with pytest.raises(ValueError, match=r"\.tran"):
        ref.read_deck("t\nr1 1 0 1k\n.tran 1u 1m\n")
    with pytest.raises(ValueError, match="NMOS"):
        ref.read_deck("t\n.model mn nmos(vto=1)\n.op\n")


def test_the_reference_matches_the_program_and_each_variant_alone():
    """Eight draws at once equal each draw solved alone, and the program
    within the cell's limit: the lanes do not mix."""
    import spicey_tpu_torch as program

    ref, deck = _ref(), _deck()
    rfb = 1e4 * np.random.default_rng(5).uniform(0.5, 2.0, 8)
    v, names, ok, info = ref.operating_points(deck, {"rfb": rfb},
                                              torch.float64, CPU)
    assert bool(ok.all()) and info["aided"] == 0
    for k in (0, 5):
        one, _n, ok1, _i = ref.operating_points(deck, {"rfb": rfb[k:k + 1]},
                                                torch.float64, CPU)
        assert bool(ok1.all())
        np.testing.assert_allclose(one[0].numpy(), v[k].numpy(),
                                   rtol=0, atol=1e-13)
    got = program.op_batch(deck, {"rfb": rfb}, dialect="extended",
                           device="cpu")
    x = np.stack([got.node_voltage(n) for n in names], axis=1)
    assert np.abs(x - v.numpy()).max() / np.abs(v.numpy()).max() < 1e-12


def test_the_references_aids_solve_what_its_newton_leaves(monkeypatch):
    """With too few Newton passes (12: rfb = 5k needs 16) a variant goes
    through the gmin and source steps, which solve it to the plain
    Newton's answer; with far too few (1) none is solved and each is
    reported so."""
    ref, deck = _ref(), _deck()
    rfb = 1e4 * np.array([0.5, 1.0, 2.0])
    want, _n, ok, _i = ref.operating_points(deck, {"rfb": rfb},
                                            torch.float64, CPU)
    assert bool(ok.all())
    monkeypatch.setattr(ref, "MAX_PASSES", 12)
    got, _n, ok, info = ref.operating_points(deck, {"rfb": rfb},
                                             torch.float64, CPU)
    assert info["aided"] >= 1 and bool(ok.all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-12)
    monkeypatch.setattr(ref, "MAX_PASSES", 1)
    _v, _n, ok, info = ref.operating_points(deck, {"rfb": rfb},
                                            torch.float64, CPU)
    assert info["aided"] == 3 and not bool(ok.any())


def test_the_references_aids_take_the_newton_limit_cycle():
    """At rfb = 5510.4927 ohm (a draw of seed 2095434620's job 4) the
    plain Newton from rest falls into a cycle in the reference as in the
    program; its aids solve it to the program's rescued answer."""
    import spicey_tpu_torch as program

    ref, deck = _ref(), _deck()
    rfb = np.array([5510.492746322804])
    v, names, ok, info = ref.operating_points(deck, {"rfb": rfb},
                                              torch.float64, CPU)
    assert info["aided"] == 1 and bool(ok.all())
    got = program.op_batch(deck, {"rfb": rfb}, dialect="extended",
                           device="cpu")
    assert got.valid.all() and got.passes[0] > 100
    x = np.stack([got.node_voltage(n) for n in names], axis=1)
    assert np.abs(x - v.numpy()).max() / np.abs(v.numpy()).max() < 1e-12


# --- the op path's four readers on hand-made contexts ---------------------

OP_METRICS = ("op_passes_per_job", "op_done_lane_pct", "op_pass_ms",
              "op_ladder_lanes_per_job")
# two jobs: 49 + 100 batched Newton passes over 1,001 lanes (the second
# job's Newton left one lane invalid at its pass limit, and the ladder
# took it in 166 passes over 17 stages), 10 passes a lane on the mean
COUNTERS = {"op.newton_passes": 149.0, "op.lane_passes": 20020.0,
            "op.ladder_lanes": 1.0, "op.ladder_rescued": 1.0,
            "op.ladder_passes": 166.0, "sync.newton_done": 315.0,
            "sync.fetch": 19.0}
# each job's solve span (ns)
SPANS = [("op_batch/prepare", 0, 10), ("op_batch/solve", 10, 490_010),
         ("op_batch/fetch", 490_010, 490_020), ("op_batch", 0, 500_000),
         ("op_batch/prepare", 600_000, 600_010),
         ("op_batch/solve", 600_010, 1_470_010),
         ("op_batch/fetch", 1_470_010, 1_470_020),
         ("op_batch", 600_000, 1_500_000)]
WANT = {"op_passes_per_job": 74.5,
        "op_done_lane_pct": 100.0 * (1 - 20020.0 / (149.0 * 1001)),
        "op_pass_ms": 1e-6 * 1_360_000 / 149.0,
        "op_ladder_lanes_per_job": 0.5}


def _context(counters: dict, intervals: list) -> run.Context:
    recs = spans.Records()
    return run.Context(jobs=2, window_s=1.5e-3, trace=trace.Trace(),
                       front_end_s=[], counters={},
                       shape={"unknowns": 36, "variants": 1001},
                       spans=intervals, program_counters=counters,
                       records=recs,
                       join=spans.join(recs, intervals, (0, 1_500_000)))


@pytest.mark.parametrize("name", OP_METRICS)
def test_op_metrics_read_the_op_paths_spans_and_counters(name):
    reader = manifest.module("metrics", name)
    assert reader.read(_context(COUNTERS, SPANS)) == pytest.approx(
        WANT[name])


@pytest.mark.parametrize("name", OP_METRICS)
def test_op_metrics_read_nothing_without_the_op_path(name):
    """A program whose op_batch has no spans or counters (the parent of
    this cell's first PR), or a cell of another entry: None."""
    reader = manifest.module("metrics", name)
    assert reader.read(_context({}, [])) is None
    other = {"sync.fetch": 2.0, "tran.steps": 202.0}
    assert reader.read(_context(other, [("mc_tran_stats/solve", 0, 9)])) \
        is None


def test_no_ladder_reads_zero_lanes():
    c = {k: v for k, v in COUNTERS.items()
         if not k.startswith("op.ladder")}
    reader = manifest.module("metrics", "op_ladder_lanes_per_job")
    assert reader.read(_context(c, SPANS)) == 0.0
    assert manifest.module("metrics", "op_passes_per_job").read(
        _context(c, SPANS)) == 74.5
