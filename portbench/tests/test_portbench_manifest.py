"""BENCHMARK.json against the benchmark's contract, and every file it
names present. CPU only; run with ``python -m pytest portbench/tests``."""

from __future__ import annotations

import json
import math
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import faults  # noqa: E402
from portbench.core import manifest  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32
    for word in cmd:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_metric_names_unique_across_kinds():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in BENCH["end_to_end"]:
        allowed |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert 1 <= len(metric["layer"]) <= 200
        assert "\n" not in metric["layer"]
    assert set(metric) <= allowed and set(metric) >= allowed - {"workloads"}
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        layer = [m for m in BENCH["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, w["name"]


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_moves_names_an_end_to_end_metric_each_cell_reports(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    target = e2e[metric["moves"]]
    for cell in metric.get("workloads",
                           [w["name"] for w in BENCH["workloads"]]):
        assert cell in target.get("workloads", [cell]), (metric, cell)


def test_one_layer_name_per_layer_and_readers_agree():
    for metric in BENCH["per_layer"]:
        reader = manifest.module("metrics", metric["name"])
        assert reader.SOURCE == metric["source"], metric["name"]
        assert reader.UNIT == metric["unit"], metric["name"]


def test_configs_have_a_cell_and_their_files():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("portbench/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert (ROOT / data["deck"]).is_file()
        assert (ROOT / "portbench" / "reference"
                / f"{c['name']}.py").is_file()
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_cells_resolve_and_carry_limits():
    pairs = set()
    four = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = manifest.Cell(w["name"], BENCH)
        assert hasattr(cell.caller, "ENTRY")
        assert cell.spec["limits"] and all(
            math.isfinite(v) and v >= 0 for v in cell.spec["limits"].values())
        assert "precision" not in cell.spec      # one precision: args'
        # the dtype the entry computes in: a statistics entry's from the
        # one precision argument, f64 or f32
        assert cell.caller.ENTRY.dtype(cell.spec) in ("float64", "float32")
        assert cell.spec["control_dtype"] in ("float32", "bfloat16")
        assert faults.names(cell.spec), w["name"]   # the entry's faults
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_states_its_deck_nominal_values_and_shapes(name):
    """What the harness reads from a configuration's file (the analysis,
    the swept elements' nominal values, the work formulas' shapes) is
    what the configuration's own plain reference reads from its deck
    (``reference/<config>.py:facts``)."""
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / f"{name}.json").read_text())
    facts = manifest.module("reference", name).facts(
        (ROOT / cfg["deck"]).read_text())
    sweep = cfg["sweep"]
    assert list(sweep["nominal"]) == sweep["elements"]
    for el, nominal in sweep["nominal"].items():
        assert facts["nominal"][el] == pytest.approx(nominal, rel=1e-15), el
    assert cfg["analysis"] == facts["analysis"]
    assert cfg["shape"] == facts["shape"]


def test_the_boost_facts_are_the_transient_readers_numbers():
    """The boost's reference reads from its deck the numbers that its
    configuration held before each reference stated its own facts: the
    transient, the three swept values, 6 unknowns, 101 points, 2 sources,
    22 stamped entries; and the 8 values a lane's pass stamps (K11's
    work)."""
    text = (ROOT / "portbench/configs/boost-converter-probe.cir").read_text()
    facts = manifest.module("reference", "boost-converter-probe").facts(text)
    assert facts["analysis"] == "tran"
    assert facts["nominal"] == pytest.approx(
        {"RR1": 1000.0, "CC1": 1e-05, "LL1": 1.0}, rel=1e-15)
    assert facts["shape"] == {"unknowns": 6, "points": 101, "sources": 2,
                              "stamp_adds": 22, "lane_values": 8}


def test_every_file_under_paths_is_named_from_name_characters():
    for p in BENCH["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or not f.is_file():
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert PATH.match(rel), rel
