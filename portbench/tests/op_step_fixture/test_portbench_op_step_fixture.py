"""A cell of another analysis taken from new files alone (CPU).

This folder holds the pieces of one cell kept apart from BENCHMARK.json
(``cells.json``): a ``.op`` / ``.step`` deck that ``reference/mna.py``
cannot read (a resistor divider clamped by a diode, the lower resistor
stepped), its plain reference with ``facts``, and its traffic mix over
the ``op_batch`` entry (``entries/op_batch.py``). The generic harness
runs it by its name and this folder: a sound run is correct, each of
the entry's faults is caught, the float32 control fails a limit, and the
configuration states what its reference reads from the deck.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

HOME = Path(__file__).resolve().parent
ROOT = HOME.parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import control, faults, run  # noqa: E402
from portbench.core import manifest  # noqa: E402

CELL = "divider-clamp-step"
SEED = 4000000411


def result_of(capsys, trace: int = 0) -> dict:
    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                   "0.05", "--trace", str(trace)], device="cpu", home=HOME)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_the_deck_is_beyond_the_transient_reader():
    mna = manifest.module("reference", "mna")
    with pytest.raises(ValueError, match=r"\.op"):
        mna.read_deck(manifest.Cell(CELL, home=HOME).deck_text)


def test_sound_run_is_correct(capsys):
    res = result_of(capsys)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["checks"]) == {"op_gap", "lanes_missing"}
    assert res["checks"]["op_gap"]["value"] < 1e-14
    assert {"setup_s", "solutions_per_s"} <= set(res["metrics"])


def test_a_traced_run_reads_its_own_metrics(capsys):
    res = result_of(capsys, trace=1)
    assert res["correct"] is True
    # op_batch opens no span: the span metric finds nothing to read; the
    # harness's own front-end span and the trace's launches read
    assert "solve_idle_pct" not in res["metrics"]
    assert res["metrics"]["front_end_ms"]["value"] > 0
    assert "launches_per_job" in res["metrics"]


@pytest.mark.parametrize("fault", ["half", "altered", "one_pass"])
def test_a_planted_fault_is_caught(capsys, fault):
    spec = manifest.Cell(CELL, home=HOME).spec
    assert fault in faults.names(spec)
    with faults.planted(spec, fault):
        assert result_of(capsys)["correct"] is False


def test_the_control_fails_the_limits():
    out = control.readings(CELL, [SEED], [4000000421], device="cpu",
                           home=HOME)
    limits = out["limits"]
    assert out["op_gap_lower"] <= limits["op_gap"]
    assert any(out[f"{n}_upper"] > limits[n] for n in limits), out


def test_the_configuration_states_its_references_facts():
    cell = manifest.Cell(CELL, home=HOME)
    got = cell.reference.facts(cell.deck_text)
    assert got == {"analysis": "op",
                   "nominal": {"r1": 1000.0, "r2": 2000.0},
                   "shape": {"unknowns": 3}}
    assert cell.config["analysis"] == got["analysis"]
    assert cell.config["shape"] == got["shape"]
    for el, nominal in cell.config["sweep"]["nominal"].items():
        assert got["nominal"][el] == pytest.approx(nominal, rel=1e-15)


def test_only_this_folder_names_the_cell():
    """No file outside this folder names the cell or its configuration;
    the harness finds them by the name and the folder alone."""
    bench = ROOT / "portbench"
    for path in bench.rglob("*"):
        if not path.is_file() or HOME in path.parents \
                or "__pycache__" in path.parts:
            continue
        text = path.read_text(errors="replace")
        assert "divider-clamp" not in text, path
