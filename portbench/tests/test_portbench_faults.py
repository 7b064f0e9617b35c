"""A run with the timed path broken underneath comes out not correct (CPU).

Each test drives the rest of a run (``run.main`` with ``device="cpu"``,
which skips the look for a card, and a job cut to a few variants) with
one fault that the cell's entry declares (``entries/<entry>.py:FAULTS``,
``faults.py``) planted in the program's route, and reads the result
line. The statistics entry's: a time step that returns its state
unchanged; half of the batch left out, the statistics taken over the
rest; an answer altered where it is produced. No cell runs across
chips, so no exchange between chips can be left out. A sound run of
each cell comes out correct. The control (the reference in the
precision below the cell's) is judged by ``control.readings`` and fails
every cell's limits.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import control, faults, run  # noqa: E402
from portbench.core import manifest  # noqa: E402

VARIANTS = 24
CELLS = sorted(w["name"] for w in manifest.benchmark()["workloads"])
# (cell, fault): every fault of every cell's entry
PLANTED = [(w, f) for w in CELLS
           for f in faults.names(manifest.Cell(w).spec)]


def result_of(capsys, workload: str, seed: int = 4000000011) -> dict:
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", "0.01", "--trace", "0"], device="cpu",
                  variants=VARIANTS)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(capsys, workload):
    res = result_of(capsys, workload)
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert {"setup_s", "solutions_per_s"} <= set(res["metrics"])


@pytest.mark.parametrize("workload,fault", PLANTED,
                         ids=[f"{w}-{f}" for w, f in PLANTED])
def test_a_planted_fault_is_caught(capsys, workload, fault):
    with faults.planted(manifest.Cell(workload).spec, fault):
        assert result_of(capsys, workload)["correct"] is False


@pytest.mark.parametrize("workload", [
    w for w in CELLS if manifest.Cell(w).spec["entry"] == "mc_tran_stats"])
def test_the_statistics_entry_declares_its_three_faults(workload):
    spec = manifest.Cell(workload).spec
    assert faults.names(spec) == ("frozen", "half", "altered")
    with pytest.raises(ValueError, match="no fault"):
        with faults.planted(spec, "one_pass"):
            pass


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_limits(workload):
    out = control.readings(workload, [], [4000000021], device="cpu",
                           variants=VARIANTS)
    limits = out["limits"]
    assert any(out[f"{n}_upper"] > limits[n] for n in limits), out


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_and_the_faults_fail_the_limits_at_the_cells_size(
        workload):
    """On the card, at the cell's own variants, on three seeds each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size runs there")
    seeds = [4000000031, 4000000032, 4000000033]
    declared = faults.names(manifest.Cell(workload).spec)
    out = control.readings(workload, [], seeds, faults=declared,
                           fault_seeds=seeds)
    limits = out["limits"]
    assert any(out[f"{n}_upper"] > limits[n] for n in limits), out
    for fault in declared:
        assert any(out[f"{n}_{fault}"] > limits[n] for n in limits), fault
