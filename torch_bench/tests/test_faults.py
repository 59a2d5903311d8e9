"""A run with the timed path broken underneath comes out not correct.

Each cell is run through the harness on the CPU at a small size (the look
for a card skipped), with the program patched, at the points its driver
declares (``faults.py``), to one fault a cell of one chip can have: a
point that returns its input unchanged, half of the batch left as it came
in, one output element altered where it is produced. The comparison has to
catch each.
"""

import time

import pytest
import torch

import faults
import harness
from cells import NAMES as CELLS, cell as make_cell


def small(name, seed):
    cell = make_cell(name)
    cell.config.update(num_images=30, height=32, width=40)
    cell.seed, cell.device = seed, torch.device("cpu")
    return cell


@pytest.mark.parametrize("fault", faults.FAULTS, ids=lambda f: f"_{f}")
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_caught(name, fault, monkeypatch):
    cell = small(name, 2 ** 31 + 3)
    faults.plant_all(monkeypatch, cell, fault)
    result = harness.run(cell, 0.2, False, time.perf_counter(), log=lambda msg: None)
    assert not result["correct"]
    assert result["failed"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_traced(name):
    cell = small(name, 77)
    result = harness.run(cell, 0.2, True, time.perf_counter(), log=lambda msg: None)
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["window"]["setup_parts"]) == set(cell.driver().SETUP_PARTS)
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
