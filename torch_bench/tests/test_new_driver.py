"""A cell on a driver the benchmark does not have is new files and manifest
entries, and is held to the same faults and control as every cell.

A copy of the benchmark gets a driver over interleaved ``(B, H, W*C)`` rows
stepping through ``Pipeline.apply_rows`` (``rows_driver.py``, as
``drivers/rows.py``), a configuration, a traffic file and manifest entries;
no file of the copy is edited. On the CPU at a test size a sound run is
correct; each fault planted at the points the new driver declares makes
the run not correct; the reference in bfloat16 in the program's place is
not correct, in float32 it is.
"""

import time
from pathlib import Path

import pytest
import torch

import control
import faults
import harness
from cells import add_cell

HERE = Path(__file__).resolve().parent
NAME = "rows_blur3"
CONFIG = "resident_12x40x24_rgb_rows"


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """``(root, bench)`` of a checkout with the new cell's files added."""
    root = tmp_path_factory.mktemp("checkout")
    cfg = dict(harness.resolve("stream_blur3").config, name=CONFIG, num_images=12,
               height=40, width=24, entry="Pipeline.apply_rows",
               residency="device: interleaved (12, 40, 72) uint8 rows")
    bench = add_cell(root, NAME, cfg, NAME,
                     {"driver": "rows", "pipeline": "blur3", "passes_per_step": 2},
                     {"drivers/rows.py": HERE / "rows_driver.py"})
    return root, bench


def _cell(copy, seed):
    cell = harness.resolve(NAME, *copy)
    cell.seed, cell.device = seed, torch.device("cpu")
    return cell


def _run(cell, trace=False):
    return harness.run(cell, 0.2, trace, time.perf_counter(), log=lambda msg: None)


def test_new_driver_cell_is_new_files_only(copy):
    _, bench = copy
    added = {"drivers/rows.py", f"configs/{CONFIG}.json", f"traffic/{NAME}.json"}
    for path in bench.rglob("*"):
        rel = path.relative_to(bench).as_posix()
        if path.is_file() and "__pycache__" not in rel and rel not in added:
            assert path.read_bytes() == (harness.BENCH_DIR / rel).read_bytes(), rel
    manifest = harness.load_manifest(copy[0])
    for group in ("configs", "workloads"):
        assert manifest[group][:-1] == harness.load_manifest()[group]
    cell = _cell(copy, 1)
    assert cell.shape == (12, 40, 24, 3) and cell.traffic["driver"] == "rows"
    faults.check_declarations(cell.driver(), [cell])


def test_new_driver_sound_run_is_correct(copy):
    cell = _cell(copy, 2 ** 31 + 9)
    result = _run(cell, trace=True)
    assert result["correct"] and result["failed"] == 0
    assert result["window"]["compared_images"] == 12
    assert set(result["window"]["setup_parts"]) == set(cell.driver().SETUP_PARTS)
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", faults.FAULTS, ids=lambda f: f"_{f}")
def test_new_driver_fault_is_caught(copy, fault, monkeypatch):
    cell = _cell(copy, 2 ** 31 + 3)
    faults.plant_all(monkeypatch, cell, fault)
    result = _run(cell)
    assert not result["correct"]
    assert result["failed"] > 0


@pytest.mark.parametrize("dtype,correct", [(torch.bfloat16, False), (torch.float32, True)],
                         ids=["bfloat16_fails", "float32_passes"])
def test_new_driver_control(copy, dtype, correct):
    res = control.control(_cell(copy, 90210), dtype)
    assert res["correct"] is correct
    assert (res["checks"]["max_abs_err"]["value"] > 0) is not correct
