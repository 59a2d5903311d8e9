"""The control, at a size a test run holds: the reference in bfloat16 in
the program's place comes out not correct in every cell, and the reference
in float32 (the configuration's precision) comes out correct."""

import pytest
import torch

import control
from cells import NAMES as CELLS, cell as make_cell


def _cell(name, seed):
    cell = make_cell(name)
    cell.config.update(num_images=24, height=40, width=36)
    cell.seed, cell.device = seed, torch.device("cpu")
    return cell


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7, 90210])
def test_bfloat16_control_fails(name, seed):
    res = control.control(_cell(name, seed), torch.bfloat16)
    assert not res["correct"]
    assert res["checks"]["max_abs_err"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_float32_reference_passes(name):
    assert control.control(_cell(name, 11), torch.float32)["correct"]
