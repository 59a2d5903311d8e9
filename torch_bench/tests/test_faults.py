"""A run with the timed path broken underneath comes out not correct.

Each cell is run through the harness on the CPU at a small size (the look
for a card skipped), with the program's pipeline patched to one fault a
cell of one chip can have: a pass that returns its input unchanged, half
of the batch left unfiltered, one output byte altered where it is
produced. The comparison has to catch each.
"""

import time

import pytest
import torch

import harness
from cells import NAMES as CELLS, cell as make_cell
from hipe_tpu_torch.models import pipelines as plib


def _unchanged(fn):
    def wrapped(self, x, *args, out=None, **kw):
        return x.clone() if out is None else out.copy_(x)
    return wrapped


def _half(fn):
    """Planar (N*C, H, W): the second half of the planes, whole images,
    left unfiltered."""
    def wrapped(self, x, *args, out=None, **kw):
        y = fn(self, x, *args, **kw).clone()
        k, c = x.shape[0] // 2, 3
        y[k - k % c:] = x[k - k % c:]
        return y if out is None else out.copy_(y)
    return wrapped


def _altered(fn):
    def wrapped(self, x, *args, out=None, **kw):
        y = fn(self, x, *args, **kw).clone()
        y.view(-1)[-1] ^= 1
        return y if out is None else out.copy_(y)
    return wrapped


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_caught(name, fault, monkeypatch):
    cell = make_cell(name)
    cell.config.update(num_images=30, height=32, width=40)
    cell.seed, cell.device = 2 ** 31 + 3, torch.device("cpu")
    for cls in (plib.Pipeline, plib.GlobalStatsPipeline):
        monkeypatch.setattr(cls, "apply_planar", fault(cls.apply_planar))
    result = harness.run(cell, 0.2, False, time.perf_counter(), log=lambda msg: None)
    assert not result["correct"]
    assert result["failed"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_traced(name):
    cell = make_cell(name)
    cell.config.update(num_images=30, height=32, width=40)
    cell.seed, cell.device = 77, torch.device("cpu")
    result = harness.run(cell, 0.2, True, time.perf_counter(), log=lambda msg: None)
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["window"]["setup_parts"]) == {"runner_s", "data_s", "warm_s"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
