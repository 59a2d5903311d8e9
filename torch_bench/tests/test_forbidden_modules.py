"""A run in whose process JAX or the JAX package is loaded once the window
has closed raises and gives no result; the port's own modules, whose name
starts with the JAX package's, do not count."""

import sys
import time
import types

import pytest
import torch

import harness
from cells import cell as make_cell


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla_extension", "flax.linen",
                                  "hipe_tpu.ops"])
def test_run_with_a_forbidden_module_loaded_raises(name, monkeypatch):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    cell = make_cell("stream_blur3")
    cell.config.update(num_images=6, height=16, width=24)
    cell.seed, cell.device = 2 ** 31 + 11, torch.device("cpu")
    with pytest.raises(RuntimeError, match=name.replace(".", r"\.")):
        harness.run(cell, 0.1, False, time.perf_counter(), log=lambda msg: None)


def test_names_are_compared_whole(monkeypatch):
    for name in ("hipe_tpu_torch.stand_in", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert "hipe_tpu_torch" in sys.modules
    assert harness.forbidden_modules() == []
