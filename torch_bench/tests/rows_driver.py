"""A driver over interleaved rows, for ``test_new_driver.py``: copied into
a copy of the benchmark as ``drivers/rows.py``, it shows that a cell on a
driver the benchmark does not have is new files and manifest entries.

The configuration's images are kept as interleaved ``(B, H, W*C)`` uint8
rows, the layout of the transcode's filter and of the engine's CUDA lane.
A step is ``passes_per_step`` chained ``Pipeline.apply_rows`` calls from
the resident rows, each reading the last one's output. What is compared is
the last step's output, every image, against the reference applied as many
times to the images made again from the seed.
"""

from __future__ import annotations

import time

import torch

from compare import Tally

_ROWS = ("hipe_tpu_torch.models.pipelines:Pipeline.apply_rows",)
FAULT_POINTS = {"unchanged": _ROWS, "half": _ROWS, "altered": _ROWS}
SETUP_PARTS = ("pipeline_s", "data_s", "warm_s")
# The program records no span on the rows path.
PASS_SPAN = None


def image_entries(cell) -> int:
    """A row block is one image."""
    return 1


class State:
    pass


def _rows(planes: torch.Tensor, shape) -> torch.Tensor:
    """Planar ``(n*c, h, w)`` -> interleaved rows ``(n, h, w*c)``."""
    _, h, w, c = shape
    n = planes.shape[0] // c
    return planes.view(n, c, h, w).permute(0, 2, 3, 1).reshape(n, h, w * c)


def _made(cell, first, count, device):
    return _rows(cell.generator().planar(first, count, cell.shape, cell.seed,
                                         cell.config["images"], device), cell.shape)


def setup(cell, log):
    parts, t = {}, time.perf_counter()

    def part(name):
        nonlocal t
        now = time.perf_counter()
        parts[name] = now - t
        t = now

    from hipe_tpu_torch.models import pipelines

    n, h, w, c = cell.shape
    s = State()
    s.pipe, s.channels = pipelines.get(cell.traffic["pipeline"]), c
    s.passes = int(cell.traffic["passes_per_step"])
    part("pipeline_s")
    s.rows = _made(cell, 0, n, cell.device)
    s.bufs = [torch.empty_like(s.rows) for _ in range(2)]
    part("data_s")
    step(s)
    part("warm_s")
    cell.notes["setup_parts"] = parts
    return s


def step(s):
    x = s.rows
    for i in range(s.passes):
        x = s.pipe.apply_rows(x, s.channels, out=s.bufs[i % 2])
    s.out = x
    return s.rows.shape[0] * s.passes, s.passes


def finish(s):
    out = s.out
    del s.rows, s.bufs, s.out
    return out, {"passes": s.passes}


def _reference(cell, first, count, passes, device, dtype=torch.float32):
    ref = cell.reference()
    x = cell.generator().planar(first, count, cell.shape, cell.seed, cell.config["images"],
                                device)
    for _ in range(passes):
        x = ref.apply(x, dtype)
    return _rows(x, cell.shape)


def check(cell, output, meta, block: int = 500) -> dict:
    n = cell.shape[0]
    tally = Tally()
    for first in range(0, n, block):
        k = min(block, n - first)
        tally.add(output[first:first + k],
                  _reference(cell, first, k, meta["passes"], output.device))
    return {"checks": tally.checks(), "compared": tally.compared}


def control_output(cell, dtype):
    passes = int(cell.traffic["passes_per_step"])
    return _reference(cell, 0, cell.shape[0], passes, cell.device, dtype), {"passes": passes}
