"""Driver of the device-resident stream (``cli stream``):
``DeviceStreamRunner.run_passes``.

The configuration's images are made on the device from the seed, straight
into the runner's resident planar stream. Set-up autotunes the kernels'
launch knob (a stored winner is timed once) and runs one step; the seconds
of each part (runner, data, autotune, warm step) go into the result's
``window.setup_parts``. A step is
``passes_per_step`` chained passes from the resident stream, each reading
the last one's output, as ``run_passes`` chains them; it is enqueued
without a wait. What is compared is the output of the window's last step,
all images, against the reference applied as many times to the images made
again from the seed.

The module-level declarations below are what the benchmark's self-tests
(``tests/test_faults.py``) hold a driver to: the program's callables at
which each fault is planted, how many entries of their leading dimension
an image takes, and the parts ``setup`` times on the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from compare import Tally

# Each fault's points, as "module:Qualified.name" of hipe_tpu_torch: a pass
# over the planar stream, whose output has its input's shape and is where
# the step's output is produced.
_PASS = ("hipe_tpu_torch.models.pipelines:Pipeline.apply_planar",
         "hipe_tpu_torch.models.pipelines:GlobalStatsPipeline.apply_planar")
FAULT_POINTS = {"unchanged": _PASS, "half": _PASS, "altered": _PASS}
# The keys of ``window.setup_parts`` on the CPU (the card adds autotune_s).
SETUP_PARTS = ("runner_s", "data_s", "warm_s")
# The program span the step path records once a pass: run_passes's own.
PASS_SPAN = "stream.pass"


def image_entries(cell) -> int:
    """Entries of a fault point's leading dimension that one image takes:
    its planes."""
    return cell.config["channels"]


class State:
    pass


def setup(cell, log):
    cuda = cell.device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(cell.device)) if cuda else (lambda: None)
    parts, t = {}, time.perf_counter()

    def part(name):
        nonlocal t
        sync()
        now = time.perf_counter()
        parts[name] = now - t
        t = now

    from hipe_tpu_torch.runtime.device_stream import DeviceStreamRunner

    n, h, w, c = cell.shape
    s = State()
    s.passes = int(cell.traffic["passes_per_step"])
    s.runner = DeviceStreamRunner(cell.traffic["pipeline"], num_images=n,
                                  image=np.zeros((h, w, c), np.uint8), device=cell.device)
    part("runner_s")
    cell.generator().fill_planar(s.runner.stream, 0, cell.shape, cell.seed,
                                 cell.config["images"], cell.device)
    part("data_s")
    if cuda:
        s.runner.autotune()
        part("autotune_s")
        tune = s.runner.tuning
        log(f"autotune {tune['chosen']} cache_hit {tune['cache_hit']} "
            f"per_pass_ms {tune['per_pass_s'][tune['chosen']] * 1e3:.4f}")
        print(f"autotune {cell.name} {tune['chosen']} cache_hit={tune['cache_hit']}",
              flush=True)
        cell.notes["autotune"] = tune["chosen"]
    s.out = s.runner.run_passes(s.passes)
    part("warm_s")
    cell.notes["setup_parts"] = parts
    return s


def step(s):
    s.out = s.runner.run_passes(s.passes)
    return s.runner.num_images * s.passes, s.passes


def finish(s):
    """The last step's output; the runner (stream and its other buffer) freed."""
    out = s.out
    del s.runner, s.out
    return out, {"passes": s.passes}


def check(cell, output, meta, block: int = 500) -> dict:
    """Every image of ``output`` against the reference, ``meta['passes']``
    times over the images made again from the seed."""
    ref = cell.reference()
    n, h, w, c = cell.shape
    tally = Tally()
    gen = cell.generator()
    for first in range(0, n, block):
        k = min(block, n - first)
        x = gen.planar(first, k, cell.shape, cell.seed, cell.config["images"], output.device)
        for _ in range(meta["passes"]):
            x = ref.apply(x)
        tally.add(output[first * c:(first + k) * c].reshape(k, c, h, w), x.view(k, c, h, w))
    return {"checks": tally.checks(), "compared": tally.compared}


def control_output(cell, dtype):
    """The control in the program's place: the reference in ``dtype``, as
    many passes as a step, over the whole stream."""
    n, h, w, c = cell.shape
    ref = cell.reference()
    x = cell.generator().planar(0, n, cell.shape, cell.seed, cell.config["images"],
                                cell.device)
    passes = int(cell.traffic["passes_per_step"])
    for first in range(0, n * c, 500 * c):
        blk = x[first:first + 500 * c]
        for _ in range(passes):
            blk = ref.apply(blk, dtype)
        x[first:first + 500 * c] = blk
    return x, {"passes": passes}
