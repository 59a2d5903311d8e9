"""Driver of the codec's transcode on the card (``serve`` with
``decode_on_device`` and ``encode_on_device``): the function
``ServingPipeline.transcode_fn`` returns, as ``_transcode_device_coefs``
calls it for a group of one geometry and one set of quant tables.

The configuration's images are made on the device from the seed
(``gen/``) and encoded there by the reference's libjpeg encoder
(``reference/transcode.py``) into the resident coefficient sets: three
``(N, Hb, Wb, 64)`` int16 tensors, Y, Cb and Cr at the configuration's
subsampling and quality, which the host's entropy decode would have handed
the card. Set-up builds the serving pipeline and its transcode function for
the sets' geometry and tables, and runs one step; the seconds of each part
go into the result's ``window.setup_parts``. A step is one call over all
the resident sets (decode, filter, encode), ``passes_per_step`` 1, enqueued
without a wait; the sets are never overwritten. What is compared is the
output of the window's last step, every coefficient of every image,
against the reference's transcode of the sets made again from the seed.

The module-level declarations are what the benchmark's self-tests hold a
driver to (``tests/faults.py``).
"""

from __future__ import annotations

import time

import torch

from compare import Tally

# The filter (its input is interleaved rows, one image a row block) and the
# encoder (its output is a component's coefficients), as serve.py calls
# them: the filter through the Pipeline class, the encoder as
# ``je.encode_planes``.
_FILTER = ("hipe_tpu_torch.models.pipelines:Pipeline.apply_rows",)
_ENCODE = ("hipe_tpu_torch.ops.jpeg_encode:encode_planes",)
FAULT_POINTS = {"unchanged": _FILTER, "half": _FILTER, "altered": _ENCODE}
SETUP_PARTS = ("pipeline_s", "data_s", "warm_s")
# The program span the step records once a call: transcode_fn's own.
PASS_SPAN = "serve.transcode"
# Images the comparison takes at once.
BLOCK = 500


def image_entries(cell) -> int:
    """A row block of the filter's input is one image."""
    return 1


class State:
    pass


def coefficient_sets(cell, first: int, count: int, device) -> list[torch.Tensor]:
    """Images ``[first, first + count)`` of the seed's stream, encoded by the
    reference: ``[Y, Cb, Cr]``, each ``(count, Hb, Wb, 64)`` int16."""
    ref = cell.reference()
    quality = cell.config["quality"]
    parts = []
    for _, block in cell.generator().images(first, count, cell.shape, cell.seed,
                                            cell.config["images"], device):
        parts.append(ref.encode(block.permute(0, 2, 3, 1).contiguous(), quality))
    return [torch.cat(comp) for comp in zip(*parts)]


def _transcode(cell, serve, sets):
    """The serving pipeline's transcode function for the sets' geometry (as
    ``jpeg_decode.geometry_of`` reads it from a stream) and quant tables
    (as the stream's tables would carry them)."""
    from hipe_tpu_torch.ops import jpeg_decode as jd

    _, h, w, c = cell.shape
    luma, chroma = cell.reference().quant_tables(cell.config["quality"])
    samplings = ((2, 2), (1, 1), (1, 1))
    geo = jd.DecodeGeometry(width=w, height=h, ncomps=c,
                            comps=tuple((hs, vs, s.shape[2], s.shape[1])
                                        for (hs, vs), s in zip(samplings, sets)),
                            max_h=2, max_v=2)
    return serve.transcode_fn(geo, tuple(tuple(q) for q in (luma, chroma, chroma)))


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

    from hipe_tpu_torch.runtime.serve import ServingPipeline

    if cell.config["subsampling"] != "420" or cell.shape[3] != 3:
        raise ValueError("the transcode driver takes 3-component 4:2:0 sets")
    s = State()
    s.serve = ServingPipeline(cell.traffic["filter"], device=cell.device,
                              quality=cell.config["quality"], decode_on_device=True,
                              encode_on_device=True,
                              encode_subsampling=cell.config["subsampling"])
    part("pipeline_s")
    s.sets = coefficient_sets(cell, 0, cell.shape[0], cell.device)
    s.fn = _transcode(cell, s.serve, s.sets)
    part("data_s")
    step(s)
    part("warm_s")
    cell.notes["setup_parts"] = parts
    return s


def step(s):
    s.out = s.fn(*s.sets)
    return s.sets[0].shape[0], 1


def finish(s):
    """The last step's output; the sets and the pipeline freed."""
    out = s.out
    s.serve.close()
    del s.serve, s.fn, s.sets, s.out
    return out, {}


def _per_image(comps: list) -> torch.Tensor:
    """The components of a block of images, side by side: (k, coefficients)."""
    return torch.cat([c.reshape(c.shape[0], -1) for c in comps], dim=1)


def _reference(cell, first, count, device, dtype=torch.float32) -> list[torch.Tensor]:
    _, h, w, _ = cell.shape
    return cell.reference().apply(coefficient_sets(cell, first, count, device), h, w,
                                  cell.config["quality"], dtype)


def check(cell, output, meta, block: int = BLOCK) -> dict:
    """Every image's three components against the reference's transcode of
    the sets made again from the seed."""
    n = cell.shape[0]
    tally = Tally()
    for first in range(0, n, block):
        k = min(block, n - first)
        want = _reference(cell, first, k, output[0].device)
        tally.add(_per_image([o[first:first + k] for o in output]), _per_image(want))
    return {"checks": tally.checks(), "compared": tally.compared}


def control_output(cell, dtype):
    """The control in the program's place: the reference's transcode with
    its filter in ``dtype``, over every set."""
    n = cell.shape[0]
    blocks = [_reference(cell, first, min(BLOCK, n - first), cell.device, dtype)
              for first in range(0, n, BLOCK)]
    return [torch.cat(comp) for comp in zip(*blocks)], {}
