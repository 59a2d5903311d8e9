"""The codec cell, ``codec_transcode``: its pass bound by hand, its control
at a test size, and a traced run's stage spans.

The bound: 5000 4:2:0 sets of 320x240, 1800 blocks of 64 int16 a set, read
once and written once; libjpeg's operations (``work/transcode.py``), 142.375
a pixel, over the int32 peak, which sets it. The control: the reference's
transcode with its filter in bfloat16, in the program's place, is not
correct; in float32 it is. Traced on the CPU, a run records
``serve.transcode`` and each of the five stage spans once a traced pass.
"""

import time

import pytest
import torch

import control
import harness
from hipe_tpu_torch.profiling import trace

NAME = "codec_transcode"
STAGES = ("codec.idct", "codec.upsample_color", "codec.filter", "codec.color_downsample",
          "codec.fdct")


def _cell(seed, n=30, h=32, w=40):
    cell = harness.resolve(NAME)
    cell.config.update(num_images=n, height=h, width=w)
    cell.seed, cell.device = seed, torch.device("cpu")
    return cell


def test_pass_bound_matches_the_hand_count():
    cell = harness.resolve(NAME)
    assert cell.shape == (5000, 240, 320, 3)
    work = cell.work()
    assert work.bytes_moved(*cell.shape) == 2 * 5000 * 1800 * 64 * 2 == 2_304_000_000
    assert work.operations(*cell.shape) == 5000 * 240 * 320 * 142.375 == 54_672_000_000
    assert work.PEAK == "int32_ops_per_s"
    assert round(cell.bound_s_per_pass() * 1e3, 4) == 1.6344


@pytest.mark.parametrize("h,w", [(32, 40), (17, 23)], ids=["32x40", "17x23"])
@pytest.mark.parametrize("dtype,correct", [(torch.bfloat16, False), (torch.float32, True)],
                         ids=["bfloat16_fails", "float32_passes"])
def test_control(h, w, dtype, correct):
    res = control.control(_cell(2 ** 31 + 21, 12, h, w), dtype)
    assert res["correct"] is correct and res["compared_images"] == 12
    assert (res["checks"]["max_abs_err"]["value"] > 0) is not correct
    assert (res["checks"]["wrong_images"]["value"] > 0) is not correct


def test_traced_run_records_each_stage_once_a_pass():
    cell = _cell(2 ** 31 + 23)
    readings = {}
    measure = harness.measure

    def kept(*args, **kw):
        readings.update(measure(*args, **kw))
        return readings

    trace.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "measure", kept)
        result = harness.run(cell, 0.2, True, time.perf_counter(), log=lambda msg: None)
    spans = trace.summary()
    trace.reset()
    assert result["correct"] and result["window"]["compared_images"] == 30
    passes = readings["trace"]["passes"]
    assert passes > 0 and readings["trace"]["steps"] == passes
    assert spans["serve.transcode"]["n"] == passes
    assert all(spans[name]["n"] == passes for name in STAGES)
    assert result["metrics"]["serve.host_ms_per_pass"]["value"] == \
        spans["serve.transcode"]["host_ms_median"]
