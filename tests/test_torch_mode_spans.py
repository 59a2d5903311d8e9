"""The mode filter's span (``profiling/trace.py``) on the CPU.

``mode_planar`` records one ``stats.mode`` a call, at either size, while a
profiler records, and none otherwise. ``GlobalStatsPipeline`` calls it once
a chunk, so a chunked mode5 pass records one a chunk, each inside its
``stream.pass``, with the same bytes on and off.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hipe_tpu_torch.models import pipelines as plib
from hipe_tpu_torch.ops import equalize as teq
from hipe_tpu_torch.profiling import trace
from hipe_tpu_torch.runtime.device_stream import DeviceStreamRunner
from hipe_tpu_torch.utils.images import checker_image


@pytest.fixture(autouse=True)
def no_records():
    trace.reset()
    yield
    trace.reset()


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


def _planes(seed, n=6, h=13, w=17):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 4, (n, h, w), np.uint8) * 85)


@pytest.mark.parametrize("size", [3, 5])
def test_a_call_records_one_span_at_either_size(size):
    planes = _planes(size)
    off = teq.mode_planar(planes, size=size)
    assert trace.summary() == {}
    with _profile():
        on = teq.mode_planar(planes, size=size)
    spans = trace.summary()
    assert set(spans) == {"stats.mode"}
    assert spans["stats.mode"]["n"] == 1
    # The CPU has no device time.
    assert spans["stats.mode"]["device_ms_total"] is None
    assert torch.equal(on, off)


@pytest.mark.parametrize("chunks", [1, 3])
def test_a_chunked_pass_records_one_span_a_chunk(chunks, monkeypatch):
    """Two passes of the stream runner over 3 RGB images: one ``stats.mode``
    a chunk, inside its ``stream.pass``; none untraced."""
    runner = DeviceStreamRunner("mode5", num_images=3, image=checker_image(24, 20, 3, seed=5),
                                device="cpu")
    per_image = 3 * 24 * 20 * plib.STATS_TEMP_BYTES["mode5"]
    monkeypatch.setattr(plib, "STATS_CHUNK_BYTES", per_image * (3 if chunks == 1 else 1))
    off = runner.run_passes(2).clone()
    assert trace.summary() == {}
    with _profile():
        on = runner.run_passes(2).clone()
    spans = trace.summary()
    assert set(spans) == {"stream.pass", "stats.mode"}
    assert spans["stream.pass"]["n"] == 2
    assert spans["stats.mode"]["n"] == 2 * chunks
    modes = trace._records["stats.mode"]
    for i, p in enumerate(trace._records["stream.pass"]):
        inside = modes[i * chunks:(i + 1) * chunks]
        assert all(p.start_ns <= r.start_ns and r.end_ns <= p.end_ns for r in inside)
    assert torch.equal(on, off)
