"""``ServingPipeline.transcode_fn`` on the CPU: the port's transcode equals
the benchmark's plain reference (``torch_bench/reference/transcode.py``),
and a call records its spans (``profiling/trace.py``) only while a
profiler records: ``serve.transcode`` and the five codec stages, once each.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from hipe_tpu_torch.ops import jpeg_decode as jd
from hipe_tpu_torch.profiling import trace
from hipe_tpu_torch.runtime.serve import ServingPipeline

BENCH = Path(__file__).resolve().parents[1] / "torch_bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from gen import photo_like  # noqa: E402
from reference import transcode as ref  # noqa: E402

PARAMS = json.loads((BENCH / "configs" / "codec_5000x320x240_q90_420.json").read_text())["images"]
SPANS = ("serve.transcode", "codec.idct", "codec.upsample_color", "codec.filter",
         "codec.color_downsample", "codec.fdct")


def _sets(n, h, w, seed):
    planes = photo_like.planar(0, n, (n, h, w, 3), seed, PARAMS, "cpu")
    return ref.encode(planes.view(n, 3, h, w).permute(0, 2, 3, 1).contiguous(), 90)


def _transcode(sets, h, w):
    luma, chroma = ref.quant_tables(90)
    geo = jd.DecodeGeometry(width=w, height=h, ncomps=3,
                            comps=tuple((hs, vs, s.shape[2], s.shape[1])
                                        for (hs, vs), s in zip(((2, 2), (1, 1), (1, 1)), sets)),
                            max_h=2, max_v=2)
    serve = ServingPipeline("blur3", device="cpu", decode_on_device=True,
                            encode_on_device=True)
    return serve, serve.transcode_fn(geo, tuple(tuple(q) for q in (luma, chroma, chroma)))


@pytest.mark.parametrize("n,h,w", [(3, 32, 40), (2, 240, 320)], ids=["32x40", "320x240"])
def test_transcode_fn_equals_the_reference(n, h, w):
    sets = _sets(n, h, w, 2 ** 31 + 5 * h)
    serve, fn = _transcode(sets, h, w)
    with serve:
        got = fn(*sets)
    want = ref.apply(sets, h, w, 90)
    assert [g.shape for g in got] == [x.shape for x in want]
    for g, x in zip(got, want):
        assert torch.equal(g, x)


def test_a_traced_call_records_each_span_once():
    sets = _sets(2, 32, 40, 11)
    serve, fn = _transcode(sets, 32, 40)
    trace.reset()
    with serve, torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        fn(*sets)
    spans = trace.summary()
    trace.reset()
    assert set(spans) == set(SPANS)
    assert all(spans[name]["n"] == 1 for name in SPANS)
    # The CPU has no device time.
    assert all(spans[name]["device_ms_total"] is None for name in SPANS)


def test_an_untraced_call_records_no_span():
    sets = _sets(2, 32, 40, 12)
    serve, fn = _transcode(sets, 32, 40)
    trace.reset()
    with serve:
        fn(*sets)
    assert trace.summary() == {}
