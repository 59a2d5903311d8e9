"""The port's spans (``profiling/trace.py``) on the CPU.

Off (no profiler recording) a span is one shared null context and records
nothing. Inside ``torch.profiler.profile()`` nested spans record their
count and host time, each on the clock of the profiler's own host event of
the same name, which is a function and not a user annotation (the profiler
would copy an annotation onto the device's timeline); a raising body
records nothing; past the bound a name's records stop. The stream runner
records one ``stream.pass`` a pass and equalize one of each stage a chunk,
inside its pass, with the same output bytes on and off.
"""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hipe_tpu_torch.models import pipelines as plib
from hipe_tpu_torch.ops import equalize as teq
from hipe_tpu_torch.profiling import trace
from hipe_tpu_torch.runtime.device_stream import DeviceStreamRunner
from hipe_tpu_torch.utils.images import checker_image

STAGES = ("stats.histogram", "stats.lut", "stats.apply")


@pytest.fixture(autouse=True)
def no_records():
    trace.reset()
    yield
    trace.reset()


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


def _runner(name, num_images=3):
    return DeviceStreamRunner(name, num_images=num_images, image=checker_image(24, 20, 3, seed=5),
                              device="cpu")


def test_off_is_one_shared_null_context_and_records_nothing():
    a, b = trace.span("x"), trace.span("y", torch.device("cpu"))
    assert a is b
    with a:
        with trace.span("z"):
            pass
    _runner("blur3").run_passes(2)
    teq.equalize_planar(torch.zeros((3, 8, 8), dtype=torch.uint8))
    assert trace.summary() == {}


def test_nested_spans_record_count_and_host_time():
    with _profile():
        for _ in range(3):
            with trace.span("outer"):
                time.sleep(0.002)
                with trace.span("inner", "cpu"):
                    time.sleep(0.003)
    s = trace.summary()
    outer, inner = s["outer"], s["inner"]
    assert outer["n"] == inner["n"] == 3
    assert inner["host_ms_median"] >= 3.0
    assert outer["host_ms_median"] >= inner["host_ms_median"] + 2.0
    assert outer["device_ms_total"] is None and inner["device_ms_total"] is None


def test_records_lie_on_the_profilers_clock():
    with _profile() as prof:
        for _ in range(2):
            with trace.span("clock.outer"):
                with trace.span("clock.inner"):
                    torch.ones(64).sum()
    host = {}
    for e in prof.profiler.kineto_results.events():
        host.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    for name in ("clock.outer", "clock.inner"):
        recs = trace._records[name]
        assert len(recs) == 2
        for r in recs:
            assert any(abs(s - r.start_ns) <= 1_000_000 and abs(t - r.end_ns) <= 1_000_000
                       for s, t in host.get(name, [])), (name, r, host.get(name))


def test_span_is_a_host_function_not_a_user_annotation():
    with _profile() as prof:
        with trace.span("fn.span"):
            torch.ones(8).sum()
        with torch.profiler.record_function("user.annotation"):
            pass
    kinds = {e.name(): e.is_user_annotation() for e in prof.profiler.kineto_results.events()}
    assert kinds["fn.span"] is False
    assert kinds["user.annotation"] is True


def test_raising_body_records_nothing_and_leaves_no_span_open():
    with _profile() as prof:
        with trace.span("kept"):
            with pytest.raises(ValueError):
                with trace.span("raised"):
                    raise ValueError("x")
        with pytest.raises(ValueError):
            with trace.span("raised"):
                raise ValueError("y")
        with trace.span("after"):
            pass
    spans = trace.summary()
    assert "raised" not in spans
    assert spans["kept"]["n"] == spans["after"]["n"] == 1
    # The profiler's own events of the raising spans were closed.
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("raised") == 2 and names.count("kept") == 1


def test_records_stop_at_the_bound(monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 2)
    with _profile():
        for _ in range(5):
            with trace.span("many"):
                pass
        with trace.span("few"):
            pass
    s = trace.summary()
    assert s["many"]["n"] == 2 and s["few"]["n"] == 1
    trace.reset()
    assert trace.summary() == {}


def test_spans_of_every_thread_are_recorded():
    def work():
        with trace.span("worker"):
            pass

    with _profile():
        with trace.span("main"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    spans = trace.summary()
    assert spans["worker"]["n"] == spans["main"]["n"] == 1


@pytest.mark.parametrize("name", ["blur3", "chain", "equalize"])
def test_stream_runner_records_each_pass(name):
    runner = _runner(name)
    with _profile():
        runner.run_passes(3)
    spans = trace.summary()
    assert spans["stream.pass"]["n"] == 3
    assert spans["stream.pass"]["device_ms_total"] is None
    assert set(spans) == ({"stream.pass", *STAGES} if name == "equalize" else {"stream.pass"})


def test_equalize_records_each_stage_once_a_call():
    planes = torch.from_numpy(checker_image(16, 12, 3, seed=9)).permute(2, 0, 1).contiguous()
    with _profile():
        teq.equalize_planar(planes)
    spans = trace.summary()
    assert set(spans) == set(STAGES)
    for stage in STAGES:
        assert spans[stage]["n"] == 1


@pytest.mark.parametrize("chunks", [1, 3])
def test_equalize_stages_lie_inside_their_pass(chunks, monkeypatch):
    """One of each stage a chunk, in order, inside its ``stream.pass``."""
    runner = _runner("equalize")
    per_image = 3 * 24 * 20 * plib.STATS_TEMP_BYTES["equalize"]
    monkeypatch.setattr(plib, "STATS_CHUNK_BYTES", per_image * (3 if chunks == 1 else 1))
    with _profile():
        runner.run_passes(2)
    spans = trace.summary()
    assert spans["stream.pass"]["n"] == 2
    passes = trace._records["stream.pass"]
    for stage in STAGES:
        assert spans[stage]["n"] == 2 * chunks
    for i, p in enumerate(passes):
        stages = [trace._records[s][i * chunks + c] for c in range(chunks) for s in STAGES]
        ends = [(r.start_ns, r.end_ns) for r in stages]
        assert p.start_ns <= ends[0][0] and ends[-1][1] <= p.end_ns
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))


@pytest.mark.parametrize("name", ["blur3", "chain", "equalize"])
def test_outputs_are_the_same_bytes_on_and_off(name):
    runner = _runner(name)
    off = runner.run_passes(3).clone()
    with _profile():
        on = runner.run_passes(3).clone()
    assert trace.summary()["stream.pass"]["n"] == 3
    assert torch.equal(on, off)
    planes = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (6, 9, 11), np.uint8))
    off = teq.equalize_planar(planes)
    with _profile():
        on = teq.equalize_planar(planes)
    assert torch.equal(on, off)
