"""The ``program_counter`` metrics read the program's counters after a
traced run: the card's clocks and clock-limit share, sampled while the
profiler records, and the launches through the launch seam.

Each reader reads through ``program_spans.spans``, so it stands only where
the driver's pass span has as many records as the traced passes. With a
stand-in card (``nvml.open_device`` patched) each gives the summary's
value; untraced, after ``reset()``, or where the records are not the traced
window's, each gives nothing. A traced run of each cell on the CPU (no
card, no seam launch) reports ``kernels.launches_per_pass`` 0 and none of
the device counters, and an untraced one none of the four. A program
without the counters gives nothing.
"""

import sys
import time
import types

import pytest
import torch

import harness
from cells import NAMES as CELLS, cell as make_cell
from hipe_tpu_torch.profiling import nvml, trace

COUNTER_METRICS = {m["name"] for m in harness.load_manifest()["per_layer"]
                   if m["source"] == "program_counter"}
DEVICE_COUNTERS = {"device.sm_clock_mhz", "device.mem_clock_mhz", "device.clock_limited_pct"}
LAUNCHES = "kernels.launches_per_pass"
# (SM MHz, memory MHz, reasons): one sample of three under the power cap.
SCRIPT = [(1980, 2619, 0x0), (1965, 2619, 0x4), (1980, 2619, 0x1)]


@pytest.fixture(autouse=True)
def no_records():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture
def card(monkeypatch):
    """A card that answers the script once, then fails (sampling ends)."""
    answers = iter(SCRIPT)
    device = types.SimpleNamespace(sample=lambda: next(answers, None))
    monkeypatch.setattr(nvml, "open_device", lambda index: device)


def _traced_passes(n, launches=0, wait=True):
    """``n`` traced ``stream.pass`` spans, the first ``launches`` seam
    launches counted inside the session (a stand-in wrapper's counter)."""
    wrapper = trace.counts_launches(types.SimpleNamespace(launches=0))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(n):
            with trace.span("stream.pass"):
                wrapper.launches += launches if i == 0 else 0
                if wait and i == 0:
                    time.sleep(10 * trace.SAMPLE_PERIOD_S)


def _read(name, readings):
    return make_cell("stream_equalize").metric_reader(name).read(readings)


def test_the_manifest_lists_the_four_counters_in_every_cell():
    assert COUNTER_METRICS == DEVICE_COUNTERS | {LAUNCHES}
    for m in harness.load_manifest()["per_layer"]:
        if m["name"] in COUNTER_METRICS:
            assert m["workloads"] == CELLS and m["moves"] == "img_per_s"
            assert m["layer"] == ("device" if m["name"] in DEVICE_COUNTERS else
                                  "kernels (ops/cuda_*, csrc/, ops/equalize.py)")


def test_each_reader_gives_the_summarys_value_where_the_pass_span_matches(card):
    _traced_passes(2, launches=6)
    s = trace.summary()
    two = {"trace": {"passes": 2}, "pass_span": "stream.pass"}
    assert _read("device.sm_clock_mhz", two) == s[trace.SM_CLOCK]["median"] == 1980.0
    assert _read("device.mem_clock_mhz", two) == s[trace.MEM_CLOCK]["median"] == 2619.0
    assert _read("device.clock_limited_pct", two) == s[trace.CLOCK_LIMITED]["pct"] == 100 / 3
    assert _read(LAUNCHES, two) == s[trace.LAUNCHES]["n"] / 2 == 3.0


@pytest.mark.parametrize("readings", [
    {"trace": {"passes": 1}, "pass_span": "stream.pass"},  # another session's records too
    {"trace": None, "pass_span": "stream.pass"},  # untraced
    {},
    {"trace": {"passes": 2}, "pass_span": None},  # a driver with no pass span
    {"trace": {"passes": 2}, "pass_span": "serve.transcode"},
], ids=["other-records", "untraced", "empty", "no-pass-span", "other-span"])
def test_each_reader_gives_nothing_where_the_records_are_not_the_windows(card, readings):
    _traced_passes(2, launches=4)
    for name in sorted(COUNTER_METRICS):
        assert _read(name, readings) is None, name
    # After reset(), nothing for any readings.
    trace.reset()
    for name in sorted(COUNTER_METRICS):
        assert _read(name, {"trace": {"passes": 2}, "pass_span": "stream.pass"}) is None


def test_a_session_without_launches_reads_zero_and_without_samples_no_clock(monkeypatch):
    monkeypatch.setattr(nvml, "open_device", lambda index: None)
    _traced_passes(3, wait=False)
    three = {"trace": {"passes": 3}, "pass_span": "stream.pass"}
    assert _read(LAUNCHES, three) == 0
    for name in sorted(DEVICE_COUNTERS):
        assert _read(name, three) is None


def test_a_program_without_the_counters_gives_nothing(card, monkeypatch):
    """A parent checkout: the spans' module without counters, or none."""
    import hipe_tpu_torch.profiling as profiling

    _traced_passes(1, launches=2)
    one = {"trace": {"passes": 1}, "pass_span": "stream.pass"}
    assert _read(LAUNCHES, one) == 2
    spans_only = {k: v for k, v in trace.summary().items() if k == "stream.pass"}
    old = types.SimpleNamespace(summary=lambda: spans_only)
    monkeypatch.setattr(profiling, "trace", old)
    monkeypatch.setitem(sys.modules, "hipe_tpu_torch.profiling.trace", old)
    for name in sorted(COUNTER_METRICS):
        assert _read(name, one) is None, name
    monkeypatch.setitem(sys.modules, "hipe_tpu_torch.profiling.trace", None)
    monkeypatch.delattr(profiling, "trace")
    for name in sorted(COUNTER_METRICS):
        assert _read(name, one) is None, name


def _run(name, traced, monkeypatch):
    cell = make_cell(name)
    cell.config.update(num_images=30, height=32, width=40)
    cell.seed, cell.device = 2 ** 31 + 13, torch.device("cpu")
    readings = {}
    measure = harness.measure

    def kept(*args, **kw):
        readings.update(measure(*args, **kw))
        return readings

    monkeypatch.setattr(harness, "measure", kept)
    trace.reset()
    result = harness.run(cell, 0.2, traced, time.perf_counter(), log=lambda msg: None)
    assert result["correct"]
    return result, readings


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_cpu_run_reports_zero_launches_and_no_device_counter(name, monkeypatch):
    result, readings = _run(name, True, monkeypatch)
    assert readings["trace"]["passes"] > 0
    assert result["metrics"][LAUNCHES] == {"value": 0.0, "unit": "launches"}
    assert not DEVICE_COUNTERS & set(result["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_an_untraced_run_reports_no_counter_and_starts_no_sampler(name, monkeypatch):
    import threading

    result, _ = _run(name, False, monkeypatch)
    assert not COUNTER_METRICS & set(result["metrics"])
    assert trace._session is None
    assert not [t for t in threading.enumerate() if t.name == "hipe-trace-sampler"]
    assert trace.summary() == {}
