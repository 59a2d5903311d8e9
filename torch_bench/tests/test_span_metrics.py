"""The ``program_span`` metrics read the program's spans after a traced run.

Each cell runs through the harness on the CPU at a small size, as
``test_faults.py`` runs it: traced, it reports ``stream.host_ms_per_pass``
from as many ``stream.pass`` records as the traced passes, and no device
metric (the CPU has no device time); untraced, it reports none of them.
A program without the spans' module, or records that are not the traced
window's, give every reader nothing.
"""

import sys
import time

import pytest
import torch

import harness
from cells import NAMES as CELLS, cell as make_cell
from hipe_tpu_torch.profiling import trace

SPAN_METRICS = {"stream.host_ms_per_pass", "stats.histogram_ms", "stats.lut_ms",
                "stats.apply_ms"}


def _run(name, traced, monkeypatch):
    cell = make_cell(name)
    cell.config.update(num_images=30, height=32, width=40)
    cell.seed, cell.device = 2 ** 31 + 11, torch.device("cpu")
    readings = {}
    measure = harness.measure

    def kept(*args, **kw):
        readings.update(measure(*args, **kw))
        return readings

    monkeypatch.setattr(harness, "measure", kept)
    trace.reset()
    result = harness.run(cell, 0.2, traced, time.perf_counter(), log=lambda msg: None)
    assert result["correct"]
    return cell, result, readings


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_host_time_from_every_traced_pass(name, monkeypatch):
    cell, result, readings = _run(name, True, monkeypatch)
    spans = trace.summary()
    assert readings["trace"]["passes"] > 0
    assert spans["stream.pass"]["n"] == readings["trace"]["passes"]
    assert result["metrics"]["stream.host_ms_per_pass"] == {
        "value": spans["stream.pass"]["host_ms_median"], "unit": "ms"}
    listed = {m["name"] for m in cell.metrics("per_layer")} & SPAN_METRICS
    assert "stream.host_ms_per_pass" in listed
    assert ({"stats.histogram_ms", "stats.lut_ms", "stats.apply_ms"} <= listed) == (
        name == "stream_equalize")
    # The CPU has no device time.
    assert set(result["metrics"]) & SPAN_METRICS == {"stream.host_ms_per_pass"}
    trace.reset()


@pytest.mark.parametrize("name", CELLS)
def test_untraced_run_reports_no_span_metric(name, monkeypatch):
    _, result, _ = _run(name, False, monkeypatch)
    assert not set(result["metrics"]) & SPAN_METRICS
    assert trace.summary() == {}


def _one_traced_pass():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("stream.pass"):
            pass


def test_readers_give_nothing_without_the_programs_spans(monkeypatch):
    import hipe_tpu_torch.profiling as profiling

    cell = make_cell("stream_equalize")
    trace.reset()
    _one_traced_pass()
    host = cell.metric_reader("stream.host_ms_per_pass")
    one = {"trace": {"passes": 1}}
    assert host.read(one) == trace.summary()["stream.pass"]["host_ms_median"]
    # A checkout whose program has no such module.
    monkeypatch.setitem(sys.modules, "hipe_tpu_torch.profiling.trace", None)
    monkeypatch.delattr(profiling, "trace")
    for name in sorted(SPAN_METRICS):
        assert cell.metric_reader(name).read(one) is None
    monkeypatch.undo()
    trace.reset()


def test_readers_give_nothing_where_the_records_are_not_the_windows():
    """Records left by an earlier profiler session in the process, or an
    untraced run's readings, are not read as the traced window's."""
    cell = make_cell("stream_equalize")
    trace.reset()
    _one_traced_pass()
    _one_traced_pass()
    host = cell.metric_reader("stream.host_ms_per_pass")
    assert host.read({"trace": {"passes": 2}}) is not None
    for readings in ({"trace": {"passes": 1}}, {"trace": None}, {}):
        for name in sorted(SPAN_METRICS):
            assert cell.metric_reader(name).read(readings) is None
    trace.reset()
