"""The ``program_span`` metrics read the program's spans after a traced run.

Each driver names the span its step path records once a pass
(``PASS_SPAN``), or ``None``. Each cell runs through the harness on the CPU
at a small size, as ``test_faults.py`` runs it. Traced, a cell whose driver
names a pass span records it once a traced pass, and each ``program_span``
metric it lists reads from those records, or reads nothing only for want of
device time; a cell whose driver names none lists no such metric. A cell on
the stream driver reports ``stream.host_ms_per_pass`` from as many
``stream.pass`` records as the traced passes, and no device metric (the
CPU has no device time). Untraced, a cell reports none of them. A program
without the spans' module, or records that are not the traced window's,
give every reader nothing.
"""

import sys
import time

import pytest
import torch

import harness
from cells import NAMES as CELLS, cell as make_cell
from hipe_tpu_torch.profiling import trace

SPAN_METRICS = {m["name"] for m in harness.load_manifest()["per_layer"]
                if m["source"] == "program_span"}
STREAM_SPAN_METRICS = {"stream.host_ms_per_pass", "stats.histogram_ms", "stats.lut_ms",
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
    readings["pass_span"] = cell.driver().PASS_SPAN
    return cell, result, readings


def _read_from_the_records(cell, result, readings, listed, monkeypatch):
    """Each metric of ``listed`` reads the kept records as the run reported
    it, or nothing only where a span lacks device time; with the records
    forgotten, nothing."""
    timed = {k: dict(v, device_ms_total=v["device_ms_total"] or 1.0)
             for k, v in trace.summary().items()}
    for m in cell.metrics("per_layer"):
        if m["name"] not in listed:
            continue
        reader = cell.metric_reader(m["name"])
        value = reader.read(readings)
        if value is None:
            assert m["name"] not in result["metrics"]
            with monkeypatch.context() as mp:
                mp.setattr(trace, "summary", lambda: timed)
                assert reader.read(readings) is not None, m["name"]
        else:
            assert result["metrics"][m["name"]] == {"value": value, "unit": m["unit"]}
    trace.reset()
    assert all(cell.metric_reader(name).read(readings) is None for name in listed)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_host_time_from_every_traced_pass(name, monkeypatch):
    cell, result, readings = _run(name, True, monkeypatch)
    spans = trace.summary()
    pass_span = readings["pass_span"]
    listed = {m["name"] for m in cell.metrics("per_layer") if m["source"] == "program_span"}
    assert readings["trace"]["passes"] > 0
    if pass_span is not None:
        assert spans[pass_span]["n"] == readings["trace"]["passes"]
    else:
        assert not listed
    if cell.traffic["driver"] == "stream":
        assert pass_span == "stream.pass"
        assert spans["stream.pass"]["n"] == readings["trace"]["passes"]
        assert result["metrics"]["stream.host_ms_per_pass"] == {
            "value": spans["stream.pass"]["host_ms_median"], "unit": "ms"}
        assert "stream.host_ms_per_pass" in listed
        assert ({"stats.histogram_ms", "stats.lut_ms", "stats.apply_ms"} <= listed) == (
            name == "stream_equalize")
        # The CPU has no device time.
        assert set(result["metrics"]) & STREAM_SPAN_METRICS == {"stream.host_ms_per_pass"}
    if pass_span is not None:
        _read_from_the_records(cell, result, readings, listed, monkeypatch)
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
    one = {"trace": {"passes": 1}, "pass_span": "stream.pass"}
    assert host.read(one) == trace.summary()["stream.pass"]["host_ms_median"]
    # A checkout whose program has no such module.
    monkeypatch.setitem(sys.modules, "hipe_tpu_torch.profiling.trace", None)
    monkeypatch.delattr(profiling, "trace")
    for name in sorted(SPAN_METRICS):
        assert cell.metric_reader(name).read(one) is None
    monkeypatch.undo()
    trace.reset()


def test_readers_give_nothing_where_the_records_are_not_the_windows():
    """Records left by an earlier profiler session in the process, an
    untraced run's readings, or a cell whose pass span is another or none,
    are not read as the traced window's."""
    cell = make_cell("stream_equalize")
    trace.reset()
    _one_traced_pass()
    _one_traced_pass()
    host = cell.metric_reader("stream.host_ms_per_pass")
    assert host.read({"trace": {"passes": 2}, "pass_span": "stream.pass"}) is not None
    for readings in ({"trace": {"passes": 1}, "pass_span": "stream.pass"},
                     {"trace": None, "pass_span": "stream.pass"}, {},
                     {"trace": {"passes": 2}, "pass_span": None},
                     {"trace": {"passes": 2}, "pass_span": "serve.transcode"}):
        for name in sorted(SPAN_METRICS):
            assert cell.metric_reader(name).read(readings) is None
    trace.reset()
