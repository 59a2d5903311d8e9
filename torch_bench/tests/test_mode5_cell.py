"""The mode filter's cell, ``stream_mode5``: its files, its pass bound by
hand, its readers, and a traced run's spans.

The bound: 5000 planar RGB 320x240 images, 1,152,000,000 B of stream, read
once and written once; 10 int32 operations a pixel (a sliding histogram's 5
values in and 5 out) over the int32 peak, which the bytes exceed. The
reference is plain torch. Traced on the CPU with its pass split into
chunks, a run is correct and records one ``stats.mode`` a chunk and one
``stream.pass`` a traced pass.
"""

import ast
import time

import pytest
import torch

import harness
from hipe_tpu_torch.models import pipelines as plib
from hipe_tpu_torch.profiling import trace

NAME = "stream_mode5"


def test_cell_resolves_every_file():
    cell = harness.resolve(NAME)
    assert cell.config["name"] == "modefilter5_5000x320x240_rgb"
    assert cell.traffic == {"driver": "stream", "pipeline": "mode5", "passes_per_step": 1}
    assert cell.chips == 1
    for mod in (cell.driver(), cell.reference(), cell.generator(), cell.work()):
        assert mod is not None
    assert {m["name"] for m in cell.metrics("end_to_end")} == {"img_per_s", "setup_s"}
    per_layer = {m["name"] for m in cell.metrics("per_layer")}
    assert per_layer == {"stream.host_ms_per_pass", "stats.mode_ms", "stats.mode_roofline"}
    for m in cell.metrics("per_layer"):
        assert callable(cell.metric_reader(m["name"]).read)


def test_reference_is_plain_torch():
    path = harness.BENCH_DIR / "reference" / "mode5.py"
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert roots == {"torch"}


def test_pass_bound_matches_the_hand_count():
    cell = harness.resolve(NAME)
    assert cell.shape == (5000, 240, 320, 3)
    work = cell.work()
    assert work.bytes_moved(*cell.shape) == 2 * 1_152_000_000 == 2_304_000_000
    assert work.operations(*cell.shape) == 10 * 1_152_000_000
    assert work.PEAK == "int32_ops_per_s"
    assert round(cell.bound_s_per_pass() * 1e3, 4) == 0.6878


def test_roofline_reads_the_bound_over_the_busy_time_a_pass():
    cell = harness.resolve(NAME)
    reader, bound = cell.metric_reader("stats.mode_roofline"), cell.bound_s_per_pass()
    r = {"trace": {"passes": 2, "busy_s": 2 * 1.3}, "bound_s_per_pass": bound}
    assert reader.read(r) == pytest.approx(100 * bound / 1.3)
    assert reader.read(dict(r, trace={"passes": 2, "busy_s": 0.0})) is None
    assert reader.read(dict(r, trace=None)) is None


def test_traced_run_records_one_mode_span_a_chunk(monkeypatch):
    cell = harness.resolve(NAME)
    cell.config.update(num_images=30, height=32, width=40)
    cell.seed, cell.device = 2 ** 31 + 29, torch.device("cpu")
    # Chunks of 4 images: 8 a pass over 30 images.
    monkeypatch.setattr(plib, "STATS_CHUNK_BYTES", 4 * 3 * 32 * 40 * plib.STATS_TEMP_BYTES["mode5"])
    readings = {}
    measure = harness.measure

    def kept(*args, **kw):
        readings.update(measure(*args, **kw))
        return readings

    monkeypatch.setattr(harness, "measure", kept)
    trace.reset()
    result = harness.run(cell, 0.2, True, time.perf_counter(), log=lambda msg: None)
    spans = trace.summary()
    trace.reset()
    assert result["correct"] and result["window"]["compared_images"] == 30
    assert result["checks"]["max_abs_err"]["value"] == 0
    passes = readings["trace"]["passes"]
    assert passes > 0 and readings["trace"]["steps"] == passes
    assert spans["stream.pass"]["n"] == passes
    assert spans["stats.mode"]["n"] == 8 * passes
    assert result["metrics"]["stream.host_ms_per_pass"]["value"] == \
        spans["stream.pass"]["host_ms_median"]
    # The CPU has no device time and no device trace.
    assert "stats.mode_ms" not in result["metrics"]
    assert "stats.mode_roofline" not in result["metrics"]
