"""A cell off the stream path is new files and manifest entries, and is
held to its own pass span.

A copy of the benchmark gets the rows driver (``rows_driver.py``) as
``drivers/rows_spanned.py``, declaring the new pass span ``rows.pass``; a
``program_span`` metric ``rows.host_ms_per_pass`` that reads that span's
host median; a configuration, a traffic file and manifest entries. No file
of the copy is edited. The program records no span on the rows path, so
the test plants ``rows.pass`` around ``Pipeline.apply_rows``, as a span of
the program's own would be. Traced on the CPU, the run is correct, records
the span once a traced pass, and the metric reads its median; without the
planted span the metric reads nothing.
"""

import time
from pathlib import Path

import pytest
import torch

import harness
from cells import add_cell
from hipe_tpu_torch.models.pipelines import Pipeline
from hipe_tpu_torch.profiling import trace

HERE = Path(__file__).resolve().parent
NAME = "rows_blur3_spanned"
CONFIG = "resident_12x40x24_rgb_rows_spanned"
SPAN = "rows.pass"
METRIC = "rows.host_ms_per_pass"
METRIC_FILE = f'''"""The host's median ms of the program's ``{SPAN}`` span over the traced
passes. Nothing without the span's records."""

import program_spans


def read(r: dict):
    return program_spans.spans(r).get("{SPAN}", {{}}).get("host_ms_median")
'''


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """``(root, bench)`` of a checkout with the new cell's files added."""
    root = tmp_path_factory.mktemp("checkout")
    driver = (HERE / "rows_driver.py").read_text()
    assert driver.count("\nPASS_SPAN = None\n") == 1
    cfg = dict(harness.resolve("stream_blur3").config, name=CONFIG, num_images=12,
               height=40, width=24, entry="Pipeline.apply_rows",
               residency="device: interleaved (12, 40, 72) uint8 rows")
    bench = add_cell(
        root, NAME, cfg, NAME,
        {"driver": "rows_spanned", "pipeline": "blur3", "passes_per_step": 2},
        {"drivers/rows_spanned.py": driver.replace("\nPASS_SPAN = None\n",
                                                   f"\nPASS_SPAN = {SPAN!r}\n"),
         f"metrics/{METRIC}.py": METRIC_FILE},
        [{"name": METRIC, "unit": "ms", "better": "lower", "source": "program_span",
          "layer": "rows (a test)", "moves": "img_per_s", "workloads": [NAME]}])
    return root, bench


def _run(copy, monkeypatch, seed):
    """A traced run of the new cell on the CPU: its result and readings."""
    cell = harness.resolve(NAME, *copy)
    cell.seed, cell.device = seed, torch.device("cpu")
    readings = {}
    measure = harness.measure

    def kept(*args, **kw):
        readings.update(measure(*args, **kw))
        return readings

    monkeypatch.setattr(harness, "measure", kept)
    trace.reset()
    result = harness.run(cell, 0.2, True, time.perf_counter(), log=lambda msg: None)
    assert result["correct"] and result["failed"] == 0
    assert readings["trace"]["passes"] > 0
    return result, readings


def test_cell_with_its_own_pass_span_is_new_files_only(copy):
    root, bench = copy
    added = {"drivers/rows_spanned.py", f"metrics/{METRIC}.py", f"configs/{CONFIG}.json",
             f"traffic/{NAME}.json"}
    for path in bench.rglob("*"):
        rel = path.relative_to(bench).as_posix()
        if path.is_file() and "__pycache__" not in rel and rel not in added:
            assert path.read_bytes() == (harness.BENCH_DIR / rel).read_bytes(), rel
    manifest = harness.load_manifest(root)
    for group in ("configs", "workloads", "per_layer"):
        assert manifest[group][:-1] == harness.load_manifest()[group]
    cell = harness.resolve(NAME, *copy)
    assert cell.driver().PASS_SPAN == SPAN
    assert [m["name"] for m in cell.metrics("per_layer")] == [METRIC]


def test_traced_run_reads_the_cells_own_pass_span(copy, monkeypatch):
    rows = Pipeline.apply_rows

    def spanned(self, *args, **kw):
        with trace.span(SPAN):
            return rows(self, *args, **kw)

    monkeypatch.setattr(Pipeline, "apply_rows", spanned)
    result, readings = _run(copy, monkeypatch, 2 ** 31 + 13)
    spans = trace.summary()
    assert spans[SPAN]["n"] == readings["trace"]["passes"]
    assert "stream.pass" not in spans
    assert result["metrics"][METRIC] == {"value": spans[SPAN]["host_ms_median"], "unit": "ms"}
    trace.reset()


def test_without_the_span_the_metric_reads_nothing(copy, monkeypatch):
    result, _ = _run(copy, monkeypatch, 2 ** 31 + 17)
    assert SPAN not in trace.summary()
    assert METRIC not in result["metrics"]
    trace.reset()
