"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its file."""

import ast
import json
import re
import time

import pytest
import torch

import faults
import harness
from cells import add_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
MANIFEST = harness.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_keys_and_sizes():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert len(json.dumps(m)) < 64 * 1024
    assert 1 <= len(m["paths"]) <= 16 and all(PATH.match(p) for p in m["paths"])
    assert all(not p.startswith("/") and ".." not in p for p in m["paths"])
    assert 1 <= len(m["command"]) <= 32 and all(LINE.match(w) for w in m["command"])
    assert m["command"][1].startswith(m["paths"][0] + "/")
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    # A full check with 24 cells fits the time a check has.
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= len(m["configs"]) <= 24 and 1 <= len(m["workloads"]) <= 24
    assert 1 <= len(m["end_to_end"]) <= 16 and 1 <= len(m["per_layer"]) <= 128


def test_names_units_and_lines():
    m = MANIFEST
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in m[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    for group in ("end_to_end", "per_layer"):
        for e in m[group]:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert set(e.get("workloads", [])) <= set(CELLS)
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert "setup_s" in {e["name"] for e in m["end_to_end"]}
    layers = {}
    for e in m["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert e["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert LINE.match(e["layer"])
        assert e["moves"] in {x["name"] for x in m["end_to_end"]}
        layers.setdefault(e["layer"].lower(), set()).add(e["layer"])
    assert all(len(v) == 1 for v in layers.values())


def _traffic_drivers() -> dict:
    """Each driver a traffic file names, with the manifest's cells on it."""
    drivers = {harness.read_json(p)["driver"]: []
               for p in sorted((harness.BENCH_DIR / "traffic").glob("*.json"))}
    for name in CELLS:
        drivers[harness.resolve(name).traffic["driver"]].append(name)
    return drivers


DRIVERS = _traffic_drivers()


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_driver_declares_its_fault_points_and_setup_parts(driver):
    """What ``test_faults.py`` holds the driver's cells to: each fault's
    points, resolved on the CPU to callables of the program; an image's
    entries of their leading dimension; the set-up parts."""
    faults.check_declarations(
        harness.load_module(harness.BENCH_DIR / "drivers" / f"{driver}.py"),
        [harness.resolve(name) for name in DRIVERS[driver]])


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_driver_declares_its_pass_span(driver):
    """What ``test_span_metrics.py`` holds the driver's cells to: the program
    span its step path records once a pass, or ``None``; a cell that lists a
    ``program_span`` metric has a driver that names one."""
    span = harness.load_module(harness.BENCH_DIR / "drivers" / f"{driver}.py").PASS_SPAN
    assert span is None or (isinstance(span, str) and span), span
    for name in DRIVERS[driver]:
        sources = {m["source"] for m in harness.resolve(name).metrics("per_layer")}
        assert "program_span" not in sources or isinstance(span, str), name


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_every_file(name):
    cell = harness.resolve(name)
    cfg = next(c for c in MANIFEST["configs"]
               if c["name"] == next(w["config"] for w in MANIFEST["workloads"]
                                    if w["name"] == name))
    assert (harness.ROOT / cfg["file"]).is_file()
    assert cell.config["name"] == cfg["name"] and cell.config["reduced"] == cfg["reduced"]
    for mod in (cell.driver(), cell.reference(), cell.generator(), cell.work()):
        assert mod is not None
    e2e = {m["name"] for m in cell.metrics("end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.metrics("per_layer")
    for kind in ("end_to_end", "per_layer"):
        for m in cell.metrics(kind):
            assert callable(cell.metric_reader(m["name"]).read)


def test_every_config_is_used_and_has_its_own_file():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    for f in files:
        assert f.startswith(MANIFEST["paths"][0] + "/configs/")


def test_pass_bounds_match_hand_counts():
    """A pass over 5000 planar RGB 320x240 images: 1,152,000,000 B of stream."""
    cases = {"stream_blur3": (2_304_000_000, 0.6878),
             "stream_chain": (2_304_000_000, 0.6878),
             "stream_equalize": (3_456_000_000, 1.0316)}
    for name, (nbytes, ms) in cases.items():
        cell = harness.resolve(name)
        assert cell.work().bytes_moved(*cell.shape) == nbytes
        assert round(cell.bound_s_per_pass() * 1e3, 4) == ms


def test_no_forbidden_imports():
    """Nothing of the benchmark imports jax, hipe_tpu, bench.py or benchmarks/."""
    banned = {"jax", "jaxlib", "hipe_tpu", "bench", "benchmarks"}
    for path in harness.BENCH_DIR.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                roots = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not roots & banned, (path, roots)


def test_new_cell_is_new_files_only(tmp_path):
    """A cell on a new configuration and a new traffic file, added as files
    and manifest entries alone, resolves and runs."""
    cfg = dict(harness.resolve("stream_blur3").config, name="resident_12x40x24_gray",
               num_images=12, height=40, width=24, channels=1)
    bench = add_cell(tmp_path, "new_cell", cfg, "stream_chain_x2",
                     {"driver": "stream", "pipeline": "chain", "passes_per_step": 2})
    cell = harness.resolve("new_cell", tmp_path, bench)
    assert cell.shape == (12, 40, 24, 1) and cell.traffic["passes_per_step"] == 2
    cell.seed, cell.device = 5, torch.device("cpu")
    result = harness.run(cell, 0.2, False, time.perf_counter(), log=lambda msg: None)
    assert result["correct"] and result["window"]["compared_images"] == 12
    assert set(result["metrics"]) == {"img_per_s", "setup_s"}
