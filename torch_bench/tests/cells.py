"""The cells the self-tests drive: every workload of the manifest; and a
copy of the benchmark with a cell added as new files and manifest entries."""

import json
import shutil
from pathlib import Path

import harness

NAMES = [w["name"] for w in harness.load_manifest()["workloads"]]


def cell(name: str) -> "harness.Cell":
    return harness.resolve(name)


def add_cell(root: Path, name: str, config: dict, traffic: str, traffic_params: dict,
             files: dict = None, per_layer: list = ()) -> Path:
    """Copy the benchmark, without its tests, to ``root/torch_bench``; add
    the configuration ``config`` (named by its ``name``), the traffic file
    ``traffic`` and ``files`` (path under the copy: a file to copy there,
    or the text to write there); write ``root/BENCHMARK.json`` as the
    manifest with the configuration, a one-chip workload ``name`` and the
    ``per_layer`` metric entries appended. No file of the copy is edited.
    Returns the copy's folder."""
    bench = Path(root) / "torch_bench"
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for rel, src in (files or {}).items():
        if isinstance(src, str):
            (bench / rel).write_text(src)
        else:
            shutil.copy(src, bench / rel)
    cfg = config["name"]
    (bench / "configs" / f"{cfg}.json").write_text(json.dumps(config))
    (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(traffic_params))
    m = harness.load_manifest()
    m["configs"].append({"name": cfg, "source": "https://example.org/" + cfg,
                         "file": f"torch_bench/configs/{cfg}.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": name, "config": cfg, "traffic": traffic,
                           "chips": 1, "why": "a test"})
    m["per_layer"].extend(per_layer)
    (Path(root) / "BENCHMARK.json").write_text(json.dumps(m))
    return bench
