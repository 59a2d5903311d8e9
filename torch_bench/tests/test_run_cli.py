"""``run.py`` without a CUDA device exits non-zero and prints no result."""

import json
import os
import shutil
import subprocess
import sys

import harness


def _run(cwd, root):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, str(root / "torch_bench" / "run.py"),
                           "--workload", "stream_blur3", "--seed", "2147483659",
                           "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def _no_result(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(obj, dict) and "correct" in obj)


def test_exits_nonzero_without_cuda():
    _no_result(_run(harness.ROOT, harness.ROOT))


def test_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "torch_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_run(tmp_path, tmp_path))
