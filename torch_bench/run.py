"""Run one cell of the port's benchmark once and print its result line.

    python3 torch_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``hipe_tpu_torch``. The cell's
configuration, traffic, driver, pipeline and metrics are found by name
(``harness.py``). The last line of standard output is one JSON object:
``correct``, ``attempted`` and ``failed`` (images), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number compared with the reference, beside its limit. The same numbers are
the last lines of standard error.

Without a CUDA device, or with fewer than the cell asks for, the run exits
with code 2 and prints no result: nothing falls back to the CPU. The kernels'
build and the stream's autotune winner stay in ``build/`` of the checkout,
and Triton's cache in ``build/triton``, so only a checkout's first run
builds.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Every compile cache at a fixed path inside the checkout, for the
    # kernels the program builds now (nvcc, in build/hipe_tpu_torch/) and
    # any it builds later with Triton or torch's extension loader.
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(BENCH_DIR))
    import harness

    cell = harness.resolve(args.workload, ROOT, BENCH_DIR)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: {cell.name} needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    cell.seed = args.seed
    cell.device = torch.device("cuda", 0)
    cell.notes["import_s"] = time.perf_counter() - T_START
    result = harness.run(cell, args.seconds, bool(args.trace), T_START)
    print(json.dumps(result), flush=True)
    print("\n".join(harness.check_lines(result["checks"])), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
