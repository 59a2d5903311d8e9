"""The control of a cell's comparison: the reference, put in the program's
place and computed in a narrower type than the configuration states, has to
come out as not correct.

    python3 torch_bench/control.py --workload <cell> --seeds 11,12,13 [--dtype bfloat16]

For each seed it makes the cell's inputs at the cell's own size, produces
what the timed path would (``control_output`` of the cell's driver: the
reference in ``--dtype``, as many passes as a step, or the batch a job
keeps) and compares it with the reference in float32 exactly as a run
does. One JSON line a seed: the numbers compared, each with its limit, and
``correct``. ``--dtype float32`` puts the reference itself in the
program's place, which has to come out correct. Needs a CUDA device; the
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))


def control(cell, dtype) -> dict:
    """The comparison's numbers for the control on ``cell`` (seed and device set)."""
    driver = cell.driver()
    out, meta = driver.control_output(cell, dtype)
    compared = driver.check(cell, out, meta)
    checks = compared["checks"]
    return {"workload": cell.name, "seed": cell.seed, "dtype": str(dtype),
            "correct": all(v["value"] <= v["limit"] for v in checks.values()),
            "compared_images": compared["compared"], "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    import harness
    import torch

    if not torch.cuda.is_available():
        print("error: the control runs on a CUDA device", file=sys.stderr)
        return 2
    dtype = getattr(torch, args.dtype)
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.resolve(args.workload)
        cell.seed, cell.device = seed, torch.device("cuda", 0)
        print(json.dumps(control(cell, dtype)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
