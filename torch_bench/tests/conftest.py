"""The benchmark's self-tests run on the CPU: the repository's root (the
program) and the benchmark's folder go on the import path."""

import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
for p in (BENCH_DIR.parent, BENCH_DIR):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
