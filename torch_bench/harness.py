"""The benchmark's core: the manifest, a cell's files, the window, the result.

Everything that belongs to one configuration, one traffic mix, one pipeline
or one metric is a file of its own, found by the name ``BENCHMARK.json``
gives it:

- ``configs/<config>.json``: the deployment (image count and shape, where
  the images live, the precision and guarantee, the image generator's
  parameters, ``reduced`` and ``assumed``);
- ``traffic/<traffic>.json``: the driver, the pipeline and the traffic's
  parameters (passes a call);
- ``drivers/<driver>.py``: set-up, one step of the window, the output the
  comparison reads, ``PASS_SPAN`` (the program span its step path records
  once a pass, or ``None``), and optionally ``counters(state)``: the
  program's counters, read before and after the window;
- ``work/<pipeline>.py``: a pass's bytes and operations from its shapes;
- ``reference/<pipeline>.py``: the plain PyTorch reference of the pipeline;
- ``metrics/<metric>.py``: one reader a metric, end-to-end or per-layer.

So a later cell, configuration, pipeline or metric is new files and new
``BENCHMARK.json`` entries, never an edit of a file that is here.

A run: set-up (import, build or load, data from the seed, warm-up), then
the window of ``--seconds``, closed by a synchronize; with ``--trace 1``
the profiler records the window's last :data:`TRACE_SECONDS`. Then the peak
device memory is read, the program's state is freed, and the output of the
window's last step is compared with the reference on inputs generated again
from the seed. Last, a run with JAX or the JAX package loaded in its
process raises and gives no result.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
MANIFEST = "BENCHMARK.json"
# Steps the host may enqueue ahead of the device: enough to hide the gaps
# between asynchronous steps, few enough that the window closes on time.
LOOKAHEAD_STEPS = 2
# How much of a traced run's window the profiler records (its last part).
TRACE_SECONDS = 3.0
# Top-level modules that no run may have loaded: JAX and the JAX package,
# which the port replaces (the port's own name only starts with the latter's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "hipe_tpu")
# The drivers and references import the benchmark's own modules by name.
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))


def load_manifest(root: Path = ROOT) -> dict:
    with open(Path(root) / MANIFEST) as f:
        return json.load(f)


def load_module(path: Path):
    """Import a file by its path: metric files carry dots in their names."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    name = "torch_bench_" + "_".join(path.relative_to(path.parents[1]).with_suffix("")
                                     .as_posix().replace(".", "_").split("/"))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def peaks(bench_dir: Path = BENCH_DIR) -> dict:
    return read_json(Path(bench_dir) / "peaks.json")


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with its files resolved by name."""

    name: str
    chips: int
    config: dict
    traffic: dict
    bench_dir: Path
    manifest: dict
    seed: int = 0
    device: object = None  # torch.device, set by the run
    notes: dict = dataclasses.field(default_factory=dict)  # what set-up chose

    @property
    def shape(self) -> tuple[int, int, int, int]:
        c = self.config
        return c["num_images"], c["height"], c["width"], c["channels"]

    def generator(self):
        return load_module(self.bench_dir / "gen" / f"{self.config['images']['kind']}.py")

    def driver(self):
        return load_module(self.bench_dir / "drivers" / f"{self.traffic['driver']}.py")

    def work(self):
        return load_module(self.bench_dir / "work" / f"{self.traffic['pipeline']}.py")

    def reference(self):
        return load_module(self.bench_dir / "reference" / f"{self.traffic['pipeline']}.py")

    def metrics(self, kind: str) -> list[dict]:
        """The manifest's metrics of ``kind`` ('end_to_end' or 'per_layer')
        that this cell reports: those that list it, and those that list none."""
        return [m for m in self.manifest[kind]
                if "workloads" not in m or self.name in m["workloads"]]

    def metric_reader(self, name: str):
        return load_module(self.bench_dir / "metrics" / f"{name}.py")

    def bound_s_per_pass(self) -> float:
        """The least time of a pass over the whole stream: its bytes over the
        memory's rate against its operations over the relevant peak."""
        work, pk = self.work(), peaks(self.bench_dir)
        n, h, w, c = self.shape
        return max(work.bytes_moved(n, h, w, c) / pk["hbm_bytes_per_s"],
                   work.operations(n, h, w, c) / pk[work.PEAK])


def resolve(workload: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    """The manifest's workload ``workload`` with its configuration and
    traffic files."""
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r} (choose from {sorted(cells)})")
    w, bench_dir = cells[workload], Path(bench_dir)
    return Cell(name=w["name"], chips=w["chips"],
                config=read_json(bench_dir / "configs" / f"{w['config']}.json"),
                traffic=read_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                bench_dir=bench_dir, manifest=manifest)


def measure(cell: Cell, driver, state, seconds: float, trace: bool, log) -> dict:
    """The window: driver steps until ``seconds`` have passed, closed by a
    synchronize. Returns the readings the metric files read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = cell.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    trace_seconds = min(TRACE_SECONDS, seconds)
    trace_at = max(0.0, seconds - trace_seconds) if trace else math.inf
    counters = getattr(driver, "counters", lambda s: {})
    before = counters(state)
    pending: collections.deque = collections.deque()
    step_ms: list[float] = []
    images = passes = 0
    prof = span = None
    traced = {"steps": 0, "images": 0, "passes": 0}
    sync()
    t0 = t_traced = time.perf_counter()
    # The traced part lasts trace_seconds from the profiler's start,
    # which takes a while: a traced window may end past ``seconds``.
    while (time.perf_counter() - t0 < seconds
           or (prof is not None and time.perf_counter() - t_traced < trace_seconds)):
        if prof is None and time.perf_counter() - t0 >= trace_at:
            sync()
            pending.clear()
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.__enter__()
            span = record_function("bench.window")
            span.__enter__()
            t_traced = time.perf_counter()
        ts = time.perf_counter()
        with record_function("bench.step"):
            im, ps = driver.step(state)
        step_ms.append((time.perf_counter() - ts) * 1e3)
        images += im
        passes += ps
        if prof is not None:
            traced["steps"] += 1
            traced["images"] += im
            traced["passes"] += ps
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            while len(pending) > LOOKAHEAD_STEPS:
                pending.popleft().synchronize()
    sync()
    window_s = time.perf_counter() - t0
    trace_summary = None
    if prof is not None:
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        devtrace = load_module(cell.bench_dir / "devtrace.py")
        trace_summary = {**devtrace.summarize(prof, log), **traced}
    after = counters(state)
    return {
        "window_s": window_s,
        "images": images,
        "passes": passes,
        "steps": len(step_ms),
        "step_ms": step_ms,
        "counters": {k: after[k] - before[k] for k in after},
        "trace": trace_summary,
    }


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is one of
    :data:`FORBIDDEN_MODULES`, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN_MODULES)


def power_limit() -> str:
    """The card's name and power limit from ``nvidia-smi``, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else f"not read (exit {out.returncode})"


def run(cell: Cell, seconds: float, trace: bool, t_start: float, log=None) -> dict:
    """One run of a cell on ``cell.device``: the result object of the line."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cuda = cell.device.type == "cuda"
    driver = cell.driver()
    state = driver.setup(cell, log)
    readings = {"setup_s": time.perf_counter() - t_start, "pass_span": driver.PASS_SPAN}
    readings.update(measure(cell, driver, state, seconds, trace, log))
    try:
        readings["bound_s_per_pass"] = cell.bound_s_per_pass()
    except FileNotFoundError:
        readings["bound_s_per_pass"] = None
    device = {"platform": "gpu" if cuda else cell.device.type,
              "kind": torch.cuda.get_device_name(cell.device) if cuda else "cpu",
              "count": cell.chips,
              "memory_peak_bytes": (torch.cuda.max_memory_allocated(cell.device)
                                    if cuda else 0)}
    if trace and readings["trace"] is not None:
        device["busy_s"] = readings["trace"]["busy_s"]
        device["window_s"] = readings["trace"]["window_s"]
    device["power"] = power_limit() if cuda else "cpu"
    # The program's state is freed before the reference runs.
    output, meta = driver.finish(state)
    del state
    if cuda:
        torch.cuda.empty_cache()
    compared = driver.check(cell, output, meta)
    checks = compared["checks"]
    del output
    metrics = {}
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        value = cell.metric_reader(m["name"]).read(readings)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits_ok = all(v["value"] <= v["limit"] for v in checks.values())
    result = {
        "correct": bool(limits_ok),
        "attempted": readings["images"],
        "failed": int(checks["wrong_images"]["value"]),
        "metrics": metrics,
        "device": device,
    }
    if trace and readings["trace"] is not None:
        result["breakdown"] = {"device_ops": readings["trace"]["device_ops"],
                               "idle_gaps": readings["trace"]["idle_gaps"]}
    steps_ms = sorted(readings["step_ms"])
    result["window"] = {"seconds": readings["window_s"], "steps": readings["steps"],
                        "passes": readings["passes"], "compared_images": compared["compared"],
                        "step_ms_min_median_max": [steps_ms[0], steps_ms[len(steps_ms) // 2],
                                                   steps_ms[-1]],
                        **cell.notes}
    result["checks"] = checks
    loaded = forbidden_modules()
    if loaded:
        raise RuntimeError(f"the run loaded {', '.join(loaded)}: no result")
    return result


def check_lines(checks: dict) -> list[str]:
    """One line a number compared: its name, its value and its limit."""
    return [f"check {k} {v['value']} limit {v['limit']}" for k, v in checks.items()]
