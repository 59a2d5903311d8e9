"""Per-stage timing events and run statistics (copy of ``hipe_tpu.profiling.events``).

The reference profiles every enqueued command with OpenCL events (3 per
image: transfer-in, kernel, transfer-out) accumulated into six per-device
counters plus a wall clock (`heterogeneous_blur.c:472-476,
544-579,32-36`). CUDA launches are asynchronous, so the port's equivalent
is stage-timed execution: each lane times host->device transfer, kernel
execution and device->host read-back, each closed by a synchronize of the
lane's CUDA stream — the analog of a profiling-enabled in-order queue. The six-counter schema and
derived metrics match the reference's CSV contract
(`data/approach2/approach2/per_run.csv`).
"""

from __future__ import annotations

import dataclasses
import time


def now_ms() -> float:
    """Monotonic wall clock in ms (analog of get_time_ms, heterogeneous_blur.c:32-36)."""
    return time.perf_counter() * 1000.0


@dataclasses.dataclass
class DeviceCounters:
    """Six-counter accumulator for one device lane (cpu or accelerator)."""

    name: str = ""
    units: int = 0  # images (A1) or rows*images (A2 per-row accounting)
    images: int = 0
    in_ms: float = 0.0
    kernel_ms: float = 0.0
    out_ms: float = 0.0

    @property
    def total_ms(self) -> float:
        return self.in_ms + self.kernel_ms + self.out_ms

    def per_unit_ms(self) -> float:
        return self.total_ms / self.units if self.units else 0.0

    def per_image_ms(self) -> float:
        return self.total_ms / self.images if self.images else 0.0

    def pct(self, part_ms: float) -> float:
        t = self.total_ms
        return (part_ms / t * 100.0) if t > 0 else 0.0

    def merge(self, other: "DeviceCounters") -> None:
        self.units += other.units
        self.images += other.images
        self.in_ms += other.in_ms
        self.kernel_ms += other.kernel_ms
        self.out_ms += other.out_ms


class StageClock:
    """Accumulates staged (in/kernel/out) timings into a DeviceCounters.

    Thread-safe: pipelined engines may have two in-flight batches timing
    stages on the same lane concurrently.
    """

    def __init__(self, counters: DeviceCounters):
        import threading

        self.counters = counters
        self._lock = threading.Lock()

    def stage(self, name: str):
        return _Stage(self.counters, name, self._lock)


class _Stage:
    def __init__(self, counters: DeviceCounters, name: str, lock):
        self.counters = counters
        self.attr = {"in": "in_ms", "kernel": "kernel_ms", "out": "out_ms"}[name]
        self.lock = lock

    def __enter__(self):
        self.t0 = now_ms()
        return self

    def __exit__(self, *exc):
        if exc and exc[0] is not None:
            # A stage that raised didn't complete: don't account its
            # partial time. (Matters for elastic recovery, where a dead
            # lane's counters would otherwise pollute the report's
            # per-device ratios with timing from an aborted attempt.)
            return False
        dt = now_ms() - self.t0
        with self.lock:
            setattr(
                self.counters, self.attr,
                getattr(self.counters, self.attr) + dt,
            )
        return False


@dataclasses.dataclass
class RunStats:
    """Everything the analyzer/report needs about one engine run."""

    approach: int  # 1 = image-level, 2 = row-split
    mode: str  # 'both' | 'cpu' | 'gpu'
    gpu_ratio: float  # fraction of work on the accelerator
    batch_size: int
    num_images: int
    num_batches: int
    width: int
    height: int
    channels: int
    pipeline: str
    wall_ms: float = 0.0
    cpu: DeviceCounters = dataclasses.field(
        default_factory=lambda: DeviceCounters("cpu")
    )
    accel: DeviceCounters = dataclasses.field(
        default_factory=lambda: DeviceCounters("accel")
    )
    split_row: int | None = None  # approach 2 only
    halo: int | None = None
    # Per-lane execution labels ('torch': the plain PyTorch rows chain;
    # 'cuda': the hand-written kernels), recorded into the CSV wg_w/wg_h
    # columns in place of the reference's 16x16 work-group size.
    cpu_exec: str = "torch"
    accel_exec: str = "cuda"

    @property
    def images_per_sec(self) -> float:
        return self.num_images / (self.wall_ms / 1000.0) if self.wall_ms else 0.0

    @property
    def mpix_per_sec(self) -> float:
        pix = self.num_images * self.width * self.height
        return pix / (self.wall_ms / 1000.0) / 1e6 if self.wall_ms else 0.0
