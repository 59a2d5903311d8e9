"""Measured-feedback autotuning: ratio calibration and batch-size sweeps
(counterpart of ``hipe_tpu.parallel.autotune``, over the port's Engine).

The reference's calibration study (`README.md:87-93`): run
with a 50/50 split, read the recommended ratio
(``ratio* = T_cpu/(T_cpu+T_gpu)``, `heterogeneous_blur.c:712-723`), re-run
with it — iterated by hand across batch sizes {35..1200} to produce the
benchmark corpus under `data/`. This module automates that loop: iterative
ratio calibration until the imbalance converges, and the batch-size sweep
harness that reproduces the corpus methodology.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from hipe_tpu_torch.parallel.partitioner import imbalance_pct
from hipe_tpu_torch.profiling.events import RunStats
from hipe_tpu_torch.profiling.report import recommended_ratio
from hipe_tpu_torch.runtime.engine import Engine, EngineConfig


@dataclasses.dataclass
class TuneResult:
    ratio: float
    stats: RunStats
    history: list[tuple[float, float]]  # (ratio, imbalance_pct) per step


def calibrate_ratio(
    base: EngineConfig,
    image: np.ndarray,
    *,
    start_ratio: float = 0.5,
    max_iters: int = 4,
    tol_pct: float = 2.0,
    num_images: int | None = None,
    cpu_device=None,
    accel_device=None,
) -> TuneResult:
    """Iterate run -> measure -> re-run with the recommended ratio.

    Stops when the measured workload imbalance drops below `tol_pct` (the
    reference's best-balance configs reach 0-0.3%, README.md:75,79) or after
    `max_iters` runs. `num_images` can shorten the calibration stream.
    """
    ratio = start_ratio
    history: list[tuple[float, float]] = []
    best: tuple[float, float, RunStats] | None = None
    for _ in range(max_iters):
        cfg = dataclasses.replace(
            base,
            gpu_ratio=ratio,
            num_images=num_images or base.num_images,
        )
        eng = Engine(cfg, cpu_device=cpu_device, accel_device=accel_device)
        stats = eng.run(image=image)
        imb = imbalance_pct(stats.cpu.total_ms, stats.accel.total_ms)
        history.append((ratio, imb))
        if best is None or imb < best[1]:
            best = (ratio, imb, stats)
        if imb <= tol_pct:
            break
        ratio = recommended_ratio(stats)
    assert best is not None
    return TuneResult(ratio=best[0], stats=best[2], history=history)


@dataclasses.dataclass
class FullTuneResult:
    ratio: float
    batch_size: int
    stats: RunStats  # the best run


def tune(
    base: EngineConfig,
    image: np.ndarray,
    *,
    batch_sizes: Sequence[int] = (35, 50, 100, 200, 500),
    calib_images: int = 300,
    cpu_device=None,
    accel_device=None,
) -> FullTuneResult:
    """Full calibration study: tune the ratio, then pick the best batch size.

    Automates the reference's two-phase methodology (`README.md:87-93` ratio
    loop + the `data/` batch sweep) into one call.
    """
    ratio = calibrate_ratio(
        base, image, num_images=calib_images,
        cpu_device=cpu_device, accel_device=accel_device,
    ).ratio
    tuned = dataclasses.replace(base, gpu_ratio=ratio)
    stats = sweep_batch_sizes(
        tuned, image, batch_sizes=batch_sizes, runs=1,
        cpu_device=cpu_device, accel_device=accel_device,
    )
    best = max(stats, key=lambda s: s.images_per_sec)
    return FullTuneResult(ratio=ratio, batch_size=best.batch_size, stats=best)


def sweep_batch_sizes(
    base: EngineConfig,
    image: np.ndarray,
    *,
    batch_sizes: Sequence[int] = (35, 50, 100, 200, 500, 800, 1200),
    runs: int = 3,
    cpu_device=None,
    accel_device=None,
) -> list[RunStats]:
    """The reference's benchmark sweep: `runs` runs per batch size.

    Returns one RunStats per (batch_size, run), in order — feed them to
    :func:`hipe_tpu_torch.profiling.corpus.write_corpus` for per_run.csv /
    avg_by_batch.csv aggregates.
    """
    out: list[RunStats] = []
    for bs in batch_sizes:
        for _ in range(runs):
            cfg = dataclasses.replace(base, batch_size=bs)
            eng = Engine(cfg, cpu_device=cpu_device,
                         accel_device=accel_device)
            out.append(eng.run(image=image))
    return out
