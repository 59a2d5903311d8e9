"""Work-partitioning geometry and ratio math (copy of ``hipe_tpu.parallel.partitioner``).

The port keeps its own copy because it may not import ``hipe_tpu``;
``tests/test_torch_runtime_support.py`` holds it equal to the original.
It reproduces the reference's partitioning formulas exactly:

- image-level split: ``num_gpu = floor(batch_count * gpu_ratio)``, remaining
  images to the CPU, image i routed to CPU iff ``i < num_cpu``
  (`heterogeneous_blur.c:449-458,489-497`);
- row split: ``split_row = floor(H * (1 - gpu_ratio))`` clamped to
  ``[halo, H - halo]``; CPU takes rows ``[0, split_row)`` plus `halo` halo
  rows below, GPU takes ``[split_row, H)`` plus `halo` halo rows above
  (`split_image_blur.c:144-173`);
- ratio recommendation: ``ratio* = T_cpu / (T_cpu + T_gpu)`` per work unit
  (`heterogeneous_blur.c:715`, `split_image_blur.c:714`, `README.md:93`);
- CLI validation semantics: out-of-range values warn and fall back to
  defaults (`heterogeneous_blur.c:72-83`).

"GPU" in the reference is the fast accelerator; in the port that role is
played by the CUDA card, so `gpu_ratio` == fraction of work sent to the card.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Sequence

DEFAULT_RATIO = 0.5  # heterogeneous_blur.c:48
DEFAULT_BATCH = 500  # heterogeneous_blur.c:46
NUM_IMAGES = 5000  # heterogeneous_blur.c:44
MAX_BATCH = NUM_IMAGES


def validate_ratio(ratio: float, warn: bool = True) -> float:
    """gpu_ratio outside [0, 1] warns and falls back to 0.5."""
    if 0.0 <= ratio <= 1.0:
        return ratio
    if warn:
        print(
            f"Warning: invalid GPU ratio {ratio}, using default "
            f"{DEFAULT_RATIO}",
            file=sys.stderr,
        )
    return DEFAULT_RATIO


def validate_batch(batch: int, num_images: int = NUM_IMAGES, warn: bool = True) -> int:
    """batch_size outside [1, num_images] warns and falls back to 500."""
    if 1 <= batch <= num_images:
        return batch
    if warn:
        print(
            f"Warning: invalid batch size {batch}, using default "
            f"{DEFAULT_BATCH}",
            file=sys.stderr,
        )
    return DEFAULT_BATCH


def num_batches(num_images: int, batch_size: int) -> int:
    """NUM_BATCHES = ceil(num_images / batch_size) (heterogeneous_blur.c:86)."""
    return -(-num_images // batch_size)


def split_images(batch_count: int, gpu_ratio: float) -> tuple[int, int]:
    """(num_cpu, num_gpu) for one batch (heterogeneous_blur.c:449-458).

    Image i goes to the CPU iff i < num_cpu (the first images of the batch).
    The reference computes ``(int)(batch_count * gpu_ratio)`` with a C
    ``float`` ratio (heterogeneous_blur.c:48,450), so the product is fp32 —
    reproduced here so the count matches the C program for every ratio.
    """
    import numpy as np

    num_gpu = int(np.float32(batch_count) * np.float32(gpu_ratio))
    return batch_count - num_gpu, num_gpu


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """Geometry of a two-way row split with halo (split_image_blur.c:144-173)."""

    height: int
    halo: int
    split_row: int  # first GPU output row
    # input slices (inclusive halo), as [start, stop) row ranges
    cpu_in: tuple[int, int]
    gpu_in: tuple[int, int]
    # output row ranges each device is responsible for
    cpu_out: tuple[int, int]
    gpu_out: tuple[int, int]

    @property
    def cpu_input_rows(self) -> int:
        return self.cpu_in[1] - self.cpu_in[0]

    @property
    def gpu_input_rows(self) -> int:
        return self.gpu_in[1] - self.gpu_in[0]

    @property
    def cpu_output_rows(self) -> int:
        return self.cpu_out[1] - self.cpu_out[0]

    @property
    def gpu_output_rows(self) -> int:
        return self.gpu_out[1] - self.gpu_out[0]


def row_split(height: int, gpu_ratio: float, halo: int = 1) -> RowSplit:
    """Compute the two-way split-image geometry.

    ``split_row = floor(H * (1 - ratio))`` clamped so each side keeps at
    least `halo` rows (`split_image_blur.c:147-154`). The CPU receives rows
    ``[0, split_row + halo)`` and owns outputs ``[0, split_row)``; the GPU
    receives ``[split_row - halo, H)`` and owns ``[split_row, H)``. The halo
    rows are computed by both devices and discarded at reassembly
    (`split_image_blur.c:526,537-539`). The reference's
    ``(int)(height * (1.0f - gpu_ratio))`` is fp32 arithmetic
    (split_image_blur.c:69,144), reproduced here with np.float32 so the
    split row matches the C program for every ratio.
    """
    import numpy as np

    split = int(np.float32(height) * (np.float32(1.0) - np.float32(gpu_ratio)))
    split = max(halo, min(split, height - halo))
    return RowSplit(
        height=height,
        halo=halo,
        split_row=split,
        cpu_in=(0, min(split + halo, height)),
        gpu_in=(max(split - halo, 0), height),
        cpu_out=(0, split),
        gpu_out=(split, height),
    )


def even_row_shards(height: int, n: int, halo: int = 1) -> list[tuple[int, int]]:
    """N-way generalization: output row ranges of an even H split.

    The reference splits two ways by ratio; a homogeneous device mesh splits
    evenly (SURVEY.md §2.3). Height must divide evenly for SPMD sharding.
    """
    assert height % n == 0, (height, n)
    step = height // n
    assert step >= halo, "shard thinner than the halo"
    return [(i * step, (i + 1) * step) for i in range(n)]


def apportion(total: int, weights: Sequence[float]) -> list[int]:
    """Split `total` units across lanes by weight (largest remainder).

    N-lane generalization of the reference's two-way image split
    (`heterogeneous_blur.c:449-458`); for weights (1-r, r) it reproduces
    `split_images` exactly on the fast lane (floor(total*r)).
    """
    s = float(sum(weights))
    assert s > 0 and all(w >= 0 for w in weights)
    raw = [total * w / s for w in weights]
    counts = [int(x) for x in raw]
    remainder = total - sum(counts)
    order = sorted(range(len(weights)), key=lambda i: raw[i] - counts[i],
                   reverse=True)
    for i in order[:remainder]:
        counts[i] += 1
    return counts


@dataclasses.dataclass(frozen=True)
class RowSegment:
    """One lane's share of an N-way row partition with halo."""

    out: tuple[int, int]  # output rows owned by this lane
    inp: tuple[int, int]  # input slab incl. halo (clamped at image edges)

    @property
    def out_rows(self) -> int:
        return self.out[1] - self.out[0]

    @property
    def in_rows(self) -> int:
        return self.inp[1] - self.inp[0]


def row_partition(
    height: int, weights: Sequence[float], halo: int = 1
) -> list[RowSegment]:
    """N-way weighted row partition with per-side halo.

    Generalizes the reference's two-way `row_split` (split_image_blur.c:
    144-173): boundaries fall at cumulative-weight row counts (apportioned
    so every lane keeps >= 1 row); each lane's input slab extends `halo`
    rows beyond its owned range, clamped at the image edges; halo outputs
    are computed-then-discarded at reassembly.
    """
    counts = apportion(height, weights)
    # guarantee every lane at least one row (clamping analog, :147-154)
    for i in range(len(counts)):
        while counts[i] == 0:
            j = max(range(len(counts)), key=lambda k: counts[k])
            counts[j] -= 1
            counts[i] += 1
    segs = []
    start = 0
    for c in counts:
        end = start + c
        segs.append(
            RowSegment(
                out=(start, end),
                inp=(max(start - halo, 0), min(end + halo, height)),
            )
        )
        start = end
    return segs


def recommend_weights(per_unit_times: Sequence[float]) -> list[float]:
    """weights_i ∝ 1/t_i — the N-lane form of `ratio* = T_cpu/(T_cpu+T_gpu)`.

    For two lanes (t_cpu, t_gpu) the fast lane's weight equals the
    reference's recommended gpu ratio (README.md:93).
    """
    if any(t <= 0 for t in per_unit_times):
        n = len(per_unit_times)
        return [1.0 / n] * n
    inv = [1.0 / t for t in per_unit_times]
    s = sum(inv)
    return [x / s for x in inv]


def recommend_ratio(t_cpu_per_unit: float, t_gpu_per_unit: float) -> float:
    """ratio* = T_cpu / (T_cpu + T_gpu) (README.md:93)."""
    denom = t_cpu_per_unit + t_gpu_per_unit
    if denom <= 0.0:
        return DEFAULT_RATIO
    return t_cpu_per_unit / denom


def imbalance_pct(t_a: float, t_b: float) -> float:
    """|Ta - Tb| / max * 100 (heterogeneous_blur.c:668-669)."""
    m = max(t_a, t_b)
    if m <= 0.0:
        return 0.0
    return abs(t_a - t_b) / m * 100.0
