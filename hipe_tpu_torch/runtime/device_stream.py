"""Device-resident stream processing — the serving fast path on the card.

The counterpart of ``hipe_tpu.runtime.device_stream``. The stream of N
images stays in device memory as planar ``(N*C, H, W)`` uint8; each pass
filters the whole stream with one launch of the pipeline's kernel (K1 for a
single gaussian, the fused chain kernel K2 for every other band and point
chain, K3 for a chain with a rank or registered-kernel stage), and only
checksums and the first image return to the host. Frames too wide for K2
or K3 (``Pipeline.routes_tiled``, e.g. 4000x2250) run one launch a stage of
the tiled kernels K4 and K5 instead; K1 takes frames of any width.

Chained passes feed every output into the next pass, alternating between
two scratch buffers (the kernels are out-of-place: a tile's halo rows
belong to its neighbour, so in-place writes would race). The stream itself is never
overwritten, so every measurement starts from the same input.

Throughput is timed with CUDA events around ``passes`` chained passes after
a warm-up; the stream (983 MB at 5000 x 256x256x3) is 20x the H100's 50 MB
L2, so every pass runs cold, as it would in service. The kernels index the
stream with 64-bit offsets, so it may exceed 2^31 bytes (100 RGB frames of
4000x2250 are 2.7 GB).
"""

from __future__ import annotations

import numpy as np
import torch

from hipe_tpu_torch.models import pipelines as plib
from hipe_tpu_torch.ops import cuda_tiled
from hipe_tpu_torch.ops.reference import gaussian_blur_int_oracle
from hipe_tpu_torch.utils.images import checker_image, hwc_to_planar

# The launch knob of K1, K2 and K3 swept by autotune: output rows per block,
# plus one block per whole plane (appended from the plane height).
ROWS_PER_BLOCK_CANDIDATES = (8, 16, 32, 64, 128)
# The launch knob of K4 and K5 on the tiled route: output tile rows x
# columns; a shape whose block would exceed shared memory is skipped.
TILE_ROWS_CANDIDATES = (8, 16, 32, 64)
TILE_COLS_CANDIDATES = (128, 256, 512)


class DeviceStreamRunner:
    """Process an N-image stream resident in device memory."""

    def __init__(
        self,
        pipeline: plib.Pipeline | str = "blur3",
        *,
        num_images: int = 5000,
        image: np.ndarray | None = None,
        device: str | torch.device = "cuda",
        stream: np.ndarray | None = None,
    ):
        self.pipeline = plib.get(pipeline)
        self.num_images = num_images
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but torch.cuda.is_available() is "
                "False: the stream runs on an NVIDIA GPU (device='cpu' serves "
                "only the plain-version parity checks)")
        if image is None:
            image = checker_image(256, 256, 3, seed=0)
        self.image = image
        h, w, c = image.shape
        self.shape = (h, w, c)
        n = num_images * c
        if stream is None:
            planes = torch.from_numpy(hwc_to_planar(image[None])).to(self.device)
            # The device-resident stream: distinct buffers per image (the
            # reference's memcpy stream simulation, in device memory).
            self.stream = planes.expand(num_images, c, h, w).contiguous().view(n, h, w)
        else:
            if stream.dtype != np.uint8 or stream.shape != (n, h, w):
                raise ValueError(
                    f"stream must be uint8 {(n, h, w)}, got {stream.dtype} "
                    f"{stream.shape}")
            self.stream = torch.tensor(stream, device=self.device)  # a copy
        # The two buffers chained passes alternate between.
        self._bufs = (torch.empty_like(self.stream), torch.empty_like(self.stream))
        # Whether the frames take the tiled route (K4/K5), whose knob is the
        # tile shape; the fused kernels' is rows_per_block.
        self.tiled = self.pipeline.routes_tiled(h, w)
        self.config = {"tile": None} if self.tiled else {"rows_per_block": None}
        self.tuning: dict | None = None

    def _one_pass(self, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        return self.pipeline.apply_planar(src, out=dst, **self.config)

    def run_passes(self, r: int) -> torch.Tensor:
        """``r`` chained passes from the stream; returns the last output."""
        x = self.stream
        for i in range(r):
            x = self._one_pass(x, self._bufs[i % 2])
        return x

    def chained(self, r: int) -> int:
        """Run ``r`` chained passes; the strided checksum of the result.

        The checksum is hipe_tpu's (``sum(out[::97, ::3, ::64])``), so a
        run here compares exactly with the JAX runner's on the same stream.
        """
        out = self.run_passes(r)
        return int(out[::97, ::3, ::64].sum(dtype=torch.int64))

    def block_candidates(self) -> list[int]:
        """``rows_per_block`` values to sweep: small tiles, then whole planes."""
        h = self.shape[0]
        return sorted({min(k, h) for k in ROWS_PER_BLOCK_CANDIDATES} | {h})

    def tile_candidates(self) -> list[tuple[int, int]]:
        """K4/K5 tile shapes to sweep, every row count by every column count."""
        return [(th, tw) for th in TILE_ROWS_CANDIDATES for tw in TILE_COLS_CANDIDATES]

    def _configs(self) -> list[tuple[str, dict, str | None]]:
        """(label, config, reason to skip or None) for each autotune candidate."""
        if not self.tiled:
            return [(f"cuda_rpb{rpb}", {"rows_per_block": rpb}, None)
                    for rpb in self.block_candidates()]
        out = []
        for tile in self.tile_candidates():
            need = max(cuda_tiled.shared_bytes(nm, tile) for nm in self.pipeline.filters)
            why = (None if need <= plib.SHARED_BYTES_PER_BLOCK else
                   f"needs {need} B of shared memory a block, over "
                   f"{plib.SHARED_BYTES_PER_BLOCK}")
            out.append((f"cuda_tile{tile[0]}x{tile[1]}", {"tile": tile}, why))
        return out

    def autotune(self, passes: int = 4, reps: int = 2) -> dict:
        """Time each launch config of the pipeline's kernels; keep the fastest.

        The configs are ``rows_per_block`` values for K1/K2/K3 and tile
        shapes for K4/K5 on the tiled route. Returns {label:
        per_pass_seconds}. A config that exceeds shared memory, or whose
        launch fails, is recorded in ``self.tuning["skipped"]`` with the
        reason; the sweep raises if none ran. The plain version is never a
        candidate.
        """
        timings: dict[str, float] = {}
        skipped: dict[str, str] = {}
        best_label, best_config, best_t = None, None, float("inf")
        for label, config, why in self._configs():
            if why is not None:
                skipped[label] = why
                continue
            self.config = config
            try:
                t = self._measure_per_pass(passes=passes, reps=reps)
            except RuntimeError as e:
                skipped[label] = f"{type(e).__name__}: {e}"
                continue
            timings[label] = t
            if t < best_t:
                best_label, best_config, best_t = label, config, t
        if best_label is None:
            raise RuntimeError(f"no autotune config ran: {skipped}")
        self.config = best_config
        self.tuning = {"chosen": best_label, "per_pass_s": timings,
                       "skipped": skipped}
        return timings

    def verify_max_abs_err(self) -> int:
        """Max-abs pixel error of the first image of one pass.

        As in ``hipe_tpu``: against the NumPy oracle for a single gaussian,
        and against the pipeline's own plain path for every other chain.
        """
        c = self.shape[2]
        got = self._one_pass(self.stream, self._bufs[0])[:c].cpu().numpy()
        if self.pipeline.single_gaussian:
            want_img = gaussian_blur_int_oracle(self.image, self.pipeline.radius)
        else:
            want_img = self.pipeline(torch.from_numpy(self.image)).numpy()
        want = hwc_to_planar(want_img[None])
        return int(np.max(np.abs(got.astype(int) - want.astype(int))))

    def _measure_per_pass(self, passes: int, reps: int) -> float:
        """Median over ``reps`` of CUDA-event seconds per chained pass."""
        if self.device.type != "cuda":
            raise RuntimeError(
                f"throughput is timed on a CUDA device, not {self.device}")
        with torch.cuda.device(self.device):
            self.run_passes(passes)  # warm-up
            samples = []
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                self.run_passes(passes)
                end.record()
                end.synchronize()
                samples.append(start.elapsed_time(end) / 1e3 / passes)
        return float(np.median(samples))

    def measure_throughput(self, passes: int = 10, reps: int = 3) -> dict:
        """Steady-state rates from the median per-pass time of ``reps`` runs."""
        t = self._measure_per_pass(passes=passes, reps=reps)
        h, w, c = self.shape
        return {
            "per_pass_s": t,
            "img_per_s": self.num_images / t,
            "mpix_per_s": self.num_images * h * w / t / 1e6,
            "gb_per_s": 2 * self.num_images * h * w * c / t / 1e9,
        }
