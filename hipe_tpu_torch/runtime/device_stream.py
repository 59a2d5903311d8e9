"""Device-resident stream processing — the serving fast path on the card.

The counterpart of ``hipe_tpu.runtime.device_stream``. The stream of N
images stays in device memory as planar ``(N*C, H, W)`` uint8; each pass
filters the whole stream with one launch of the pipeline's kernel (K1 for a
single gaussian, the fused chain kernel K2 for every other band and point
chain, K3 for a chain with a rank or registered-kernel stage), and only
checksums and the first image return to the host. Frames too wide for K2
or K3 (``Pipeline.routes_tiled``, e.g. 4000x2250) run one launch a stage of
the tiled kernels K4 and K5 instead; K1 takes frames of any width. The
autotune sweeps the launch configs the pipeline offers
(``launch_candidates``).

A global-statistics pipeline (``GlobalStatsPipeline``: equalize,
autocontrast, contrast, color, sharpness, mode) runs its PyTorch ops in
chunks of whole images, with no launch knob to sweep; sharpness's SMOOTH
plane runs K3, and equalize (K8-K10) and the mode filters (K12) run
hand-written kernels over the whole stream in one chunk.

Chained passes feed every output into the next pass, alternating between
two scratch buffers (the kernels are out-of-place: a tile's halo rows
belong to its neighbour, so in-place writes would race). The stream itself is never
overwritten, so every measurement starts from the same input. Each pass is
a host-only ``stream.pass`` span (``profiling/trace.py``), recorded only
while a profiler records.

Throughput is timed with CUDA events around ``passes`` chained passes after
a warm-up; the stream (983 MB at 5000 x 256x256x3) is 20x the H100's 50 MB
L2, so every pass runs cold, as it would in service. The kernels index the
stream with 64-bit offsets, so it may exceed 2^31 bytes (100 RGB frames of
4000x2250 are 2.7 GB).

The autotune's winner is kept on disk (``tune_cache_path``, by default
``build/hipe_tpu_torch/autotune.json``), keyed by card, pipeline, shape,
stream length and knob: the next run times the stored config once and
sweeps again only if that time exceeds the stored one by more than
:data:`RETUNE_FACTOR`, or when asked to (``retune=True``, ``stream
--retune``). This is ``hipe_tpu``'s persisted winner; its checks for a
broken TPU compile service are not carried over.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

from hipe_tpu_torch.models import pipelines as plib
from hipe_tpu_torch.ops import _build
from hipe_tpu_torch.ops.reference import gaussian_blur_int_oracle
from hipe_tpu_torch.profiling.trace import span
from hipe_tpu_torch.utils.images import checker_image, hwc_to_planar

# A stored winner is kept while its fresh time a pass stays within this
# factor of the stored one (hipe_tpu's _RETUNE_FACTOR); beyond it the full
# sweep runs again.
RETUNE_FACTOR = 1.6
_TUNE_CACHE_VERSION = 1


def default_tune_cache_path() -> str:
    """``build/hipe_tpu_torch/autotune.json`` beside the kernels' builds."""
    return str(_build.BUILD_ROOT / "autotune.json")


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
        tune_cache_path: str | None = None,
    ):
        self.pipeline = plib.get(pipeline)
        self.global_stats = isinstance(self.pipeline, plib.GlobalStatsPipeline)
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
        if self.global_stats and self.pipeline.channels != c:
            # The planar stream groups an image's planes by its channel count.
            self.pipeline = dataclasses.replace(self.pipeline, channels=c)
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
        # (label, config, reason to skip or None) for each autotune config of
        # the pipeline's route; every config sets the same knob (none for a
        # global-statistics pipeline), which starts at its default.
        self.candidates = self.pipeline.launch_candidates(h, w, self.device)
        self.config = dict.fromkeys(self.candidates[0][1])
        self.tuning: dict | None = None
        self.tune_cache_path = tune_cache_path or default_tune_cache_path()

    def _one_pass(self, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        return self.pipeline.apply_planar(src, out=dst, **self.config)

    def run_passes(self, r: int) -> torch.Tensor:
        """``r`` chained passes from the stream; returns the last output."""
        x = self.stream
        for i in range(r):
            with span("stream.pass"):
                x = self._one_pass(x, self._bufs[i % 2])
        return x

    def chained(self, r: int) -> int:
        """Run ``r`` chained passes; the strided checksum of the result.

        The checksum is hipe_tpu's (``sum(out[::97, ::3, ::64])``), so a
        run here compares exactly with the JAX runner's on the same stream.
        """
        out = self.run_passes(r)
        return int(out[::97, ::3, ::64].sum(dtype=torch.int64))

    # ---- the autotune's winner on disk ----

    def _tune_key(self) -> str:
        h, w, c = self.shape
        card = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                else self.device.type)
        knob = next(iter(self.config), "none")
        stages = (self.pipeline.params if self.global_stats else ','.join(self.pipeline.filters))
        return (f"{card}|{self.pipeline.name}:{stages}|"
                f"{h}x{w}x{c}|n{self.num_images}|{knob}")

    def _read_cache(self) -> dict:
        try:
            with open(self.tune_cache_path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return {}
        if not isinstance(data, dict) or data.get("version") != _TUNE_CACHE_VERSION:
            return {}
        return data.get("entries", {})

    def _load_cached_config(self):
        """(label, config, per_pass_s) stored for this key and still among
        the sweep's runnable candidates, else None."""
        ent = self._read_cache().get(self._tune_key())
        if not isinstance(ent, dict):
            return None
        runnable = {label: cfg for label, cfg, why in self.candidates if why is None}
        if ent.get("label") not in runnable:
            return None
        try:
            return ent["label"], runnable[ent["label"]], float(ent["per_pass_s"])
        except (KeyError, TypeError, ValueError):
            return None

    def _store_cached_config(self, label: str, per_pass_s: float) -> None:
        entries = self._read_cache()
        entries[self._tune_key()] = {"label": label, "per_pass_s": per_pass_s}
        try:
            os.makedirs(os.path.dirname(os.path.abspath(self.tune_cache_path)),
                        exist_ok=True)
            tmp = f"{self.tune_cache_path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump({"version": _TUNE_CACHE_VERSION, "entries": entries}, f,
                          indent=1)
            os.replace(tmp, self.tune_cache_path)
        except OSError as e:
            # The cache saves a sweep; a run never fails for it.
            print(f"autotune: cannot store the winner in {self.tune_cache_path}: {e}",
                  file=sys.stderr)

    def autotune(self, passes: int = 4, reps: int = 2, *, retune: bool = False) -> dict:
        """Time each launch config of the pipeline's kernels; keep the fastest.

        The configs are ``rows_per_block`` values for K1/K2/K3 and tile
        shapes for K4/K5 on the tiled route; a global-statistics pipeline has
        one, named after its route (on the card ``cuda_k8_k10`` for
        equalize and ``cuda_k12`` for mode and mode5, else ``torch_ops``),
        so the sweep only times it. Returns {label:
        per_pass_seconds}. A config that exceeds shared memory, or whose
        launch fails, is recorded in ``self.tuning["skipped"]`` with the
        reason; the sweep raises if none ran. The plain version is never a
        candidate.

        The winner is stored at :attr:`tune_cache_path`; a stored winner is
        timed once and kept unless that time exceeds the stored one by more
        than :data:`RETUNE_FACTOR` (then the sweep runs again) or
        ``retune`` is set. The stored time is the fastest seen, so
        a slow drift cannot ratchet the threshold up.
        ``self.tuning["cache_hit"]`` says which path ran.
        """
        cached = None if retune else self._load_cached_config()
        if cached is not None:
            label, config, cached_t = cached
            self.config = config
            try:
                t = self._measure_per_pass(passes=passes, reps=reps)
            except RuntimeError as e:
                print(f"autotune: stored config {label} failed ({e}); sweeping again",
                      file=sys.stderr)
            else:
                if t <= cached_t * RETUNE_FACTOR:
                    self.tuning = {"chosen": label, "per_pass_s": {label: t},
                                   "skipped": {}, "cache_hit": True,
                                   "cached_per_pass_s": cached_t}
                    self._store_cached_config(label, min(t, cached_t))
                    return {label: t}
                print(f"autotune: stored config {label} regressed ({t * 1e3:.4f} ms "
                      f"against {cached_t * 1e3:.4f} ms a pass); sweeping again",
                      file=sys.stderr)
        timings: dict[str, float] = {}
        skipped: dict[str, str] = {}
        best_label, best_config, best_t = None, None, float("inf")
        for label, config, why in self.candidates:
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
                       "skipped": skipped, "cache_hit": False}
        self._store_cached_config(best_label, best_t)
        return timings

    def verify_max_abs_err(self) -> int:
        """Max-abs pixel error of the first image of one pass.

        Against the NumPy oracle for a single gaussian and for a
        global-statistics op (its PIL semantics), and against the
        pipeline's own plain path for every other chain.
        """
        c = self.shape[2]
        got = self._one_pass(self.stream, self._bufs[0])[:c].cpu().numpy()
        if self.global_stats:
            want_img = self.pipeline.oracle(self.image)
        elif self.pipeline.single_gaussian:
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
