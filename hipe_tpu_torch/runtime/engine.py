"""The heterogeneous execution engine (host-CPU + CUDA lanes).

The counterpart of ``hipe_tpu.runtime.engine`` and, through it, of the
reference's two host programs (`heterogeneous_blur.c`,
`split_image_blur.c`): one engine, two partitioning strategies, three
device modes. The reference pairs a CPU OpenCL device with a GPU OpenCL
device and balances them with a tunable ratio; on an H100 host the pair is
the host CPU, running the plain PyTorch rows chain, and the card, running
the hand-written kernels:

- approach 1 (image-level): the first ``batch - floor(batch*ratio)`` images
  of each batch go to the CPU lane, the rest to the CUDA lane
  (`heterogeneous_blur.c:449-458,489-497`);
- approach 2 (row-split): every image is split at
  ``split_row = floor(H*(1-ratio))`` with `radius` halo rows; both lanes run
  the same clamped pipeline on their slab and the halo rows are
  computed-then-discarded at reassembly, generalized from the reference's
  halo=1 (`split_image_blur.c:144-173,516,526,537-539`);
- modes: 'both' | 'cpu' | 'gpu' ('tpu' and 'accel' are aliases of 'gpu').

The CUDA lane always runs the kernels through ``Pipeline.apply_rows``: K1's
rows entry for a single gaussian, a relayout onto K2/K3 (K4/K5 for planes
too wide for them) for every other chain. A global-statistics pipeline
(``GlobalStatsPipeline``) runs its PyTorch ops on each lane's device, K3
for sharpness's SMOOTH plane on the card; approach 2 refuses it (it has
no halo radius). The CPU lane is a device the user
asks for (mode 'both' or 'cpu'), never a fallback: mode 'both' or 'gpu'
with no CUDA card raises, unless the caller passes the devices.

Lanes run concurrently on worker threads (the analog of the two in-order
OpenCL command queues). Each worker thread of a CUDA lane puts its work
on a CUDA stream of its own, so batches in flight (``pipeline_depth`` 2+)
neither serialize on the legacy default stream nor wait for each other's
synchronizes; its batches go through pinned host memory both ways (on an
H100 host, 115 MB moves at 4.8 GB/s from pageable memory and 46 GB/s from
pinned: PERF.md). With ``profile=True`` each lane stage-times transfer-in /
kernel / transfer-out, each stage closed by a synchronize of that stream
(the analog of CL_QUEUE_PROFILING_ENABLE event timing, `:201-212,544-579`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from hipe_tpu_torch.models import pipelines as plib
from hipe_tpu_torch.parallel import mesh as meshlib
from hipe_tpu_torch.parallel import partitioner as pt
from hipe_tpu_torch.profiling.events import DeviceCounters, RunStats, StageClock, now_ms
from hipe_tpu_torch.profiling.report import render_report
from hipe_tpu_torch.runtime import stream as streamlib

MODE_ALIASES = {"tpu": "gpu", "accel": "gpu"}


@dataclasses.dataclass
class EngineConfig:
    """CLI-visible knobs, with the reference's defaults and validation."""

    approach: int = 1
    mode: str = "both"  # 'both' | 'cpu' | 'gpu'
    gpu_ratio: float = pt.DEFAULT_RATIO  # fraction of work on the CUDA lane
    batch_size: int = pt.DEFAULT_BATCH
    num_images: int = pt.NUM_IMAGES
    pipeline: str | Sequence[str] = "blur3"
    profile: bool = True  # stage-timed lanes (profiling queues analog)
    save_output: str | None = None  # A2: save batch-0 image 0 (SAVE_IMAGE)
    trace_dir: str | None = None  # write a torch.profiler Chrome trace of the run
    # Batches in flight per lane. 1 reproduces the reference's per-batch
    # clFinish barrier (heterogeneous_blur.c:538-539); 2+ overlaps batch
    # k+1's transfers with batch k's compute.
    pipeline_depth: int = 1
    verbose: bool = False
    # 'static' = the reference's fixed-ratio split per batch; 'greedy' =
    # batch-level work stealing (approach 1, mode 'both'): each lane pulls
    # the next whole batch when free, so the split follows measured lane
    # speed at run time (imbalance bounded by ~one batch) without a ratio.
    scheduler: str = "static"
    # Elastic recovery (greedy scheduler only): when a lane fails mid-run
    # its batch is requeued and surviving lanes finish the stream; the run
    # raises only if every lane is dead or the same batch fails on a second
    # lane (data, not device, fault). Off by default: the reference is
    # fail-fast (heterogeneous_blur.c:25-30).
    elastic: bool = False

    def validate(self) -> "EngineConfig":
        self.gpu_ratio = pt.validate_ratio(self.gpu_ratio)
        self.batch_size = pt.validate_batch(self.batch_size, self.num_images)
        self.mode = MODE_ALIASES.get(self.mode, self.mode)
        if self.approach not in (1, 2):
            raise ValueError(f"approach must be 1 or 2, got {self.approach!r}")
        if self.mode not in ("both", "cpu", "gpu"):
            raise ValueError(f"mode must be both, cpu or gpu, got {self.mode!r}")
        if self.scheduler not in ("static", "greedy"):
            raise ValueError(f"scheduler must be static or greedy, got {self.scheduler!r}")
        if self.scheduler == "greedy" and (self.approach != 1 or self.mode != "both"):
            # Warn-and-default, like the reference's CLI validation.
            print("Warning: greedy scheduling applies to approach 1 mode "
                  "'both'; using static", file=sys.stderr)
            self.scheduler = "static"
        if self.scheduler == "greedy" and self.pipeline_depth != 1:
            print("Warning: pipeline_depth has no effect under the greedy "
                  "scheduler (lanes are self-paced); using 1", file=sys.stderr)
            self.pipeline_depth = 1
        if self.elastic and self.scheduler != "greedy":
            print("Warning: elastic recovery requires the greedy scheduler; "
                  "running fail-fast", file=sys.stderr)
            self.elastic = False
        if self.approach == 2 and self.mode != "both":
            # The reference's split-image program is inherently two-device.
            raise ValueError("approach 2 requires mode='both'")
        return self


class _Lane:
    """One device lane: transfer-in -> ``Pipeline.apply_rows`` -> transfer-out."""

    def __init__(self, name: str, device, pipeline: plib.Pipeline,
                 counters: DeviceCounters, profile: bool):
        self.name = name
        self.device = torch.device(device)
        self.pipeline = pipeline
        self.counters = counters
        self.clock = StageClock(counters)
        self.profile = profile
        # 'cuda': the hand-written kernels; 'torch': the plain rows chain.
        self.path = "cuda" if self.device.type == "cuda" else "torch"
        self._local = threading.local()

    def _on_stream(self):
        """(context, sync) for the calling thread: on a CUDA lane its own
        stream on the lane's card, made at the thread's first batch, and
        that stream's synchronize; on the CPU lane nothing to wait for."""
        if self.device.type != "cuda":
            return contextlib.nullcontext(), lambda: None
        s = getattr(self._local, "stream", None)
        if s is None:
            s = self._local.stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(s), s.synchronize

    def warmup(self, shape: tuple) -> None:
        """Run one batch of ``shape`` outside the wall clock and the counters
        (the clBuildProgram analog): on the card the kernels are built at
        first use here, in the caller's thread, before any lane thread
        starts, and the pinned staging buffers of the shape are allocated."""
        self._run(np.zeros(shape, np.uint8), StageClock(DeviceCounters()), profile=False)

    def process(self, host_batch: np.ndarray) -> np.ndarray:
        return self._run(host_batch, self.clock, self.profile)

    # Data travels in interleaved-rows layout (B, H, W*C), a reshape of the
    # channels-last batch. 'in' includes making the batch contiguous on the
    # host (broadcast stream views and row slabs are not).
    def _run(self, host_batch: np.ndarray, clock: StageClock, profile: bool) -> np.ndarray:
        b, h, w, c = host_batch.shape
        ctx, sync = self._on_stream()
        # Without profiling, one stage and one synchronize at the end.
        stage = clock.stage if profile else (lambda name: contextlib.nullcontext())
        with ctx, (contextlib.nullcontext() if profile else clock.stage("kernel")):
            with stage("in"):
                x = self._to_device(host_batch)
                if profile:
                    sync()
            with stage("kernel"):
                y = self.pipeline.apply_rows(x, c)
                if profile:
                    sync()
            with stage("out"):
                out = self._to_host(y)
                sync()
        return out.reshape(b, h, w, c)

    def _to_device(self, host_batch: np.ndarray) -> torch.Tensor:
        b, h, w, c = host_batch.shape
        if self.device.type != "cuda":
            rows = np.ascontiguousarray(host_batch).reshape(b, h, w * c)
            # torch.from_numpy takes no read-only array.
            return torch.from_numpy(rows if rows.flags.writeable else rows.copy())
        # Staged in pinned host memory (the copy that makes the batch
        # contiguous writes there), then copied at the link's rate without
        # a pageable bounce; PyTorch's pinned cache reuses the buffer for
        # later batches of the shape, after the copy has read it.
        staged = torch.empty((b, h, w * c), dtype=torch.uint8, pin_memory=True)
        np.copyto(staged.numpy().reshape(b, h, w, c), host_batch)
        return staged.to(self.device, non_blocking=True)

    def _to_host(self, y: torch.Tensor) -> np.ndarray:
        """The result on the host (valid once the lane's stream is synced):
        from the card into pinned memory, which the returned array keeps."""
        if self.device.type != "cuda":
            return y.numpy()
        out = torch.empty(y.shape, dtype=torch.uint8, pin_memory=True)
        out.copy_(y, non_blocking=True)
        return out.numpy()


def run_greedy_lanes(
    lanes: dict[str, "_Lane"],
    stream,
    *,
    n_batches: int,
    elastic: bool = False,
    progress=None,
):
    """Batch-level work stealing over N named lanes, with optional elastic
    lane-failure recovery. Shared by the two-lane :class:`Engine` and the
    N-lane :class:`hipe_tpu_torch.runtime.fleet.FleetEngine`.

    Each lane pulls the next whole batch when free, so the work split
    follows measured speed instead of a pre-tuned ratio; final imbalance is
    bounded by roughly one batch per lane. Replaces the reference's
    static-ratio dispatch + manual calibration loop
    (heterogeneous_blur.c:449-497, README.md:87-93) with self-balancing.

    With ``elastic=True`` a failing lane's orphaned batch is requeued for
    the surviving lanes (a device fault kills one lane, not the run); a
    second failure of the same batch, or no survivors, raises.

    Returns batch 0's output (or None if another accounting path kept it).
    """
    notify = progress or (lambda msg: None)
    # Prefetch so batch production (e.g. JPEG decode) runs in its own
    # thread; the lock below then only guards a fast queue pop.
    pf_iter = iter(streamlib.Prefetcher(stream, depth=2))
    it = iter(enumerate(pf_iter))
    lock = threading.Lock()
    errors: list[BaseException] = []
    retry: list[tuple] = []  # batches orphaned by a failed lane
    alive = {name: True for name in lanes}
    result: dict = {"first": None}

    def account(batch_idx: int, host_batch, out, lane: "_Lane") -> None:
        bc = host_batch.shape[0]
        lane.counters.images += bc
        lane.counters.units += bc
        if batch_idx == 0:
            result["first"] = out
        notify(f"Batch {batch_idx + 1} complete.")

    def worker(name: str, lane: "_Lane") -> None:
        while not errors:
            item = None
            try:
                with lock:
                    if retry:
                        item = retry.pop()
                    else:
                        item = next(it, None)
                if item is None:
                    return
                batch_idx, host_batch, *attempt = item
                notify(f"=== Processing Batch {batch_idx + 1}/{n_batches} ===")
                out = lane.process(host_batch)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                # Covers lane failures and stream-producer errors (e.g. a
                # corrupt JPEG mid-stream). Elastic mode requeues the
                # orphaned batch for surviving lanes; a second failure of
                # the same batch means the batch itself is bad: raise.
                alive[name] = False
                second_try = bool(item) and bool(item[2:])
                if (not elastic or item is None or second_try
                        or not any(alive.values())):
                    errors.append(e)
                    return
                print(f"Warning: lane '{name}' failed ({type(e).__name__}); "
                      "redistributing its batch to surviving lanes", file=sys.stderr)
                with lock:
                    retry.append((item[0], item[1], 1))
                return
            account(batch_idx, host_batch, out, lane)

    threads = [threading.Thread(target=worker, args=(name, lane), daemon=True)
               for name, lane in lanes.items()]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        # On an error exit the producer thread would otherwise stay blocked
        # in q.put holding staged batches; closing the generator releases it.
        close = getattr(pf_iter, "close", None)
        if close is not None:
            close()
    if not errors and retry:
        # Every healthy lane exited before draining the requeue (the
        # failure happened as the stream ran dry): finish inline.
        survivors = [n for n, ok in alive.items() if ok]
        if not survivors:
            raise RuntimeError("all lanes failed")
        lane = lanes[survivors[0]]
        while retry:
            batch_idx, host_batch, *_ = retry.pop()
            out = lane.process(host_batch)
            account(batch_idx, host_batch, out, lane)
    if errors:
        raise errors[0]
    return result["first"]


class Engine:
    """Heterogeneous host-CPU + CUDA image-processing engine."""

    def __init__(self, config: EngineConfig | None = None,
                 cpu_device=None, accel_device=None, **kw):
        self.config = (config or EngineConfig(**kw)).validate()
        cfg = self.config
        self.pipeline = plib.get(cfg.pipeline)

        inv = meshlib.discover()
        if cpu_device is None and cfg.mode in ("both", "cpu"):
            cpu_device = meshlib.require_device(inv, "cpu")
        if accel_device is None and cfg.mode in ("both", "gpu"):
            # Hard-fail when no card is visible, like the reference's device
            # discovery (heterogeneous_blur.c:181-184): never a second CPU lane.
            accel_device = meshlib.require_device(inv, "accel")
        self.cpu_device = cpu_device
        self.accel_device = accel_device

        self._lanes: dict[str, _Lane] = {}
        self.stats = RunStats(
            approach=cfg.approach, mode=cfg.mode, gpu_ratio=cfg.gpu_ratio,
            batch_size=cfg.batch_size, num_images=cfg.num_images,
            num_batches=pt.num_batches(cfg.num_images, cfg.batch_size),
            width=0, height=0, channels=0, pipeline=self.pipeline.name,
        )
        if cfg.mode in ("both", "cpu"):
            self._lanes["cpu"] = _Lane("cpu", cpu_device, self.pipeline,
                                       self.stats.cpu, profile=cfg.profile)
            self.stats.cpu_exec = self._lanes["cpu"].path
        if cfg.mode in ("both", "gpu"):
            self._lanes["accel"] = _Lane("accel", accel_device, self.pipeline,
                                         self.stats.accel, profile=cfg.profile)
            self.stats.accel_exec = self._lanes["accel"].path
        depth = max(1, cfg.pipeline_depth)
        self._pool = ThreadPoolExecutor(max_workers=2 * depth)
        self.first_output: np.ndarray | None = None

    def _progress(self, msg: str) -> None:
        """Per-batch progress lines (reference heterogeneous_blur.c:420,599)."""
        if self.config.verbose:
            print(msg, flush=True)

    def _drain(self, window, limit: int) -> None:
        """Wait for the oldest in-flight batch(es) beyond `limit`."""
        while len(window) > limit:
            batch_idx, futures, finalize = window.pop(0)
            outs = [f.result() for f in futures]
            if finalize is not None:
                finalize(outs)
            self._progress(f"Batch {batch_idx + 1} complete.")

    # ---- approach 1: image-level distribution ----

    def _split(self, bc: int) -> tuple[int, int]:
        """(images to the CPU lane, images to the CUDA lane) of a batch."""
        if self.config.mode == "both":
            return pt.split_images(bc, self.config.gpu_ratio)
        return (bc, 0) if self.config.mode == "cpu" else (0, bc)

    def _run_approach1(self, stream) -> None:
        depth = max(1, self.config.pipeline_depth)
        window: list = []
        for batch_idx, host_batch in enumerate(stream):
            self._progress(f"=== Processing Batch {batch_idx + 1}/"
                           f"{self.stats.num_batches} ===")
            num_cpu, num_acc = self._split(host_batch.shape[0])
            futures = []
            for name, part, n in (("cpu", host_batch[:num_cpu], num_cpu),
                                  ("accel", host_batch[num_cpu:], num_acc)):
                if n:
                    lane = self._lanes[name]
                    futures.append(self._pool.submit(lane.process, part))
                    lane.counters.images += n
                    lane.counters.units += n

            def finalize(outs, batch_idx=batch_idx):
                if batch_idx == 0:
                    # Keep batch 0's output for verification / inspection.
                    self.first_output = np.concatenate(outs, axis=0)

            window.append((batch_idx, futures, finalize))
            self._drain(window, depth - 1)
        self._drain(window, 0)

    # ---- approach 1, greedy scheduler: batch-level work stealing ----

    def _run_greedy(self, stream) -> None:
        first = run_greedy_lanes(self._lanes, stream, n_batches=self.stats.num_batches,
                                 elastic=self.config.elastic, progress=self._progress)
        if first is not None:
            self.first_output = first

    # ---- approach 2: split-image distribution ----

    def _run_approach2(self, stream) -> None:
        cfg = self.config
        depth = max(1, cfg.pipeline_depth)
        window: list = []
        for batch_idx, host_batch in enumerate(stream):
            self._progress(f"=== Processing Batch {batch_idx + 1}/"
                           f"{self.stats.num_batches} ===")
            bc, h, w, c = host_batch.shape
            rs = pt.row_split(h, cfg.gpu_ratio, halo=self.pipeline.radius)
            self.stats.split_row = rs.split_row
            self.stats.halo = rs.halo
            cpu_slab = host_batch[:, rs.cpu_in[0]: rs.cpu_in[1]]
            acc_slab = host_batch[:, rs.gpu_in[0]: rs.gpu_in[1]]
            futures = [
                self._pool.submit(self._lanes["cpu"].process, cpu_slab),
                self._pool.submit(self._lanes["accel"].process, acc_slab),
            ]
            self.stats.cpu.images += bc
            self.stats.accel.images += bc
            self.stats.cpu.units += bc * rs.cpu_output_rows
            self.stats.accel.units += bc * rs.gpu_output_rows

            def finalize(outs, batch_idx=batch_idx, rs=rs):
                if batch_idx != 0:
                    return
                cpu_out, acc_out = outs
                # Reassemble batch 0 (split_image_blur.c:548-553): each side
                # drops its computed-but-discarded halo rows.
                top = cpu_out[:, : rs.cpu_output_rows]
                bottom = acc_out[:, rs.gpu_out[0] - rs.gpu_in[0]:]
                self.first_output = np.concatenate([top, bottom], axis=1)
                if cfg.save_output:
                    from hipe_tpu_torch.io_.jpeg import encode_file

                    encode_file(self.first_output[0], cfg.save_output)

            window.append((batch_idx, futures, finalize))
            self._drain(window, depth - 1)
        self._drain(window, 0)

    # ---- running a stream ----

    def run(self, image: np.ndarray | None = None, stream=None) -> RunStats:
        cfg = self.config
        if stream is None:
            if image is None:
                from hipe_tpu_torch.utils.images import checker_image

                # The reference's 320x240 geometry (its JPEG asset is not in
                # the repository).
                image = checker_image(240, 320, 3, seed=0)
            stream = streamlib.ReplicatedStream(image, cfg.num_images, cfg.batch_size)
        if not hasattr(stream, "batch_shapes"):
            # One-shot iterables (generators) would be exhausted by the
            # geometry scan + warmup below; materialize once.
            stream = list(stream)
        _, h, w, c = self._stream_shapes(stream)[0]
        self.stats.height, self.stats.width, self.stats.channels = h, w, c

        self._warmup(stream)
        with contextlib.ExitStack() as trace:
            if cfg.trace_dir:
                trace.callback(self._trace(cfg.trace_dir))
            t0 = now_ms()
            try:
                if cfg.approach == 1 and cfg.scheduler == "greedy":
                    self._run_greedy(stream)
                elif cfg.approach == 1:
                    self._run_approach1(stream)
                else:
                    self._run_approach2(stream)
            finally:
                self.stats.wall_ms = now_ms() - t0
        return self.stats

    def _trace(self, trace_dir: str):
        """Start a torch.profiler trace (host, and the card when a lane runs
        on one); returns the callback that stops it and writes
        ``trace_dir/trace.json`` (Chrome trace format, for Perfetto)."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if any(lane.device.type == "cuda" for lane in self._lanes.values()):
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()

        def stop() -> None:
            prof.__exit__(None, None, None)
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

        return stop

    @staticmethod
    def _stream_shapes(stream) -> list[tuple]:
        """Batch shapes, preferring the cheap path (no decode/materialize)."""
        if hasattr(stream, "batch_shapes"):
            return stream.batch_shapes()
        return [b.shape for b in stream]

    def _warmup(self, stream) -> None:
        """Run every (lane, shape) pair once before the wall clock starts."""
        cfg = self.config
        lane_shapes: set[tuple[str, tuple]] = set()
        for bc, h, w, c in set(self._stream_shapes(stream)):
            if cfg.approach == 1 and cfg.scheduler == "greedy":
                # Any lane may take any batch (incl. the remainder batch).
                for lane_name in self._lanes:
                    lane_shapes.add((lane_name, (bc, h, w, c)))
            elif cfg.approach == 1:
                num_cpu, num_acc = self._split(bc)
                if num_cpu:
                    lane_shapes.add(("cpu", (num_cpu, h, w, c)))
                if num_acc:
                    lane_shapes.add(("accel", (num_acc, h, w, c)))
            else:
                rs = pt.row_split(h, cfg.gpu_ratio, halo=self.pipeline.radius)
                lane_shapes.add(("cpu", (bc, rs.cpu_input_rows, w, c)))
                lane_shapes.add(("accel", (bc, rs.gpu_input_rows, w, c)))
        for lane_name, shape in sorted(lane_shapes):
            self._lanes[lane_name].warmup(shape)

    def report(self, accel_name: str | None = None) -> str:
        """The 8-section report; with a CPU lane, also its torch threads."""
        if accel_name is None:
            dev = self.accel_device
            accel_name = ("GPU" if dev is None or torch.device(dev).type == "cuda"
                          else torch.device(dev).type.upper())
        text = render_report(self.stats, accel_name=accel_name)
        if "cpu" in self._lanes:
            what = ("PyTorch global-statistics ops"
                    if isinstance(self.pipeline, plib.GlobalStatsPipeline)
                    else "plain PyTorch rows chain")
            text += f"\n   CPU lane: {what}, {torch.get_num_threads()} intra-op threads"
        return text
