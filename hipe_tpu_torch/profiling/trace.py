"""Spans on the profiler's clock: the host and device time of the port's stages.

A span records only while a ``torch.profiler`` session records (the
harness's ``--trace 1``, ``Engine``'s ``trace_dir``, an operator's own
profiler); otherwise :func:`span` returns one shared null context and
records nothing. A recorded span:

- is a host event of the trace, so an idle gap of the device can be put
  down to it. It is recorded as a function, not as a user annotation:
  the profiler copies a user annotation onto the device's timeline, where
  it would cover the device's idle time inside the span;
- stamps its host start and end with ``time.time_ns()``, the clock the
  profiler stamps host events with;
- for a CUDA ``device``, records a timing event on the current stream at
  its enter and at its exit. The two events cost the device a few
  microseconds, so only spans whose device time is read take one.

A span whose body raises is not recorded (``events.StageClock``'s rule).
Records stay in memory, at most :data:`MAX_RECORDS` a name;
:func:`summary` reads them and :func:`reset` clears them.

The spans:

- ``stream.pass`` (host only) around each pass of
  ``runtime/device_stream.py``'s ``DeviceStreamRunner.run_passes``;
- ``stats.histogram``, ``stats.lut``, ``stats.apply`` (with device time)
  around equalize's three stages in ``ops/equalize.py``'s
  ``equalize_planar``;
- ``stats.mode`` (with device time) around the whole of ``ops/equalize.py``'s
  ``mode_planar`` (``mode`` and ``mode5``): one a call, so one a chunk of
  ``GlobalStatsPipeline``'s chunked pass (on the card one K12 launch, the
  stream one chunk);
- ``serve.transcode`` (host only) around each call of the function
  ``runtime/serve.py``'s ``ServingPipeline.transcode_fn`` returns: one a
  transcode of a group;
- the codec's stages, each with device time and each once a call of the
  function it sits in, around all of that stage's launches or chunks:
  ``codec.idct`` (the components' IDCTs: K6, or the reduced IDCTs) and
  ``codec.upsample_color`` (upsampling and YCbCr -> RGB: K11 where it
  takes the geometry, else torch ops in chunks) in
  ``ops/jpeg_decode.py``'s ``decode_planes_scaled``; ``codec.filter`` (the
  filter and the stages after it) in ``runtime/serve.py``'s
  ``ServingPipeline.encode_fn`` with ``with_filter``; and
  ``codec.color_downsample`` (RGB -> YCbCr, edge padding, downsampling) and
  ``codec.fdct`` (fDCT + quantize: K7) in ``ops/jpeg_encode.py``'s
  ``encode_planes``. A transcode records ``serve.transcode`` and each of
  these five once.

Beside the spans, the counters of a profiler session. The first span
entered while a profiler records opens a session and starts one thread,
which samples the card (``nvml.py``) every :data:`SAMPLE_PERIOD_S` from a
period after that span until the first tick after the profiler stops;
:func:`summary` and :func:`reset` close the session too. What a session
counts, in :func:`summary`:

- ``device.sm_clock_mhz`` and ``device.mem_clock_mhz``: the SM and memory
  clocks (NVML's ``nvmlDeviceGetClockInfo``) of the CUDA device current on
  the thread that opened the session, each sample stamped with
  ``time.time_ns()``;
- ``device.clock_limited``: the share of those samples whose clock-event
  reasons (``nvmlDeviceGetCurrentClocksEventReasons``) hold a limit
  (``nvml.LIMITING``: the power cap, a thermal or hardware slowdown), and
  the names of the reasons seen;
- ``kernels.launches``: the launches through ``ops/_build.py``'s ``entry``
  (each wrapper's ``.launches``, read at the session's first span and at
  its close).

A sample counts up to the end of the last span kept: the profiler's own
stop, with the device idle, is left out. Without NVML (the CPU, a machine
without the driver's library) there are no samples, and a session that
counted no launch gives no launch entry, so a traced run on the CPU
summarizes its spans alone. Samples stay in memory, at most
:data:`MAX_RECORDS`.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import numpy as np
import torch
from torch.autograd import profiler as _profiler

from hipe_tpu_torch.profiling import nvml

MAX_RECORDS = 100_000
SAMPLE_PERIOD_S = 0.01
# The names of the counters in the summary.
SM_CLOCK, MEM_CLOCK = "device.sm_clock_mhz", "device.mem_clock_mhz"
CLOCK_LIMITED, LAUNCHES = "device.clock_limited", "kernels.launches"

_NULL = contextlib.nullcontext()
_Record = collections.namedtuple("_Record", "start_ns end_ns events")
_lock = threading.Lock()
_records: dict[str, list[_Record]] = {}
_Sample = collections.namedtuple("_Sample", "t_ns sm_mhz mem_mhz reasons")
_samples: list[_Sample] = []
_launches = 0  # counted by the sessions closed since the last reset
_launchers: list = []  # the entry wrappers, each with its ``.launches``
_session = None  # the open session, or None


def counts_launches(wrapper):
    """Register ``wrapper`` (of ``ops/_build.py``'s ``entry``), whose
    ``.launches`` each session reads; returns it."""
    _launchers.append(wrapper)
    return wrapper


def _launch_total() -> int:
    return sum(w.launches for w in list(_launchers))


def span(name: str, device=None):
    """A context manager that records ``name`` while a profiler records;
    ``device`` (a CUDA device) adds the device time between its two ends."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    if _session is None:
        _open_session()
    return _Span(name, device)


class _Session:
    """One profiler session's counters: the launch total at its start, and
    the thread that samples the card until the profiler stops."""

    def __init__(self, index):
        self.index = index
        self.launches = _launch_total()
        self.closed = False
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._sample, name="hipe-trace-sampler",
                                       daemon=True)

    def _sample(self):
        # NVML opens a period after the first span, not during it: at a
        # profiler's start the device's queue is empty, and that span would
        # wait on the opening for the interpreter lock while the device idles.
        device = None
        if not self.stop.wait(SAMPLE_PERIOD_S) and _profiler._is_profiler_enabled:
            device = nvml.open_device(self.index)
        due = time.monotonic()
        while device is not None and _profiler._is_profiler_enabled and not self.stop.is_set():
            t0 = time.time_ns()
            got = device.sample()
            t1 = time.time_ns()
            if got is None:  # a failed call ends the sampling
                break
            with _lock:
                if not self.closed and len(_samples) < MAX_RECORDS:
                    _samples.append(_Sample((t0 + t1) // 2, *got))
            due += SAMPLE_PERIOD_S
            self.stop.wait(max(0.0, due - time.monotonic()))
        while _profiler._is_profiler_enabled and not self.stop.wait(SAMPLE_PERIOD_S):
            pass
        _close(self, count=True)


def _open_session() -> None:
    """Open a session on the CUDA device current on this thread, if any."""
    global _session
    index = torch.cuda.current_device() if torch.cuda.is_initialized() else None
    with _lock:
        if _session is not None:  # opened by another thread meanwhile
            return
        _session = _Session(index)
        _session.thread.start()


def _close(session: _Session, count: bool) -> None:
    """Close ``session`` once, adding its launches where ``count``."""
    global _launches, _session
    with _lock:
        if session.closed:
            return
        session.closed = True
        if count:
            _launches += _launch_total() - session.launches
        if _session is session:
            _session = None


def _stop(count: bool) -> None:
    """Close the open session, if any, and wait for its thread."""
    session = _session
    if session is None:
        return
    _close(session, count)
    session.stop.set()
    if session.thread is not threading.current_thread():
        session.thread.join(timeout=1.0)


class _Span:
    __slots__ = ("name", "stream", "rf", "events", "t0")

    def __init__(self, name: str, device):
        self.name = name
        cuda = device is not None and torch.device(device).type == "cuda"
        self.stream = torch.cuda.current_stream(device) if cuda else None

    def __enter__(self):
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.events = None
        if self.stream is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, kind, value, tb):
        t1 = time.time_ns()
        try:
            if kind is None and self.events is not None:
                self.events[1].record(self.stream)
        finally:
            self.rf.__exit__(kind, value, tb)
        if kind is None:
            with _lock:
                kept = _records.setdefault(self.name, [])
                if len(kept) < MAX_RECORDS:
                    kept.append(_Record(self.t0, t1, self.events))
        return False


def summary() -> dict:
    """``{name: stats}`` of the records kept, and the counters. Per span
    name: ``n``; ``host_ms_median``; ``device_ms_total``, the sum of the
    device time between each span's two events (waited for here), or
    ``None`` where no span of the name had a CUDA device. Closes the open
    session; see the module's docstring for the counters."""
    _stop(count=True)
    with _lock:
        kept = {name: list(recs) for name, recs in _records.items()}
        samples, launches = list(_samples), _launches
    spans = {}
    for name, recs in kept.items():
        host_ms = np.array([r.end_ns - r.start_ns for r in recs], np.float64) / 1e6
        timed = [r.events for r in recs if r.events is not None]
        for _, end in timed:
            end.synchronize()
        spans[name] = {
            "n": len(recs),
            "host_ms_median": float(np.median(host_ms)),
            "device_ms_total": (float(sum(s.elapsed_time(e) for s, e in timed))
                                if timed else None),
        }
    last_end = max((r.end_ns for recs in kept.values() for r in recs), default=None)
    samples = [x for x in samples if last_end is not None and x.t_ns <= last_end]
    if samples:
        for name, field in ((SM_CLOCK, "sm_mhz"), (MEM_CLOCK, "mem_mhz")):
            mhz = np.array([getattr(x, field) for x in samples], np.float64)
            spans[name] = {"n": len(mhz), "median": float(np.median(mhz)),
                           "min": float(mhz.min()), "max": float(mhz.max())}
        seen = 0
        for x in samples:
            seen |= x.reasons
        limited = sum(1 for x in samples if x.reasons & nvml.LIMITING)
        spans[CLOCK_LIMITED] = {"n": len(samples), "pct": 100.0 * limited / len(samples),
                                "reasons": nvml.reason_names(seen)}
    if launches:
        spans[LAUNCHES] = {"n": launches}
    return spans


def reset() -> None:
    """Close the open session without counting it, and forget every record,
    sample and launch counted."""
    global _launches
    _stop(count=False)
    with _lock:
        _records.clear()
        _samples.clear()
        _launches = 0
