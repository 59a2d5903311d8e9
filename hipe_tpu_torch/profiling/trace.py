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
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import numpy as np
import torch
from torch.autograd import profiler as _profiler

MAX_RECORDS = 100_000

_NULL = contextlib.nullcontext()
_Record = collections.namedtuple("_Record", "start_ns end_ns events")
_lock = threading.Lock()
_records: dict[str, list[_Record]] = {}


def span(name: str, device=None):
    """A context manager that records ``name`` while a profiler records;
    ``device`` (a CUDA device) adds the device time between its two ends."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, device)


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
    """``{name: stats}`` of the records kept. Per name: ``n``;
    ``host_ms_median``; ``device_ms_total``, the sum of the device time
    between each span's two events (waited for here), or ``None`` where no
    span of the name had a CUDA device."""
    with _lock:
        kept = {name: list(recs) for name, recs in _records.items()}
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
    return spans


def reset() -> None:
    """Forget every record."""
    with _lock:
        _records.clear()
