"""What a ``torch.profiler`` trace of the window says: the device's busy
time, the device operations that took most of it, and the idle gaps by
what the host was doing.

The traced window is the ``bench.window`` span the harness records around
the traced steps and their closing synchronize. The device is busy where a
kernel, a copy or a memset runs (their union: overlaps count once). A gap
is named by the innermost host event that covers its middle (an ATen op, a
CUDA runtime call or one of the harness's spans), or ``no host event``;
where that is a harness span or nothing, the last host op that ended
before the gap is named after it (``bench.step after aten::empty``).
"""

from __future__ import annotations

import collections

import numpy as np

BUSY_TYPES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
LABELLED_GAPS = 500  # the longest gaps named one by one; the rest are summed
NAME_CHARS = 120


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def _busy(e) -> bool:
    """Whether a device event is a kernel, a copy or a memset: by its
    activity type where the profiler gives one, else by what it is not (the
    device-side copy of a user annotation, whatever its name, or of a
    harness span; a synchronization)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in BUSY_TYPES
    annotation = getattr(e, "is_user_annotation", None)
    if annotation is not None and annotation():
        return False
    name = e.name()
    return not name.startswith("bench.") and "synchroniz" not in name.lower()


def summarize(prof, log=None) -> dict:
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    window = [e for e in events if e.name() == "bench.window"]
    if not window:
        raise RuntimeError("the trace holds no bench.window span")
    w0, w1 = window[0].start_ns(), window[0].end_ns()
    device, host = [], []
    seen = collections.Counter()
    for e in events:
        s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if e.device_type() == DeviceType.CUDA:
            seen[_short(e.name())[:60]] += 1
            if _busy(e) and t > s:
                device.append((s, t, e.name()))
        elif t >= s and e.name() != "bench.window":
            host.append((e.start_ns(), e.end_ns(), e.name()))
    if log:
        log(f"trace: device events by name {dict(seen.most_common(12))}")
    device.sort()
    busy = []  # merged intervals
    for s, t, _ in device:
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t)
        else:
            busy.append([s, t])
    busy_ns = sum(t - s for s, t in busy)
    by_op = collections.Counter()
    for s, t, name in device:
        by_op[_short(name)] += (t - s) / 1e9
    gaps, last = [], w0
    for s, t in busy:
        if s > last:
            gaps.append((last, s))
        last = max(last, t)
    if w1 > last:
        gaps.append((last, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    by_host = collections.Counter()
    if host:
        hs = np.array([h[0] for h in host], np.int64)
        he = np.array([h[1] for h in host], np.int64)
        ops = np.array([not h[2].startswith("bench.") for h in host])
        for s, t in gaps[:LABELLED_GAPS]:
            mid = (s + t) // 2
            cover = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = (host[cover[np.argmin(he[cover] - hs[cover])]][2] if len(cover)
                    else "no host event")
            if name.startswith("bench.") or not len(cover):
                # Inside the harness's span but no op of the program's: name
                # the last host op that ended before the gap.
                before = np.nonzero(ops & (he <= s))[0]
                if len(before):
                    name += " after " + host[before[np.argmax(he[before])]][2]
            by_host[_short(name)] += (t - s) / 1e9
    else:
        for s, t in gaps[:LABELLED_GAPS]:
            by_host["no host event"] += (t - s) / 1e9
    rest = sum(t - s for s, t in gaps[LABELLED_GAPS:]) / 1e9
    if rest:
        by_host[f"shorter gaps than the {LABELLED_GAPS} longest"] += rest
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "device_ops": [[n, v] for n, v in by_op.most_common(TOP)],
        "idle_gaps": [[n, v] for n, v in by_host.most_common(TOP)],
    }
