"""The counters of a profiler session (``profiling/trace.py``) and the NVML
binding (``profiling/nvml.py``) on the CPU.

The card is a stand-in: ``nvml.open_device`` returns a scripted sequence of
clocks and reasons. Inside a ``torch.profiler`` session the first span
starts one sampler thread, which stamps each sample on ``time.time_ns()``
and is gone at the first tick after the profiler stops; the summary's
medians and limited share are the script's. Untraced, nothing starts and
nothing is summarized. Without the library no clock entry appears and
nothing raises. ``reset()`` stops the thread and forgets the samples. The
launch seam's count is the launches inside the session alone. The binding
itself runs against a stand-in library.
"""

import contextlib
import ctypes
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hipe_tpu_torch.ops import _build
from hipe_tpu_torch.profiling import nvml, trace

THREAD = "hipe-trace-sampler"
COUNTERS = {trace.SM_CLOCK, trace.MEM_CLOCK, trace.CLOCK_LIMITED}
# (SM MHz, memory MHz, reasons): the power cap twice, idle, application
# clocks, display, the power cap with idle, HW slowdown, nothing.
SCRIPT = [(1980, 2619, 0x0), (1965, 2619, 0x4), (1950, 2619, 0x4), (1980, 2619, 0x1),
          (1980, 2619, 0x2), (1980, 2619, 0x100), (1965, 2619, 0x5), (1755, 2619, 0x8),
          (1980, 2619, 0x0)]


@pytest.fixture(autouse=True)
def no_records():
    trace.reset()
    yield
    trace.reset()


class StandIn:
    """A card that answers ``script`` in order, then fails every call (which
    ends the sampling); with ``repeat`` it answers the script over and over."""

    def __init__(self, script, repeat=False):
        self.script, self.repeat = list(script), repeat
        self.calls, self.done = 0, threading.Event()
        self.threads = set()

    def sample(self):
        self.threads.add(threading.current_thread().name)
        i = self.calls
        self.calls += 1
        if self.repeat:
            return self.script[i % len(self.script)]
        if i >= len(self.script):
            self.done.set()
            return None
        return self.script[i]


@pytest.fixture
def card(monkeypatch):
    """Patch the binding to open ``card.device`` (scripted) on any index."""
    state = types.SimpleNamespace(device=StandIn(SCRIPT), opened=[])

    def open_device(index):
        state.opened.append(index)
        return state.device

    monkeypatch.setattr(nvml, "open_device", open_device)
    return state


def _samplers():
    return [t for t in threading.enumerate() if t.name == THREAD]


def _joined(timeout=5.0):
    for t in _samplers():
        t.join(timeout=timeout)
    return not _samplers()


def test_one_thread_samples_the_session_on_the_spans_clock(card):
    before = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("outer"):
            assert len(_samplers()) == 1
            helper = threading.Thread(target=lambda: trace.span("inner").__enter__().__exit__(
                None, None, None))
            helper.start()
            helper.join(timeout=30)
            assert not helper.is_alive()
            assert card.device.done.wait(timeout=30)
            assert len(_samplers()) == 1
        inside = time.time_ns()
    assert _joined()
    after = time.time_ns()
    assert card.device.threads == {THREAD}
    assert card.opened == [None]  # the CPU: no CUDA device current
    stamps = [s.t_ns for s in trace._samples]
    assert len(stamps) == len(SCRIPT)
    assert all(before <= t <= inside <= after for t in stamps)
    assert stamps == sorted(stamps)
    # Sample i is due SAMPLE_PERIOD_S x i after the first.
    assert stamps[-1] - stamps[0] >= 0.9 * (len(stamps) - 1) * trace.SAMPLE_PERIOD_S * 1e9
    s = trace.summary()
    sm = np.array([x[0] for x in SCRIPT], np.float64)
    assert s[trace.SM_CLOCK] == {"n": len(SCRIPT), "median": float(np.median(sm)),
                                 "min": 1755.0, "max": 1980.0}
    assert s[trace.MEM_CLOCK] == {"n": len(SCRIPT), "median": 2619.0, "min": 2619.0,
                                  "max": 2619.0}
    assert s[trace.CLOCK_LIMITED] == {
        "n": len(SCRIPT), "pct": 100.0 * 4 / len(SCRIPT),
        "reasons": ["gpu_idle", "applications_clocks_setting", "sw_power_cap", "hw_slowdown",
                    "display_clock_setting"]}
    assert s["outer"]["n"] == s["inner"]["n"] == 1
    assert trace.LAUNCHES not in s  # no launch on the CPU


def test_the_thread_samples_the_device_current_where_the_span_was_entered(card, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("outer"):
            assert card.device.done.wait(timeout=30)
    assert _joined()
    assert card.opened == [3]


def test_the_thread_ends_at_the_first_tick_after_the_profiler_stops(card):
    card.device = StandIn(SCRIPT, repeat=True)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("outer"):
            time.sleep(0.1)
    assert _joined()
    calls = card.device.calls
    assert 1 <= calls
    time.sleep(5 * trace.SAMPLE_PERIOD_S)
    assert card.device.calls == calls
    # A sample after the last span's end is not summarized.
    s = trace.summary()
    last_end = trace._records["outer"][0].end_ns
    kept = [x for x in trace._samples if x.t_ns <= last_end]
    assert s[trace.SM_CLOCK]["n"] == len(kept) >= 1


def test_untraced_starts_no_thread_and_summarizes_nothing(card):
    with trace.span("outer"):
        with trace.span("inner", "cpu"):
            time.sleep(3 * trace.SAMPLE_PERIOD_S)
    assert not _samplers() and card.opened == [] and card.device.calls == 0
    assert trace._samples == [] and trace._session is None
    assert trace.summary() == {}


def test_a_second_profiler_session_opens_a_second_sampler(card):
    card.device = StandIn(SCRIPT, repeat=True)
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span("outer"):
                time.sleep(3 * trace.SAMPLE_PERIOD_S)
        assert _joined()
    assert card.opened == [None, None]
    s = trace.summary()
    assert s["outer"]["n"] == 2 and s[trace.SM_CLOCK]["n"] >= 2


@pytest.mark.parametrize("absent", ["library", "call"])
def test_without_the_library_spans_and_launches_stand_and_nothing_raises(absent, monkeypatch):
    """No library, or one whose calls fail: no clock or reason entry."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    if absent == "library":
        monkeypatch.setattr(nvml, "LIBRARY", "libnvidia-ml-absent.so.1")
        nvml._library.cache_clear()
    else:
        monkeypatch.setattr(nvml, "open_device", lambda index: StandIn([]))
    wrapper = _stand_in_wrapper(monkeypatch)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span("outer"):
                for _ in range(3):
                    wrapper(torch.zeros(2, dtype=torch.uint8))
        assert _joined()
        s = trace.summary()
    finally:
        nvml._library.cache_clear()
    assert not COUNTERS & set(s)
    assert s["outer"]["n"] == 1 and s[trace.LAUNCHES] == {"n": 3}


def test_reset_stops_the_thread_and_forgets_the_samples(card):
    card.device = StandIn(SCRIPT, repeat=True)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("outer"):
            deadline = time.monotonic() + 30
            while card.device.calls < 3 and time.monotonic() < deadline:
                time.sleep(trace.SAMPLE_PERIOD_S)
            assert trace._samples
            trace.reset()
            assert not _samplers() and trace._samples == [] and trace._session is None
            assert trace.summary() == {}
            calls = card.device.calls
            time.sleep(3 * trace.SAMPLE_PERIOD_S)
            assert card.device.calls == calls and trace._samples == []


def test_samples_stop_at_the_bound(card, monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 4)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("outer"):
            assert card.device.done.wait(timeout=30)
    assert len(trace._samples) == 4
    assert trace.summary()[trace.SM_CLOCK]["n"] == 4


def _stand_in_wrapper(monkeypatch):
    """An ``entry`` wrapper over a stand-in C entry point that succeeds."""
    lib = types.SimpleNamespace(hipe_stand_in_count=lambda *args: 0)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))

    @_build.entry("hipe_stand_in_count", _build.P)
    def wrapper(x):
        wrapper.launch(x, lambda: "stand-in", x.data_ptr())

    assert wrapper in trace._launchers
    return wrapper


@pytest.mark.parametrize("k,j", [(1, 0), (5, 3), (0, 4)])
def test_the_session_counts_the_seams_launches_inside_it_alone(k, j, monkeypatch):
    wrapper = _stand_in_wrapper(monkeypatch)
    x = torch.zeros(4, dtype=torch.uint8)
    for _ in range(j):
        wrapper(x)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("outer"):
            for _ in range(k):
                wrapper(x)
    assert _joined()
    for _ in range(j):
        wrapper(x)
    s = trace.summary()
    assert wrapper.launches == k + 2 * j
    assert s.get(trace.LAUNCHES) == ({"n": k} if k else None)
    assert s["outer"]["n"] == 1


class StandInLib:
    """NVML as ctypes would expose it: each function writes its result
    through the pointer it is given and returns 0, or ``fail`` for the
    names in ``failing``."""

    def __init__(self, reasons_symbol="nvmlDeviceGetCurrentClocksEventReasons", failing=()):
        self.lookups = []

        def fn(name, body):
            def call(*args):
                self.lookups.append((name, args[0] if name.startswith("nvmlDeviceGetHandle")
                                     else None))
                return 999 if name in failing else body(*args)
            return call

        def handle(key, out):
            out._obj.value = 0x1234
            return 0

        def clock(h, kind, out):
            out.contents.value = {nvml.CLOCK_SM: 1965, nvml.CLOCK_MEM: 2619}[kind]
            return 0

        def reasons(h, out):
            out.contents.value = 0x4 | 0x1
            return 0

        self.nvmlInit_v2 = fn("nvmlInit_v2", lambda: 0)
        self.nvmlDeviceGetHandleByUUID = fn("nvmlDeviceGetHandleByUUID", handle)
        self.nvmlDeviceGetClockInfo = fn("nvmlDeviceGetClockInfo", clock)
        setattr(self, reasons_symbol, fn(reasons_symbol, reasons))


@pytest.fixture
def props(monkeypatch):
    p = types.SimpleNamespace(uuid="58e3d0c2-0000-1111-2222-333344445555")
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda index: p)
    return p


@pytest.mark.parametrize("symbol", ["nvmlDeviceGetCurrentClocksEventReasons",
                                    "nvmlDeviceGetCurrentClocksThrottleReasons"])
def test_the_binding_reads_clocks_and_reasons_by_uuid(symbol, props, monkeypatch):
    lib = StandInLib(symbol)
    monkeypatch.setattr(ctypes, "CDLL", lambda name: lib)
    nvml._library.cache_clear()
    try:
        dev = nvml.open_device(0)
        assert dev.sample() == (1965, 2619, 0x5)
    finally:
        nvml._library.cache_clear()
    handles = [a for n, a in lib.lookups if n.startswith("nvmlDeviceGetHandle")]
    assert handles == [b"GPU-58e3d0c2-0000-1111-2222-333344445555"]
    assert nvml.reason_names(0x5 | 0x400) == ["gpu_idle", "sw_power_cap", "0x400"]


@pytest.mark.parametrize("failing", ["nvmlInit_v2", "nvmlDeviceGetHandleByUUID",
                                     "nvmlDeviceGetClockInfo",
                                     "nvmlDeviceGetCurrentClocksEventReasons"])
def test_the_binding_gives_nothing_where_a_call_fails(failing, props, monkeypatch):
    lib = StandInLib(failing=(failing,))
    monkeypatch.setattr(ctypes, "CDLL", lambda name: lib)
    nvml._library.cache_clear()
    try:
        dev = nvml.open_device(0)
        assert dev is None if failing.startswith("nvmlInit") or "Handle" in failing else (
            dev.sample() is None)
    finally:
        nvml._library.cache_clear()


def test_the_binding_gives_nothing_without_a_device_or_library(monkeypatch):
    assert nvml.open_device(None) is None
    monkeypatch.setattr(nvml, "LIBRARY", "libnvidia-ml-absent.so.1")
    nvml._library.cache_clear()
    try:
        assert nvml.open_device(0) is None
    finally:
        nvml._library.cache_clear()
