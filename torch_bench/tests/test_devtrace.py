"""``devtrace`` counts the device busy where a kernel, a copy or a memset
runs, and not where a user annotation's device-side copy lies, whatever its
name: on stand-in events without an activity type, as torch 2.11's, and
with one."""

import types

import pytest
from torch.autograd import DeviceType

import harness

devtrace = harness.load_module(harness.BENCH_DIR / "devtrace.py")


def _event(name, start, end, device=DeviceType.CUDA, annotation=False, kind=None):
    e = types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, end_ns=lambda: end,
        device_type=lambda: device, is_user_annotation=lambda: annotation)
    if kind is not None:
        e.activity_type = lambda: kind
    return e


KERNEL = _event("blur_u8_kernel<1, 1, true>", 100, 400)
BENCH_ANNOTATION = _event("bench.step", 0, 1000, annotation=True)
OTHER_ANNOTATION = _event("Engine.run", 0, 1000, annotation=True)


@pytest.mark.parametrize("event,busy", [(KERNEL, True), (BENCH_ANNOTATION, False),
                                        (OTHER_ANNOTATION, False)],
                         ids=["kernel", "bench_annotation", "other_annotation"])
def test_busy_without_activity_type(event, busy):
    assert not hasattr(event, "activity_type")
    assert devtrace._busy(event) is busy


def test_busy_by_activity_type():
    assert devtrace._busy(_event("k", 0, 1, kind="kernel"))
    assert not devtrace._busy(_event("Engine.run", 0, 1, kind="gpu_user_annotation"))


def test_an_annotation_over_the_window_adds_no_busy_time():
    window = _event("bench.window", 0, 1000, device=DeviceType.CPU, annotation=True)
    events = [window, KERNEL, BENCH_ANNOTATION, OTHER_ANNOTATION,
              _event("cudaLaunchKernel", 90, 110, device=DeviceType.CPU)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    summary = devtrace.summarize(prof)
    assert summary["window_s"] == 1e-6
    assert summary["busy_s"] == 300e-9
    assert summary["device_ops"] == [[KERNEL.name(), 300e-9]]
